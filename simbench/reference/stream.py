"""The open loop's request plan in plain NumPy: Poisson gaps, arrival
times, token-bucket admission and queue bounds, per replica.

Request ``k``'s gap is ``arr_fix[k] + round(-log1p(-u) * gap_ns)`` in f32,
``u`` the f32 uniform of ``fold_in(key(seed), n_events + 1 + k)``. The
f32 ``log1p`` is the sequence of f32 operations of XLA's CPU
implementation, the simulator's definition of the stream (its
constants are the f32 bit patterns below), with the multiply-adds that
its code generator fuses rounded once, as a fused multiply-add rounds.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import prng

F32, F64 = np.float32, np.float64


def _f32(bits: int) -> float:
    return float(np.array(bits, np.uint32).view(F32))


_SMALL_X = _f32(0x3ED413CD)
_MIN_NORMAL = _f32(0x00800000)
_SQRT_HALF = _f32(0x3F3504F3)
_LOG_Y1 = (_f32(0x3D9021BB), _f32(0xBDEBD1B8), _f32(0x3DEF251A))
_LOG_Y2 = (_f32(0xBDFE5D4F), _f32(0x3E11E9BF), _f32(0xBE2AAE50))
_LOG_Y3 = (_f32(0x3E4CCEAC), _f32(0xBE7FFFFC), _f32(0x3EAAAAAA))
_LN2_LO = _f32(0xB95E8083)
_LN2_HI = _f32(0x3F318000)
_Q = (_f32(0x417101AD), _f32(0x42A6185B), _f32(0x435DC32D),
      _f32(0x439A8CA3), _f32(0x43586D8A), _f32(0x42707982))
_P = (_f32(0x383DE04B), _f32(0x3EFF40C5), _f32(0x40D284FA),
      _f32(0x41EF4B9C), _f32(0x4273CC76), _f32(0x426473AD),
      _f32(0x41A05101))


def fma_f32(a, b, c) -> np.ndarray:
    """``a * b + c`` of f32 values rounded once: the f64 product is exact,
    the f64 sum is made round-to-odd from its exact error, and rounding
    that to f32 is the correctly rounded result."""
    p = np.asarray(a, F32).astype(F64) * F64(b) if np.ndim(b) == 0 else \
        np.asarray(a, F32).astype(F64) * np.asarray(b, F32).astype(F64)
    cd = np.asarray(c, F32).astype(F64)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    bits = np.atleast_1d(s).view(np.int64).copy()
    err = np.broadcast_to(err, bits.shape)
    sv = np.atleast_1d(s)
    fix = (err != 0) & ((bits & 1) == 0)
    toward = np.where((err > 0) == (sv > 0), bits + 1, bits - 1)
    bits = np.where(fix, toward, bits)
    out = bits.view(F64).astype(F32)
    return out.reshape(np.shape(s))


def _log_f32(v: np.ndarray) -> np.ndarray:
    bad = ~(v > 0.0)
    is_zero = v == 0.0
    is_inf = v == np.inf
    vc = np.where(v > F32(_MIN_NORMAL), v, F32(_MIN_NORMAL)).astype(F32)
    bits = vc.view(np.int32)
    e = ((bits >> 23) - 127).astype(F32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).astype(np.int32).view(F32)
    e = e + F32(1.0)
    lo = m < F32(_SQRT_HALF)
    tmp = np.where(lo, m, F32(0.0)).astype(F32)
    e = e - np.where(lo, F32(1.0), F32(0.0)).astype(F32)
    x = (m + F32(-1.0)) + tmp
    z = x * x
    x3 = z * x
    y1 = fma_f32(x, _LOG_Y1[0], _LOG_Y1[1])
    y2 = fma_f32(x, _LOG_Y2[0], _LOG_Y2[1])
    y3 = fma_f32(x, _LOG_Y3[0], _LOG_Y3[1])
    y1 = fma_f32(y1, x, _LOG_Y1[2])
    y2 = fma_f32(y2, x, _LOG_Y2[2])
    y3 = fma_f32(y3, x, _LOG_Y3[2])
    y = fma_f32(y1, x3, y2)
    y = fma_f32(y, x3, y3)
    y = fma_f32(y, x3, e * F32(_LN2_LO))
    r = fma_f32(z, -0.5, x)
    r = r + y
    r = fma_f32(e, _LN2_HI, r)
    r = np.where(bad, F32(np.nan), r)
    r = np.where(is_zero, F32(-np.inf), r)
    return np.where(is_inf, F32(np.inf), r).astype(F32)


def log1p_f32(x: np.ndarray) -> np.ndarray:
    """``log(1 + x)`` of f32 values, rounded as the stream defines it."""
    x = np.asarray(x, F32)
    with np.errstate(all="ignore"):
        large = _log_f32(x + F32(1.0))
        q = x * F32(0.0) + F32(1.0)
        for c in _Q:
            q = fma_f32(q, x, c)
        p = x * F32(0.0) + F32(_P[0])
        for c in _P[1:]:
            p = fma_f32(p, x, c)
        ratio = p / q
        x2 = x * x
        small = x + fma_f32(x2, -0.5, (x * x2) * ratio)
    return np.where(np.abs(x) < F32(_SMALL_X), small, large).astype(F32)


class Plan(NamedTuple):
    """One replica's requests: arrival times (int), admitted by the token
    bucket (bool), and queue bound, each ``(R,)``."""
    arr: np.ndarray
    tok: np.ndarray
    qcap: np.ndarray


def bf16(x) -> np.ndarray:
    """f32 values rounded to bfloat16 (nearest, ties to even), as f32."""
    b = np.asarray(x, F32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(F32)


def bf16_down(x) -> np.ndarray:
    """f32 values cut to bfloat16 toward zero, as a uniform drawn with 8
    mantissa bits is: it stays below 1."""
    b = np.asarray(x, F32).view(np.uint32) & np.uint32(0xFFFF0000)
    return b.view(F32)


def plan(lw, seed: int, n_events: int, low: bool = False) -> Plan:
    """The request plan of one replica of the lowered workload ``lw``.
    ``low`` (the control) computes the jitter in bfloat16."""
    R = len(lw.arr_fix)
    k = np.arange(R, dtype=np.int64)
    ph = (k[:, None] >= lw.arr_edges[None, :]).sum(1) - 1
    gap_r = lw.arr_gap_ns[ph]
    u = prng.uniform(prng.fold_in(prng.key(seed), n_events + 1 + k))
    if not low:
        jit = -log1p_f32(-u) * gap_r
    else:
        lg = bf16(np.log1p(-bf16_down(u).astype(F64)))
        jit = bf16(-lg * bf16(gap_r).astype(F64))
    gaps = lw.arr_fix + np.rint(jit).astype(np.int64)
    rate_r, burst_r = lw.arr_token[ph, 0], lw.arr_token[ph, 1]
    tok = np.ones(R, bool)
    credit = np.float32(burst_r[0]) if R else F32(0)
    gf = gaps.astype(F32)
    for j in range(R):
        c = fma_f32(gf[j], rate_r[j], credit)[()]
        c = min(c, burst_r[j])
        ok = c >= F32(1.0)
        credit = F32(c - F32(1.0)) if ok else F32(c)
        tok[j] = ok or not rate_r[j] > 0.0
    return Plan(np.cumsum(gaps), tok, lw.arr_qcap[ph])
