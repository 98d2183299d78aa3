"""Arrival-stream precompute of the open loop, batched over replicas.

Requests arrive at precomputed times, wait in a FIFO queue, are
dispatched to the first idle thread, acquire / release once and depart.
Everything *state-independent* about the stream is computed here, once,
before the event loop runs, for B replicas at a time (the reference
``vmap``s the same functions over the replica axis):

  * **arrival gaps** — per-request inter-arrival times, the sum of a
    deterministic base gap (``arr_fix``, trace replay) and a Poisson
    jitter term ``round(-log1p(-u) * gap_ns)`` in f32, drawn from the
    counter-based ``fold_in`` stream of ``core/prng.py`` with counters
    offset past ``n_events`` so the event draws and the arrival draws
    never share a counter;
  * **arrival times** — the int64 prefix sum of the gaps;
  * **token-bucket admission** — debit-on-arrival with per-request refill
    credit, folded into a 0/1 admit mask (it depends on arrival times
    only, never on service);
  * **queue-bound rows** — the per-request queue capacity (a request's
    phase is its *index* interval via ``arr_edges``).

The bounded-queue tail drop is service-dependent and stays in the event
loop. The plain engine and the CUDA kernel consume the same plan.

Bitwise agreement with the reference rests on one function:
:func:`log1p_f32`. The reference's ``jnp.log1p`` on f32 is XLA's own
inlined approximation, not a libm call, and neither ``torch.log1p`` nor
``np.log1p`` nor a log taken in f64 rounds to the same f32 on every
input; a 1 ns difference in one gap shifts every later arrival of the
replica. So the function is written out as XLA's sequence of f32
operations, one tensor op each, with ``torch.where`` for the range
selects. XLA's CPU code generator contracts the polynomial's
multiply-adds into fused multiply-adds (the LLVM IR shows separate
``fmul``/``fadd``; the contraction happens below it, and separate f32
rounding of those steps differs from the reference on about 1.5 % of
inputs). Those steps, and the token bucket's refill, go through
:func:`fma_f32`, an exact fused multiply-add built from f64 tensor ops,
so the result is the same on the CPU and on a CUDA device.

>>> import torch
>>> x = torch.tensor([0.0, -0.25, -0.5, -0.999], dtype=torch.float32)
>>> [round(v, 6) for v in log1p_f32(x).tolist()]
[0.0, -0.287682, -0.693147, -6.907768]
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import prng

__all__ = [
    "ArrivalPlan", "arrival_gaps", "arrival_plan", "arrival_times_i64",
    "fma_f32", "log1p_f32", "per_request", "request_phase_onehot",
    "token_admit",
]

I32, I64 = torch.int32, torch.int64
F32, F64 = torch.float32, torch.float64


def _f32(bits: int) -> float:
    """The f32 whose IEEE bit pattern is ``bits`` (exact as a Python
    float, so a tensor op with it sees exactly that f32)."""
    return float(np.array(bits, np.uint32).view(np.float32))


# Constants of XLA's CPU f32 log1p, read from the optimised LLVM IR of a
# jitted ``jnp.log1p`` on an f32 vector (``XLA_FLAGS=--xla_dump_to=DIR``,
# file ``*log-plus-one*.ir-with-opt.ll``), given here as f32 bit patterns.
# |x| below this uses the rational branch, else log(1 + x).
_SMALL_X = _f32(0x3ED413CD)                  # 0.41421357 ~ sqrt(2) - 1
# log(v) of v = 1 + x: mantissa/exponent split, then a degree-8 polynomial
_MIN_NORMAL = _f32(0x00800000)               # 2**-126, floor on v
_SQRT_HALF = _f32(0x3F3504F3)                # 0.70710677
_LOG_Y1 = (_f32(0x3D9021BB), _f32(0xBDEBD1B8), _f32(0x3DEF251A))
_LOG_Y2 = (_f32(0xBDFE5D4F), _f32(0x3E11E9BF), _f32(0xBE2AAE50))
_LOG_Y3 = (_f32(0x3E4CCEAC), _f32(0xBE7FFFFC), _f32(0x3EAAAAAA))
_LN2_LO = _f32(0xB95E8083)                   # -2.1219444e-04
_LN2_HI = _f32(0x3F318000)                   # 0.693359375
# log1p(x) ~ x - x**2/2 + x**3 * P(x) / Q(x) for small |x|
_Q = (_f32(0x417101AD), _f32(0x42A6185B), _f32(0x435DC32D),
      _f32(0x439A8CA3), _f32(0x43586D8A), _f32(0x42707982))
_P = (_f32(0x383DE04B), _f32(0x3EFF40C5), _f32(0x40D284FA),
      _f32(0x41EF4B9C), _f32(0x4273CC76), _f32(0x426473AD),
      _f32(0x41A05101))


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` of f32 operands with one rounding, as a hardware FMA
    gives it, from f64 tensor ops on any device: the product of two f32
    is exact in f64; the f64 sum is made round-to-odd (its exact error
    from a two-sum sets the last bit), and round-to-odd at 53 bits followed
    by round-to-nearest-even at 24 bits is the correctly rounded result.
    ``b`` and ``c`` may be f32-exact Python floats."""
    p = a.to(F64) * b
    cd = c.to(F64) if isinstance(c, torch.Tensor) else c
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)          # exact: p + c == s + err
    bits = s.view(I64)
    even = (bits & 1) == 0
    toward = torch.where((err > 0) == (s > 0), bits + 1, bits - 1)
    bits = torch.where((err != 0) & even, toward, bits)
    return bits.view(F64).to(F32)


def _log_f32(v: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log`` of ``v`` (the large-|x| branch of its log1p),
    op for op; ``fma_f32`` where the code generator contracts."""
    bad = ~(v > 0.0)                          # v <= 0 or NaN -> NaN
    is_zero = v == 0.0                        # -> -inf
    is_inf = v == float("inf")                # -> +inf
    vc = torch.where(v > _MIN_NORMAL, v, torch.full_like(v, _MIN_NORMAL))
    bits = vc.view(I32)
    e = ((bits >> 23) - 127).to(F32)          # biased exponent, exact
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(F32)        # in [0.5, 1)
    e = e + 1.0
    lo = m < _SQRT_HALF
    tmp = torch.where(lo, m, torch.zeros_like(m))
    e = e - torch.where(lo, torch.ones_like(m), torch.zeros_like(m))
    x = (m + -1.0) + tmp
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
    y = fma_f32(y, x3, e * _LN2_LO)
    r = fma_f32(z, -0.5, x)
    r = r + y
    r = fma_f32(e, _LN2_HI, r)
    r = torch.where(bad, torch.full_like(r, float("nan")), r)
    r = torch.where(is_zero, torch.full_like(r, float("-inf")), r)
    return torch.where(is_inf, torch.full_like(r, float("inf")), r)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + x)`` of an f32 tensor, rounded as XLA's CPU ``log1p``
    rounds it, on any device: the reference's operations in the
    reference's order, one tensor op each (``fma_f32`` counts as one)."""
    if x.dtype != F32:
        raise ValueError(f"log1p_f32 takes float32, got {x.dtype}")
    large = _log_f32(x + 1.0)
    q = x * 0.0 + 1.0
    for c in _Q:
        q = fma_f32(q, x, c)
    p = x * 0.0 + _P[0]
    for c in _P[1:]:
        p = fma_f32(p, x, c)
    ratio = p / q
    x2 = x * x
    small = x + fma_f32(x2, -0.5, (x * x2) * ratio)
    return torch.where(x.abs() < _SMALL_X, small, large)


class ArrivalPlan(NamedTuple):
    """State-independent per-request arrays, each ``(B, R)``."""
    gaps: Any     # i32  inter-arrival gaps, ns
    tok: Any      # i32  1 = token-bucket admitted (1s when bucket off)
    tokcum: Any   # i32  exclusive prefix count of ``tok``
    qcap: Any     # i32  per-request wait-queue bound


def request_phase_onehot(arr_edges: torch.Tensor,
                         n_requests: int) -> torch.Tensor:
    """``(B, R, P)`` bool one-hot of each request's phase: request ``k``
    belongs to phase ``sum(k >= arr_edges) - 1``, the analogue of the
    engine's per-event phase resolve (padded phases carry ``arr_edges =
    INT32_MAX`` and are unreachable)."""
    B, P = arr_edges.shape
    idx = torch.arange(n_requests, dtype=I32, device=arr_edges.device)
    ph = (idx[None, :, None] >= arr_edges[:, None, :]).sum(-1) - 1
    return ph[..., None] == torch.arange(P, device=arr_edges.device)


def per_request(oh: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Per-phase ``(B, P)`` values onto requests through the one-hot
    ``(B, R, P)`` mask (one True per row, so the sum is a gather)."""
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    return torch.where(oh, vals[:, None, :], zero).sum(-1, dtype=vals.dtype)


def arrival_gaps(seed, arr_fix, gap_ns_r, n_events: int) -> torch.Tensor:
    """``(B, R)`` i32 gaps ``arr_fix + round(-log1p(-u) * gap_ns_r)``
    with ``u`` the f32 uniform of ``fold_in(key(seed), n_events + 1 +
    k)``; ``gap_ns_r == 0`` (no Poisson term) contributes exactly 0."""
    R = arr_fix.shape[-1]
    k1, k2 = prng.key(seed)
    k = torch.arange(R, dtype=I64, device=arr_fix.device)[None]
    u = prng.uniform(prng.fold_in((k1[:, None], k2[:, None]),
                                  n_events + 1 + k))
    jit = torch.round(-log1p_f32(-u) * gap_ns_r).to(I32)
    return arr_fix + jit


def arrival_times_i64(gaps: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of the gaps over the request axis, int64."""
    return torch.cumsum(gaps.to(I64), dim=-1)


def token_admit(gaps, rate_r, burst_r) -> torch.Tensor:
    """Debit-on-arrival token bucket -> ``(B, R)`` i32 0/1 mask.

    The bucket holds ``credit`` tokens (f32), starts full, refills at
    ``rate_r`` tokens/ns between arrivals and caps at ``burst_r``; a
    request is admitted iff a full token is there at its arrival (then
    debited). ``rate_r == 0`` switches the policy off. One f32 op per
    line, in the reference's order, over the ``(B,)`` replica vector; the
    refill ``credit + g * r`` is one fused multiply-add, as XLA's CPU
    code generator contracts it (two roundings flip an admission in a few
    replicas per thousand).
    """
    credit = burst_r[:, 0]
    ok = torch.empty(gaps.shape, dtype=torch.bool, device=gaps.device)
    gf = gaps.to(F32)
    for k in range(gaps.shape[-1]):
        c = fma_f32(gf[:, k], rate_r[:, k], credit)
        c = torch.minimum(c, burst_r[:, k])
        ok_k = c >= 1.0
        credit = torch.where(ok_k, c - 1.0, c)
        ok[:, k] = ok_k
    return torch.where(rate_r > 0.0, ok, True).to(I32)


def arrival_plan(wl, n_events: int) -> ArrivalPlan:
    """The plan of every replica of ``wl``, a ``WorkloadOperands`` of
    tensors with a leading replica axis B (``arr_fix (B, R)`` with
    ``R > 0``); the plan lies on ``wl``'s device."""
    R = wl.arr_fix.shape[-1]
    oh = request_phase_onehot(wl.arr_edges, R)
    gap_ns_r = per_request(oh, wl.arr_gap_ns)
    rate_r = per_request(oh, wl.arr_token[..., 0])
    burst_r = per_request(oh, wl.arr_token[..., 1])
    qcap_r = per_request(oh, wl.arr_qcap)
    gaps = arrival_gaps(wl.seed, wl.arr_fix, gap_ns_r, n_events)
    tok = token_admit(gaps, rate_r, burst_r)
    tokcum = torch.cumsum(tok, dim=-1, dtype=I32) - tok
    return ArrivalPlan(gaps=gaps, tok=tok, tokcum=tokcum, qcap=qcap_r)
