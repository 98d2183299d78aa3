"""SSD intra-chunk block: the wrapper of the CUDA kernel K6
(``csrc/ssd_scan.cu``), its launch plan and ``ssd_intra_chunk``.

Replaces the TPU kernel ``repro/kernels/ssd_scan/kernel.py::_ssd_kernel``.
One CTA per ``(b, chunk, tile of hb heads)`` forms ``c b^T`` once on the
tensor cores and keeps it in registers, then per head the masked-decay
local attention ``y_diag``, the chunk's terminal ``states`` and
``chunk_decay``, all three products as 3xTF32 ``mma.sync``, without
writing the ``(L, L)`` decay matrix to device memory (see the header of the
``.cu`` file). ``ssd_plan`` picks the head tile. Built by ``nvcc`` at the
first launch (``kernels/_build``); importing this module needs neither
``nvcc`` nor a CUDA device.

``ssd_kernel`` launches for CUDA tensors or raises — no path leads from it
to the plain version. ``LIB`` declares the library; it counts the launches
(one per call), and nothing else does.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import asdict, dataclass

import torch

from repro_torch.device import device_of, resolve_backend
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref

_LAST_PLAN = None

SMEM_LIMIT = _build.SMEM_LIMIT
#: the longest chunk: c b^T stays in registers, 16 rows in each of 8 warps
MAX_L = 128
#: SMs of an H100, the plan's default when no device is asked
N_SM = 132
_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = _build.Library("ssd_scan", {
    "ssd_launch": [_vp] * 7 + [_ci] * 7 + [_vp],
    "ssd_smem_bytes": [_ci] * 4,
}, _build.REPORT_FLAGS)


def last_plan() -> dict | None:
    """The plan of the last launch (``SsdPlan.as_dict()``), or None."""
    return None if _LAST_PLAN is None else _LAST_PLAN.as_dict()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _smem_total(L: int, P: int, N: int, hb: int) -> int:
    LP = _round_up(L, 16)
    LDB, LDX = _round_up(N, 8) + 4, _round_up(P, 16) + 4
    return 4 * (2 * LP * LDB + 2 * LP * LDX + 2 * hb * LP + hb)


def smem_bytes(L: int, P: int, N: int, hb: int = 1) -> int:
    """Shared memory of one CTA (mirrors ``ssd_smem_bytes`` in the
    ``.cu``), f32: b's big and small TF32 halves (c's rows until c b^T is
    formed), each ``L`` rows padded to 16 of ``N`` padded to 8 plus 4
    floats; two xd buffers of ``L`` rows of ``P`` padded to 16 plus 4; the
    ``hb`` heads' cumulative sums and state weights; a tile counter a head.
    Raises ``ValueError`` naming the fix for a chunk longer than 128 or
    above what a block may use."""
    total = _smem_total(L, P, N, hb)
    if L > MAX_L or total > SMEM_LIMIT:
        LP, LDB = _round_up(L, 16), _round_up(N, 8) + 4
        raise ValueError(
            f"SSD kernel cannot hold one chunk (L={L}, P={P}, N={N}, "
            f"hb={hb}): it keeps c b^T in registers for chunks of at most "
            f"{MAX_L} steps and needs {total:,} B of the {SMEM_LIMIT:,} B "
            f"of shared memory a block may use (b's two TF32 halves alone "
            f"{8 * LP * LDB:,} B). Use a shorter chunk or backend='plain'.")
    return total


@dataclass(frozen=True)
class SsdPlan:
    hb: int
    ctas: int
    waves: int
    smem_bytes: int

    def as_dict(self) -> dict:
        return asdict(self)


@functools.lru_cache(maxsize=256)
def ssd_plan(B: int, nc: int, H: int, L: int, P: int, N: int,
             n_sm: int = N_SM) -> SsdPlan:
    """The launch shape of K6: the head tile ``hb``, a divisor of ``H``
    whose CTA fits a block's shared memory. One CTA per SM (each holds b's
    halves and keeps c b^T in registers); the tile is the largest of those
    that keep the SMs busiest over the launch's waves (CTAs / (waves x
    SMs)): c b^T and the b, c copies are shared by more heads, and fewer
    CTAs would leave SMs idle. At the path shape (B=2, nc=16, H=16, L=128)
    hb = 4: 128 CTAs, one wave. Tiles too big for shared memory are left
    out; raises ``ValueError`` naming the fix only where one head's chunk
    cannot fit a CTA."""
    if min(B, nc, H, L, P, N, n_sm) < 1:
        raise ValueError(f"every extent must be positive, got B={B}, "
                         f"nc={nc}, H={H}, L={L}, P={P}, N={N}, "
                         f"n_sm={n_sm}")
    smem_bytes(L, P, N)          # raises where one head cannot fit
    plans = []
    for hb in range(1, H + 1):
        smem = _smem_total(L, P, N, hb)
        if H % hb == 0 and smem <= SMEM_LIMIT:
            ctas = B * nc * (H // hb)
            plans.append(SsdPlan(hb, ctas, -(-ctas // n_sm), smem))
    return max(plans, key=lambda p: (p.ctas / (p.waves * n_sm), p.hb))


@functools.lru_cache(maxsize=None)
def _n_sm(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ssd_kernel(xd, dA, b, c):
    """Launch K6 on the current stream, with ``ssd_plan``'s head tile:
    ``(y_diag, states, chunk_decay)`` as ``ref.ssd_chunk_ref``. All
    operands contiguous f32 CUDA tensors."""
    global _LAST_PLAN
    what = "SSD intra-chunk kernel"
    _build.check_operands(what, torch.float32, xd=xd, dA=dA, b=b, c=c)
    B, nc, L, H, P = xd.shape
    N = b.shape[-1]
    plan = ssd_plan(B, nc, H, L, P, N, _n_sm(xd.device))
    lib = LIB.load()
    f32 = dict(dtype=torch.float32, device=xd.device)
    y = torch.empty((B, nc, L, H, P), **f32)
    states = torch.empty((B, nc, H, P, N), **f32)
    decay = torch.empty((B, nc, H), **f32)
    with torch.cuda.device(xd.device):
        err = lib.ssd_launch(
            xd.data_ptr(), dA.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), states.data_ptr(), decay.data_ptr(), B, nc, L, H,
            P, N, plan.hb, _build.stream_of(xd))
    _build.check_launch(lib, err, f"{what} (B={B}, nc={nc}, L={L}, H={H}, "
                                  f"P={P}, N={N}, hb={plan.hb})")
    LIB.count()
    _LAST_PLAN = plan
    return y, states, decay


def ssd_intra_chunk(xd, dA, b, c, *, hb: int = 8, backend: str = "auto"):
    """xd: (B,nc,L,H,P) dt-scaled inputs; dA: (B,nc,L,H); b,c: (B,nc,L,N).
    Returns y_diag (B,nc,L,H,P) f32, states (B,nc,H,P,N) f32,
    chunk_decay (B,nc,H) f32.

    Runs where the inputs lie: CUDA tensors launch K6, CPU tensors take
    ``ssd_chunk_ref``. The reference's head tile ``hb`` is accepted and
    checked as the reference checks it (``H % min(hb, H) == 0``) but does
    not set the CUDA kernel's tile: ``ssd_plan`` does, for the card.
    """
    if xd.dim() != 5 or dA.shape != xd.shape[:4] or b.dim() != 4 \
            or b.shape[:3] != xd.shape[:3] or c.shape != b.shape:
        raise ValueError(f"expected xd (B,nc,L,H,P), dA (B,nc,L,H), b and c "
                         f"(B,nc,L,N); got {tuple(xd.shape)}, "
                         f"{tuple(dA.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    H = xd.shape[3]
    if H % min(hb, H):
        raise ValueError(f"H={H} must be a multiple of the head tile "
                         f"hb={hb}")
    dev = device_of(xd=xd, dA=dA, b=b, c=c)
    if resolve_backend(backend, dev) == "plain":
        return ssd_chunk_ref(xd, dA, b, c)
    return ssd_kernel(*(t.float().contiguous() for t in (xd, dA, b, c)))
