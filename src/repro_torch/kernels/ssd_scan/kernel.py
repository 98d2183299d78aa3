"""SSD intra-chunk block: the wrapper of the CUDA kernel K6
(``csrc/ssd_scan.cu``) and ``ssd_intra_chunk``.

Replaces the TPU kernel ``repro/kernels/ssd_scan/kernel.py::_ssd_kernel``.
One block per ``(b, chunk, head)`` takes the chunk's cumulative decay in
shared memory and forms the masked-decay local attention ``y_diag``, the
chunk's terminal ``states`` and ``chunk_decay`` without writing the
``(L, L)`` decay matrix to device memory (see the header of the ``.cu``
file). Built by ``nvcc`` at the first launch (``kernels/_build``);
importing this module needs neither ``nvcc`` nor a CUDA device.

``ssd_kernel`` launches for CUDA tensors or raises — no path leads from it
to the plain version. ``LAUNCHES`` counts its launches (one per call), and
nothing else increments it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import device_of, resolve_backend
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref

#: number of kernel launches since the last ``reset_launches()``
LAUNCHES = 0

#: shared memory one block may use on Hopper
SMEM_LIMIT = 227 * 1024
#: rows of c (and of y) the kernel forms W for at a time
TILE_ROWS = 32

_vp, _ci = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "ssd_launch": [_vp] * 7 + [_ci] * 6 + [_vp],
    "ssd_smem_bytes": [_ci] * 3,
}


def launches() -> int:
    return LAUNCHES


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def load():
    return _build.load_library("ssd_scan", SIGNATURES)


def smem_bytes(L: int, P: int, N: int) -> int:
    """Shared memory of one block (mirrors ``ssd_smem_bytes`` in the
    ``.cu``): cs (L), b (L, N + 1), xd (L, P), a c tile (32, N) and a W
    tile (32, L), f32. Raises ``ValueError`` above what a block may use."""
    total = 4 * (L + L * (N + 1) + L * P + TILE_ROWS * (N + L))
    if total > SMEM_LIMIT:
        raise ValueError(
            f"SSD kernel cannot hold one chunk (L={L}, P={P}, N={N}) in the "
            f"{SMEM_LIMIT:,} B of shared memory a block may use: it needs "
            f"{total:,} B (b alone {4 * L * (N + 1):,} B). Use a shorter "
            f"chunk or backend='plain'.")
    return total


def ssd_kernel(xd, dA, b, c):
    """Launch K6 on the current stream: ``(y_diag, states, chunk_decay)``
    as ``ref.ssd_chunk_ref``. All operands contiguous f32 CUDA tensors."""
    global LAUNCHES
    what = "SSD intra-chunk kernel"
    _build.require_cuda(what, xd=xd, dA=dA, b=b, c=c)
    for name, t in (("xd", xd), ("dA", dA), ("b", b), ("c", c)):
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got "
                             f"{t.dtype}")
    B, nc, L, H, P = xd.shape
    N = b.shape[-1]
    smem_bytes(L, P, N)
    lib = load()
    f32 = dict(dtype=torch.float32, device=xd.device)
    y = torch.empty((B, nc, L, H, P), **f32)
    states = torch.empty((B, nc, H, P, N), **f32)
    decay = torch.empty((B, nc, H), **f32)
    with torch.cuda.device(xd.device):
        err = lib.ssd_launch(
            xd.data_ptr(), dA.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), states.data_ptr(), decay.data_ptr(), B, nc, L, H,
            P, N, _build.stream_of(xd))
    _build.check_launch(lib, err, f"{what} (B={B}, nc={nc}, L={L}, H={H}, "
                                  f"P={P}, N={N})")
    LAUNCHES += 1
    return y, states, decay


def ssd_intra_chunk(xd, dA, b, c, *, hb: int = 8, backend: str = "auto"):
    """xd: (B,nc,L,H,P) dt-scaled inputs; dA: (B,nc,L,H); b,c: (B,nc,L,N).
    Returns y_diag (B,nc,L,H,P) f32, states (B,nc,H,P,N) f32,
    chunk_decay (B,nc,H) f32.

    Runs where the inputs lie: CUDA tensors launch K6, CPU tensors take
    ``ssd_chunk_ref``. The reference's head tile ``hb`` is accepted and
    checked (``H % min(hb, H) == 0``); the CUDA kernel takes one head per
    block.
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
