"""Wrapper of the draw-stream kernel (``csrc/draw_stream.cu``).

Makes a shard's whole ``(u1, r2, r3[, u4])`` — the state-independent draw
stream of ``ops.precompute_draws`` — in one launch, bit for bit what the
plain route computes from ``core/prng.py``: one thread per (replica,
event), the replica's ``edges`` and ``zcdf`` rows staged in shared memory
by each block, the writes coalesced along the event axis straight into
the ``(B, n_events)`` outputs (see the header of the ``.cu`` file). The
threefry2x32 it runs is ``csrc/threefry.cuh``, which K2 includes too.

Build: at the first launch ``csrc/draw_stream.cu`` is compiled by ``nvcc``
for ``sm_90a`` into ``build/`` (``kernels/_build``), loaded with
``ctypes``. Nothing here runs at import time: importing this module needs
neither ``nvcc`` nor a CUDA device.

``draw_stream`` launches the kernel for CUDA tensors or raises — there is
no path from here to the plain version. ``LIB`` declares the library; it
counts the launches (one per call with at least one element), and nothing
else does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_vp, _ci, _cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
LIB = _build.Library("draw_stream", {
    "draw_stream_launch": [_vp] * 7 + [_ci] * 5 + [_cu, _cu, _vp]})


def randint_words(N: int) -> tuple[int, int]:
    """``(span, mult)`` of ``prng.randint(k, (), 0, max(N - 1, 1))``: the
    range and ``2**32 mod span`` of its double-width combine."""
    span = max(N - 1, 1)
    mult = (1 << 16) % span
    return span, (mult * mult) % span


def draw_stream(seed, edges, zcdf, n_events: int, N: int, kpn: int,
                rw: bool = False):
    """``(u1 f32, r2 i32, r3 i32[, u4 f32])``, each ``(B, n_events)``, for
    ``seed (B,) i32``, ``edges (B, P) i32`` and ``zcdf (B, P, kz) f32``
    CUDA tensors, in one launch on the current stream (no synchronise).
    The contract of ``ops.precompute_draws``; raises for anything else."""
    B = seed.shape[0] if seed.dim() == 1 else -1
    P = edges.shape[-1]
    f32, i32 = torch.float32, torch.int32
    _build.check_operands("draw-stream kernel", seed=(seed, i32, (B,)),
                          edges=(edges, i32, (B, P)),
                          zcdf=(zcdf, f32, (B, P, zcdf.shape[-1])))
    dev = seed.device
    u1 = torch.empty((B, n_events), dtype=f32, device=dev)
    r2 = torch.empty((B, n_events), dtype=i32, device=dev)
    r3 = torch.empty((B, n_events), dtype=i32, device=dev)
    u4 = torch.empty_like(u1) if rw else None
    out = (u1, r2, r3, u4) if rw else (u1, r2, r3)
    if B == 0 or n_events < 1:
        return out
    lib = LIB.load()
    span, mult = randint_words(N)
    with torch.cuda.device(dev):
        err = lib.draw_stream_launch(
            seed.data_ptr(), edges.data_ptr(), zcdf.data_ptr(),
            u1.data_ptr(), r2.data_ptr(), r3.data_ptr(),
            None if u4 is None else u4.data_ptr(), B, n_events, P,
            zcdf.shape[-1], kpn, span, mult, _build.stream_of(seed))
    _build.check_launch(lib, err, f"draw-stream kernel (B={B}, "
                                  f"n_events={n_events}, P={P}, "
                                  f"kz={zcdf.shape[-1]}, rw={rw})")
    LIB.count()
    return out
