"""Wrapper of the arrival-plan kernel (``csrc/arrival_plan.cu``).

Makes a shard's whole open-loop ``ArrivalPlan`` — gaps, token-admit mask,
its exclusive prefix count and queue bounds, the contract of
``ops.precompute_plan`` — in one launch, bit for bit what the plain route
``traffic/stream.py::arrival_plan`` computes: one block a replica, a thread
a request, thread 0 running the token bucket's serial credit chain (see the
header of the ``.cu`` file). The threefry2x32 it runs is
``csrc/threefry.cuh``, shared with K2 and the draw kernel.

Build: at the first launch ``csrc/arrival_plan.cu`` is compiled by ``nvcc``
for ``sm_90a`` into ``build/`` (``kernels/_build``), loaded with
``ctypes``. Nothing here runs at import time: importing this module needs
neither ``nvcc`` nor a CUDA device.

``arrival_plan`` launches the kernel for CUDA tensors or raises — there is
no path from here to the plain version. ``LIB`` declares the library; it
counts the launches (one per call with at least one request), and nothing
else does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.traffic.stream import ArrivalPlan

_vp, _ci, _cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
LIB = _build.Library("arrival_plan", {
    "arrival_plan_launch": [_vp] * 10 + [_ci] * 3 + [_cu, _vp]})


def arrival_plan(seed, arr_fix, arr_edges, arr_gap_ns, arr_token, arr_qcap,
                 n_events: int) -> ArrivalPlan:
    """The ``ArrivalPlan`` of ``(B, R)`` int32 arrays for ``seed (B,) i32``,
    ``arr_fix (B, R) i32``, ``arr_edges (B, P) i32``, ``arr_gap_ns (B, P)
    f32``, ``arr_token (B, P, 2) f32`` and ``arr_qcap (B, P) i32`` CUDA
    tensors, in one launch on the current stream (no synchronise). The
    contract of ``ops.precompute_plan``; raises for anything else."""
    B = seed.shape[0] if seed.dim() == 1 else -1
    R = arr_fix.shape[-1]
    P = arr_edges.shape[-1]
    i32, f32 = torch.int32, torch.float32
    _build.check_operands(
        "arrival-plan kernel", seed=(seed, i32, (B,)),
        arr_fix=(arr_fix, i32, (B, R)), arr_edges=(arr_edges, i32, (B, P)),
        arr_gap_ns=(arr_gap_ns, f32, (B, P)),
        arr_token=(arr_token, f32, (B, P, 2)),
        arr_qcap=(arr_qcap, i32, (B, P)))
    out = ArrivalPlan(*(torch.empty((B, R), dtype=i32, device=seed.device)
                        for _ in ArrivalPlan._fields))
    if B == 0 or R == 0:
        return out
    lib = LIB.load()
    with torch.cuda.device(seed.device):
        err = lib.arrival_plan_launch(
            seed.data_ptr(), arr_fix.data_ptr(), arr_edges.data_ptr(),
            arr_gap_ns.data_ptr(), arr_token.data_ptr(), arr_qcap.data_ptr(),
            *(a.data_ptr() for a in out), B, R, P,
            (n_events + 1) & 0xFFFFFFFF, _build.stream_of(seed))
    _build.check_launch(lib, err, f"arrival-plan kernel (B={B}, R={R}, "
                                  f"P={P})")
    LIB.count()
    return out
