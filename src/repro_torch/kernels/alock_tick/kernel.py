"""Batched ALock tables: the wrapper of the CUDA kernel K2
(``csrc/alock_tick.cu``) and ``alock_tick``.

Replaces the TPU kernel ``repro/kernels/alock_tick/kernel.py::
_tick_kernel``. One CUDA thread per table applies the table's whole
schedule, its per-thread rows in shared memory for the run (see the
header of the ``.cu`` file). Built by ``nvcc`` at the first launch
(``kernels/_build``); importing this module needs neither ``nvcc`` nor a
CUDA device.

``tick_kernel`` launches for CUDA tensors or raises — no path leads from
it to the plain version. ``LAUNCHES`` counts its launches (one per call
with at least one table), and nothing else increments it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import device_of, resolve_backend
from repro_torch.kernels import _build
from repro_torch.kernels.alock_tick.ref import alock_tick_plain

#: number of kernel launches since the last ``reset_launches()``
LAUNCHES = 0

#: shared memory one block may use on Hopper
SMEM_LIMIT = 227 * 1024
#: int32 rows per table in shared memory: pc, budget, next, prev, cohort
FIELDS = 5
WARP = 32

_vp, _ci = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "alock_tick_launch": [_vp] * 14 + [_ci, _ci, ctypes.c_longlong, _ci,
                                       _ci, _ci, _vp],
    "alock_tick_smem_bytes": [_ci] * 2,
}


def launches() -> int:
    return LAUNCHES


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def load():
    return _build.load_library("alock_tick", SIGNATURES)


def tables_per_block(T: int, tile: int) -> int:
    """``tile`` tables per block where they fit in shared memory; else the
    most whole warps of tables that do. Raises ``ValueError`` naming the
    limit when one warp's tables (or ``tile``, if smaller) do not fit."""
    if tile < 1 or T < 1:
        raise ValueError(f"need tile >= 1 and T >= 1, got tile={tile}, "
                         f"T={T}")
    per_table = 4 * FIELDS * T
    if per_table * tile <= SMEM_LIMIT:
        return tile
    fit = SMEM_LIMIT // per_table // WARP * WARP
    if fit < 1:
        raise ValueError(
            f"alock_tick kernel cannot hold one warp's tables in the "
            f"{SMEM_LIMIT:,} B of shared memory a block may use: at T={T} "
            f"threads a table needs {per_table:,} B (pc, budget, next, "
            f"prev, cohort), {WARP} tables {WARP * per_table:,} B. Use "
            f"fewer threads per table or backend='plain'.")
    return fit


def smem_bytes(T: int, tile: int) -> int:
    """Dynamic shared memory of one block as launched for ``tile``
    (mirrors ``alock_tick_smem_bytes`` in the ``.cu``)."""
    return 4 * FIELDS * T * tables_per_block(T, tile)


def tick_kernel(tails, victim, pc, budget, nxt, prev, sched, cohorts, *,
                b_init=(5, 20), tile: int = 128):
    """Launch K2 on the current stream: the six final arrays as
    ``ref.alock_tick_plain``. All operands contiguous int32 CUDA tensors
    of the shapes ``alock_tick`` documents."""
    global LAUNCHES
    what = "alock_tick kernel"
    ops = dict(tails=tails, victim=victim, pc=pc, budget=budget, nxt=nxt,
               prev=prev, sched=sched, cohorts=cohorts)
    _build.require_cuda(what, **ops)
    for name, t in ops.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{what}: {name} must be int32, got {t.dtype}")
    Tab, T = pc.shape
    steps = sched.shape[1]
    per = tables_per_block(T, min(tile, max(Tab, 1)))
    out = [torch.empty_like(a) for a in (tails, victim, pc, budget, nxt,
                                         prev)]
    if Tab == 0:
        return out
    lib = load()
    with torch.cuda.device(pc.device):
        err = lib.alock_tick_launch(
            *(t.data_ptr() for t in (sched, cohorts, tails, victim, pc,
                                     budget, nxt, prev, *out)),
            Tab, T, steps, int(b_init[0]), int(b_init[1]), per,
            _build.stream_of(pc))
    _build.check_launch(lib, err, f"{what} (Tab={Tab}, T={T}, "
                                  f"steps={steps}, tables per block={per})")
    LAUNCHES += 1
    return out


def alock_tick(tails, victim, pc, budget, nxt, prev, sched, cohorts, *,
               b_init=(5, 20), tile: int = 128, backend: str = "auto"):
    """Apply (Tab, steps) schedules to Tab independent single-lock tables.

    tails (Tab,2), victim (Tab,1), pc/budget/nxt/prev (Tab,T),
    sched (Tab,steps), cohorts (Tab,T) — all int32. Returns the six final
    arrays in the same shapes. ``tile`` is the tables per block of the
    kernel; Tab need not be a multiple of it, and it changes no result.

    Runs where the inputs lie: CUDA tensors launch K2, CPU tensors take
    ``ref.alock_tick_plain`` (``backend='kernel'`` on them raises).
    """
    Tab, T = pc.shape
    shapes = dict(tails=(Tab, 2), victim=(Tab, 1), budget=(Tab, T),
                  nxt=(Tab, T), prev=(Tab, T), cohorts=(Tab, T))
    args = dict(tails=tails, victim=victim, budget=budget, nxt=nxt,
                prev=prev, cohorts=cohorts)
    bad = {n: tuple(args[n].shape) for n, s in shapes.items()
           if tuple(args[n].shape) != s}
    if bad or sched.dim() != 2 or sched.shape[0] != Tab:
        raise ValueError(f"alock_tick: expected tails (Tab,2), victim "
                         f"(Tab,1), pc/budget/nxt/prev/cohorts (Tab,T), "
                         f"sched (Tab,steps) with Tab={Tab}, T={T}; got "
                         f"{bad or {'sched': tuple(sched.shape)}}")
    dev = device_of(tails=tails, victim=victim, pc=pc, budget=budget,
                    nxt=nxt, prev=prev, sched=sched, cohorts=cohorts)
    if resolve_backend(backend, dev) == "plain":
        return alock_tick_plain(tails, victim, pc, budget, nxt, prev, sched,
                                cohorts, b_init=b_init, tile=tile)
    return tick_kernel(*(t.to(torch.int32).contiguous() for t in (
        tails, victim, pc, budget, nxt, prev, sched, cohorts)),
        b_init=b_init, tile=tile)
