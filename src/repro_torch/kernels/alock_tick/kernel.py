"""Batched ALock tables: the wrapper of the CUDA kernel K2
(``csrc/alock_tick.cu``), its shared-memory plan, the launch words of the
schedule it draws, and ``alock_tick``.

Replaces the TPU kernel ``repro/kernels/alock_tick/kernel.py::
_tick_kernel``. A block is chain warps (one table per lane, its threads'
records in shared memory) and draw warps that fill a ring of schedule
stages beside them (see the header of the ``.cu`` file). Two modes:
``tick_kernel`` takes the ``(Tab, steps)`` schedule (the TPU kernel's
contract); ``tick_drawn`` draws it inside the kernel from launch words
derived here on the host (``draw_words``), bit for bit
``core/prng.py::randint``, so no schedule is ever stored;
``draw_schedule`` writes that in-kernel stream out instead of running the
tables. Built by ``nvcc`` at the first launch (``kernels/_build``);
importing this module needs neither ``nvcc`` nor a CUDA device.

The launchers take CUDA tensors or raise — no path leads from them to the
plain version. ``LIB`` declares the library; it counts their launches (one
per call with at least one table), and nothing else does.
"""
from __future__ import annotations

import ctypes
from dataclasses import asdict, dataclass
from typing import NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.device import device_of, resolve_backend
from repro_torch.kernels import _build
from repro_torch.kernels.alock_tick.ref import alock_tick_plain

_LAST_PLAN: dict | None = None

SMEM_LIMIT = _build.SMEM_LIMIT
WARP = 32
#: threads a block at most (the kernel's launch bound)
MAX_THREADS = 256
#: the ring's default shape: steps a stage, stages
STAGE_STEPS = 64
STAGES = 4
#: draw warps a block by default: copies of a given schedule are cheap;
#: hashes want the three schedulers the chain warp does not use
DRAW_WARPS = {"given": 1, "drawn": 3}
#: ring shapes tried in turn when the default does not fit beside the
#: records: (stage steps, stages)
RING_LADDER = ((64, 4), (64, 3), (64, 2), (32, 2), (16, 2), (8, 2))
MODES = {"given": 0, "drawn": 1, "draw_only": 2}

_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_cull = ctypes.c_ulonglong
LIB = _build.Library("alock_tick", {
    "alock_tick_launch": [_ci] + [_vp] * 15 + [_ci, _ci, _cll, _ci, _ci, _ci,
                                               _ci, _ci, _ci, _ci, _vp,
                                               _cull, _cull, _vp],
    "alock_tick_smem_bytes": [_ci] * 4,
})


def last_plan() -> dict | None:
    """The plan of the last launch (``TickPlan.as_dict()``), or None."""
    return _LAST_PLAN


# -- the shared-memory plan ---------------------------------------------------

def _round16(b: int) -> int:
    return (b + 15) // 16 * 16


def smem_table(T: int, chain_warps: int, stage_steps: int,
               stages: int) -> dict:
    """name -> (offset, bytes) of one block's dynamic shared memory, in the
    ``.cu``'s order (``Layout``): full and empty barriers per stage, one
    16-byte record per table thread (and a scratch record per table, the
    target of a step without a remote write) and one cohort word,
    [thread][table] with a table stride of 32 x chain warps, then the ring,
    [stage][table]
    rows of ``stage_steps + 4`` words (the chain reads four steps at a
    time)."""
    ps = WARP * chain_warps
    rec = _round16(16 * stages)
    coh = rec + 16 * (T + 1) * ps
    ring = _round16(coh + 4 * T * ps)
    return {"barriers": (0, 16 * stages),
            "records": (rec, 16 * (T + 1) * ps),
            "cohorts": (coh, 4 * T * ps),
            "ring": (ring, 4 * stages * ps * (stage_steps + 4))}


def layout_bytes(T: int, chain_warps: int, stage_steps: int,
                 stages: int) -> int:
    """Total of ``smem_table`` (mirrors ``alock_tick_smem_bytes``)."""
    off, size = smem_table(T, chain_warps, stage_steps, stages)["ring"]
    return _round16(off + size)


@dataclass(frozen=True)
class TickPlan:
    mode: str
    T: int
    tables_per_block: int
    chain_warps: int
    draw_warps: int
    stage_steps: int
    stages: int
    smem_bytes: int

    def as_dict(self) -> dict:
        return asdict(self)


def tick_plan(T: int, tile: int = 128, n_tables: int | None = None,
              mode: str = "given", chain_warps: int = 1,
              draw_warps: int | None = None, stage_steps: int = STAGE_STEPS,
              stages: int = STAGES) -> TickPlan:
    """The launch shape of K2 for tables of ``T`` threads.

    Tables per block: ``tile``, capped by ``n_tables`` and by the chain
    warps' lanes (one warp, 32 tables, by default: about one block per SM
    at the path shape). Where the records (20 B a table thread) of the
    requested chain warps do not fit beside the smallest ring, the block
    shrinks to whole warps of tables; then the ring steps down
    ``RING_LADDER`` from the requested shape until the block fits. Raises
    ``ValueError`` naming the limit when one warp's tables do not fit.
    Changes no result."""
    if tile < 1 or T < 1:
        raise ValueError(f"need tile >= 1 and T >= 1, got tile={tile}, "
                         f"T={T}")
    if mode not in MODES or mode == "draw_only":
        raise ValueError(f"mode must be 'given' or 'drawn', got {mode!r}")
    if stage_steps < 4 or stage_steps % 4 or stages < 1:
        raise ValueError(f"stage_steps must be a positive multiple of 4 and "
                         f"stages >= 1, got {stage_steps}, {stages}")
    dw = DRAW_WARPS[mode] if draw_warps is None else draw_warps
    if chain_warps < 1 or dw < 1 or WARP * (chain_warps + dw) > MAX_THREADS:
        raise ValueError(f"need >= 1 chain and draw warps, at most "
                         f"{MAX_THREADS // WARP} in all, got {chain_warps} "
                         f"+ {dw}")
    per = min(tile, WARP * chain_warps, max(1, n_tables or tile))
    cw = -(-per // WARP)
    rings = [(stage_steps, stages)] + [r for r in RING_LADDER
                                       if r[0] * r[1] < stage_steps * stages]
    small = rings[-1]
    while cw > 1 and layout_bytes(T, cw, *small) > SMEM_LIMIT:
        cw -= 1
        per = min(per, WARP * cw)
    for S, st in rings:
        if layout_bytes(T, cw, S, st) <= SMEM_LIMIT:
            return TickPlan(mode, T, per, cw, dw, S, st,
                            layout_bytes(T, cw, S, st))
    raise ValueError(
        f"alock_tick kernel cannot hold one warp's tables in the "
        f"{SMEM_LIMIT:,} B of shared memory a block may use: at T={T} "
        f"threads a warp of {WARP} tables needs {WARP * 20 * T:,} B of "
        f"records (pc, budget, next, prev) and cohorts, plus "
        f"{layout_bytes(T, 1, *small) - WARP * 20 * T:,} B of scratch "
        f"records, ring and barriers. Use fewer threads per table or "
        f"backend='plain'.")


def tables_per_block(T: int, tile: int) -> int:
    """Tables per block of a launch with schedule given at ``tile``."""
    return tick_plan(T, tile).tables_per_block


def smem_bytes(T: int, tile: int) -> int:
    """Dynamic shared memory of one block of that launch."""
    return tick_plan(T, tile).smem_bytes


# -- the launch words of the drawn schedule -----------------------------------

class DrawWords(NamedTuple):
    """What ``core/prng.py::randint(key(seed), (rows, pitch), 0, span)``
    needs per element, as uint32 Python ints: the two subkeys of
    ``split(key(seed), 2)`` ("higher" and "lower" bits), ``span``,
    ``mult = 2**32 % span``, the division magic of ``span`` and the first
    row ``r0`` and row pitch of the 64-bit counter ``(r0 + t) * pitch +
    i``."""
    hi0: int
    hi1: int
    lo0: int
    lo1: int
    span: int
    mult: int
    magic: int
    shift: int
    r0: int
    pitch: int


def span_magic(span: int) -> tuple[int, int]:
    """``(magic, shift)`` with ``x // span == ((((x - h) >> 1) + h) >>
    shift)``, ``h = (magic * x) >> 32``, for every uint32 ``x``: the
    round-up method for a 33-bit multiplier (Granlund and Montgomery;
    libdivide's branch-free u32). ``(0, 0)`` where ``span`` is a power of
    two: the kernel takes ``x & (span - 1)`` there."""
    if span < 1 or span >= 1 << 32:
        raise ValueError(f"span must be in [1, 2**32), got {span}")
    if span & (span - 1) == 0:
        return 0, 0
    shift = span.bit_length() - 1
    m, rem = divmod(1 << (32 + shift), span)
    m = 2 * m + (1 if 2 * rem >= span else 0)
    return (m + 1) & 0xFFFFFFFF, shift


def draw_words(seed: int, T: int, r0: int = 0,
               pitch: int = 0) -> DrawWords:
    """Launch words of the schedule ``randint(key(seed), (*, pitch), 0,
    T)`` from row ``r0`` on, derived on the host with ``prng.key`` /
    ``prng.split`` (as ``ops.schedule`` draws it on a device)."""
    k = prng.key(torch.tensor(seed, dtype=torch.int32))
    sub = prng.split(k, 2)
    span = max(T, 1)
    mult = (1 << 16) % span
    mult = (mult * mult) % span
    magic, shift = span_magic(span)
    return DrawWords(int(sub[0][0]), int(sub[1][0]), int(sub[0][1]),
                     int(sub[1][1]), span, mult, magic, shift, int(r0),
                     int(pitch))


# -- launches -----------------------------------------------------------------

def launch(lib, mode: str, p: TickPlan, state, cohorts, sched=None,
           sched_out=None, words: DrawWords | None = None, steps: int = 0,
           b_init=(5, 20), what: str = "alock_tick kernel"):
    """One launch of ``lib`` (the built ``alock_tick.cu``, or a copy of
    it) in ``mode`` with plan ``p``; ``state`` the six input arrays. Returns
    the six outputs (``sched_out`` is filled in ``draw_only`` mode). Counts
    the launch; raises if it was refused."""
    global _LAST_PLAN
    tails, victim, pc, budget, nxt, prev = state
    Tab, T = pc.shape
    out = [torch.empty_like(a) for a in state]
    if Tab == 0:
        return out
    w = words or DrawWords(*(0,) * 10)
    wbuf = (ctypes.c_uint * 8)(*w[:8])
    with torch.cuda.device(pc.device):
        err = lib.alock_tick_launch(
            MODES[mode], sched.data_ptr() if sched is not None else None,
            *(t.data_ptr() for t in (cohorts, tails, victim, pc, budget, nxt,
                                     prev, *out)),
            sched_out.data_ptr() if sched_out is not None else None,
            Tab, T, steps, int(b_init[0]), int(b_init[1]),
            p.tables_per_block, p.chain_warps, p.draw_warps, p.stage_steps,
            p.stages, wbuf, w.r0, w.pitch, _build.stream_of(pc))
    _build.check_launch(lib, err, f"{what} ({mode}, Tab={Tab}, T={T}, "
                                  f"steps={steps}, plan {p.as_dict()})")
    LIB.count()
    _LAST_PLAN = {**p.as_dict(), "launch_mode": mode}
    return out


def tick_kernel(tails, victim, pc, budget, nxt, prev, sched, cohorts, *,
                b_init=(5, 20), tile: int = 128):
    """Launch K2 with the schedule given, on the current stream: the six
    final arrays as ``ref.alock_tick_plain``. All operands contiguous
    int32 CUDA tensors of the shapes ``alock_tick`` documents."""
    what = "alock_tick kernel"
    state = (tails, victim, pc, budget, nxt, prev)
    _build.check_operands(what, torch.int32, tails=tails, victim=victim,
                          pc=pc, budget=budget, nxt=nxt, prev=prev,
                          sched=sched, cohorts=cohorts)
    Tab, T = pc.shape
    p = tick_plan(T, tile, Tab, "given")
    return launch(LIB.load(), "given", p, state, cohorts, sched=sched,
                  steps=sched.shape[1], b_init=b_init, what=what)


def tick_drawn(tails, victim, pc, budget, nxt, prev, cohorts, *, seed: int,
               steps: int, b_init=(5, 20), tile: int = 128, r0: int = 0,
               pitch: int | None = None, words: DrawWords | None = None):
    """Launch K2 with the schedule drawn inside the kernel: the six final
    arrays of ``tick_kernel`` on ``randint(key(seed), (r0 + Tab, pitch), 0,
    T)[r0:, :steps]`` (``pitch`` defaults to ``steps``: the schedule
    ``ops.schedule(Tab, steps, T, seed)`` for ``r0 = 0``), which is never
    stored. ``words`` overrides the launch words (the negative control)."""
    what = "alock_tick kernel, drawn schedule"
    state = (tails, victim, pc, budget, nxt, prev)
    _build.check_operands(what, torch.int32, tails=tails, victim=victim,
                          pc=pc, budget=budget, nxt=nxt, prev=prev,
                          cohorts=cohorts)
    Tab, T = pc.shape
    p = tick_plan(T, tile, Tab, "drawn")
    w = words or draw_words(seed, T, r0, steps if pitch is None else pitch)
    return launch(LIB.load(), "drawn", p, state, cohorts, words=w, steps=steps,
                  b_init=b_init, what=what)


def draw_schedule(n_tables: int, steps: int, T: int, seed: int = 0,
                  r0: int = 0, pitch: int | None = None,
                  device="cuda") -> torch.Tensor:
    """The schedule K2 draws in ``tick_drawn``, written out by a draw-only
    launch: ``(n_tables, steps)`` int32, equal to ``randint(key(seed),
    (r0 + n_tables, pitch), 0, T, rows=(r0, r0 + n_tables))[:, :steps]``."""
    dev = torch.device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    out = torch.empty((n_tables, steps), **i32)
    state = (torch.zeros((n_tables, 2), **i32),
             torch.zeros((n_tables, 1), **i32),
             *(torch.zeros((n_tables, T), **i32) for _ in range(4)))
    cohorts = torch.zeros((n_tables, T), **i32)
    what = "alock_tick kernel, draw only"
    _build.check_operands(what, torch.int32, out=out, cohorts=cohorts)
    w = draw_words(seed, T, r0, steps if pitch is None else pitch)
    launch(LIB.load(), "draw_only", tick_plan(T, 128, n_tables, "drawn"),
           state, cohorts, sched_out=out, words=w, steps=steps, what=what)
    return out


def alock_tick(tails, victim, pc, budget, nxt, prev, sched, cohorts, *,
               b_init=(5, 20), tile: int = 128, backend: str = "auto"):
    """Apply (Tab, steps) schedules to Tab independent single-lock tables.

    tails (Tab,2), victim (Tab,1), pc/budget/nxt/prev (Tab,T),
    sched (Tab,steps), cohorts (Tab,T) — all int32. Returns the six final
    arrays in the same shapes. ``tile`` caps the tables per block of the
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
