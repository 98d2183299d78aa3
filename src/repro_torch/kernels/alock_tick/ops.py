"""Monte-Carlo runs over the batched lock-table kernel K2.

``monte_carlo_cs_entries`` draws a random thread schedule for each of
many independent single-lock ALock tables — the stream of
``jax.random.randint(jax.random.key(seed), (n_tables, steps), 0,
n_threads, int32)``, bit for bit (``core/prng.py``) — applies it with K2
and reports the share of threads in the critical section and the
histogram of final program counters: the fairness statistic behind the
Fig. 4 budget study. On a CUDA device K2 draws that schedule itself from
launch words derived on the host (``kernel.tick_drawn``): the
``(n_tables, steps)`` schedule is never stored. ``schedule`` is the same
stream in plain tensor code, what the CPU path and the checks use.

>>> r = monte_carlo_cs_entries(6, 4, 40, (0, 0, 1, 1), seed=3,
...                            device="cpu")
>>> sorted(r), int(r["final_pc_histogram"].sum())
(['final_pc_histogram', 'in_cs_frac'], 24)
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import machine as mc
from repro_torch.core import prng
from repro_torch.device import resolve_backend, resolve_device
from repro_torch.kernels.alock_tick import kernel as _kernel
from repro_torch.kernels.alock_tick.ref import alock_tick_ref

#: schedule elements drawn per slab: bounds the int64 temporaries of the
#: generator (about 2.5 GB at this size)
SCHED_CHUNK_ELEMS = 1 << 25

# "seconds" splits the wall time of monte_carlo_cs_entries() calls by
# stage; device stages are closed by a synchronize on a CUDA device. The
# "schedule" stage is the schedule stream on the plain path and, on the
# kernel path, the host's derivation of its launch words (the stream is
# drawn inside K2, in "engine"); both also make the fresh tables.
# "launches" is K2's own launch counter, "plan" its last launch's plan.
_SECONDS = {"schedule": 0.0, "engine": 0.0, "aggregate": 0.0}


def exec_stats() -> dict:
    """Snapshot of {launches, seconds, plan} since the last reset."""
    return {"launches": _kernel.LIB.launches(), "seconds": dict(_SECONDS),
            "plan": _kernel.last_plan()}


def reset_exec_stats() -> None:
    for k in _SECONDS:
        _SECONDS[k] = 0.0
    _kernel.LIB.reset_launches()


def _clock(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def fresh_tables(n_tables: int, n_threads: int, device="cuda"):
    """``(tails (n,2), victim (n,1), pc (n,T), budget (n,T), nxt (n,T),
    prev (n,T))`` int32: empty tails, every thread in NCS with budget
    -1."""
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)

    def z():
        return torch.zeros((n_tables, n_threads), **i32)
    return (torch.zeros((n_tables, 2), **i32),
            torch.zeros((n_tables, 1), **i32),
            torch.full((n_tables, n_threads), mc.NCS, **i32),
            torch.full((n_tables, n_threads), -1, **i32), z(), z())


def schedule(n_tables: int, steps: int, n_threads: int, seed: int = 0,
             device="cuda") -> torch.Tensor:
    """``(n_tables, steps)`` int32 thread indices in ``[0, n_threads)``:
    ``jax.random.randint(jax.random.key(seed), (n_tables, steps), 0,
    n_threads, int32)``, drawn in slabs of whole rows."""
    dev = resolve_device(device)
    k = prng.key(torch.tensor(seed, dtype=torch.int32, device=dev))
    out = torch.empty((n_tables, steps), dtype=torch.int32, device=dev)
    rows = max(1, SCHED_CHUNK_ELEMS // max(1, steps))
    for r0 in range(0, n_tables, rows):
        r1 = min(r0 + rows, n_tables)
        out[r0:r1] = prng.randint(k, (n_tables, steps), 0, n_threads,
                                  rows=(r0, r1))
    return out


def in_cs_fraction(pc_fin: torch.Tensor) -> float:
    """The share of threads in CS as the reference computes it: the f32
    mean of 0/1 values, whose sum is exact below 2**24 elements. XLA
    turns the mean's division by the constant element count ``n`` into a
    product with ``f32(1 / n)``, which can differ from the quotient in
    the last bit; so this takes that product too."""
    count = np.float32(int((pc_fin == mc.CS).sum()))
    return float(count * (np.float32(1) / np.float32(pc_fin.numel())))


def monte_carlo_cs_entries(n_tables: int, n_threads: int, steps: int,
                           cohorts, b_init=(5, 20), seed: int = 0,
                           backend: str = "auto", device="cuda"):
    """Run random schedules over many tables; count CS entries per cohort
    (the fairness statistic behind Fig. 4's budget study).

    ``cohorts`` has one entry per thread (0 local, 1 remote), shared by
    every table. ``backend='kernel'`` (the default on a CUDA device)
    launches K2 once, drawing the schedule inside the kernel
    (``kernel.tick_drawn``, ``tile=min(128, n_tables)``); ``'plain'`` draws
    ``schedule`` and runs ``ref.alock_tick_ref`` on ``device`` — the
    reference's ``use_kernel=False``. Returns ``{"in_cs_frac": float,
    "final_pc_histogram": (14,) int32 tensor}``.
    """
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    t0 = _clock(dev)
    if backend == "kernel":
        words = _kernel.draw_words(seed, n_threads, 0, steps)
    else:
        sched = schedule(n_tables, steps, n_threads, seed, dev)
    coh = torch.as_tensor(np.asarray(cohorts, np.int32), device=dev)
    tails, vic, pc, bud, nxt, prev = fresh_tables(n_tables, n_threads, dev)
    t1 = _clock(dev)
    if backend == "kernel":
        out = _kernel.tick_drawn(
            tails, vic, pc, bud, nxt, prev,
            coh.expand(n_tables, n_threads).contiguous(), seed=seed,
            steps=steps, b_init=tuple(b_init), tile=min(128, n_tables),
            words=words)
    else:
        out = alock_tick_ref(tails, vic[:, 0], pc, bud, nxt, prev, sched,
                             coh, np.asarray(b_init, np.int32))
    t2 = _clock(dev)
    pc_fin = out[2]
    hist = torch.bincount(pc_fin.reshape(-1), minlength=14)[:14]
    res = {"in_cs_frac": in_cs_fraction(pc_fin),
           "final_pc_histogram": hist.to(torch.int32)}
    t3 = _clock(dev)
    _SECONDS["schedule"] += t1 - t0
    _SECONDS["engine"] += t2 - t1
    _SECONDS["aggregate"] += t3 - t2
    return res
