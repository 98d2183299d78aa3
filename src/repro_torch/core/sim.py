"""Discrete-event simulator for the distributed lock table — front door.

The lock machines of ``core/machine.py`` are driven by a next-event loop
(argmin over per-thread ready times), one event at a time, so every
shared-state mutation is serialised through a single event queue and
executions are linearizable by construction. Time is int64 nanoseconds;
the machine state is int32.

Two backends share the semantics (``kernels/event_loop``):

  * ``backend="kernel"`` — the hand-written CUDA kernel: one warp per
    replica, the replica's whole state in shared memory for the run.
    Needs a CUDA device.
  * ``backend="plain"`` — the same loop as plain PyTorch tensor code, on
    whatever device was asked for. It is the kernel's yardstick for
    correctness, not a fast path.

``backend="auto"`` is the kernel on a CUDA device and the plain version on
an explicitly requested CPU. Every entry point takes ``device=`` and
defaults to ``"cuda"``; without a CUDA device that raises.

The semantic machine itself — ``Sem``, ``init_sem`` and ``sem_step``, the
plain engine's transition — is driven by an explicit thread schedule in
``run_schedule``, which the property tests hold against the Python
machines of ``core/machine.py``.

Workloads are declarative ``repro_torch.workloads.Workload`` specs lowered
to ``WorkloadOperands``; a legacy flat ``SimConfig`` rides the
``from_simconfig`` adapter. Open-loop specs (``Workload.arrivals``) also
return the per-request arrays ``arr_ns / wait_ns / sojourn_ns / rstat``
(``repro_torch.traffic``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.cost_model import CostModel
from repro_torch.device import resolve_backend, resolve_device
from repro_torch.kernels.event_loop.ops import run_events
from repro_torch.kernels.event_loop.ref import (LAT_SAMPLES, Sem, init_sem,
                                               sem_step)
from repro_torch.workloads import (Workload, WorkloadOperands, as_workload,
                                   lower, zipf_cdf)

__all__ = [
    "SimConfig", "SimResult", "Sem", "simulate", "topology", "zipf_cdf",
    "resolve_backend", "resolve_device", "init_sem", "sem_step",
    "run_schedule", "Workload", "WorkloadOperands", "LAT_SAMPLES",
]


def run_schedule(alg, cohorts, b_init, schedule, n_locks: int = 1,
                 device="cuda"):
    """Drive the tensor machine with an explicit thread schedule (single
    lock, semantics only). Returns ``(sem, trace)``: the final ``Sem`` and
    the per-step ``(pc (S,T), tail[0] (S,2), victim[0] (S,), budget
    (S,T))`` after each step, all int32 on ``device``."""
    dev = resolve_device(device)
    T = len(cohorts)
    sem = init_sem(T, n_locks, targets=[0] * T, cohorts=cohorts, device=dev)
    sem = Sem(*(a[None] for a in sem))
    i32 = dict(dtype=torch.int32, device=dev)
    tn = torch.tensor([0 if c == 0 else 1 for c in cohorts],  # any split
                      **i32)
    ln = torch.zeros(n_locks, **i32)
    b_init = torch.as_tensor(np.asarray(b_init, np.int32), device=dev)
    sched = torch.as_tensor(np.asarray(schedule, np.int64).reshape(-1),
                            device=dev)
    S = sched.shape[0]
    trace = tuple(torch.empty(shape, **i32)
                  for shape in ((S, T), (S, 2), (S,), (S, T)))
    for i in range(S):
        sem, _, _ = sem_step(alg, sem, sched[i:i + 1], b_init, tn, ln)
        for acc, a in zip(trace, (sem.pc, sem.tail[:, 0], sem.victim[:, 0],
                                  sem.budget)):
            acc[i] = a[0]
    return Sem(*(a[0] for a in sem)), trace


class SimConfig(NamedTuple):
    """Legacy flat per-run config.

    .. deprecated::
        Kept as a compatibility front door only — it can express neither
        per-thread locality nor phases. New code should build
        ``repro_torch.workloads.Workload`` specs; ``simulate`` /
        ``batch.sweep`` route SimConfig through the bitwise-faithful
        ``repro_torch.workloads.from_simconfig`` adapter.
    """
    alg: str
    n_nodes: int
    threads_per_node: int
    n_locks: int
    locality: float           # P(target lock is on own node)
    b_init: tuple = (5, 20)   # (local, remote) budgets
    seed: int = 0
    zipf_s: float = 0.0       # Zipf skew of the per-node lock choice


class SimResult(NamedTuple):
    ops: int
    sim_ns: int
    throughput_mops: float    # million lock+unlock ops per second
    lat_ns: np.ndarray        # latency samples (ns), -1 padded
    per_thread_ops: np.ndarray
    reacquires: int = 0       # budget-exhaustion pReacquire events
    passes: int = 0           # MCS lock passes
    # open-loop (Workload.arrivals) extras — None on closed-loop runs
    arr_ns: np.ndarray | None = None      # (R,) request arrival times
    wait_ns: np.ndarray | None = None     # (R,) queue wait, -1 = never served
    sojourn_ns: np.ndarray | None = None  # (R,) total, -1 = never completed
    rstat: np.ndarray | None = None       # (R,) traffic status codes


def topology(alg: str, n_nodes: int, threads_per_node: int, n_locks: int,
             cm: CostModel = CostModel()):
    """Static per-shape operands: (thread_node, lock_node, cost scalars).

    thread_node/lock_node (int32 numpy vectors) are fully determined by
    (alg, N, tpn, K) and stay unbatched broadcast operands of the engine.
    The cost scalars are ``cm.cost_rows(...)`` — the *default* rows; the
    engine consumes the per-phase ``WorkloadOperands.cost_rows`` the
    lowering emits (equal to this tuple for every default-cost phase).
    """
    T, N, K = n_nodes * threads_per_node, n_nodes, n_locks
    if N < 1 or K < 1:
        raise ValueError(f"need n_nodes >= 1 and n_locks >= 1, got "
                         f"(n_locks={K}, n_nodes={N})")
    if K % N != 0:
        raise ValueError(
            f"locks must partition evenly across nodes: n_locks={K} is not "
            f"a multiple of n_nodes={N} (got (n_locks, n_nodes)=({K}, {N}))")
    thread_node = np.arange(T, dtype=np.int32) // np.int32(threads_per_node)
    lock_node = np.arange(K, dtype=np.int32) // np.int32(K // N)
    return thread_node, lock_node, cm.cost_rows(alg, N, threads_per_node)


def simulate(cfg: SimConfig | Workload, n_events: int = 400_000,
             cm: CostModel = CostModel(), backend: str = "auto",
             device="cuda") -> SimResult:
    """Run one workload (a ``Workload`` spec, or a legacy ``SimConfig``
    through the adapter) for ``n_events`` events on the chosen backend and
    device. Results come back as numpy arrays and Python numbers."""
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    w = as_workload(cfg)
    lw = lower(w, n_events, cm)
    T, N, K = lw.n_threads, w.n_nodes, w.n_locks
    thread_node, lock_node, _ = topology(w.alg, N, w.threads_per_node, K, cm)
    batched = WorkloadOperands(*(np.asarray(a)[None] for a in lw.operands))
    out = run_events(w.alg, T, N, K, n_events, batched, thread_node,
                     lock_node, backend=backend, device=dev)
    out = [o[0].cpu().numpy() for o in out]
    done, lat, _lat_n, t_end, nreacq, npass = out[:6]
    extras = {}
    if len(out) > 6:        # open-loop run: per-request serving arrays
        extras = dict(arr_ns=out[6], wait_ns=out[7], sojourn_ns=out[8],
                      rstat=out[9])
    ops = int(done.sum())
    sim_ns = max(int(t_end), 1)
    return SimResult(ops, sim_ns, ops / sim_ns * 1e3, lat, done,
                     int(nreacq), int(npass), **extras)
