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

Workloads are declarative ``repro_torch.workloads.Workload`` specs lowered
to ``WorkloadOperands``; a legacy flat ``SimConfig`` rides the
``from_simconfig`` adapter. This slice runs the closed loop only:
open-loop specs (``Workload.arrivals``) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.cost_model import CostModel
from repro_torch.device import resolve_backend, resolve_device
from repro_torch.kernels.event_loop.ops import OPEN_LOOP_MSG, run_events
from repro_torch.kernels.event_loop.ref import LAT_SAMPLES
from repro_torch.workloads import (Workload, WorkloadOperands, as_workload,
                                   lower, zipf_cdf)

__all__ = [
    "SimConfig", "SimResult", "simulate", "topology", "zipf_cdf",
    "resolve_backend", "resolve_device", "Workload", "WorkloadOperands",
    "LAT_SAMPLES",
]


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
    arr_ns: np.ndarray | None = None
    wait_ns: np.ndarray | None = None
    sojourn_ns: np.ndarray | None = None
    rstat: np.ndarray | None = None


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
    if w.arrivals is not None:
        raise NotImplementedError(OPEN_LOOP_MSG)
    lw = lower(w, n_events, cm)
    T, N, K = lw.n_threads, w.n_nodes, w.n_locks
    thread_node, lock_node, _ = topology(w.alg, N, w.threads_per_node, K, cm)
    batched = WorkloadOperands(*(np.asarray(a)[None] for a in lw.operands))
    out = run_events(w.alg, T, N, K, n_events, batched, thread_node,
                     lock_node, backend=backend, device=dev)
    done, lat, _lat_n, t_end, nreacq, npass = (
        o[0].cpu().numpy() for o in out)
    ops = int(done.sum())
    sim_ns = max(int(t_end), 1)
    return SimResult(ops, sim_ns, ops / sim_ns * 1e3, lat, done,
                     int(nreacq), int(npass))
