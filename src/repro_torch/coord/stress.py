"""Coordination-plane stress scenarios driven by declarative Workload specs.

The simulator and the *real* (threaded) coordination plane share one
scenario language: a ``repro_torch.workloads.Workload`` — per-thread
locality, Zipf-skewed lock choice, and phases (hot-key storms, node churn via
``down_nodes``) — here drives ``CoordService``'s lock table, lease manager
and membership instead of the event-loop engines.

Phases map onto the per-thread *operation* axis (op ``o`` of
``ops_per_thread`` lands in the phase covering fraction ``o / ops``).
At each phase boundary the runner advances an injected manual clock past
the lease TTL, so every phase opens with a lease-expiry storm: up nodes
race to (re)acquire per-node leases, and leases of downed nodes are stolen
— deterministically, because the clock never depends on wall time. Lock
traffic itself runs on real threads (actual concurrency), while the draw
streams are per-thread seeded, so op *counts and targets* are reproducible
even though interleavings are not.

Pure Python threads and numpy: no tensor and no device work. The spec is
lowered by the port's own ``repro_torch.workloads.lower``, so the draws
(``w.seed * 100_003 + tid`` per thread, the lease rng per phase, node and
victim) and with them every count above are the reference package's.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from repro_torch.coord.service import CoordService, LeaseManager, Membership
from repro_torch.workloads import Workload, lower


class ManualClock:
    """Injectable deterministic clock for LeaseManager/Membership."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


@dataclass
class StressReport:
    ops: int = 0
    local_ops: int = 0
    remote_ops: int = 0
    reacquires: int = 0
    lease_grants: int = 0
    lease_steals: int = 0          # grants that fenced off a prior epoch
    lease_retries: int = 0         # backoff sleeps the retry loop took
    phase_members: list = field(default_factory=list)  # alive() per phase
    per_node_ops: list = field(default_factory=list)


def run_coord_stress(w: Workload, ops_per_thread: int = 200,
                     lease_ttl: float = 5.0,
                     clock: ManualClock | None = None) -> StressReport:
    """Drive the threaded coordination plane through ``w``'s phase program.

    Returns a :class:`StressReport`; with the default :class:`ManualClock`
    the lease/membership half is fully deterministic and the lock-traffic
    half is deterministic in counts (per-thread seeded draw streams).
    """
    clock = clock or ManualClock()
    N, tpn, K = w.n_nodes, w.threads_per_node, w.n_locks
    kpn = K // N
    T = N * tpn
    # reuse the simulator's lowering so both planes interpret the spec
    # identically (locality rows, CDFs, phase edges over a 1k-op axis)
    lw = lower(w, n_events=1000)
    o = lw.operands
    P = o.n_phases
    svc = CoordService(N, locks_per_node=kpn,
                       local_budget=w.b_init[0], remote_budget=w.b_init[1])
    leases = LeaseManager(svc, ttl_s=lease_ttl, clock=clock)
    members = Membership(svc, heartbeat_ttl=lease_ttl, clock=clock)
    rep = StressReport(per_node_ops=[0] * N)
    ops_lock = threading.Lock()
    epochs: dict[str, int] = {}

    # phase per op index, hoisted out of the threaded hot loop
    frac_edge = o.edges.astype(np.float64) / 1000.0
    op_phase = (np.searchsorted(
        frac_edge, np.arange(ops_per_thread) / ops_per_thread,
        side="right") - 1).tolist()

    def node_up(p: int, node: int) -> bool:
        return bool(o.active[p, node * tpn])

    # two barriers per phase: the main thread opens the phase (clock
    # already advanced past the TTL), then runs the lease/membership storm
    # CONCURRENTLY with that phase's lock traffic — the coord plane is
    # stressed under live table contention, not in isolation
    enter = threading.Barrier(T + 1)
    leave = threading.Barrier(T + 1)

    def worker(tid: int):
        node = tid // tpn
        rng = np.random.default_rng(w.seed * 100_003 + tid)
        for p in range(P):
            enter.wait()
            for op in range(ops_per_thread):
                if op_phase[op] != p:
                    continue
                if not node_up(p, node):
                    continue               # node is down this phase
                if rng.random() < float(o.locality[p, tid]):
                    tgt = node
                else:
                    tgt = int((node + 1 + rng.integers(0, max(N - 1, 1)))
                              % N)
                off = int(np.searchsorted(o.zcdf[p], rng.random(),
                                          side="right"))
                lk = tgt * kpn + min(off, kpn - 1)
                with svc.table.critical(node, lk):
                    pass
                with ops_lock:
                    rep.per_node_ops[node] += 1
            leave.wait()

    ths = [threading.Thread(target=worker, args=(t,)) for t in range(T)]
    [t.start() for t in ths]
    for p in range(P):
        # lease-expiry storm at the phase boundary: everything outstanding
        # times out at once, up nodes re-acquire, dead nodes get stolen
        clock.advance(lease_ttl + 1.0)
        enter.wait()
        up = [n for n in range(N) if node_up(p, n)]
        for n in range(N):
            (members.join if n in up else members.leave)(n)
        for n in up:
            for victim in range(N):
                # bounded retry with deterministic jitter: the seeded rng
                # fixes the backoff schedule, the injected sleep advances
                # the manual clock (and counts the retries) — contended
                # names still resolve to one holder per storm
                def _sleep(d):
                    rep.lease_retries += 1
                    clock.advance(d)
                lease = leases.acquire(
                    n, f"shard:{victim}", attempts=2,
                    backoff_base_s=0.05, deadline_s=0.5,
                    rng=np.random.default_rng(
                        w.seed * 611_953 + p * 1009 + n * 31 + victim),
                    sleep=_sleep)
                if lease is None:
                    continue
                rep.lease_grants += 1
                prev = epochs.get(lease.name)
                if prev is not None and lease.epoch == prev + 1:
                    rep.lease_steals += 1
                epochs[lease.name] = lease.epoch
        rep.phase_members.append(members.alive())
        leave.wait()
    [t.join() for t in ths]
    st = svc.table.stats
    rep.ops = st.ops
    rep.local_ops = st.local_ops
    rep.remote_ops = st.remote_ops
    rep.reacquires = st.reacquires
    return rep
