"""Explicit-state model checking of the lock machines.

Reproduces the paper's TLA+ verification (Appendix A) in-process:
  - MutualExclusion : no reachable state has two threads in CS
  - DeadlockFree    : every reachable non-quiescent state can progress
  - EventualEntry   : from every reachable state, every thread can still
                      reach its critical section (EF cs_t — livelock
                      freedom under a fair scheduler)

The machine's atomic actions are exactly the spec's labeled steps, so the
state space here corresponds to the PlusCal translation's. Pure Python
over ``core/machine.py``: it needs no device.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from repro_torch.core import machine as mc


@dataclass
class CheckResult:
    states: int
    mutex_ok: bool
    deadlock_free: bool
    eventual_entry: bool
    violations: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.mutex_ok and self.deadlock_free and self.eventual_entry


def explore(machine: str, cohorts: tuple[int, ...],
            b_init: tuple[int, int] = (2, 2),
            max_states: int = 2_000_000) -> CheckResult:
    """BFS over all interleavings of `machine` with the given cohort
    assignment (one entry per thread: mc.LOCAL / mc.REMOTE)."""
    step = mc.MACHINES[machine]
    n = len(cohorts)
    init = mc.initial_state(n)
    seen: dict[mc.LockState, int] = {init: 0}
    order: list[mc.LockState] = [init]
    succs: list[list[int]] = []
    frontier = deque([init])
    mutex_ok = True
    violations = []

    while frontier:
        st = frontier.popleft()
        row = []
        ncs_count = sum(1 for t in range(n) if st.pc[t] == mc.NCS)
        cs_count = sum(1 for t in range(n) if st.pc[t] == mc.CS)
        if cs_count > 1:
            mutex_ok = False
            violations.append(("mutex", st))
        for t in range(n):
            nst, _ = step(st, t, cohorts[t], b_init)
            if nst not in seen:
                if len(seen) >= max_states:
                    raise RuntimeError(
                        f"state space exceeds {max_states}; shrink config")
                seen[nst] = len(order)
                order.append(nst)
                frontier.append(nst)
            row.append(seen[nst])
        succs.append(row)

    # deadlock: non-quiescent state whose every successor is itself
    deadlock_free = True
    for i, st in enumerate(order):
        if all(j == i for j in succs[i]):
            if any(st.pc[t] != mc.NCS for t in range(len(cohorts))):
                deadlock_free = False
                violations.append(("deadlock", st))

    # EF cs_t for every thread from every state: reverse reachability
    eventual = True
    nstates = len(order)
    radj: list[list[int]] = [[] for _ in range(nstates)]
    for i, row in enumerate(succs):
        for j in row:
            if j != i:
                radj[j].append(i)
    for t in range(len(cohorts)):
        good = [st.pc[t] == mc.CS for st in order]
        dq = deque(i for i, g in enumerate(good) if g)
        while dq:
            i = dq.popleft()
            for p in radj[i]:
                if not good[p]:
                    good[p] = True
                    dq.append(p)
        if not all(good):
            eventual = False
            bad = next(i for i, g in enumerate(good) if not g)
            violations.append(("eventual_entry", t, order[bad]))
    return CheckResult(len(order), mutex_ok, deadlock_free, eventual,
                       violations)


def bounded_overtaking(machine: str, cohorts: tuple[int, ...],
                       b_init: tuple[int, int], schedule,
                       steps: int = 20_000) -> int:
    """Run a schedule (iterable of tids); return the max number of CS
    entries that occur while some thread is continuously waiting. For the
    ALock this must be bounded by the budgets (fairness); the RDMA spinlock
    is unbounded (starvation-prone)."""
    step = mc.MACHINES[machine]
    st = mc.initial_state(len(cohorts))
    waiting_since: dict[int, int] = {}
    cs_entries = 0
    worst = 0
    for k, tid in zip(range(steps), schedule):
        was_cs = st.pc[tid] == mc.CS
        st, op = step(st, tid, cohorts[tid], b_init)
        if st.pc[tid] == mc.CS and not was_cs:
            cs_entries += 1
            waiting_since.pop(tid, None)
            for t0, since in waiting_since.items():
                worst = max(worst, cs_entries - since)
        if mc.wants_lock(st, tid) and tid not in waiting_since:
            waiting_since[tid] = cs_entries
    return worst
