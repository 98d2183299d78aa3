"""Canonical ALock / RDMA-spinlock / RDMA-MCS state machines.

Pure step functions over immutable tuples, mirroring the paper's TLA+ spec
(Appendix A) program counters. One source of truth consumed by
  - core/tla.py          exhaustive model checking (mutex, deadlock, ...)
  - tests (hypothesis)   adversarial schedule exploration
  - core/sim.py          the batched torch event simulator (same PCs;
                         transition for transition the same machine)

Machine model
-------------
A single ALock guards one resource; threads are permanently assigned a
cohort for a given request: LOCAL(0) threads use shared-memory ops, REMOTE(1)
threads use RDMA ops. The two MCS tails double as Peterson flags (tail != 0
<=> cohort interested/holding) and `victim` arbitrates between cohort
leaders. Budgets bound consecutive intra-cohort lock passes (Dice et al.
style); a thread passed budget 0 must re-run Peterson (pReacquire) before
entering, restoring inter-cohort fairness.

Each step is one atomic shared-memory/RDMA access (the swap is modeled as an
atomic fetch-and-swap — the paper emulates it with an rCAS retry loop, which
is linearizable to the same thing; the retry cost is charged in the cost
model, not in the semantics).
"""
from __future__ import annotations

from typing import NamedTuple

LOCAL, REMOTE = 0, 1

# --- program counters (shared by all machines; not all used by all) -------
NCS = 0          # non-critical section; next step begins a request
SWAP = 1         # MCS: swap own descriptor into cohort tail
WRITE_NEXT = 2   # MCS: link into predecessor's next pointer
SPIN_BUDGET = 3  # MCS: local-spin until budget passed (>= 0)
SET_VICTIM = 4   # Peterson: victim := my cohort  (first acquisition)
PET_WAIT = 5     # Peterson: wait (victim != me) or (other tail == 0)
SET_VICTIM_R = 6  # Peterson re-acquire path (budget exhausted)
PET_WAIT_R = 7
CS = 8           # critical section
REL_CAS = 9      # release: CAS tail from self back to 0
SPIN_NEXT = 10   # release: wait for successor to link itself
PASS = 11        # release: write successor budget (budget - 1)
# spinlock-only
SL_CAS = 12      # spin: CAS word 0 -> tid
SL_REL = 13      # write word back to 0
# reader-writer ALock only (alock-rw)
RD_TRY = 14      # reader: enter + word++ iff both tails empty
RD_CS = 15       # reader critical section (shared)
RD_REL = 16      # reader release: word--
WR_DRAIN = 17    # writer: wait for reader count (word) to drain to 0

PC_NAMES = {v: k for k, v in list(globals().items()) if isinstance(v, int)}


class LockState(NamedTuple):
    """One lock + all thread descriptors (tids are 0-based; slots store
    tid+1 with 0 = null)."""
    tail: tuple            # (tail_local, tail_remote) — Peterson flags
    victim: int            # cohort id 0/1
    budget: tuple          # per-thread descriptor budget (-1 = waiting)
    next: tuple            # per-thread descriptor next pointer (tid+1)
    pc: tuple              # per-thread program counter
    prev: tuple            # per-thread remembered predecessor (tid+1)
    word: int = 0          # spinlock/MCS lock word (tid+1); rw reader count


class Op(NamedTuple):
    """What a step did — consumed by cost models and fairness accounting."""
    label: str             # e.g. "swap", "pet_check", "spin", ...
    kind: str              # "local" | "remote" | "none"
    progressed: bool       # False for an unsuccessful spin re-check


def initial_state(n_threads: int, victim: int = 0) -> LockState:
    z = (0,) * n_threads
    return LockState(tail=(0, 0), victim=victim, budget=(-1,) * n_threads,
                     next=z, pc=(NCS,) * n_threads, prev=z, word=0)


def _set(t: tuple, i: int, v) -> tuple:
    return t[:i] + (v,) + t[i + 1:]


def _opk(cohort: int) -> str:
    return "local" if cohort == LOCAL else "remote"


# ---------------------------------------------------------------------------
# ALock


def alock_step(st: LockState, tid: int, cohort: int,
               b_init: tuple[int, int]) -> tuple[LockState, Op]:
    """Advance thread `tid` (in `cohort`) by one atomic action.

    b_init = (local_budget, remote_budget): kInitBudget per cohort.
    """
    c = cohort
    pc = st.pc[tid]
    B = b_init[c]
    me = tid + 1

    if pc == NCS:
        # c1: fresh descriptor
        st = st._replace(budget=_set(st.budget, tid, -1),
                         next=_set(st.next, tid, 0),
                         pc=_set(st.pc, tid, SWAP))
        return st, Op("desc_init", "local", True)

    if pc == SWAP:
        prev = st.tail[c]
        st = st._replace(tail=_set(st.tail, c, me),
                         prev=_set(st.prev, tid, prev))
        if prev == 0:
            # queue was empty: budget reset, must run Peterson (not passed)
            st = st._replace(budget=_set(st.budget, tid, B),
                             pc=_set(st.pc, tid, SET_VICTIM))
        else:
            st = st._replace(pc=_set(st.pc, tid, WRITE_NEXT))
        return st, Op("swap", _opk(c), True)

    if pc == WRITE_NEXT:
        p = st.prev[tid] - 1
        st = st._replace(next=_set(st.next, p, me),
                         pc=_set(st.pc, tid, SPIN_BUDGET))
        return st, Op("write_next", _opk(c), True)

    if pc == SPIN_BUDGET:
        b = st.budget[tid]
        if b == -1:
            return st, Op("spin_budget", "none", False)  # local spin
        if b == 0:
            st = st._replace(pc=_set(st.pc, tid, SET_VICTIM_R))
            return st, Op("budget_zero", "local", True)
        st = st._replace(pc=_set(st.pc, tid, CS))
        return st, Op("passed", "local", True)

    if pc in (SET_VICTIM, SET_VICTIM_R):
        nxt = PET_WAIT if pc == SET_VICTIM else PET_WAIT_R
        st = st._replace(victim=c, pc=_set(st.pc, tid, nxt))
        return st, Op("set_victim", _opk(c), True)

    if pc in (PET_WAIT, PET_WAIT_R):
        # one 64B read observes (tail_l, tail_r, victim) together (Fig. 3)
        if st.tail[1 - c] == 0 or st.victim != c:
            if pc == PET_WAIT_R:
                st = st._replace(budget=_set(st.budget, tid, B))
            st = st._replace(pc=_set(st.pc, tid, CS))
            return st, Op("pet_acquired", _opk(c), True)
        return st, Op("pet_check", _opk(c), False)

    if pc == CS:
        st = st._replace(pc=_set(st.pc, tid, REL_CAS))
        return st, Op("cs", "none", True)

    if pc == REL_CAS:
        if st.tail[c] == me:
            st = st._replace(tail=_set(st.tail, c, 0),
                             pc=_set(st.pc, tid, NCS))
            return st, Op("rel_cas_ok", _opk(c), True)
        st = st._replace(pc=_set(st.pc, tid, SPIN_NEXT))
        return st, Op("rel_cas_fail", _opk(c), True)

    if pc == SPIN_NEXT:
        if st.next[tid] == 0:
            return st, Op("spin_next", "none", False)
        st = st._replace(pc=_set(st.pc, tid, PASS))
        return st, Op("succ_seen", "local", True)

    if pc == PASS:
        succ = st.next[tid] - 1
        st = st._replace(budget=_set(st.budget, succ, st.budget[tid] - 1),
                         pc=_set(st.pc, tid, NCS))
        return st, Op("pass", _opk(c), True)

    raise AssertionError(f"bad pc {pc}")


# ---------------------------------------------------------------------------
# RDMA spinlock (competitor): every op through the RNIC, incl. loopback


def spinlock_step(st: LockState, tid: int, cohort: int,
                  _b=None) -> tuple[LockState, Op]:
    pc = st.pc[tid]
    me = tid + 1
    if pc == NCS:
        st = st._replace(pc=_set(st.pc, tid, SL_CAS))
        return st, Op("desc_init", "local", True)
    if pc == SL_CAS:
        if st.word == 0:
            st = st._replace(word=me, pc=_set(st.pc, tid, CS))
            return st, Op("cas_ok", "remote", True)
        return st, Op("cas_fail", "remote", False)   # remote spinning!
    if pc == CS:
        st = st._replace(pc=_set(st.pc, tid, SL_REL))
        return st, Op("cs", "none", True)
    if pc == SL_REL:
        st = st._replace(word=0, pc=_set(st.pc, tid, NCS))
        return st, Op("rel_write", "remote", True)
    raise AssertionError(f"bad pc {pc}")


# ---------------------------------------------------------------------------
# RDMA MCS (competitor): single queue, lock-word ops via RNIC (loopback for
# local threads), budget-free; spins locally on own descriptor.


def mcs_step(st: LockState, tid: int, cohort: int,
             _b=None) -> tuple[LockState, Op]:
    pc = st.pc[tid]
    me = tid + 1
    if pc == NCS:
        st = st._replace(budget=_set(st.budget, tid, -1),
                         next=_set(st.next, tid, 0),
                         pc=_set(st.pc, tid, SWAP))
        return st, Op("desc_init", "local", True)
    if pc == SWAP:
        prev = st.word
        st = st._replace(word=me, prev=_set(st.prev, tid, prev))
        if prev == 0:
            st = st._replace(pc=_set(st.pc, tid, CS))
        else:
            st = st._replace(pc=_set(st.pc, tid, WRITE_NEXT))
        return st, Op("swap", "remote", True)
    if pc == WRITE_NEXT:
        p = st.prev[tid] - 1
        st = st._replace(next=_set(st.next, p, me),
                         pc=_set(st.pc, tid, SPIN_BUDGET))
        return st, Op("write_next", "remote", True)
    if pc == SPIN_BUDGET:
        if st.budget[tid] == -1:
            return st, Op("spin_budget", "none", False)  # local spin
        st = st._replace(pc=_set(st.pc, tid, CS))
        return st, Op("passed", "local", True)
    if pc == CS:
        st = st._replace(pc=_set(st.pc, tid, REL_CAS))
        return st, Op("cs", "none", True)
    if pc == REL_CAS:
        if st.word == me:
            st = st._replace(word=0, pc=_set(st.pc, tid, NCS))
            return st, Op("rel_cas_ok", "remote", True)
        st = st._replace(pc=_set(st.pc, tid, SPIN_NEXT))
        return st, Op("rel_cas_fail", "remote", True)
    if pc == SPIN_NEXT:
        if st.next[tid] == 0:
            return st, Op("spin_next", "none", False)
        st = st._replace(pc=_set(st.pc, tid, PASS))
        return st, Op("succ_seen", "local", True)
    if pc == PASS:
        succ = st.next[tid] - 1
        st = st._replace(budget=_set(st.budget, succ, 1),
                         pc=_set(st.pc, tid, NCS))
        return st, Op("pass", "remote", True)
    raise AssertionError(f"bad pc {pc}")


# ---------------------------------------------------------------------------
# Hierarchical topology-aware lock (hlock): the ALock protocol verbatim —
# the generalization lives entirely in how the *caller* derives `cohort`
# (rack-of-thread vs rack-of-lock instead of node-of-thread vs
# node-of-lock) and in the cost tiers charged per op (same node / same
# rack / cross rack). Keeping the PC-level protocol identical to
# `alock_step` is what makes the trivial topology (every node its own
# rack) bitwise-equal to the flat ALock — the regression anchor the
# simulator tests pin.


def hlock_step(st: LockState, tid: int, cohort: int,
               b_init: tuple[int, int]) -> tuple[LockState, Op]:
    return alock_step(st, tid, cohort, b_init)


# ---------------------------------------------------------------------------
# Reader-writer ALock (alock-rw): writers run the full ALock protocol but
# drain the shared reader count (kept in `word`, unused by the plain
# ALock) before entering the CS; readers bypass the MCS/Peterson machinery
# entirely — they increment `word` iff both cohort tails are empty
# (writer preference: any queued writer blocks new readers) and share the
# CS among themselves. A reader holds from the successful RD_TRY until
# its RD_REL decrement executes.


def alock_rw_step(st: LockState, tid: int, cohort: int,
                  b_init: tuple[int, int],
                  is_read: bool = False) -> tuple[LockState, Op]:
    pc = st.pc[tid]

    if pc == NCS and is_read:
        # descriptor reset mirrors the writer arm (and the tensor engine's
        # unconditional NCS re-arm) even though readers never queue
        st = st._replace(budget=_set(st.budget, tid, -1),
                         next=_set(st.next, tid, 0),
                         pc=_set(st.pc, tid, RD_TRY))
        return st, Op("desc_init", "local", True)

    if pc == RD_TRY:
        if st.tail[0] == 0 and st.tail[1] == 0:
            st = st._replace(word=st.word + 1,
                             pc=_set(st.pc, tid, RD_CS))
            return st, Op("rd_enter", _opk(cohort), True)
        return st, Op("rd_blocked", _opk(cohort), False)

    if pc == RD_CS:
        st = st._replace(pc=_set(st.pc, tid, RD_REL))
        return st, Op("rd_cs", "none", True)

    if pc == RD_REL:
        st = st._replace(word=st.word - 1, pc=_set(st.pc, tid, NCS))
        return st, Op("rd_rel", _opk(cohort), True)

    if pc == WR_DRAIN:
        if st.word == 0:
            st = st._replace(pc=_set(st.pc, tid, CS))
            return st, Op("wr_drained", _opk(cohort), True)
        return st, Op("wr_drain", _opk(cohort), False)

    # writer path: the plain ALock, with every CS entry rerouted through
    # the reader drain
    nst, op = alock_step(st, tid, cohort, b_init)
    if nst.pc[tid] == CS and pc != WR_DRAIN:
        nst = nst._replace(pc=_set(nst.pc, tid, WR_DRAIN))
    return nst, op


MACHINES = {"alock": alock_step, "spinlock": spinlock_step, "mcs": mcs_step,
            "hlock": hlock_step, "alock-rw": alock_rw_step}


def in_cs(st: LockState, tid: int) -> bool:
    return st.pc[tid] == CS


def in_read_cs(st: LockState, tid: int) -> bool:
    """Reader holds the shared CS from rd_enter until its RD_REL
    decrement has executed (pc back at NCS)."""
    return st.pc[tid] in (RD_CS, RD_REL)


def wants_lock(st: LockState, tid: int) -> bool:
    return st.pc[tid] not in (NCS, CS, REL_CAS, SPIN_NEXT, PASS, SL_REL,
                              RD_CS, RD_REL)
