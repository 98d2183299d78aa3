"""Plain PyTorch versions of the batched ALock table transition (K2).

``alock_transition`` is one ALock step of a batch of independent
single-lock tables, each at its own scheduled thread, written as masks
over the program-counter classes and one-hot selects over the thread
axis, as the reference's kernel and oracle write it: a scheduled thread
outside ``[0, T)`` selects nothing and leaves its table as it was, and a
``-1`` predecessor or successor (no such thread) writes nothing. A cohort
of 0 is local and any other value remote. Semantics are those of
``core/machine.py::alock_step``; everything is int32.

``alock_tick_plain`` has the contract of the kernel's wrapper
(``victim (Tab,1)``, per-table ``cohorts (Tab,T)``, a static ``b_init``
pair and ``tile``): it is what ``chip_smoke.py`` holds K2 against on the
card. ``alock_tick_ref`` has the contract of the reference's oracle
(``victim (Tab,)``, ``cohorts (T,)`` shared by every table, ``b_init
(2,)``) and is a thin adapter over the same code. Both loop over the
schedule in Python, so they are slow by construction; nothing on the main
path calls them when a CUDA device is present. ``drawn_schedule_plain``
is the plain mirror of the schedule the kernel draws itself from its
launch words.
"""
from __future__ import annotations

import torch

from repro_torch.core import machine as mc
from repro_torch.core import prng


def alock_transition(tails, victim, pc, budget, nxt, prev, tid, cohorts,
                     b_local, b_remote):
    """One ALock step of every table. ``tails (Tab,2)``, ``victim
    (Tab,)``, ``pc/budget/nxt/prev (Tab,T)``, ``tid (Tab,)`` the thread
    each table steps, ``cohorts (Tab,T)``; the budgets are ints. Returns
    the new ``(tails, victim, pc, budget, nxt, prev)``."""
    T = pc.shape[1]
    tids = torch.arange(T, device=pc.device)[None]
    oh = tids == tid[:, None]                             # (Tab, T)

    def sel(a):
        """``a[t, tid[t]]`` per table, 0 where ``tid`` is out of range."""
        return torch.where(oh, a, 0).sum(1, dtype=torch.int32)

    c = sel(cohorts)
    me = (tid + 1).to(torch.int32)
    p = sel(pc)
    local = c == 0
    B = torch.where(local, b_local, b_remote).to(torch.int32)
    tail_c = torch.where(local, tails[:, 0], tails[:, 1])
    tail_o = torch.where(local, tails[:, 1], tails[:, 0])

    def col(m):
        return m[:, None]

    # NCS: reset the descriptor
    is_ncs = p == mc.NCS
    budget = torch.where(col(is_ncs) & oh, -1, budget)
    nxt = torch.where(col(is_ncs) & oh, 0, nxt)
    # SWAP: the cohort tail becomes me, remember the predecessor
    is_swap = p == mc.SWAP
    empty = tail_c == 0
    new_tail_c = torch.where(is_swap, me, tail_c)
    prev = torch.where(col(is_swap) & oh, col(tail_c), prev)
    budget = torch.where(col(is_swap & empty) & oh, col(B), budget)
    # WRITE_NEXT: link into the predecessor's next pointer
    is_wn = p == mc.WRITE_NEXT
    oh_pred = tids == col(sel(prev) - 1)
    nxt = torch.where(col(is_wn) & oh_pred, col(me), nxt)
    # SPIN_BUDGET reads the budget as it stands here
    is_sb = p == mc.SPIN_BUDGET
    b = sel(budget)
    # SET_VICTIM / SET_VICTIM_R
    is_sv = (p == mc.SET_VICTIM) | (p == mc.SET_VICTIM_R)
    v = torch.where(is_sv, c, victim)
    # PET_WAIT / PET_WAIT_R
    is_pw = (p == mc.PET_WAIT) | (p == mc.PET_WAIT_R)
    can = (tail_o == 0) | (v != c)
    is_pwr = p == mc.PET_WAIT_R
    budget = torch.where(col(is_pwr & can) & oh, col(B), budget)
    # REL_CAS
    is_rc = p == mc.REL_CAS
    solo = new_tail_c == me
    new_tail_c = torch.where(is_rc & solo, 0, new_tail_c)
    # SPIN_NEXT / PASS
    is_sn = p == mc.SPIN_NEXT
    nx = sel(nxt)
    has_succ = nx != 0
    is_pass = p == mc.PASS
    oh_succ = tids == col(nx - 1)
    budget = torch.where(col(is_pass) & oh_succ, col(b - 1), budget)

    def full(v):
        return torch.full_like(p, v)

    new_pc = p
    for cond, val in (
            (is_ncs, full(mc.SWAP)),
            (is_swap, torch.where(empty, mc.SET_VICTIM, mc.WRITE_NEXT)),
            (is_wn, full(mc.SPIN_BUDGET)),
            (is_sb, torch.where(b == -1, mc.SPIN_BUDGET, torch.where(
                b == 0, mc.SET_VICTIM_R, mc.CS))),
            (p == mc.SET_VICTIM, full(mc.PET_WAIT)),
            (p == mc.SET_VICTIM_R, full(mc.PET_WAIT_R)),
            (is_pw, torch.where(can, mc.CS, torch.where(
                is_pwr, mc.PET_WAIT_R, mc.PET_WAIT))),
            (p == mc.CS, full(mc.REL_CAS)),
            (is_rc, torch.where(solo, mc.NCS, mc.SPIN_NEXT)),
            (is_sn, torch.where(has_succ, mc.PASS, mc.SPIN_NEXT)),
            (is_pass, full(mc.NCS))):           # the masks are disjoint
        new_pc = torch.where(cond, val.to(torch.int32), new_pc)
    pc = torch.where(oh, col(new_pc), pc)
    tails = torch.where(col(local), torch.stack([new_tail_c, tails[:, 1]], 1),
                        torch.stack([tails[:, 0], new_tail_c], 1))
    return tails, v, pc, budget, nxt, prev


def _run(tails, victim, pc, budget, nxt, prev, sched, cohorts, b_local,
         b_remote):
    state = tuple(a.to(torch.int32) for a in
                  (tails, victim, pc, budget, nxt, prev))
    cohorts = cohorts.to(torch.int32)
    for i in range(sched.shape[1]):
        state = alock_transition(*state, sched[:, i], cohorts, b_local,
                                 b_remote)
    return state


def alock_tick_plain(tails, victim, pc, budget, nxt, prev, sched, cohorts,
                     *, b_init=(5, 20), tile: int = 128):
    """The kernel's contract in plain tensor code: ``tails (Tab,2)``,
    ``victim (Tab,1)``, ``pc/budget/nxt/prev (Tab,T)``, ``sched
    (Tab,steps)``, ``cohorts (Tab,T)``, all int32, ``b_init`` a
    ``(local, remote)`` pair of ints. Returns the six final int32 arrays
    ``(Tab,2) (Tab,1) (Tab,T) x 4``. ``tile`` (tables per block in the
    kernel) is checked and changes no result."""
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    out = _run(tails, victim[:, 0], pc, budget, nxt, prev, sched, cohorts,
               int(b_init[0]), int(b_init[1]))
    return (out[0], out[1][:, None]) + out[2:]


def alock_tick_ref(tails, victim, pc, budget, nxt, prev, sched, cohorts,
                   b_init):
    """The reference oracle's contract: ``victim (Tab,)``, ``cohorts
    (T,)`` shared by every table, ``b_init`` a length-2 array or tensor;
    the rest as ``alock_tick_plain``. Returns ``(tails (Tab,2), victim
    (Tab,), pc, budget, nxt, prev (Tab,T))``."""
    b_local, b_remote = (int(b) for b in b_init)
    cohorts = torch.as_tensor(cohorts, device=pc.device)
    return _run(tails, victim, pc, budget, nxt, prev, sched,
                cohorts.to(torch.int32).expand(pc.shape), b_local, b_remote)


def drawn_schedule_plain(words, n_tables: int, steps: int) -> torch.Tensor:
    """What K2 draws in its drawn mode, element by element as the kernel
    computes it, from its launch words (``kernel.DrawWords``): at the
    64-bit counter ``c = (r0 + t) * pitch + i`` the lower bits ``lo`` (b1 ^
    b2 of threefry2x32 under subkey ``(lo0, lo1)``) and, unless ``span``
    is a power of two, the higher bits ``hi`` under ``(hi0, hi1)``; then
    ``(hi % span * mult + lo % span) % span`` in uint32, each ``%`` by the
    magic ``x - ((((x - h) >> 1) + h) >> shift) * span``, ``h =
    umulhi(magic, x)``, or ``lo & (span - 1)`` for a power of two.
    Returns ``(n_tables, steps)`` int32 on the CPU."""
    m32 = 0xFFFFFFFF
    t = torch.arange(n_tables, dtype=torch.int64)[:, None]
    c = (words.r0 + t) * words.pitch + torch.arange(steps,
                                                    dtype=torch.int64)[None]
    c0, c1 = c >> 32, c & m32

    def bits(k0, k1):
        x0, x1 = prng.threefry2x32(k0, k1, c0, c1)
        return x0 ^ x1

    span = words.span
    lo = bits(words.lo0, words.lo1)
    if span & (span - 1) == 0:
        return (lo & (span - 1)).to(torch.int32)

    def mod(x):
        # umulhi(magic, x) without a 64-bit overflow: magic = a * 2**16 + b
        a, b = words.magic >> 16, words.magic & 0xFFFF
        h = (a * x + ((b * x) >> 16)) >> 16
        q = ((((x - h) & m32) >> 1) + h) >> words.shift
        return (x - q * span) & m32

    hi = bits(words.hi0, words.hi1)
    return mod((mod(hi) * words.mult + mod(lo)) & m32).to(torch.int32)
