"""Plain PyTorch version of the next-event loop (closed and open loop).

``run_events_plain`` is the function the CUDA kernel
(``csrc/event_loop.cu``) computes, written as ordinary tensor code:
batched over the replica axis B, a Python loop over the events, the
14- to 18-way program-counter dispatch expressed as masks over PC classes
and the single-word state updates as gathers and masked scatters at
per-replica indices. It runs on any device; it is what the CPU tests hold
against the JAX reference bit for bit, and what the kernel is held against
on the card. It is slow by construction (a few hundred small tensor ops
per event) and nothing on the main path calls it when a CUDA device is
present. ``draw_stream_plain`` is, in the same way, the draw stream the
draw kernel (``csrc/draw_stream.cu``) computes.

Semantics (one replica; every replica is independent):

  per event ``i``: resolve the phase ``ph = sum(i >= edges) - 1``; at a
  phase boundary bump rejoining threads' clocks to the cluster's current
  time; pick ``tid = argmin(ready)`` over schedulable threads (lowest
  index wins ties); run one transition of thread ``tid``'s lock machine
  (``core/machine.py`` PCs) which yields a cost opcode and the node whose
  RNIC serves it; serialise RDMA/loopback work through that node's busy
  clock, scale costs by the per-phase fail-slow node multipliers
  (``round(f32(cost) * mult)``, half to even), and stamp the thread's new
  ready time; account completions (per-thread op counts, latency ring).

Open loop (``R > 0`` request slots, an ``ArrivalPlan`` from
``traffic/stream.py``): idle threads (NCS, no request bound) wake at the
earliest available arrival instead of re-arming; every event first
ingests the requests that have arrived by ``now`` (token-rejected ones and
the tail beyond the queue bound drop), then an idle selected thread takes
the FIFO head. An idle thread with nothing to take makes no step at all
(``step_ok`` false: machine state, busy clock, ready clock and counters
stay as they were), and a drained stream with every thread idle makes the
event a no-op. The finishing release of a bound request stamps its
sojourn and frees the thread.

Clocks are int64 ns, machine state int32, the two probability compares
f32 against f32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import machine as mc
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.traffic.metrics import COMPLETED, DROPPED, IN_SERVICE

LAT_SAMPLES = 1 << 15
#: columns of an engine's ``diag``: events run, the open loop's pointer
#: path, lock operations begun, begun shared, begun on the loopback tier
DIAG_COLS = 5

# cost opcodes emitted by the machine transitions
OP_LOCAL, OP_POLL, OP_CS, OP_THINK, OP_RDMA, OP_LOOP = range(6)

_NEVER = torch.iinfo(torch.int64).max    # parked threads lose every argmin
_I32_MAX = torch.iinfo(torch.int32).max

#: bound on the (replica x event) elements hashed at once: every threefry
#: temporary is an int64 tensor of a small multiple of this many elements
DRAW_CHUNK_ELEMS = 1 << 22
#: bound on the (replica x event x kpn) booleans of one inverse-CDF pass
CDF_CHUNK_ELEMS = 1 << 27


def _zipf_offsets(u3, ph, zcdf, kpn):
    """``min(sum(u3 >= zcdf[ph]), kpn - 1)`` per (replica, event), int32.
    ``ph`` is None for single-phase operands."""
    B, E = u3.shape
    P = zcdf.shape[1]
    out = torch.empty((B, E), dtype=torch.int32, device=u3.device)
    step = max(1, CDF_CHUNK_ELEMS // max(1, B * kpn))
    for s in range(0, E, step):
        u = u3[:, s:s + step, None]
        cnt = (u >= zcdf[:, 0, None, :]).sum(-1)
        for p in range(1, P):
            cnt_p = (u >= zcdf[:, p, None, :]).sum(-1)
            cnt = torch.where(ph[:, s:s + step] == p, cnt_p, cnt)
        out[:, s:s + step] = cnt.clamp(max=kpn - 1).to(torch.int32)
    return out


def draw_stream_plain(seed, edges, zcdf, n_events: int, N: int, kpn: int,
                      rw: bool = False):
    """The draw stream of ``ops.precompute_draws`` (its contract) in torch
    integer ops on the operands' device: the counter-based generator of
    ``core/prng.py``, the event axis in chunks so that temporaries stay
    bounded whatever ``B * n_events`` is."""
    dev = seed.device
    B = seed.shape[0]
    P = edges.shape[1]
    n_sub = 4 if rw else 3
    u1 = torch.empty((B, n_events), dtype=torch.float32, device=dev)
    r2 = torch.empty((B, n_events), dtype=torch.int32, device=dev)
    r3 = torch.empty((B, n_events), dtype=torch.int32, device=dev)
    u4 = torch.empty_like(u1) if rw else None
    k0 = prng.key(seed)
    k0 = (k0[0][:, None], k0[1][:, None])
    step = max(1, DRAW_CHUNK_ELEMS // max(1, B))
    for s in range(0, n_events, step):
        i = torch.arange(s, min(s + step, n_events), dtype=torch.int64,
                         device=dev)[None]
        sub = prng.split(prng.fold_in(k0, i), n_sub)     # (n_sub, B, E)
        # subkeys 0, 2 (, 3) feed uniforms; subkey 1 feeds randint
        uni = [0, 2, 3][:n_sub - 1]
        fl = prng.uniform((sub[0][uni], sub[1][uni]))
        u1[:, s:s + step] = fl[0]
        r2[:, s:s + step] = prng.randint((sub[0][1], sub[1][1]), (), 0,
                                         max(N - 1, 1))
        ph = ((i[:, :, None] >= edges[:, None, :]).sum(-1) - 1
              if P > 1 else None)
        r3[:, s:s + step] = _zipf_offsets(fl[1], ph, zcdf, kpn)
        if rw:
            u4[:, s:s + step] = fl[2]
    return (u1, r2, r3, u4) if rw else (u1, r2, r3)


def _gat(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[b, idx[b]]`` per replica row. Out-of-range-low indices (a
    ``-1`` "no thread") are clamped; such values are never consumed."""
    return a.gather(1, idx.clamp(min=0).long()[:, None])[:, 0]


def _masked(a: torch.Tensor, idx: torch.Tensor, val, mask: torch.Tensor):
    """Index and source of the scatter ``a[b, idx[b]] = val[b]`` on the
    rows where ``mask`` (the current value elsewhere)."""
    ix = idx.clamp(min=0).long()[:, None]
    cur = a.gather(1, ix)[:, 0]
    if not isinstance(val, torch.Tensor):
        val = torch.full_like(cur, val)
    return ix, torch.where(mask, val.to(a.dtype), cur)[:, None]


def _put(a: torch.Tensor, idx: torch.Tensor, val, mask: torch.Tensor):
    """In place: ``a[b, idx[b]] = val[b]`` on the rows where ``mask``."""
    a.scatter_(1, *_masked(a, idx, val, mask))


def _set(a: torch.Tensor, idx: torch.Tensor, val, mask: torch.Tensor):
    """``_put`` on a copy; ``a`` itself is left as it was."""
    return a.scatter(1, *_masked(a, idx, val, mask))


def _scale_cost(c: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Fail-slow multiplier on an integer-ns cost: round-to-nearest-even
    of the f32 product (exact below 2**24, so ``m == 1.0`` is inert)."""
    return torch.round(c.to(torch.float32) * m).to(torch.int32)


class Sem(NamedTuple):
    """Semantic (cost-free) machine state, int32. Every field may carry a
    leading replica axis B, which ``sem_step`` steps all at once."""
    tail: torch.Tensor     # (K,2) tid+1 per cohort
    victim: torch.Tensor   # (K,)
    word: torch.Tensor     # (K,) mcs/spinlock lock word; alock-rw readers
    budget: torch.Tensor   # (T,)
    nxt: torch.Tensor      # (T,)
    prev: torch.Tensor     # (T,)
    pc: torch.Tensor       # (T,)
    target: torch.Tensor   # (T,) lock index
    cohort: torch.Tensor   # (T,) 0 local / 1 remote


def init_sem(n_threads: int, n_locks: int, targets=None, cohorts=None,
             device="cuda") -> Sem:
    """Fresh state of one replica: empty tails and lock words, every
    thread in NCS with budget -1; ``targets`` / ``cohorts`` (one per
    thread) default to 0."""
    dev = resolve_device(device)
    T, K = n_threads, n_locks
    i32 = dict(dtype=torch.int32, device=dev)

    def per_thread(v):
        return (torch.zeros(T, **i32) if v is None else
                torch.as_tensor(np.asarray(v, np.int32), device=dev))
    return Sem(tail=torch.zeros((K, 2), **i32),
               victim=torch.zeros(K, **i32), word=torch.zeros(K, **i32),
               budget=torch.full((T,), -1, **i32),
               nxt=torch.zeros(T, **i32), prev=torch.zeros(T, **i32),
               pc=torch.full((T,), mc.NCS, **i32),
               target=per_thread(targets), cohort=per_thread(cohorts))


def _rows(a, B: int, dev) -> torch.Tensor:
    """A per-replica operand as a (B, n) int32 tensor on ``dev``: a 1-D
    operand is shared by every replica, a 2-D one has its own row each."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    if t.dtype != torch.int32 or t.device != dev:
        t = t.to(device=dev, dtype=torch.int32)
    return t[None].expand(B, t.shape[0]) if t.dim() == 1 else t


def sem_step(alg, sem: Sem, tid, b_init, thread_node, lock_node,
             new_target=None, new_cohort=None, new_read=None, rack=None):
    """One semantic step of thread ``tid``: ``(sem', opcode, node)`` —
    the new state (``sem`` itself is left as it was), the step's cost
    opcode and the node whose RNIC serves it (0 for CPU-side work).

    Used by the plain event loop and by the schedule-driven runner
    ``core.sim.run_schedule``. ``new_target`` / ``new_cohort`` are the
    lock and cohort an NCS step re-arms with (default: the thread's
    current ones); ``new_read`` routes that re-arm to the reader path
    (alock-rw; default: a writer); ``rack`` is the per-node rack id that
    hlock's cost tiers read (default: every node its own rack).

    Either one replica — ``sem`` fields ``(K,2) (K,) (T,)``, ``tid`` a
    scalar, ``b_init (2,)``, ``thread_node (T,)``, ``lock_node (K,)``,
    ``rack (N,)`` — or B at once, each with a leading axis B (``tid``
    and the ``new_*`` values ``(B,)``; the topology and ``b_init`` may
    be shared without it).
    """
    single = sem.pc.dim() == 1
    if single:
        sem = Sem(*(a[None] for a in sem))
    dev = sem.pc.device
    B, T = sem.pc.shape
    K = sem.victim.shape[1]
    i32 = torch.int32
    if not (isinstance(tid, torch.Tensor) and tid.dim() == 1):
        tid = torch.as_tensor(tid, device=dev).reshape(-1).expand(B)
    binit = _rows(b_init, B, dev)
    tn, ln = _rows(thread_node, B, dev), _rows(lock_node, B, dev)
    is_hl = alg == "hlock"
    is_rw = alg == "alock-rw"
    is_alock = alg in ("alock", "hlock", "alock-rw")
    is_spin = alg == "spinlock"
    if not (is_alock or is_spin or alg == "mcs"):
        raise ValueError(f"unknown algorithm {alg!r}")
    if is_hl and rack is not None:
        rk = _rows(rack, B, dev)

        def rack_of(nd):
            return _gat(rk, nd)
    else:
        def rack_of(nd):
            return nd

    tail2 = sem.tail.reshape(B, 2 * K)
    victim, word = sem.victim, sem.word
    pc, bud, nxt, prv = sem.pc, sem.budget, sem.nxt, sem.prev
    tgt, coh = sem.target, sem.cohort
    me = (tid + 1).to(i32)
    p = _gat(pc, tid)
    tg, ch, bd = _gat(tgt, tid), _gat(coh, tid), _gat(bud, tid)
    nx, pv = _gat(nxt, tid), _gat(prv, tid)
    mynode = _gat(tn, tid)

    def arg(v, default):
        if v is None:
            return default
        if not (isinstance(v, torch.Tensor) and v.dim() == 1):
            v = torch.as_tensor(v, device=dev).reshape(-1).expand(B)
        return v
    new_t, new_c = arg(new_target, tg), arg(new_cohort, ch)

    # -- PC class masks (exactly one true per row) --------------------------
    is_ncs, is_swap = p == mc.NCS, p == mc.SWAP
    is_wn, is_sb = p == mc.WRITE_NEXT, p == mc.SPIN_BUDGET
    is_sv, is_svr = p == mc.SET_VICTIM, p == mc.SET_VICTIM_R
    is_pw, is_pwr = p == mc.PET_WAIT, p == mc.PET_WAIT_R
    is_cs, is_rc = p == mc.CS, p == mc.REL_CAS
    is_sn, is_ps = p == mc.SPIN_NEXT, p == mc.PASS
    is_slc, is_slr = p == mc.SL_CAS, p == mc.SL_REL
    if is_rw:
        is_rdt, is_rdc = p == mc.RD_TRY, p == mc.RD_CS
        is_rdr, is_wd = p == mc.RD_REL, p == mc.WR_DRAIN

    c0 = ch == 0
    Bc = torch.where(c0, binit[:, 0], binit[:, 1])
    if is_alock:
        t01 = sem.tail.gather(1, tg.long()[:, None, None].expand(B, 1, 2))
        t0k, t1k = t01[:, 0, 0], t01[:, 0, 1]
        my_tail = 2 * tg + (~c0).to(i32)
        tail_c = torch.where(c0, t0k, t1k)
        tail_o = torch.where(c0, t1k, t0k)
        vk = _gat(victim, tg)
    if not is_alock or is_rw:
        wk = _gat(word, tg)
    pred, succ = pv - 1, nx - 1
    has_succ = nx != 0
    # mcs/spinlock keep the lock word where the ALock family keeps its
    # cohort tails
    prev_val = tail_c if is_alock else wk
    empty = prev_val == 0
    solo = prev_val == me
    if is_alock:
        can = (tail_o == 0) | (vk != ch)
    else:
        free = wk == 0
    newb = (bd - 1) if is_alock else torch.ones_like(bd)
    if is_rw:
        can_rd = (tail_c == 0) & (tail_o == 0)

    # -- lock word / tails / victim -----------------------------------------
    if is_alock:
        tail2 = _set(tail2, my_tail, me, is_swap)
        tail2 = _set(tail2, my_tail, 0, is_rc & solo)
        victim = _set(victim, tg, ch, is_sv | is_svr)
    else:
        word = _set(word, tg, me, is_swap | (is_slc & free))
        word = _set(word, tg, 0, (is_rc & solo) | is_slr)
    if is_rw:
        word = _set(word, tg, wk + 1, is_rdt & can_rd)
        word = _set(word, tg, wk - 1, is_rdr)

    # -- per-thread descriptors ---------------------------------------------
    prv = _set(prv, tid, prev_val, is_swap)
    nxt = _set(nxt, tid, 0, is_ncs)
    nxt = _set(nxt, pred, me, is_wn)
    bud_val = torch.where(is_ncs, torch.full_like(bd, -1), Bc)
    bud_m = is_ncs
    if is_alock:
        bud_m = bud_m | (is_pwr & can) | (is_swap & empty)
    bud = _set(bud, tid, bud_val, bud_m)
    bud = _set(bud, succ, newb, is_ps)
    tgt = _set(tgt, tid, new_t, is_ncs)
    coh = _set(coh, tid, new_c, is_ncs)

    # -- next PC -------------------------------------------------------------
    def pcv(v):
        return torch.full_like(p, v)

    ecs = mc.WR_DRAIN if is_rw else mc.CS
    if is_rw:
        first = torch.where(arg(new_read, torch.zeros_like(tg)) != 0,
                            pcv(mc.RD_TRY), pcv(mc.SWAP))
    else:
        first = pcv(mc.SL_CAS if is_spin else mc.SWAP)
    if is_alock:
        pc_swap = torch.where(empty, pcv(mc.SET_VICTIM), pcv(mc.WRITE_NEXT))
        pc_sb = torch.where(
            bd == -1, pcv(mc.SPIN_BUDGET),
            torch.where(bd == 0, pcv(mc.SET_VICTIM_R), pcv(ecs)))
    else:
        pc_swap = torch.where(empty, pcv(mc.CS), pcv(mc.WRITE_NEXT))
        pc_sb = torch.where(bd == -1, pcv(mc.SPIN_BUDGET), pcv(mc.CS))
    table = [
        (is_ncs, first), (is_swap, pc_swap),
        (is_wn, pcv(mc.SPIN_BUDGET)), (is_sb, pc_sb),
        (is_sv, pcv(mc.PET_WAIT)), (is_svr, pcv(mc.PET_WAIT_R)),
        (is_cs, pcv(mc.SL_REL if is_spin else mc.REL_CAS)),
        (is_rc, torch.where(solo, pcv(mc.NCS), pcv(mc.SPIN_NEXT))),
        (is_sn, torch.where(has_succ, pcv(mc.PASS), pcv(mc.SPIN_NEXT))),
        (is_ps, pcv(mc.NCS)),
        (is_slr, pcv(mc.NCS)),
    ]
    if is_alock:
        table += [
            (is_pw, torch.where(can, pcv(ecs), pcv(mc.PET_WAIT))),
            (is_pwr, torch.where(can, pcv(ecs), pcv(mc.PET_WAIT_R)))]
    else:
        table.append((is_slc, torch.where(free, pcv(mc.CS), pcv(mc.SL_CAS))))
    if is_rw:
        table += [
            (is_rdt, torch.where(can_rd, pcv(mc.RD_CS), pcv(mc.RD_TRY))),
            (is_rdc, pcv(mc.RD_REL)), (is_rdr, pcv(mc.NCS)),
            (is_wd, torch.where(wk == 0, pcv(mc.CS), pcv(mc.WR_DRAIN))),
        ]
    new_pc = p
    for cond, val in table:                 # the masks are disjoint
        new_pc = torch.where(cond, val, new_pc)
    pc = _set(pc, tid, new_pc, torch.ones_like(is_ncs))

    # -- cost opcode + the node whose RNIC serves it ------------------------
    lnode = _gat(ln, tg)
    pred_node, succ_node = _gat(tn, pred), _gat(tn, succ)

    def opv(v):
        return torch.full_like(p, v)

    if is_hl:
        # three tiers: own node -> shared memory, same rack -> the
        # loopback/rack fabric, cross rack -> full RDMA
        rk_me = rack_of(mynode)

        def tiered(nd):
            return torch.where(
                nd == mynode, opv(OP_LOCAL),
                torch.where(rack_of(nd) == rk_me, opv(OP_LOOP),
                            opv(OP_RDMA)))

        lock_code = tiered(lnode)
        wn_code, ps_code = tiered(pred_node), tiered(succ_node)
    elif is_alock:
        lock_code = torch.where(c0, opv(OP_LOCAL), opv(OP_RDMA))
        wn_code = torch.where(pred_node == mynode, opv(OP_LOCAL),
                              opv(OP_RDMA))
        ps_code = torch.where(succ_node == mynode, opv(OP_LOCAL),
                              opv(OP_RDMA))
    else:
        lock_code = torch.where(lnode == mynode, opv(OP_LOOP), opv(OP_RDMA))
        wn_code = torch.where(pred_node == mynode, opv(OP_LOOP),
                              opv(OP_RDMA))
        ps_code = torch.where(succ_node == mynode, opv(OP_LOOP),
                              opv(OP_RDMA))
    lock_m = (is_swap | is_sv | is_svr | is_pw | is_pwr | is_rc | is_slc
              | is_slr)
    cs_m = is_cs
    if is_rw:
        lock_m = lock_m | is_rdt | is_rdr | is_wd
        cs_m = cs_m | is_rdc
    code = opv(0)
    for cond, val in (
            (is_ncs, opv(OP_THINK)), (is_wn, wn_code),
            (is_sb, torch.where(bd == -1, opv(OP_POLL), opv(OP_LOCAL))),
            (cs_m, opv(OP_CS)),
            (is_sn, torch.where(has_succ, opv(OP_LOCAL), opv(OP_POLL))),
            (is_ps, ps_code), (lock_m, lock_code)):
        code = torch.where(cond, val, code)
    node = opv(0)
    for cond, val in ((is_wn, pred_node), (is_ps, succ_node),
                      (lock_m, lnode)):
        node = torch.where(cond, val, node)

    out = Sem(tail=tail2.reshape(B, K, 2), victim=victim, word=word,
              budget=bud, nxt=nxt, prev=prv, pc=pc, target=tgt, cohort=coh)
    if single:
        return Sem(*(a[0] for a in out)), code[0], node[0]
    return out, code, node


def run_events_plain(alg, T, N, K, n_events, wl, thread_node, lock_node,
                     streams, *, lat_samples: int = LAT_SAMPLES, plan=None,
                     arr=None, diag=None):
    """Batched event loop in plain tensor ops.

    ``wl`` is a ``WorkloadOperands`` of tensors with a leading replica
    axis B; ``thread_node (T,)`` / ``lock_node (K,)`` int32 broadcast;
    ``streams`` is ``precompute_draws``' ``(u1, r2, r3[, u4])``, each
    ``(B, n_events)``. Returns ``(done (B,T) i32, lat (B,lat_samples) i64,
    lat_n (B,) i32, t_end (B,) i64, nreacq (B,) i32, npass (B,) i32)``;
    an open-loop ``wl`` (``R > 0``) also takes ``plan``, the
    ``traffic.stream.ArrivalPlan`` of its replicas, and ``arr (B,R) i64``,
    their arrival times (``arrival_times_i64(plan.gaps)``), and appends
    ``(arr, wq, soj) (B,R) i64, rstat (B,R) i32``.

    ``diag``, an optional ``(B, 5)`` int32 tensor, is filled by the
    kernel's rule: column 0 the events the loop ran — ``i + 1`` for the
    first event ``i`` at which an open-loop replica is idle for good
    (every thread idle, nothing admitted pending, the arrival stream
    drained; every later event is a no-op), else ``n_events`` — column 1
    1 where an open-loop replica's arrival times are non-decreasing,
    column 2 the lock operations begun (the NCS steps taken), column 3
    those begun shared (alock-rw's readers, the steps into RD_TRY; 0 for
    every other algorithm) and column 4 those begun on the loopback tier
    (hlock's locks in another node of the taker's rack, whose lock steps
    cost OP_LOOP; 0 for every other algorithm). This engine runs every
    event either way; the counts cost a few ops an event and are made
    only when ``diag`` is given.
    """
    R = wl.arr_fix.shape[-1]
    if R > 0 and (plan is None or arr is None):
        raise ValueError("an open-loop run (R > 0) needs its arrival plan "
                         "and arrival times")
    is_hl = alg == "hlock"
    is_rw = alg == "alock-rw"
    is_alock = alg in ("alock", "hlock", "alock-rw")
    is_spin = alg == "spinlock"
    if not (is_alock or is_spin or alg == "mcs"):
        raise ValueError(f"unknown algorithm {alg!r}")
    dev = wl.seed.device
    B = wl.seed.shape[0]
    P = wl.edges.shape[1]
    kpn = K // N
    i32, i64 = torch.int32, torch.int64
    u1s, r2s, r3s = streams[:3]
    u4s = streams[3] if is_rw else None

    def zeros(shape, dt=i32):
        return torch.zeros(shape, dtype=dt, device=dev)

    # fresh replicas: empty tails / lock words, every thread in NCS
    sem = Sem(*(a[None].expand((B,) + a.shape).clone()
                for a in init_sem(T, K, device=dev)))
    ready, opst = zeros((B, T), i64), zeros((B, T), i64)
    busy = zeros((B, N), i64)
    done = zeros((B, T))
    lat = torch.full((B, lat_samples), -1, dtype=i64, device=dev)
    latn, reacq, npass = zeros(B), zeros(B), zeros(B)

    rows = torch.arange(B, device=dev)
    tids = torch.arange(T, device=dev)[None]
    tn = thread_node.to(dev).to(i32)[None].expand(B, T)
    ln = lock_node.to(dev).to(i32)[None].expand(B, K)
    rk = wl.rack.to(i32) if is_hl else None
    edges = wl.edges
    if R:
        tok, tokcum, qcap = plan.tok, plan.tokcum, plan.qcap
        idx_r = torch.arange(R, dtype=i32, device=dev)[None]
        rstat = zeros((B, R))
        curreq = torch.full((B, T), -1, dtype=i32, device=dev)
        arrptr, qlen = zeros(B), zeros(B)
        wq = torch.full((B, R), -1, dtype=i64, device=dev)
        soj = torch.full((B, R), -1, dtype=i64, device=dev)

    def at_phase(a, ph):
        return a[:, 0] if ph is None else a[rows, ph]

    ev_run = torch.full((B,), n_events, dtype=i32, device=dev)
    n_ops, n_reads, n_loop = zeros(B), zeros(B), zeros(B)
    for i in range(n_events):
        # -- phase resolve + the boundary rejoin bump -----------------------
        if P > 1:
            ph = (i >= edges).sum(1) - 1
            act_row = wl.active[rows, ph]
            was_act = wl.active[rows, (ph - 1).clamp(min=0)]
            actm = act_row != 0
            rejoin = ((i == edges).any(1)[:, None] & actm & (was_act == 0))
            never = torch.full_like(ready, _NEVER)
            cont_min = torch.where(actm & (was_act != 0), ready,
                                   never).min(1).values
            act_min = torch.where(actm, ready, never).min(1).values
            now_min = torch.where(cont_min == _NEVER, act_min, cont_min)
            ready = torch.where(
                rejoin, torch.maximum(ready, now_min[:, None]), ready)
        else:
            ph = None
        if R:
            # idle threads wake at the earliest available arrival; busy
            # threads keep their own clocks
            pend = (sem.pc == mc.NCS) & (curreq < 0)
            avail = (rstat == 0) & (tok == 1)
            next_arr = torch.where(avail, arr, _NEVER).min(1).values
            wake = torch.where(pend, torch.maximum(ready, next_arr[:, None]),
                               ready)
            if diag is not None:
                # idle for good: no thread can step again, at this event or
                # any later one
                stop = pend.all(1) & (next_arr == _NEVER)
                ev_run = torch.where(stop & (ev_run == n_events), i + 1,
                                     ev_run)
        else:
            wake = ready
        elig = torch.where(actm, wake, _NEVER) if P > 1 else wake
        loc_row = at_phase(wl.locality, ph)
        think_e = at_phase(wl.think_ns, ph)
        binit = at_phase(wl.b_init, ph)
        cst = at_phase(wl.cost_rows, ph)
        nm_row = at_phase(wl.node_mult, ph)

        # lowest index among the minimal clocks
        emin = elig.min(1).values
        tid = torch.where(elig == emin[:, None], tids, T).min(1).values
        now = _gat(wake, tid)
        p = _gat(sem.pc, tid)
        mynode = _gat(tn, tid)

        # -- workload draw (consumed by the NCS re-arm only) ----------------
        ge = u1s[:, i] < _gat(loc_row, tid)
        other = (mynode + 1 + r2s[:, i]) % N
        node_w = torch.where(ge, mynode, other)
        new_t = node_w * kpn + r3s[:, i]
        if is_hl:
            rk_me = _gat(rk, mynode)
            new_c = (_gat(rk, node_w) != rk_me).to(i32)
            # the loopback tier: another node of the taker's rack
            new_loop = (new_c == 0) & (node_w != mynode)
        else:
            new_c = (node_w != mynode).to(i32)
        new_r = (u4s[:, i] < _gat(at_phase(wl.read_frac, ph), tid)
                 if is_rw else None)

        if R:
            # -- arrival ingestion: every request with arr <= now joins the
            # wait queue or drops (token reject / queue full); `rank` orders
            # the admitted newcomers so the tail drop is exact when a burst
            # overshoots the remaining room
            live = now != _NEVER
            pend_tid = pend.gather(1, tid[:, None])[:, 0]
            cnt_now = torch.where(live, (arr <= now[:, None]).sum(
                1, dtype=i32), arrptr)
            newly = (idx_r >= arrptr[:, None]) & (idx_r < cnt_now[:, None])
            rank = tokcum - _gat(tokcum, arrptr.clamp(max=R - 1))[:, None]
            join = newly & (tok == 1) & (rank < qcap - qlen[:, None])
            rstat = torch.where(newly & ~join, DROPPED, rstat)
            qlen = qlen + join.sum(1, dtype=i32)
            arrptr = cnt_now
            # -- dispatch: an idle selected thread takes the FIFO head -----
            queued = (rstat == 0) & (idx_r < arrptr[:, None])
            head = torch.where(queued, idx_r, _I32_MAX).min(1).values
            do_disp = live & pend_tid & queued.any(1)
            hd = head.clamp(max=R - 1)
            _put(rstat, hd, IN_SERVICE, do_disp)
            _put(curreq, tid, hd, do_disp)
            _put(wq, hd, now - _gat(arr, hd), do_disp)
            qlen = qlen - do_disp.to(i32)
            # an idle thread with nothing to take makes no machine step
            step_ok = live & (~pend_tid | do_disp)

        # -- one transition of thread tid: the new machine, the cost
        # opcode and the node whose RNIC serves it
        nsem, code, tnode = sem_step(alg, sem, tid, binit, tn, ln, new_t,
                                     new_c, new_r, rk)
        new_pc = _gat(nsem.pc, tid)
        is_ncs, is_sb = p == mc.NCS, p == mc.SPIN_BUDGET
        is_ps = p == mc.PASS
        fin_m = (p == mc.REL_CAS) | is_ps | (p == mc.SL_REL)
        if is_rw:
            fin_m = fin_m | (p == mc.RD_REL)
        if R:
            # a no-op event leaves the whole machine as it was
            sem = Sem(*(torch.where(step_ok.view((B,) + (1,) * (a.dim() - 1)),
                                    a, b) for a, b in zip(nsem, sem)))
            ok = step_ok
        else:
            sem = nsem
            ok = torch.ones_like(is_ncs)

        # -- cost application -----------------------------------------------
        # svc/wire scale by the target card's node, dt_plain by the caller's
        is_loop = code == OP_LOOP
        is_rdma = ((code == OP_RDMA) | is_loop) & ok
        nm_t, nm_my = _gat(nm_row, tnode), _gat(nm_row, mynode)
        svc = _scale_cost(torch.where(is_loop, cst[:, 5], cst[:, 4]), nm_t)
        wire = _scale_cost(torch.where(is_loop, cst[:, 7], cst[:, 6]), nm_t)
        fin = torch.maximum(now, _gat(busy, tnode)) + svc
        _put(busy, tnode, fin, is_rdma)
        base = cst[:, 0]
        for cond, val in ((code == OP_POLL, cst[:, 1]),
                          (code == OP_CS, cst[:, 2]),
                          (code == OP_THINK, think_e)):
            base = torch.where(cond, val, base)
        dt_plain = _scale_cost(base, nm_my)
        new_ready = torch.where(is_rdma, fin + wire, now + dt_plain)

        # -- completion accounting: lat_val reads op_start BEFORE the
        # re-stamp, so it spans acquire-entry -> release exactly -----------
        finished = fin_m & (new_pc == mc.NCS) & ok
        lat_val = now - _gat(opst, tid)
        _put(lat, latn % lat_samples, lat_val, finished)
        latn = latn + finished.to(i32)
        done[rows, tid] += finished.to(i32)
        _put(ready, tid, new_ready, ok)
        _put(opst, tid, new_ready, is_ncs & ok)
        reacq = reacq + (is_sb & (new_pc == mc.SET_VICTIM_R) & ok).to(i32)
        npass = npass + (is_ps & ok).to(i32)
        if diag is not None:
            began = is_ncs & ok
            n_ops = n_ops + began.to(i32)
            if is_rw:
                n_reads = n_reads + (began & new_r).to(i32)
            if is_hl:
                n_loop = n_loop + (began & new_loop).to(i32)
        if R:
            # -- departure: the finishing release frees the thread and
            # stamps the request's sojourn at the step's completion time
            req = _gat(curreq, tid)
            comp = finished & (req >= 0)
            rq = req.clamp(min=0)
            _put(soj, rq, new_ready - _gat(arr, rq), comp)
            _put(rstat, rq, COMPLETED, comp)
            _put(curreq, tid, -1, comp)

    if diag is not None:
        diag[:, 0] = ev_run
        diag[:, 1] = ((arr[:, 1:] >= arr[:, :-1]).all(1).to(i32) if R
                      else 0)
        diag[:, 2] = n_ops
        diag[:, 3] = n_reads
        diag[:, 4] = n_loop
    out = (done, lat, latn, ready.max(1).values, reacq, npass)
    return out + (arr, wq, soj, rstat) if R else out
