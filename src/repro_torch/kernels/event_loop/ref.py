"""Plain PyTorch version of the next-event loop (closed loop).

``run_events_plain`` is the function the CUDA kernel
(``csrc/event_loop.cu``) computes, written as ordinary tensor code:
batched over the replica axis B, a Python loop over the events, the
14- to 18-way program-counter dispatch expressed as masks over PC classes
and the single-word state updates as gathers and masked scatters at
per-replica indices. It runs on any device; it is what the CPU tests hold
against the JAX reference bit for bit, and what the kernel is held against
on the card. It is slow by construction (a few hundred small tensor ops
per event) and nothing on the main path calls it when a CUDA device is
present.

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

Clocks are int64 ns, machine state int32, the two probability compares
f32 against f32.
"""
from __future__ import annotations

import torch

from repro_torch.core import machine as mc

LAT_SAMPLES = 1 << 15

# cost opcodes emitted by the machine transitions
OP_LOCAL, OP_POLL, OP_CS, OP_THINK, OP_RDMA, OP_LOOP = range(6)

_NEVER = torch.iinfo(torch.int64).max    # parked threads lose every argmin

OPEN_LOOP_MSG = (
    "open-loop workloads (Workload.arrivals, R > 0) are not ported yet — "
    "ROADMAP Queue A, item 'open loop' (traffic/stream.py, "
    "traffic/metrics.py and the R > 0 branch of the event loop)")


def _gat(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[b, idx[b]]`` per replica row. Out-of-range-low indices (a
    ``-1`` "no thread") are clamped; such values are never consumed."""
    return a.gather(1, idx.clamp(min=0).long()[:, None])[:, 0]


def _put(a: torch.Tensor, idx: torch.Tensor, val, mask: torch.Tensor):
    """In place: ``a[b, idx[b]] = val[b]`` on the rows where ``mask``."""
    ix = idx.clamp(min=0).long()[:, None]
    cur = a.gather(1, ix)[:, 0]
    if not isinstance(val, torch.Tensor):
        val = torch.full_like(cur, val)
    a.scatter_(1, ix, torch.where(mask, val.to(a.dtype), cur)[:, None])


def _scale_cost(c: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Fail-slow multiplier on an integer-ns cost: round-to-nearest-even
    of the f32 product (exact below 2**24, so ``m == 1.0`` is inert)."""
    return torch.round(c.to(torch.float32) * m).to(torch.int32)


def run_events_plain(alg, T, N, K, n_events, wl, thread_node, lock_node,
                     streams, *, lat_samples: int = LAT_SAMPLES):
    """Batched closed-loop event loop in plain tensor ops.

    ``wl`` is a ``WorkloadOperands`` of tensors with a leading replica
    axis B; ``thread_node (T,)`` / ``lock_node (K,)`` int32 broadcast;
    ``streams`` is ``precompute_draws``' ``(u1, r2, r3[, u4])``, each
    ``(B, n_events)``. Returns ``(done (B,T) i32, lat (B,lat_samples) i64,
    lat_n (B,) i32, t_end (B,) i64, nreacq (B,) i32, npass (B,) i32)``.
    """
    if wl.arr_fix.shape[-1] > 0:
        raise NotImplementedError(OPEN_LOOP_MSG)
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
    t0, t1, vic = zeros((B, K)), zeros((B, K)), zeros((B, K))
    wrd = zeros((B, K)) if is_rw else None       # per-lock reader counts
    pc = torch.full((B, T), mc.NCS, dtype=i32, device=dev)
    bud = torch.full((B, T), -1, dtype=i32, device=dev)
    nxt, prv, tgt, coh = (zeros((B, T)) for _ in range(4))
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

    def at_phase(a, ph):
        return a[:, 0] if ph is None else a[rows, ph]

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
            elig = torch.where(actm, ready, never)
        else:
            ph = None
            elig = ready
        loc_row = at_phase(wl.locality, ph)
        think_e = at_phase(wl.think_ns, ph)
        binit = at_phase(wl.b_init, ph)
        cst = at_phase(wl.cost_rows, ph)
        nm_row = at_phase(wl.node_mult, ph)

        # lowest index among the minimal clocks
        emin = elig.min(1).values
        tid = torch.where(elig == emin[:, None], tids, T).min(1).values
        now = _gat(ready, tid)
        me = (tid + 1).to(i32)
        p = _gat(pc, tid)
        tg, ch, bd = _gat(tgt, tid), _gat(coh, tid), _gat(bud, tid)
        nx, pv = _gat(nxt, tid), _gat(prv, tid)
        mynode = _gat(tn, tid)

        # -- workload draw (consumed by the NCS re-arm only) ----------------
        ge = u1s[:, i] < _gat(loc_row, tid)
        other = (mynode + 1 + r2s[:, i]) % N
        node_w = torch.where(ge, mynode, other)
        new_t = node_w * kpn + r3s[:, i]
        if is_hl:
            rk_me = _gat(rk, mynode)
            new_c = (_gat(rk, node_w) != rk_me).to(i32)
        else:
            new_c = (node_w != mynode).to(i32)
        if is_rw:
            new_r = u4s[:, i] < _gat(at_phase(wl.read_frac, ph), tid)

        # -- PC class masks (exactly one true per row) ----------------------
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
        t0k, t1k = _gat(t0, tg), _gat(t1, tg)
        tail_c = torch.where(c0, t0k, t1k)
        tail_o = torch.where(c0, t1k, t0k)
        vk = _gat(vic, tg)
        pred, succ = pv - 1, nx - 1
        has_succ = nx != 0
        # mcs/spinlock keep the lock word where the ALock family keeps
        # tail 0
        prev_val = tail_c if is_alock else t0k
        empty = prev_val == 0
        solo = prev_val == me
        free = t0k == 0
        can = (tail_o == 0) | (vk != ch)
        newb = (bd - 1) if is_alock else torch.ones_like(bd)
        if is_rw:
            can_rd = (tail_c == 0) & (tail_o == 0)
            wdv = _gat(wrd, tg)

        # -- lock word / tails / victim -------------------------------------
        if is_alock:
            _put(t0, tg, me, is_swap & c0)
            _put(t1, tg, me, is_swap & ~c0)
            _put(t0, tg, 0, is_rc & solo & c0)
            _put(t1, tg, 0, is_rc & solo & ~c0)
            _put(vic, tg, ch, is_sv | is_svr)
        else:
            _put(t0, tg, me, is_swap | (is_slc & free))
            _put(t0, tg, 0, (is_rc & solo) | is_slr)
        if is_rw:
            _put(wrd, tg, wdv + 1, is_rdt & can_rd)
            _put(wrd, tg, wdv - 1, is_rdr)

        # -- per-thread descriptors -----------------------------------------
        _put(prv, tid, prev_val, is_swap)
        _put(nxt, tid, 0, is_ncs)
        _put(nxt, pred, me, is_wn)
        bud_val = torch.where(is_ncs, torch.full_like(bd, -1), Bc)
        bud_m = is_ncs | (is_pwr & can)
        if is_alock:
            bud_m = bud_m | (is_swap & empty)
        _put(bud, tid, bud_val, bud_m)
        _put(bud, succ, newb, is_ps)
        _put(tgt, tid, new_t, is_ncs)
        _put(coh, tid, new_c, is_ncs)

        # -- next PC ---------------------------------------------------------
        def pcv(v):
            return torch.full_like(p, v)

        ecs = mc.WR_DRAIN if is_rw else mc.CS
        if is_rw:
            first = torch.where(new_r, pcv(mc.RD_TRY), pcv(mc.SWAP))
        else:
            first = pcv(mc.SL_CAS if is_spin else mc.SWAP)
        if is_alock:
            pc_swap = torch.where(empty, pcv(mc.SET_VICTIM),
                                  pcv(mc.WRITE_NEXT))
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
            (is_pw, torch.where(can, pcv(ecs), pcv(mc.PET_WAIT))),
            (is_pwr, torch.where(can, pcv(ecs), pcv(mc.PET_WAIT_R))),
            (is_cs, pcv(mc.SL_REL if is_spin else mc.REL_CAS)),
            (is_rc, torch.where(solo, pcv(mc.NCS), pcv(mc.SPIN_NEXT))),
            (is_sn, torch.where(has_succ, pcv(mc.PASS),
                                pcv(mc.SPIN_NEXT))),
            (is_ps, pcv(mc.NCS)),
            (is_slc, torch.where(free, pcv(mc.CS), pcv(mc.SL_CAS))),
            (is_slr, pcv(mc.NCS)),
        ]
        if is_rw:
            table += [
                (is_rdt, torch.where(can_rd, pcv(mc.RD_CS),
                                     pcv(mc.RD_TRY))),
                (is_rdc, pcv(mc.RD_REL)), (is_rdr, pcv(mc.NCS)),
                (is_wd, torch.where(wdv == 0, pcv(mc.CS),
                                    pcv(mc.WR_DRAIN))),
            ]
        new_pc = p
        for cond, val in table:             # the masks are disjoint
            new_pc = torch.where(cond, val, new_pc)
        _put(pc, tid, new_pc, torch.ones_like(is_ncs))

        # -- cost opcode + the node whose RNIC serves it --------------------
        lnode = _gat(ln, tg)
        pred_node, succ_node = _gat(tn, pred), _gat(tn, succ)

        def opv(v):
            return torch.full_like(p, v)

        if is_hl:
            # three tiers: own node -> shared memory, same rack -> the
            # loopback/rack fabric, cross rack -> full RDMA
            def tiered(nd):
                return torch.where(
                    nd == mynode, opv(OP_LOCAL),
                    torch.where(_gat(rk, nd) == rk_me, opv(OP_LOOP),
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
            lock_code = torch.where(lnode == mynode, opv(OP_LOOP),
                                    opv(OP_RDMA))
            wn_code = torch.where(pred_node == mynode, opv(OP_LOOP),
                                  opv(OP_RDMA))
            ps_code = torch.where(succ_node == mynode, opv(OP_LOOP),
                                  opv(OP_RDMA))
        lock_m = (is_swap | is_sv | is_svr | is_pw | is_pwr | is_rc
                  | is_slc | is_slr)
        cs_m = is_cs
        if is_rw:
            lock_m = lock_m | is_rdt | is_rdr | is_wd
            cs_m = cs_m | is_rdc
        code = opv(0)
        for cond, val in (
                (is_ncs, opv(OP_THINK)), (is_wn, wn_code),
                (is_sb, torch.where(bd == -1, opv(OP_POLL),
                                    opv(OP_LOCAL))),
                (cs_m, opv(OP_CS)),
                (is_sn, torch.where(has_succ, opv(OP_LOCAL),
                                    opv(OP_POLL))),
                (is_ps, ps_code), (lock_m, lock_code)):
            code = torch.where(cond, val, code)
        tnode = opv(0)
        for cond, val in ((is_wn, pred_node), (is_ps, succ_node),
                          (lock_m, lnode)):
            tnode = torch.where(cond, val, tnode)

        # -- cost application -----------------------------------------------
        # svc/wire scale by the target card's node, dt_plain by the caller's
        is_loop = code == OP_LOOP
        is_rdma = (code == OP_RDMA) | is_loop
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
        fin_m = is_rc | is_ps | is_slr
        if is_rw:
            fin_m = fin_m | is_rdr
        finished = fin_m & (new_pc == mc.NCS)
        lat_val = now - _gat(opst, tid)
        _put(lat, latn % lat_samples, lat_val, finished)
        latn = latn + finished.to(i32)
        done[rows, tid] += finished.to(i32)
        _put(ready, tid, new_ready, torch.ones_like(is_ncs))
        _put(opst, tid, new_ready, is_ncs)
        reacq = reacq + (is_sb & (new_pc == mc.SET_VICTIM_R)).to(i32)
        npass = npass + is_ps.to(i32)

    return done, lat, latn, ready.max(1).values, reacq, npass
