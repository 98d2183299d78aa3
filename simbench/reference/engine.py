"""The next-event simulation of one replica, written as a plain Python loop.

A replica is a cluster of ``N`` nodes with ``tpn`` threads each and ``K``
locks spread evenly over the nodes, run for ``n_events`` events. Each
event resolves the phase (``sum(i >= edges) - 1``; at a phase boundary
the threads whose node comes back up catch up to the cluster's clock),
picks the thread with the earliest ready clock (lowest index on ties,
threads of a down node never), and runs one step of its lock protocol:

* ``alock`` (and ``hlock``, whose cohorts are racks): two MCS queues, one
  per cohort (the lock's own node, everyone else), joined by a Peterson
  handshake on ``victim``, with per-cohort pass budgets ``b_init``;
* ``mcs``: one queue on the lock word;
* ``spinlock``: compare-and-swap on the lock word until it succeeds;
* ``alock-rw``: ``alock`` for writers, who wait for the reader count to
  drain; readers enter while both queues are empty.

A thread leaving its non-critical section draws its next lock: its own
node's with probability ``locality`` (the uniform ``u1`` of the event),
else another node ``(node + 1 + r2) % N``; the lock within the node is
the Zipf rank ``r3``. Each step costs an opcode priced by the cost rows:
RDMA and loopback work is serialised through the serving node's RNIC
clock (``busy``), scaled by that node's fail-slow multiplier; other work
by the caller's. A release that returns the thread to its non-critical
section completes an operation and records its latency.

Open loop: ``R`` requests arrive by a precomputed plan; an idle thread
(non-critical section, no request) wakes at the next available arrival;
every event first takes in what has arrived by its time (a request the
token bucket refused, or one past the queue bound, is dropped), then an
idle selected thread takes the head of the queue. An idle thread with
nothing to take makes no step. The completing release stamps the
request's sojourn.
"""
from __future__ import annotations

import heapq
from bisect import bisect_right
from typing import NamedTuple

import numpy as np

from . import prng, stream

LAT_SAMPLES = 1 << 15
NEVER = (1 << 63) - 1
PENDING, IN_SERVICE, DROPPED, COMPLETED = 0, 1, 2, 3
(NCS, SWAP, WRITE_NEXT, SPIN_BUDGET, SET_VICTIM, PET_WAIT, SET_VICTIM_R,
 PET_WAIT_R, CS, REL_CAS, SPIN_NEXT, PASS, SL_CAS, SL_REL, RD_TRY, RD_CS,
 RD_REL, WR_DRAIN) = range(18)
OP_LOCAL, OP_POLL, OP_CS, OP_THINK, OP_RDMA, OP_LOOP = range(6)
_LOCK_PCS = frozenset((SWAP, SET_VICTIM, SET_VICTIM_R, PET_WAIT, PET_WAIT_R,
                       REL_CAS, SL_CAS, SL_REL))
_LOCK_PCS_RW = _LOCK_PCS | {RD_TRY, RD_REL, WR_DRAIN}
#: events whose draws are made at once
DRAW_BLOCK = 1 << 14


class Replica(NamedTuple):
    """One replica's outputs."""
    done: np.ndarray        # (T,) operations completed per thread
    lat: np.ndarray         # (LAT_SAMPLES,) latency ring, -1 padded
    lat_n: int
    t_end: int              # the latest ready clock
    reacquires: int
    passes: int
    arr: np.ndarray | None = None    # (R,) open loop: arrival times
    wait: np.ndarray | None = None   # (R,) queue waits, -1 if never served
    sojourn: np.ndarray | None = None  # (R,) -1 if never completed
    rstat: np.ndarray | None = None  # (R,) PENDING .. COMPLETED


class _Draws:
    """The event draws of one replica, made a block of events at a time:
    ``u1`` (locality uniform), ``r2`` (other-node offset), ``r3`` (Zipf
    rank within the node, against the phase of the event), ``u4`` (read
    coin)."""

    def __init__(self, lw, seed: int, rw: bool, low: bool):
        self.lw, self.seed, self.rw, self.low = lw, seed, rw, low
        self.start = -DRAW_BLOCK

    def at(self, i: int):
        if not 0 <= i - self.start < DRAW_BLOCK:
            self._fill(i - i % DRAW_BLOCK)
        j = i - self.start
        return self.u1[j], self.r2[j], self.r3[j], self.u4[j]

    def _fill(self, s: int):
        lw = self.lw
        i = np.arange(s, s + DRAW_BLOCK, dtype=np.int64)
        sub = prng.split(prng.fold_in(prng.key(self.seed), i),
                         4 if self.rw else 3)
        u1, u3 = prng.uniform(sub[0]), prng.uniform(sub[2])
        u4 = prng.uniform(sub[3]) if self.rw else np.zeros_like(u1)
        r2 = prng.randint(sub[1], 0, max(lw.N - 1, 1))
        ph = (i[:, None] >= lw.edges[None, :]).sum(1) - 1
        cdf = lw.zcdf[ph]
        if self.low:
            u1, u3, u4 = (stream.bf16_down(a) for a in (u1, u3, u4))
            cdf = stream.bf16(cdf)
        r3 = np.minimum((u3[:, None] >= cdf).sum(1), lw.K // lw.N - 1)
        self.start = s
        self.u1, self.u4 = u1.tolist(), u4.tolist()
        self.r2, self.r3 = r2.tolist(), r3.tolist()


def run(lw, seed: int, n_events: int, low: bool = False) -> Replica:
    """Simulate one replica of the lowered workload ``lw`` with ``seed``.
    ``low`` (the control) computes every f32 value the run reads in
    bfloat16 instead (``stream.bf16``; uniforms keep their top 8 bits)."""
    alg, T, N, K = lw.alg, lw.T, lw.N, lw.K
    if alg not in ("alock", "hlock", "alock-rw", "mcs", "spinlock"):
        raise ValueError(f"unknown algorithm {alg!r}")
    is_hl, is_rw = alg == "hlock", alg == "alock-rw"
    is_alock = alg in ("alock", "hlock", "alock-rw")
    is_spin = alg == "spinlock"
    tpn, kpn = T // N, K // N
    P = len(lw.edges)
    R = len(lw.arr_fix)
    tn = [t // tpn for t in range(T)]
    ln = [k // kpn for k in range(K)]
    rack = lw.rack.tolist()
    edges = lw.edges.tolist()
    f32 = stream.bf16 if low else np.float32
    loc = f32(lw.locality).tolist()
    rfrac = f32(lw.read_frac).tolist()
    nmult = f32(lw.node_mult).tolist()
    cost = lw.cost_rows.tolist()
    think = lw.think_ns.tolist()
    binit = lw.b_init.tolist()
    active = lw.active.tolist()
    draws = _Draws(lw, seed, is_rw, low)

    def scale(c, m):
        # round-half-even of the f32 product (exact for m == 1)
        if m == 1.0:
            return c
        return int(np.rint(f32(np.float32(c) * np.float32(m))))

    tail0, tail1 = [0] * K, [0] * K
    victim, word = [0] * K, [0] * K
    bud, nxt, prv = [-1] * T, [0] * T, [0] * T
    pcs, tgt, coh = [NCS] * T, [0] * T, [0] * T
    ready, opst, done = [0] * T, [0] * T, [0] * T
    busy = [0] * N
    lat = [-1] * LAT_SAMPLES
    latn = reacq = npass = 0
    heap = [(0, t) for t in range(T)] if P == 1 and not R else None

    if R:
        pl = stream.plan(lw, seed, n_events, low)
        arr, tok, qcap = pl.arr.tolist(), pl.tok.tolist(), pl.qcap.tolist()
        tokcum = (np.cumsum(pl.tok) - pl.tok).tolist()
        sorted_arr = bool(np.all(np.diff(pl.arr) >= 0))
        rstat, wq, soj = [PENDING] * R, [-1] * R, [-1] * R
        curreq = [-1] * T
        arrptr = qlen = 0
        nxt_avail = 0          # no request below it is still available

    for i in range(n_events):
        ph = 0
        if P > 1:
            ph = bisect_right(edges, i) - 1
            if edges[ph] == i:
                _catch_up(ready, active, ph, T)
        if R:
            while nxt_avail < R and not (rstat[nxt_avail] == PENDING
                                         and tok[nxt_avail]):
                nxt_avail += 1
            next_arr = NEVER
            for k in range(nxt_avail, R):
                if rstat[k] == PENDING and tok[k] and arr[k] < next_arr:
                    next_arr = arr[k]
                    if sorted_arr:
                        break
            pend = [pcs[t] == NCS and curreq[t] < 0 for t in range(T)]
            wake = [max(ready[t], next_arr) if pend[t] else ready[t]
                    for t in range(T)]
        else:
            wake = ready
        if heap is not None:
            now, tid = heapq.heappop(heap)
        else:
            act = active[ph] if P > 1 else None
            tid, best = 0, NEVER + 1
            for t in range(T):
                v = wake[t] if act is None or act[t] else NEVER
                if v < best:
                    tid, best = t, v
            now = wake[tid]
        p = pcs[tid]
        mynode = tn[tid]
        ok = True
        if R:
            live = now != NEVER
            if not live and all(pend):
                # nothing is left to serve: the state stays as it is but
                # for the catch-up at the phase boundaries still ahead
                for q in range(ph + 1, P):
                    if edges[q] < n_events:
                        _catch_up(ready, active, q, T)
                break
            pend_tid = pend[tid]
            if live:
                cnt = (bisect_right(arr, now) if sorted_arr
                       else sum(a <= now for a in arr))
            else:
                cnt = arrptr
            # every arrival joins the queue or drops; the rank among this
            # event's token-admitted arrivals decides the tail drop
            base, joined = tokcum[min(arrptr, R - 1)], 0
            for k in range(arrptr, cnt):
                if tok[k] and tokcum[k] - base < qcap[k] - qlen:
                    joined += 1
                else:
                    rstat[k] = DROPPED
            qlen += joined
            arrptr = cnt
            head = -1
            for k in range(arrptr):
                if rstat[k] == PENDING:
                    head = k
                    break
            do_disp = live and pend_tid and head >= 0
            if do_disp:
                rstat[head] = IN_SERVICE
                curreq[tid] = head
                wq[head] = now - arr[head]
                qlen -= 1
            ok = live and (not pend_tid or do_disp)
            if not ok:
                continue

        # -- one step of thread tid's lock protocol -------------------------
        me = tid + 1
        tg, ch, bd = tgt[tid], coh[tid], bud[tid]
        nx, pv = nxt[tid], prv[tid]
        c0 = ch == 0
        bi = binit[ph]
        Bc = bi[0] if c0 else bi[1]
        if is_alock:
            tail_c = tail0[tg] if c0 else tail1[tg]
            tail_o = tail1[tg] if c0 else tail0[tg]
            vk = victim[tg]
            can = tail_o == 0 or vk != ch
            prev_val = tail_c
        if not is_alock or is_rw:
            wk = word[tg]
        if not is_alock:
            prev_val = wk
        pred, succ = pv - 1, nx - 1
        has_succ = nx != 0
        empty, solo = prev_val == 0, prev_val == me
        new_pc = p
        if p == NCS:
            u1, r2, r3, u4 = draws.at(i)
            if u1 < loc[ph][tid]:
                node_w = mynode
            else:
                node_w = (mynode + 1 + r2) % N
            nxt[tid] = 0
            bud[tid] = -1
            tgt[tid] = node_w * kpn + r3
            if is_hl:
                coh[tid] = int(rack[node_w] != rack[mynode])
            else:
                coh[tid] = int(node_w != mynode)
            if is_rw and u4 < rfrac[ph][tid]:
                new_pc = RD_TRY
            else:
                new_pc = SL_CAS if is_spin else SWAP
        elif p == SWAP:
            if is_alock:
                if c0:
                    tail0[tg] = me
                else:
                    tail1[tg] = me
                if empty:
                    bud[tid] = Bc
                new_pc = SET_VICTIM if empty else WRITE_NEXT
            else:
                word[tg] = me
                new_pc = CS if empty else WRITE_NEXT
            prv[tid] = prev_val
        elif p == WRITE_NEXT:
            nxt[pred] = me
            new_pc = SPIN_BUDGET
        elif p == SPIN_BUDGET:
            if bd == -1:
                new_pc = SPIN_BUDGET
            elif is_alock and bd == 0:
                new_pc = SET_VICTIM_R
            else:
                new_pc = WR_DRAIN if is_rw else CS
        elif p in (SET_VICTIM, SET_VICTIM_R):
            victim[tg] = ch
            new_pc = PET_WAIT if p == SET_VICTIM else PET_WAIT_R
        elif p in (PET_WAIT, PET_WAIT_R):
            if can:
                if p == PET_WAIT_R:
                    bud[tid] = Bc
                new_pc = WR_DRAIN if is_rw else CS
        elif p == CS:
            new_pc = SL_REL if is_spin else REL_CAS
        elif p == REL_CAS:
            if solo:
                if is_alock:
                    if c0:
                        tail0[tg] = 0
                    else:
                        tail1[tg] = 0
                else:
                    word[tg] = 0
                new_pc = NCS
            else:
                new_pc = SPIN_NEXT
        elif p == SPIN_NEXT:
            new_pc = PASS if has_succ else SPIN_NEXT
        elif p == PASS:
            bud[succ] = bd - 1 if is_alock else 1
            new_pc = NCS
        elif p == SL_CAS:
            if wk == 0:
                word[tg] = me
                new_pc = CS
        elif p == SL_REL:
            word[tg] = 0
            new_pc = NCS
        elif p == RD_TRY:
            if tail_c == 0 and tail_o == 0:
                word[tg] = wk + 1
                new_pc = RD_CS
        elif p == RD_CS:
            new_pc = RD_REL
        elif p == RD_REL:
            word[tg] = wk - 1
            new_pc = NCS
        elif p == WR_DRAIN:
            if wk == 0:
                new_pc = CS
        pcs[tid] = new_pc

        # -- the step's cost opcode and the node whose RNIC serves it -------
        if p == NCS:
            code, tnode = OP_THINK, 0
        elif p == WRITE_NEXT:
            tnode = tn[max(pred, 0)]
            code = _peer_code(is_hl, is_alock, tnode, mynode, rack)
        elif p == PASS:
            tnode = tn[max(succ, 0)]
            code = _peer_code(is_hl, is_alock, tnode, mynode, rack)
        elif p == SPIN_BUDGET:
            code, tnode = (OP_POLL if bd == -1 else OP_LOCAL), 0
        elif p == CS or p == RD_CS:
            code, tnode = OP_CS, 0
        elif p == SPIN_NEXT:
            code, tnode = (OP_LOCAL if has_succ else OP_POLL), 0
        elif p in (_LOCK_PCS_RW if is_rw else _LOCK_PCS):
            tnode = ln[tg]
            if is_hl:
                code = _peer_code(True, True, tnode, mynode, rack)
            elif is_alock:
                code = OP_LOCAL if c0 else OP_RDMA
            else:
                code = OP_LOOP if tnode == mynode else OP_RDMA
        else:
            code, tnode = OP_LOCAL, 0

        # -- cost ------------------------------------------------------------
        cst = cost[ph]
        if code == OP_RDMA or code == OP_LOOP:
            lp = code == OP_LOOP
            m = nmult[ph][tnode]
            svc = scale(cst[5] if lp else cst[4], m)
            wire = scale(cst[7] if lp else cst[6], m)
            fin = max(now, busy[tnode]) + svc
            busy[tnode] = fin
            new_ready = fin + wire
        else:
            if code == OP_POLL:
                base = cst[1]
            elif code == OP_CS:
                base = cst[2]
            elif code == OP_THINK:
                base = think[ph]
            else:
                base = cst[0]
            new_ready = now + scale(base, nmult[ph][mynode])

        # -- completion accounting ------------------------------------------
        if new_pc == NCS and p in (REL_CAS, PASS, SL_REL, RD_REL):
            lat[latn % LAT_SAMPLES] = now - opst[tid]
            latn += 1
            done[tid] += 1
            if R and curreq[tid] >= 0:
                rq = curreq[tid]
                soj[rq] = new_ready - arr[rq]
                rstat[rq] = COMPLETED
                curreq[tid] = -1
        ready[tid] = new_ready
        if heap is not None:
            heapq.heappush(heap, (new_ready, tid))
        if p == NCS:
            opst[tid] = new_ready
        if p == SPIN_BUDGET and new_pc == SET_VICTIM_R:
            reacq += 1
        if p == PASS:
            npass += 1

    out = Replica(np.asarray(done, np.int64), np.asarray(lat, np.int64),
                  latn, max(ready), reacq, npass)
    if R:
        out = out._replace(arr=np.asarray(arr, np.int64),
                           wait=np.asarray(wq, np.int64),
                           sojourn=np.asarray(soj, np.int64),
                           rstat=np.asarray(rstat, np.int64))
    return out


def _peer_code(is_hl, is_alock, nd, mynode, rack):
    if is_hl:
        if nd == mynode:
            return OP_LOCAL
        return OP_LOOP if rack[nd] == rack[mynode] else OP_RDMA
    if nd == mynode:
        return OP_LOCAL if is_alock else OP_LOOP
    return OP_RDMA


def _catch_up(ready, active, ph, T):
    """The boundary of phase ``ph``: threads whose node comes back up move
    their clocks to the earliest of those that stayed up."""
    act, was = active[ph], active[max(ph - 1, 0)]
    cont = [ready[t] for t in range(T) if act[t] and was[t]]
    if not cont:
        cont = [ready[t] for t in range(T) if act[t]]
    now_min = min(cont) if cont else NEVER
    for t in range(T):
        if act[t] and not was[t]:
            ready[t] = max(ready[t], now_min)
