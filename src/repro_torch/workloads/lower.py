"""Lowering: declarative :class:`Workload` specs -> traced operand structs.

``lower()`` turns a spec into a :class:`WorkloadOperands` — plain arrays,
*all of them traced operands* of the event-loop engines:

  ========== ========== ===================================================
  field      shape      meaning
  ========== ========== ===================================================
  locality   (P, T) f32 per-phase per-thread P(target lock is local)
  zcdf       (P, kpn)   per-phase inclusive Zipf CDF of the within-node draw
  edges      (P,) i32   first event index of each phase (edges[0] == 0)
  think_ns   (P,) i32   per-phase think time between critical sections
  active     (P, T) i32 1 = schedulable; 0 = thread's node is down
  b_init     (P, 2) i32 per-phase (local, remote) ALock budgets
  cost_rows  (P, 8) i32 per-phase cost-model rows (CostModel.cost_rows)
  seed       () i32     replica PRNG seed
  node_mult  (P, N) f32 per-phase per-node fail-slow cost multipliers
  arr_gap_ns (P,) f32   per-phase mean Poisson inter-arrival gap (0 = none)
  arr_edges  (P,) i32   first *request* index of each phase
  arr_qcap   (P,) i32   per-phase wait-queue bound (INT32_MAX = unbounded)
  arr_token  (P, 2) f32 per-phase token bucket (refill/ns, burst)
  arr_fix    (R,) i32   deterministic base inter-arrival gaps (trace replay)
  rack       (N,) i32   per-node rack id (hlock cohort/cost tiers; the
                        default ``arange(N)`` — every node its own rack —
                        makes hlock degenerate to the flat ALock)
  read_frac  (P, T) f32 per-phase per-thread P(request is a read) —
                        branches the alock-rw dispatch only
  ========== ========== ===================================================

Only ``(alg, T, N, K, n_events, R)`` — plus the phase-count P via the
operand *shapes* — is static, so a sweep mixing scenarios (different
localities, skews, phase programs, cost profiles, budget programs) shares
one compiled executable per shape bucket; ``pad_phases`` extends any
replica to a bucket's max P with unreachable phases (``edges =
INT32_MAX``), which provably never alters the per-event phase selection.

Open-loop arrival streams (``Workload.arrivals``) lower to the ``arr_*``
rows; ``R`` is the static request-slot count (``arr_fix.shape[-1]``) and
``R == 0`` *is* the closed loop — the arrival rows collapse to zero-work
placeholders and the engines trace the identical closed-loop program
(bitwise inertness). A request's
phase is its *index* interval (``arr_edges``), mirroring how events map to
phases, so rate programs modulate the stream without any in-loop coupling.

Cost and budget *programs*: every phase row carries its own 8-entry cost
table (resolved through :func:`~repro_torch.core.cost_model.resolve_cost` from
the workload's / phase's ``cost`` field, defaulting to the sweep's
``CostModel``) and its own ``(local, remote)`` ALock budget pair (the
phase's ``b_init`` override, else the workload's). The engines index both
by the phase active at the event — a single-phase spec with default cost
lowers to exactly the rows ``sim.topology`` computed before profiles
existed, keeping that path bitwise-frozen.

``from_simconfig`` adapts the legacy flat ``SimConfig`` to a single-phase
``Workload`` bitwise-faithfully (same draws, costs, clocks).

>>> from repro_torch.workloads import Workload, Phase, lower
>>> w = Workload("alock", n_nodes=2, threads_per_node=2, n_locks=8,
...              phases=(Phase(frac=0.5),
...                      Phase(frac=0.5, cost="congested-nic",
...                            b_init=(2, 40))))
>>> lw = lower(w, n_events=1000)
>>> lw.operands.cost_rows.shape, lw.operands.b_init.shape
((2, 8), (2, 2))
>>> lw.operands.b_init.tolist()          # phase 0 inherits the workload
[[5, 20], [2, 40]]
>>> bool((lw.operands.cost_rows[1] >= lw.operands.cost_rows[0]).all())
True
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.cost_model import CostModel, N_COST_ROWS, resolve_cost
from repro_torch.workloads.spec import (Mixed, Phase, Workload,
                                        _check_think, resolve_node_mult)

_I32_MAX = np.iinfo(np.int32).max


class WorkloadOperands(NamedTuple):
    """The lowered, fully-traced workload (see module docstring for the
    per-field shapes). A flat tuple of leaves: ``batch.sweep`` stacks a
    leading replica axis B onto every leaf and the engines run batched
    over it. ``lower()`` emits numpy leaves; :func:`to_device` turns them
    into torch tensors of the same dtypes."""
    locality: Any   # (P, T) f32
    zcdf: Any       # (P, kpn) f32
    edges: Any      # (P,) i32
    think_ns: Any   # (P,) i32
    active: Any     # (P, T) i32
    b_init: Any     # (P, 2) i32
    seed: Any       # () i32
    cost_rows: Any  # (P, 8) i32
    node_mult: Any  # (P, N) f32
    arr_gap_ns: Any  # (P,) f32
    arr_edges: Any   # (P,) i32
    arr_qcap: Any    # (P,) i32
    arr_token: Any   # (P, 2) f32
    arr_fix: Any     # (R,) i32 — R == 0 means closed loop
    rack: Any        # (N,) i32 — per-node rack id (no phase axis)
    read_frac: Any   # (P, T) f32

    @property
    def n_phases(self) -> int:
        return self.edges.shape[-1]

    @property
    def n_requests(self) -> int:
        """Static request-slot count R (0 = closed loop)."""
        return self.arr_fix.shape[-1]


class Lowered(NamedTuple):
    """A spec bound to a run length: static shape info + operand arrays."""
    alg: str
    n_nodes: int
    threads_per_node: int
    n_locks: int
    n_events: int
    operands: WorkloadOperands      # numpy, no batch axis

    @property
    def n_threads(self) -> int:
        return self.n_nodes * self.threads_per_node

    @property
    def shape_key(self) -> tuple:
        """The static-argument tuple that determines a compile bucket."""
        return (self.alg, self.n_threads, self.n_nodes, self.n_locks,
                self.n_events, self.operands.n_requests)


def zipf_cdf(kpn: int, s: float) -> np.ndarray:
    """Inclusive CDF of a Zipf(s) draw over the ``kpn`` locks of one node.

    ``cdf[j] = P(lock_rank <= j)`` with ``P(rank j) ∝ (j+1)^-s``. Behavior
    notes the engines rely on:

      * ``s = 0`` is *exactly* the uniform workload in float32 —
        ``cdf[j] == float32((j+1)/kpn)`` bit for bit, so a zero-skew spec
        and the pre-Zipf engine draw identical locks;
      * the weights are normalized in float64 and only the cumulative sum
        is cast to float32, so ``cdf[-1] == 1.0`` exactly and the
        inverse-CDF draw can never walk past the last rank (the engines
        additionally clamp against the final-ulp case);
      * float32 so it can ride the traced batch axis next to ``locality``
        without recompiles.

    >>> zipf_cdf(4, 0.0).tolist()
    [0.25, 0.5, 0.75, 1.0]
    >>> float(zipf_cdf(8, 1.5)[-1])
    1.0
    """
    if kpn < 1:
        raise ValueError(f"need at least one lock per node, got kpn={kpn}")
    s = float(s)
    if not math.isfinite(s) or s < 0.0:
        raise ValueError(f"zipf skew must be finite and >= 0, got {s}")
    ranks = np.arange(1, kpn + 1, dtype=np.float64)
    w = ranks ** (-s)
    return np.cumsum(w / w.sum()).astype(np.float32)


def resolve_locality(loc, n_nodes: int, tpn: int) -> np.ndarray:
    """Scalar | (T,) tuple | Mixed -> the per-thread (T,) float32 vector."""
    T = n_nodes * tpn
    if isinstance(loc, Mixed):
        n_hot = int(round(loc.frac * tpn))
        row = np.full(tpn, np.float32(loc.rest))
        row[:n_hot] = np.float32(loc.local)
        return np.tile(row, n_nodes)
    if isinstance(loc, tuple):
        return np.asarray(loc, np.float32)
    return np.full(T, np.float32(loc))


def resolve_read_frac(rf, n_threads: int) -> np.ndarray:
    """Scalar | (T,) tuple -> the per-thread (T,) float32 read probability."""
    if isinstance(rf, tuple):
        return np.asarray(rf, np.float32)
    return np.full(n_threads, np.float32(rf))


def lower(w: Workload, n_events: int,
          cm: CostModel = CostModel()) -> Lowered:
    """Bind a spec to a run length and emit its traced operand struct.

    ``cm`` is the *sweep-level* cost model: the base every ``cost=None``
    workload/phase inherits. A workload-level ``cost`` replaces it for the
    whole run; a phase-level ``cost`` replaces it for that phase only.
    """
    N, tpn, K = w.n_nodes, w.threads_per_node, w.n_locks
    T = N * tpn
    if K % N != 0:
        raise ValueError(
            f"locks must partition evenly across nodes: n_locks={K} is not "
            f"a multiple of n_nodes={N} (got (n_locks, n_nodes)=({K}, {N}))")
    kpn = K // N
    phases = w.phases or (Phase(frac=1.0),)
    P = len(phases)
    base_cm = resolve_cost(w.cost, cm)

    arr = w.arrivals
    R = 0 if arr is None else arr.n_requests

    locality = np.empty((P, T), np.float32)
    zcdf = np.empty((P, kpn), np.float32)
    edges = np.empty(P, np.int32)
    think_ns = np.empty(P, np.int32)
    active = np.ones((P, T), np.int32)
    b_init = np.empty((P, 2), np.int32)
    cost_rows = np.empty((P, N_COST_ROWS), np.int32)
    node_mult = np.empty((P, N), np.float32)
    arr_gap_ns = np.zeros(P, np.float32)
    arr_edges = np.zeros(P, np.int32)
    arr_qcap = np.full(P, _I32_MAX, np.int32)
    arr_token = np.zeros((P, 2), np.float32)
    read_frac = np.empty((P, T), np.float32)
    # trivial default (every node its own rack): same-rack == same-node,
    # under which hlock is bitwise the flat ALock
    rack = (np.arange(N, dtype=np.int32) if w.topology is None
            else np.asarray(w.topology, np.int32))
    cum = 0.0
    for p, ph in enumerate(phases):
        edges[p] = int(round(cum * n_events))
        if arr is not None:
            # request index intervals mirror the event-phase mapping: the
            # phase's fraction of the run is its fraction of the stream
            arr_edges[p] = int(round(cum * R))
            rate = arr.rate_per_us if ph.rate_per_us is None \
                else ph.rate_per_us
            arr_gap_ns[p] = np.float32(1000.0 / rate) if rate > 0.0 else 0.0
            if arr.queue_cap is not None:
                arr_qcap[p] = arr.queue_cap
            if arr.token_rate_per_us > 0.0:
                arr_token[p] = (np.float32(arr.token_rate_per_us / 1000.0),
                                np.float32(arr.token_burst))
        cum += ph.frac
        loc = w.locality if ph.locality is None else ph.locality
        locality[p] = resolve_locality(loc, N, tpn)
        zs = w.zipf_s if ph.zipf_s is None else ph.zipf_s
        zcdf[p] = zipf_cdf(kpn, zs)
        cm_p = resolve_cost(ph.cost, base_cm)
        cost_rows[p] = cm_p.cost_rows(w.alg, N, tpn)
        b_init[p] = w.b_init if ph.b_init is None else ph.b_init
        mult = _check_think(w.think if ph.think is None else ph.think)
        # mult == 1.0 reproduces topology()'s c_think integer exactly —
        # the SimConfig adapter's bitwise contract rests on this
        think_ns[p] = int(round(mult * cm_p.think_ns))
        node_mult[p] = resolve_node_mult(
            w.node_mult if ph.node_mult is None else ph.node_mult, N)
        read_frac[p] = resolve_read_frac(
            w.read_frac if ph.read_frac is None else ph.read_frac, T)
        for node in ph.down_nodes:
            active[p, node * tpn:(node + 1) * tpn] = 0
    edges[0] = 0
    if arr is not None:
        arr_edges[0] = 0
    if arr is None:
        arr_fix = np.zeros(0, np.int32)
    elif arr.trace_ns:
        # absolute recorded times -> per-request base gaps (the additive
        # form lets a trace carry optional Poisson jitter on top)
        ts = np.asarray(arr.trace_ns, np.int64)
        gaps = np.diff(ts, prepend=0)
        if (gaps > _I32_MAX).any():
            raise ValueError("trace_ns inter-arrival gap overflows int32 ns")
        arr_fix = gaps.astype(np.int32)
    else:
        arr_fix = np.zeros(R, np.int32)
    if P == 1 and (active == 0).any():
        # the engines take a fast path (no phase/active machinery) for
        # single-phase operands, which is only sound when every thread is
        # schedulable — split a masked single phase into two identical
        # halves so the invariant "P == 1 implies all-active" holds by
        # construction (semantically identical: same mask both halves,
        # the boundary rejoin is a no-op)
        P = 2
        locality = np.repeat(locality, 2, axis=0)
        zcdf = np.repeat(zcdf, 2, axis=0)
        think_ns = np.repeat(think_ns, 2, axis=0)
        active = np.repeat(active, 2, axis=0)
        b_init = np.repeat(b_init, 2, axis=0)
        cost_rows = np.repeat(cost_rows, 2, axis=0)
        node_mult = np.repeat(node_mult, 2, axis=0)
        edges = np.asarray([0, n_events // 2], np.int32)
        arr_gap_ns = np.repeat(arr_gap_ns, 2, axis=0)
        arr_qcap = np.repeat(arr_qcap, 2, axis=0)
        arr_token = np.repeat(arr_token, 2, axis=0)
        arr_edges = np.asarray([0, R // 2], np.int32)
        read_frac = np.repeat(read_frac, 2, axis=0)
    if P > 1 and np.any(np.diff(edges) <= 0):
        # a zero-event phase would silently vanish AND misdirect the
        # rejoin bump at its boundary (was_act would read the dropped
        # phase's mask) — reject instead
        raise ValueError(
            f"phase program collapses at n_events={n_events}: edges "
            f"{edges.tolist()} are not strictly increasing (every phase "
            f"needs at least one event — raise n_events or merge phases)")

    ops = WorkloadOperands(
        locality=locality, zcdf=zcdf, edges=edges, think_ns=think_ns,
        active=active, b_init=b_init, seed=np.int32(w.seed),
        cost_rows=cost_rows, node_mult=node_mult,
        arr_gap_ns=arr_gap_ns, arr_edges=arr_edges, arr_qcap=arr_qcap,
        arr_token=arr_token, arr_fix=arr_fix, rack=rack,
        read_frac=read_frac)
    return Lowered(w.alg, N, tpn, K, int(n_events), ops)


def pad_phases(ops: WorkloadOperands, n_phases: int) -> WorkloadOperands:
    """Extend a replica's operands to ``n_phases`` with unreachable phases.

    Padded phases start at ``INT32_MAX`` (past any event index), so the
    per-event selection ``phase = sum(i >= edges) - 1`` is bitwise
    unchanged; their payload rows — locality, CDFs, think, active mask,
    budgets, cost rows, node multipliers — just duplicate the last real
    phase. Inertness of
    the cost/budget rows is load-bearing for one-compile-per-bucket
    sweeps and is asserted engine-level in the tests.
    """
    P = ops.n_phases
    if P == n_phases:
        return ops
    if P > n_phases:
        raise ValueError(f"cannot shrink {P} phases to {n_phases}")
    extra = n_phases - P

    def rep(a):
        return np.concatenate([a, np.repeat(a[-1:], extra, axis=0)], axis=0)

    return ops._replace(
        locality=rep(ops.locality), zcdf=rep(ops.zcdf),
        edges=np.concatenate([ops.edges,
                              np.full(extra, _I32_MAX, np.int32)]),
        think_ns=rep(ops.think_ns), active=rep(ops.active),
        b_init=rep(ops.b_init), cost_rows=rep(ops.cost_rows),
        node_mult=rep(ops.node_mult),
        # padded phases own no request-index interval, so their arrival
        # rows are unreachable by construction (arr_edges = INT32_MAX >
        # any request index); arr_fix is per-request, not per-phase
        arr_gap_ns=rep(ops.arr_gap_ns),
        arr_edges=np.concatenate([ops.arr_edges,
                                  np.full(extra, _I32_MAX, np.int32)]),
        arr_qcap=rep(ops.arr_qcap), arr_token=rep(ops.arr_token),
        # rack has no phase axis — pad-inert by construction
        read_frac=rep(ops.read_frac))


def from_simconfig(cfg) -> Workload:
    """Adapt a legacy flat ``SimConfig`` to a single-phase :class:`Workload`.

    .. deprecated::
        ``SimConfig`` is kept only as a compatibility front door;
        new code should construct :class:`Workload` (and
        ``repro_torch.experiments.Experiment``) directly. Per-seed results
        through this adapter are bitwise-equal to the pre-spec engine
        on both backends.
    """
    return Workload(
        alg=cfg.alg, n_nodes=cfg.n_nodes,
        threads_per_node=cfg.threads_per_node, n_locks=cfg.n_locks,
        locality=float(cfg.locality), zipf_s=float(cfg.zipf_s),
        b_init=tuple(cfg.b_init), seed=int(cfg.seed))


def as_workload(obj) -> Workload:
    """Coerce Workload | SimConfig-shaped NamedTuple -> Workload."""
    if isinstance(obj, Workload):
        return obj
    if hasattr(obj, "_fields") and hasattr(obj, "locality"):
        return from_simconfig(obj)
    raise TypeError(f"expected Workload or SimConfig, got {type(obj)!r}")


#: numpy dtype of every ``WorkloadOperands`` leaf, in field order — the
#: engines' operand contract (the reference lowers to exactly these)
OPERAND_DTYPES = {
    "locality": np.float32, "zcdf": np.float32, "edges": np.int32,
    "think_ns": np.int32, "active": np.int32, "b_init": np.int32,
    "seed": np.int32, "cost_rows": np.int32, "node_mult": np.float32,
    "arr_gap_ns": np.float32, "arr_edges": np.int32, "arr_qcap": np.int32,
    "arr_token": np.float32, "arr_fix": np.int32, "rack": np.int32,
    "read_frac": np.float32,
}


def to_device(ops: WorkloadOperands, device) -> WorkloadOperands:
    """Numpy (or tensor) leaves -> contiguous torch tensors on ``device``,
    each with its ``OPERAND_DTYPES`` dtype. Works with or without a
    leading replica axis."""
    out = []
    for name, leaf in zip(WorkloadOperands._fields, ops):
        if not isinstance(leaf, torch.Tensor):
            # a fresh writable copy: torch refuses to wrap read-only arrays
            leaf = torch.from_numpy(np.array(leaf, OPERAND_DTYPES[name]))
        want = torch.from_numpy(np.empty(0, OPERAND_DTYPES[name])).dtype
        out.append(leaf.to(device=device, dtype=want).contiguous())
    return WorkloadOperands(*out)


def operands_from_numpy(fields, device) -> WorkloadOperands:
    """Adopt operands lowered elsewhere: ``fields`` is the 16 leaves as
    numpy arrays — a dict keyed by field name or a tuple in field order,
    with or without a leading replica axis — and the result is a
    ``WorkloadOperands`` of torch tensors on ``device``, dtype for dtype.
    A leaf whose dtype differs from the operand contract is refused rather
    than cast, so a drifted lowering cannot hide behind a conversion."""
    names = WorkloadOperands._fields
    if isinstance(fields, dict):
        missing = [n for n in names if n not in fields]
        if missing or len(fields) != len(names):
            raise ValueError(f"operands need exactly the fields {names}; "
                             f"missing {missing}, got {sorted(fields)}")
        leaves = [fields[n] for n in names]
    else:
        leaves = list(fields)
        if len(leaves) != len(names):
            raise ValueError(f"operands need {len(names)} leaves in the "
                             f"order {names}, got {len(leaves)}")
    arrs = []
    for n, leaf in zip(names, leaves):
        a = np.asarray(leaf)
        if a.dtype != OPERAND_DTYPES[n]:
            raise TypeError(f"operand {n!r} must be "
                            f"{np.dtype(OPERAND_DTYPES[n]).name}, got "
                            f"{a.dtype.name}")
        arrs.append(a)
    return to_device(WorkloadOperands(*arrs), device)
