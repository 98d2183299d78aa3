"""Declarative workload specs for the lock-table simulator.

A :class:`Workload` describes *what the threads do* — per-thread (not
per-run) behavior — independently of how it is executed:

  * **locality** — ``P(target lock is on own node)`` as a scalar, a
    per-thread ``(T,)`` vector, or a named :func:`mixed` split (a fraction
    of each node's threads runs mostly-local, the rest mostly-remote);
  * **zipf_s** — Zipf skew of the within-node lock choice (hot keys);
  * **think** — think-time class between critical sections, either a named
    class from :data:`THINK_CLASSES` or a float multiplier of the cost
    model's ``think_ns``;
  * **cost** — the RDMA cost model the run executes under: ``None`` for
    the sweep default, a named :data:`~repro_torch.core.cost_model.COST_PROFILES`
    entry (``"congested-nic"``, ``"idle-nic"``), an explicit
    :class:`~repro_torch.core.cost_model.CostModel`, or a field-override mapping
    (``{"rnic_svc_ns": 900.0}``). Lowered to per-phase traced cost rows —
    swapping profiles never adds a compile;
  * **b_init** — the ALock ``(local, remote)`` lease budgets;
  * **phases** — piecewise regimes over the event axis (:class:`Phase`):
    each phase covers a fraction of the run and may override locality /
    skew / think / **cost** / **b_init** and take whole nodes down
    (``down_nodes`` — node join/leave churn). Threads of a downed node
    are simply never scheduled while the phase lasts. Per-phase ``cost``
    and ``b_init`` make the cost table and the budget *programs* over the
    run — e.g. a mid-run NIC-congestion burst, or a budget ramp.

  * **node_mult** — per-node fail-slow degradation: a multiplier applied
    to every cost the node *performs* (its local/poll/cs/think work and
    the RNIC service + wire of RDMA ops it serves). ``None`` means a
    uniform healthy cluster; a :data:`NODE_MULT_PROFILES` name or a
    ``{node: mult}`` mapping degrades specific nodes (the "limplock"
    effect — one slow NIC/CPU dragging the system). Per-phase overrides
    make degradation a *program* over the run (fail-slow cascades).
    Lowered to a traced ``(P, N)`` operand — swapping degradation
    patterns never adds a compile.

Specs are frozen and hashable, so they key result dicts the way the old
``SimConfig`` NamedTuple did. Execution knobs (events, seeds, backend,
devices) intentionally live elsewhere: ``repro_torch.experiments`` composes
``Workload x seeds x ExecOptions`` into batched sweeps, and
``repro_torch.workloads.lower`` turns a spec into the traced operand struct the
engines consume.

>>> w = Workload("alock", n_nodes=2, threads_per_node=2, n_locks=8,
...              b_init=(5, 20),
...              phases=(Phase(frac=0.5),
...                      Phase(frac=0.5, cost="congested-nic",
...                            b_init=(1, 1))))
>>> w.n_threads, w.n_phases
(4, 2)
>>> w == w.replace() and w != w.replace(seed=1)
True
>>> Workload("alock", 2, 2, 8, cost={"rnic_svc_ns": 900.0}).cost
(('rnic_svc_ns', 900.0),)
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from repro_torch.core.cost_model import freeze_cost

ALGS = ("alock", "spinlock", "mcs", "hlock", "alock-rw")

# Named think-time classes: multipliers of CostModel.think_ns. "default"
# is exactly the cost model's value (1.0), which the SimConfig adapter
# relies on for bitwise equality with the pre-spec front door.
THINK_CLASSES = {
    "none": 0.0,
    "short": 0.25,
    "default": 1.0,
    "long": 4.0,
}


def _check_prob(p, what: str) -> float:
    p = float(p)
    if not math.isfinite(p) or not 0.0 <= p <= 1.0:
        raise ValueError(f"{what} must be a probability in [0, 1], got {p}")
    return p


@dataclass(frozen=True)
class Mixed:
    """Per-node locality split: ``frac`` of each node's threads run at
    ``P(local) = local``, the remainder at ``P(local) = rest``."""
    local: float
    frac: float
    rest: float

    def __post_init__(self):
        _check_prob(self.local, "mixed(local=...)")
        _check_prob(self.frac, "mixed(frac=...)")
        _check_prob(self.rest, "mixed(rest=...)")


def mixed(local: float = 0.9, frac: float = 0.5, rest: float = 0.0) -> Mixed:
    """A named per-thread locality mix, e.g. ``mixed(local=0.9, frac=0.5)``:
    half of each node's threads target their own node 90% of the time, the
    other half is fully remote (``rest=0.0``)."""
    return Mixed(float(local), float(frac), float(rest))


def _freeze_locality(loc):
    """Scalar | (T,) sequence | Mixed -> hashable canonical form."""
    if isinstance(loc, Mixed):
        return loc
    if isinstance(loc, (tuple, list)):
        return tuple(_check_prob(v, "locality[t]") for v in loc)
    return _check_prob(loc, "locality")


def _freeze_read_frac(rf, what: str = "read_frac"):
    """Scalar | (T,) sequence | None -> hashable canonical form. The
    probability a request is a *read* — only the reader-writer machine
    (``alock-rw``) branches on it; write-only machines ignore it, so a
    leaderboard can hand every algorithm the same spec."""
    if rf is None:
        return None
    if isinstance(rf, (tuple, list)):
        return tuple(_check_prob(v, f"{what}[t]") for v in rf)
    return _check_prob(rf, what)


def freeze_topology(topo):
    """Validate + canonicalize a ``topology`` value (per-node rack ids).

    ``None`` means the trivial topology — every node its own rack — under
    which ``hlock`` degenerates to the flat two-cohort ALock (same-node =
    same-rack). A sequence gives one rack id per node; ids only need to
    be ``>= 0`` (equality is all the cohort test uses).
    """
    if topo is None:
        return None
    t = tuple(int(r) for r in topo)
    bad = [r for r in t if r < 0]
    if bad:
        raise ValueError(f"topology rack ids must be >= 0, got {bad}")
    return t


def racks_of(n_nodes: int, n_racks: int) -> tuple:
    """Evenly partition ``n_nodes`` into ``n_racks`` contiguous racks —
    the common cookbook shape for :attr:`Workload.topology`.

    >>> racks_of(8, 2)
    (0, 0, 0, 0, 1, 1, 1, 1)
    >>> racks_of(6, 4)
    (0, 0, 1, 1, 2, 3)
    """
    n_nodes, n_racks = int(n_nodes), int(n_racks)
    if not 1 <= n_racks <= n_nodes:
        raise ValueError(f"n_racks must be in [1, {n_nodes}], got {n_racks}")
    per, extra = divmod(n_nodes, n_racks)
    out = []
    for r in range(n_racks):
        out += [r] * (per + (1 if r < extra else 0))
    return tuple(out)


# Named fail-slow degradation profiles: {node: multiplier} patterns a
# Workload/Phase ``node_mult`` field can name instead of spelling out.
# 4x is the canonical "limping" severity — the limplock literature's
# cascading-slowdown regime sits between 3x and 10x single-node drag.
NODE_MULT_PROFILES: dict[str, dict[int, float]] = {
    "healthy": {},
    "limp-node0-2x": {0: 2.0},
    "limp-node0-4x": {0: 4.0},
}


def freeze_node_mult(nm):
    """Validate + canonicalize a ``node_mult`` value to its frozen form.

    ``None`` (uniform) and :data:`NODE_MULT_PROFILES` names pass through;
    a ``{node: mult}`` mapping (or pair iterable) becomes a sorted tuple
    of ``(node, mult)`` pairs. Multipliers must be finite and > 0 —
    a *dead* node is ``Phase.down_nodes``, not an infinite multiplier.
    """
    if nm is None:
        return None
    if isinstance(nm, str):
        if nm not in NODE_MULT_PROFILES:
            raise ValueError(f"unknown node_mult profile {nm!r}; "
                             f"registered: {sorted(NODE_MULT_PROFILES)}")
        return nm
    if isinstance(nm, dict):
        nm = tuple(sorted(nm.items()))
    if isinstance(nm, (tuple, list)):
        out = []
        for pair in nm:
            n, m = pair
            n, m = int(n), float(m)
            if n < 0:
                raise ValueError(f"node_mult node ids must be >= 0, got {n}")
            if not math.isfinite(m) or m <= 0.0:
                raise ValueError(f"node_mult multipliers must be finite "
                                 f"and > 0, got {m} for node {n}")
            out.append((n, m))
        if len({n for n, _ in out}) != len(out):
            raise ValueError("duplicate node ids in node_mult")
        return tuple(sorted(out))
    raise TypeError(f"node_mult must be None, a profile name, or a "
                    f"{{node: mult}} mapping, got {type(nm)!r}")


def node_mult_pairs(nm) -> tuple:
    """A ``node_mult`` value (raw or frozen) -> concrete ``(node, mult)``
    pairs (profile names resolved). ``None`` -> ``()``."""
    nm = freeze_node_mult(nm)
    if nm is None:
        return ()
    if isinstance(nm, str):
        return tuple(sorted(NODE_MULT_PROFILES[nm].items()))
    return nm


def resolve_node_mult(nm, n_nodes: int) -> tuple:
    """Frozen ``node_mult`` -> a dense ``(n_nodes,)`` multiplier tuple
    (1.0 everywhere a pair does not override) — the lowering's per-phase
    row of the traced ``(P, N)`` operand."""
    row = [1.0] * n_nodes
    for n, m in node_mult_pairs(nm):
        row[n] = m
    return tuple(row)


@dataclass(frozen=True)
class Arrivals:
    """Open-loop arrival stream: requests arrive, queue, acquire once and
    depart — instead of the closed loop's fixed thread pool re-acquiring
    forever (see ``docs/serving.md``).

    The stream is the *sum* of a deterministic base trace and a Poisson
    jitter term, which unifies the three spec shapes:

      * ``rate_per_us > 0`` with an empty trace — a Poisson process at the
        offered rate (phase-modulated via :attr:`Phase.rate_per_us`);
      * ``trace_ns`` non-empty with ``rate_per_us == 0`` — exact
        deterministic replay of recorded arrival times;
      * both — replay with Poisson-distributed per-request jitter.

    ``max_requests`` is the static request-slot count ``R`` (a shape, so
    it keys the compile bucket); a non-empty trace pins ``R`` to its
    length. Two admission policies lower to traced operands:
    ``queue_cap`` bounds the wait queue (tail drop, counted), and
    ``token_rate_per_us``/``token_burst`` gate admission through a token
    bucket (debit-on-arrival; a request entering with no token is
    dropped). ``None``/``0.0`` disables each policy.

    >>> Arrivals(rate_per_us=2.0, max_requests=64).n_requests
    64
    >>> Arrivals(trace_ns=(0, 500, 900)).n_requests
    3
    """
    rate_per_us: float = 0.0
    max_requests: int = 256
    trace_ns: tuple = ()
    queue_cap: int | None = None
    token_rate_per_us: float = 0.0
    token_burst: float = 8.0

    def __post_init__(self):
        r = float(self.rate_per_us)
        if not math.isfinite(r) or r < 0.0:
            raise ValueError(f"rate_per_us must be finite and >= 0, got {r}")
        object.__setattr__(self, "rate_per_us", r)
        mr = int(self.max_requests)
        if mr < 1:
            raise ValueError(f"max_requests must be >= 1, got {mr}")
        object.__setattr__(self, "max_requests", mr)
        tr = tuple(int(t) for t in self.trace_ns)
        if any(t < 0 for t in tr):
            raise ValueError("trace_ns times must be >= 0")
        if any(b < a for a, b in zip(tr, tr[1:])):
            raise ValueError("trace_ns must be non-decreasing")
        object.__setattr__(self, "trace_ns", tr)
        if r == 0.0 and not tr:
            raise ValueError("Arrivals needs rate_per_us > 0 or a trace_ns")
        if self.queue_cap is not None:
            qc = int(self.queue_cap)
            if qc < 0:
                raise ValueError(f"queue_cap must be >= 0, got {qc}")
            object.__setattr__(self, "queue_cap", qc)
        tkr = float(self.token_rate_per_us)
        if not math.isfinite(tkr) or tkr < 0.0:
            raise ValueError(
                f"token_rate_per_us must be finite and >= 0, got {tkr}")
        object.__setattr__(self, "token_rate_per_us", tkr)
        tkb = float(self.token_burst)
        if not math.isfinite(tkb) or tkb < 1.0:
            raise ValueError(f"token_burst must be >= 1, got {tkb}")
        object.__setattr__(self, "token_burst", tkb)

    @property
    def n_requests(self) -> int:
        """The static request-slot count ``R`` (trace length wins)."""
        return len(self.trace_ns) if self.trace_ns else self.max_requests


@dataclass(frozen=True)
class Phase:
    """One piecewise regime over the event axis.

    ``frac`` is the fraction of the run's events this phase covers (phase
    fractions must sum to 1). ``None`` overrides inherit the workload's
    base value. ``down_nodes`` lists node ids whose threads are parked
    (never scheduled) for the duration — node leave/join churn; at least
    one node must stay up. ``cost`` swaps the RDMA cost table for the
    phase (profile name / CostModel / field overrides — see
    :func:`~repro_torch.core.cost_model.resolve_cost`); ``b_init`` re-programs
    the ALock ``(local, remote)`` budgets: acquisitions arming while the
    phase is live use the phase's budgets (the handoff is per-arm, not
    retroactive — a budget granted in phase *p* is spent down even after
    the boundary, until its holder re-arms); ``node_mult`` swaps the
    per-node fail-slow multipliers for the phase (degradation programs —
    a limp that spreads node-to-node across phases).
    """
    frac: float
    locality: object = None          # scalar | (T,) tuple | Mixed | None
    zipf_s: float | None = None
    think: object = None             # THINK_CLASSES name | float | None
    down_nodes: tuple = ()
    cost: object = None              # COST_PROFILES name | CostModel |
    #                                  override mapping | None (inherit)
    b_init: tuple | None = None      # (local, remote) | None (inherit)
    node_mult: object = None         # NODE_MULT_PROFILES name |
    #                                  {node: mult} mapping | None (inherit)
    rate_per_us: float | None = None  # open-loop arrival rate override
    #                                   (needs Workload.arrivals) | inherit
    read_frac: object = None         # scalar | (T,) tuple | None (inherit)
    #                                  P(request is a read) — alock-rw only

    def __post_init__(self):
        f = float(self.frac)
        if not math.isfinite(f) or f <= 0.0 or f > 1.0:
            raise ValueError(f"Phase.frac must be in (0, 1], got {self.frac}")
        object.__setattr__(self, "frac", f)
        object.__setattr__(self, "read_frac",
                           _freeze_read_frac(self.read_frac,
                                             "Phase.read_frac"))
        if self.rate_per_us is not None:
            r = float(self.rate_per_us)
            if not math.isfinite(r) or r < 0.0:
                raise ValueError(
                    f"Phase.rate_per_us must be finite and >= 0, got {r}")
            object.__setattr__(self, "rate_per_us", r)
        if self.locality is not None:
            object.__setattr__(self, "locality",
                               _freeze_locality(self.locality))
        object.__setattr__(self, "down_nodes",
                           tuple(int(n) for n in self.down_nodes))
        object.__setattr__(self, "cost", freeze_cost(self.cost))
        if self.b_init is not None:
            object.__setattr__(self, "b_init", _check_b_init(self.b_init))
        object.__setattr__(self, "node_mult",
                           freeze_node_mult(self.node_mult))


@dataclass(frozen=True)
class Workload:
    """Declarative simulator workload: topology + per-thread behavior.

    The spec is purely descriptive. ``repro_torch.workloads.lower.lower`` turns
    it into the batched traced-operand struct (``WorkloadOperands``) that
    ``core/sim.py``, ``core/batch.py`` and ``kernels/event_loop`` consume,
    so sweeps mixing arbitrary localities / skews / phase programs share
    one compiled executable per ``(alg, T, N, K, n_events)`` shape bucket.
    """
    alg: str
    n_nodes: int
    threads_per_node: int
    n_locks: int
    locality: object = 1.0           # scalar | (T,) tuple | Mixed
    zipf_s: float = 0.0
    think: object = "default"        # THINK_CLASSES name | float multiplier
    b_init: tuple = (5, 20)          # (local, remote) budgets
    seed: int = 0
    phases: tuple = ()               # tuple[Phase, ...]
    cost: object = None              # COST_PROFILES name | CostModel |
    #                                  override mapping | None (sweep default)
    node_mult: object = None         # NODE_MULT_PROFILES name |
    #                                  {node: mult} mapping | None (uniform)
    arrivals: Arrivals | None = None  # open-loop request stream | None
    #                                   (closed loop — threads re-acquire)
    topology: tuple | None = None    # per-node rack ids (n_nodes,) | None
    #                                  (trivial: every node its own rack).
    #                                  Drives hlock's cohort test + cost
    #                                  tiers; inert for the flat machines.
    read_frac: object = 0.0          # scalar | (T,) tuple — P(read);
    #                                  branches alock-rw only, inert
    #                                  elsewhere (leaderboards share specs)

    def __post_init__(self):
        if self.alg not in ALGS:
            raise ValueError(f"alg must be one of {ALGS}, got {self.alg!r}")
        for name in ("n_nodes", "threads_per_node", "n_locks"):
            v = int(getattr(self, name))
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
            object.__setattr__(self, name, v)
        object.__setattr__(self, "locality", _freeze_locality(self.locality))
        zs = float(self.zipf_s)
        if not math.isfinite(zs) or zs < 0.0:
            raise ValueError(
                f"zipf_s must be finite and >= 0, got {self.zipf_s}")
        object.__setattr__(self, "zipf_s", zs)
        _check_think(self.think)
        object.__setattr__(self, "b_init", _check_b_init(self.b_init))
        object.__setattr__(self, "cost", freeze_cost(self.cost))
        object.__setattr__(self, "node_mult",
                           freeze_node_mult(self.node_mult))
        object.__setattr__(self, "seed", int(self.seed))
        topo = freeze_topology(self.topology)
        if topo is not None and len(topo) != self.n_nodes:
            raise ValueError(f"topology needs one rack id per node "
                             f"({self.n_nodes}), got {len(topo)}")
        object.__setattr__(self, "topology", topo)
        rf = _freeze_read_frac(self.read_frac)
        if rf is None:
            rf = 0.0
        object.__setattr__(self, "read_frac", rf)
        phases = tuple(self.phases)
        if phases:
            if not all(isinstance(p, Phase) for p in phases):
                raise ValueError("phases must be Phase instances")
            tot = sum(p.frac for p in phases)
            if abs(tot - 1.0) > 1e-6:
                raise ValueError(
                    f"phase fractions must sum to 1, got {tot:g}")
            for p in phases:
                bad = [n for n in p.down_nodes
                       if not 0 <= n < self.n_nodes]
                if bad:
                    raise ValueError(f"down_nodes {bad} outside "
                                     f"[0, {self.n_nodes})")
                if len(set(p.down_nodes)) >= self.n_nodes:
                    raise ValueError("a phase cannot take every node down")
        object.__setattr__(self, "phases", phases)
        if isinstance(self.locality, tuple) and \
                len(self.locality) != self.n_threads:
            raise ValueError(
                f"per-thread locality needs {self.n_threads} entries, "
                f"got {len(self.locality)}")
        for p in phases:
            if isinstance(p.locality, tuple) and \
                    len(p.locality) != self.n_threads:
                raise ValueError(
                    f"phase per-thread locality needs {self.n_threads} "
                    f"entries, got {len(p.locality)}")
        if isinstance(self.read_frac, tuple) and \
                len(self.read_frac) != self.n_threads:
            raise ValueError(
                f"per-thread read_frac needs {self.n_threads} entries, "
                f"got {len(self.read_frac)}")
        for p in phases:
            if isinstance(p.read_frac, tuple) and \
                    len(p.read_frac) != self.n_threads:
                raise ValueError(
                    f"phase per-thread read_frac needs {self.n_threads} "
                    f"entries, got {len(p.read_frac)}")
        # node_mult node ids are validated here (not in Phase) because
        # only the workload knows the topology — same split as down_nodes
        for what, nm in [("node_mult", self.node_mult)] + \
                [(f"phases[{i}].node_mult", p.node_mult)
                 for i, p in enumerate(phases)]:
            bad = [n for n, _ in node_mult_pairs(nm)
                   if not 0 <= n < self.n_nodes]
            if bad:
                raise ValueError(f"{what} node ids {bad} outside "
                                 f"[0, {self.n_nodes})")
        if self.arrivals is not None and \
                not isinstance(self.arrivals, Arrivals):
            raise TypeError(f"arrivals must be an Arrivals or None, "
                            f"got {type(self.arrivals)!r}")
        if self.arrivals is None:
            bad_ph = [i for i, p in enumerate(phases)
                      if p.rate_per_us is not None]
            if bad_ph:
                raise ValueError(
                    f"phases {bad_ph} set rate_per_us but the workload has "
                    f"no arrivals= stream (closed loop has no rate)")

    @property
    def n_threads(self) -> int:
        return self.n_nodes * self.threads_per_node

    @property
    def n_phases(self) -> int:
        return max(1, len(self.phases))

    def replace(self, **kw) -> "Workload":
        """A copy with fields replaced (phases/locality re-validated)."""
        return dataclasses.replace(self, **kw)


def _check_b_init(b) -> tuple:
    """Validate a (local, remote) ALock budget pair."""
    bi = tuple(int(v) for v in b)
    if len(bi) != 2:
        raise ValueError(f"b_init must be (local, remote), got {bi}")
    if any(v < 0 for v in bi):
        raise ValueError(f"b_init budgets must be >= 0, got {bi}")
    return bi


def _check_think(think) -> float:
    """Resolve a think class/multiplier to its float multiplier."""
    if isinstance(think, str):
        if think not in THINK_CLASSES:
            raise ValueError(f"unknown think class {think!r}; pick from "
                             f"{sorted(THINK_CLASSES)} or pass a float")
        return THINK_CLASSES[think]
    m = float(think)
    if not math.isfinite(m) or m < 0.0:
        raise ValueError(f"think multiplier must be finite and >= 0, got {m}")
    return m
