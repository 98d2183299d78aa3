"""Scenario registry: named, self-contained workload programs.

A *scenario* is a named function that builds and runs a workload program —
an :class:`~repro_torch.experiments.experiment.Experiment` over the
simulator, or a threaded coordination-plane stress — and returns CSV-able
rows. The registry is the one entry point of named runs: every registered
name is runnable with nothing but ``(n_seeds, n_events, options)``, with
the specs, labels and rows of the reference registry.

Rows are dicts with at least ``name`` / ``us_per_call`` / ``derived``
(the benchmark suite's CSV columns); simulator rows additionally carry
``p99_lat_ns`` / ``mean_mops``; open-loop scenarios add serving rows
(goodput, drop rate, sojourn percentiles) and saturation knees.

A scenario may declare an :class:`~repro_torch.experiments.slo.Slo` — a
latency/throughput contract :func:`~repro_torch.experiments.slo.check_slo`
evaluates against its rows.

The coordination-plane scenario ``coord-stress`` stays registered, so the
name list equals the reference's, but raises ``NotImplementedError``: the
threaded coordination plane (``coord/``) is ROADMAP Queue A item A9.

>>> from repro_torch.experiments.registry import (scenario_names,
...                                               scenario_workloads)
>>> len(scenario_names()), len(scenario_workloads("open-loop-ramp"))
(14, 18)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.experiments.experiment import Experiment
from repro_torch.experiments.options import ExecOptions
from repro_torch.experiments.slo import Slo
from repro_torch.traffic.metrics import detect_knee
from repro_torch.workloads import (Arrivals, Phase, Workload, mixed,
                                   racks_of, resolve_node_mult)

COORD_MSG = (
    "the coordination-plane stress (coord/service.py, coord/stress.py) is "
    "not ported yet — ROADMAP Queue A, item A9")

_SCENARIOS: dict[str, "Scenario"] = {}


@dataclass(frozen=True)
class Scenario:
    name: str
    summary: str
    fn: Callable
    slo: Slo | None = None
    #: for simulator scenarios: a zero-arg callable returning the exact
    #: ``Workload`` specs the scenario sweeps. None for non-simulator
    #: scenarios (coord-stress drives the threaded coordination plane).
    workloads: Callable | None = None


def scenario(name: str, summary: str, slo: Slo | None = None,
             workloads: Callable | None = None):
    """Register ``fn(n_seeds, n_events, options) -> list[dict]``, with an
    optional :class:`Slo` the ``--check-slo`` gate enforces and an
    optional ``workloads()`` builder exposing the swept specs."""
    def deco(fn):
        if name in _SCENARIOS:
            raise ValueError(f"scenario {name!r} already registered")
        _SCENARIOS[name] = Scenario(name, summary, fn, slo, workloads)
        return fn
    return deco


def scenario_workloads(name: str):
    """The ``Workload`` specs a simulator scenario sweeps (None when the
    scenario does not drive the event simulator)."""
    sc = get_scenario(name)
    return None if sc.workloads is None else list(sc.workloads())


def scenario_names() -> list[str]:
    return sorted(_SCENARIOS)


def get_scenario(name: str) -> Scenario:
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; registered: "
                         f"{scenario_names()}") from None


def run_scenario(name: str, n_seeds: int = 1, n_events: int = 150_000,
                 options: ExecOptions = ExecOptions()) -> list[dict]:
    return get_scenario(name).fn(n_seeds, n_events, options)


# ---------------------------------------------------------------------------
# built-ins

# the common mid-size topology the sim scenarios share: one shape bucket
# per algorithm no matter how phases / localities / skews vary
_BASE = Workload("alock", n_nodes=4, threads_per_node=4, n_locks=16,
                 locality=0.95)


def _phase_mults(w: Workload) -> list[tuple]:
    """Dense per-phase ``(n_nodes,)`` multiplier rows of a spec."""
    base = w.node_mult
    phases = w.phases or (Phase(frac=1.0),)
    return [resolve_node_mult(p.node_mult if p.node_mult is not None
                              else base, w.n_nodes) for p in phases]


def _rows(result) -> list[dict]:
    out = []
    for lbl, w, br in result:
        out.append({
            "name": lbl, "us_per_call": br.mean_lat_us,
            "derived": f"{br.mean_mops:.3f}±{br.ci95_mops:.3f}Mops",
            "alg": w.alg,
            "mean_mops": br.mean_mops, "ci95_mops": br.ci95_mops,
            "p99_lat_ns": br.p99_lat_ns,
            "ops": int(br.ops.sum()),
        })
        # under non-uniform fail-slow degradation a per-alg aggregate
        # hides exactly the asymmetry the scenario exists to show — break
        # the throughput out per node (op-share weighted)
        mults = _phase_mults(w)
        if any(m != 1.0 for row in mults for m in row):
            pto = br.per_thread_ops.sum(axis=0)
            total = max(float(pto.sum()), 1e-9)
            tpn = w.threads_per_node
            for n in range(w.n_nodes):
                share = float(pto[n * tpn:(n + 1) * tpn].sum()) / total
                xmax = max(row[n] for row in mults)
                out.append({
                    "name": f"{lbl}.node{n}", "us_per_call": 0.0,
                    "derived": (f"{br.mean_mops * share:.3f}Mops "
                                f"({share:.3f} share, x{xmax:g})"),
                    "node_mops": br.mean_mops * share,
                    "node_op_share": share, "node_mult_max": xmax,
                })
    return out


# spec-building constants shared by each scenario fn and its registered
# ``workloads`` builder, so the differential harness replays the *exact*
# specs the scenario sweeps (no drift between the two)
_UNIFORM_AXES = dict(alg=("alock", "spinlock", "mcs"),
                     locality=(0.85, 0.95, 1.0))
_STORM = (Phase(frac=0.4), Phase(frac=0.2, zipf_s=3.0), Phase(frac=0.4))
_MIX_FRACS = (0.25, 0.5, 0.75)
_CHURN = (Phase(frac=0.3), Phase(frac=0.4, down_nodes=(3,)),
          Phase(frac=0.3))
_NIC_BURST = (Phase(frac=0.3), Phase(frac=0.4, cost="congested-nic"),
              Phase(frac=0.3))
_RAMP = (Phase(frac=0.34, b_init=(1, 1)), Phase(frac=0.33),
         Phase(frac=0.33, b_init=(20, 80)))
_RAMP_BASE = _BASE.replace(locality=0.9)
# fail-slow: node 0 limps at 4x. "hot" places the traffic on the limping
# node (its own threads hammer their local locks, everyone else's remote
# traffic spreads across nodes incl. node 0); "cold" steers all steady
# traffic away from node 0's locks (its threads go fully remote, everyone
# else fully local) — the limp then only taxes work node 0 itself performs.
_LIMP = "limp-node0-4x"
_TPN = _BASE.threads_per_node
_T = _BASE.n_nodes * _TPN
_LIMP_HOT = (1.0,) * _TPN + (0.0,) * (_T - _TPN)
_LIMP_COLD = (0.0,) * _TPN + (1.0,) * (_T - _TPN)
# degradation spreading node-to-node over the run; node 3 stays healthy
_CASCADE = (Phase(frac=0.25),
            Phase(frac=0.25, node_mult={0: 4.0}),
            Phase(frac=0.25, node_mult={0: 4.0, 1: 4.0}),
            Phase(frac=0.25, node_mult={0: 4.0, 1: 4.0, 2: 4.0}))
# open-loop ramp: offered Poisson rates bracketing every algorithm's
# measured service capacity on the shared topology (~9 req/us alock,
# ~2.1 mcs, ~2.3 spinlock) so detect_knee lands inside the sweep for each.
# R stays modest — the kernel pays O(R) lanes per event step — and the
# bounded queue makes overload shed load instead of completing everything
# eventually (an event-bounded run with an unbounded queue drains its
# backlog, which would hide the knee).
_RAMP_RATES = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0)
_RAMP_REQS = 256
_RAMP_QCAP = 32
_OPEN_ALGS = ("alock", "mcs", "spinlock")
# burst-storm: steady 1 req/us with a mid-run 12 req/us spike (phased
# rate program), absorbed by three admission policies per algorithm
_BURST_PH = (Phase(frac=0.4), Phase(frac=0.2, rate_per_us=12.0),
             Phase(frac=0.4))
_BURST_POLICIES = (
    ("open", Arrivals(rate_per_us=1.0, max_requests=_RAMP_REQS)),
    ("queue16", Arrivals(rate_per_us=1.0, max_requests=_RAMP_REQS,
                         queue_cap=16)),
    ("token", Arrivals(rate_per_us=1.0, max_requests=_RAMP_REQS,
                       token_rate_per_us=2.0, token_burst=16.0)),
)
# read-heavy: alock-rw at increasing read mixes against the writer-only
# alock control on the identical spec — readers share the CS, so the
# throughput ratio should grow with the read fraction and dominate by 0.9
_READ_FRACS = (0.5, 0.9, 0.99)
# rack-locality: two racks of two nodes each (racks_of(4, 2)); hlock's
# rack cohort merges each rack into one Peterson side, discounting
# in-rack remote traffic (loopback-priced) at the cost of coarser lease
# handoffs — the sweep brackets where each effect wins
_RACKS = racks_of(_BASE.n_nodes, 2)
_RACK_LOCS = (0.5, 0.75, 0.95)


def _rw_label(rf: float) -> str:
    return f"alock-rw.rf{int(rf * 100)}"


def _uniform_grid_workloads():
    import itertools
    return [_BASE.replace(alg=a, locality=l)
            for a, l in itertools.product(*_UNIFORM_AXES.values())]


def _hot_key_storm_workloads():
    return [w for alg in ("alock", "mcs")
            for w in (_BASE.replace(alg=alg),
                      _BASE.replace(alg=alg, phases=_STORM))]


def _mixed_locality_workloads():
    return [_BASE] + [_BASE.replace(locality=mixed(local=0.95, frac=f,
                                                   rest=0.5))
                      for f in _MIX_FRACS]


def _node_churn_workloads():
    return [_BASE, _BASE.replace(phases=_CHURN)]


def _congested_nic_workloads():
    return [w for alg in ("alock", "mcs")
            for w in (_BASE.replace(alg=alg),
                      _BASE.replace(alg=alg, phases=_NIC_BURST),
                      _BASE.replace(alg=alg, cost="congested-nic"))]


def _budget_ramp_workloads():
    return [_RAMP_BASE, _RAMP_BASE.replace(b_init=(1, 1)),
            _RAMP_BASE.replace(phases=_RAMP)]


def _limping_node_workloads():
    return [_BASE.replace(alg=alg, locality=loc, node_mult=nm)
            for alg in ("alock", "mcs")
            for loc in (_LIMP_HOT, _LIMP_COLD)
            for nm in (None, _LIMP)]


def _fail_slow_cascade_workloads():
    return [w for alg in ("alock", "mcs")
            for w in (_BASE.replace(alg=alg),
                      _BASE.replace(alg=alg, phases=_CASCADE))]


def _open_loop_ramp_workloads():
    return [_BASE.replace(alg=alg,
                          arrivals=Arrivals(rate_per_us=r,
                                            max_requests=_RAMP_REQS,
                                            queue_cap=_RAMP_QCAP))
            for alg in _OPEN_ALGS for r in _RAMP_RATES]


def _burst_storm_workloads():
    return [_BASE.replace(alg=alg, phases=_BURST_PH, arrivals=arr)
            for alg in ("alock", "mcs") for _, arr in _BURST_POLICIES]


def _read_heavy_workloads():
    return [_BASE] + [_BASE.replace(alg="alock-rw", read_frac=rf)
                      for rf in _READ_FRACS]


def _rack_locality_workloads():
    return [_BASE.replace(alg=alg, locality=loc,
                          topology=_RACKS if alg == "hlock" else None)
            for alg in ("alock", "hlock", "mcs") for loc in _RACK_LOCS]


def _serving_rows(label: str, br) -> dict:
    """One serving row per open-loop workload (seed-averaged)."""
    sm = br.serving_mean()
    return {
        "name": f"{label}.serving", "us_per_call": 0.0,
        "derived": (f"{sm['goodput_per_us']:.3f}/"
                    f"{sm['offered_per_us']:.3f} req/us, "
                    f"drop {sm['drop_rate']:.3f}"),
        "offered_per_us": sm["offered_per_us"],
        "goodput_per_us": sm["goodput_per_us"],
        "drop_rate": sm["drop_rate"],
        "completed": sm["completed"], "dropped": sm["dropped"],
        "p99_sojourn_ns": sm["p99_sojourn_ns"],
        "mean_wait_ns": sm["mean_wait_ns"],
        "mean_concurrency": sm["mean_concurrency"],
    }


@scenario("uniform-grid",
          "alg x locality grid on the shared 4-node topology",
          workloads=_uniform_grid_workloads)
def _uniform_grid(n_seeds, n_events, options):
    exp = Experiment("uniform-grid", n_seeds=n_seeds, n_events=n_events,
                     options=options)
    exp.add_grid(_BASE, **_UNIFORM_AXES)
    return _rows(exp.run())


@scenario("hot-key-storm",
          "mid-run Zipf(3) burst vs steady uniform traffic (phased)",
          workloads=_hot_key_storm_workloads)
def _hot_key_storm(n_seeds, n_events, options):
    exp = Experiment("hot-key-storm", n_seeds=n_seeds, n_events=n_events,
                     options=options)
    for alg in ("alock", "mcs"):
        exp.add(_BASE.replace(alg=alg), label=f"{alg}.steady")
        exp.add(_BASE.replace(alg=alg, phases=_STORM), label=f"{alg}.storm")
    res = exp.run()
    rows = _rows(res)
    for alg in ("alock", "mcs"):
        hit = res[f"{alg}.storm"].mean_mops / \
            max(res[f"{alg}.steady"].mean_mops, 1e-9)
        rows.append({"name": f"{alg}.storm_throughput_ratio",
                     "us_per_call": 0.0, "derived": f"{hit:.3f}x",
                     "ratio": hit})
    return rows


@scenario("mixed-locality",
          "per-thread locality splits (mixed(local, frac, rest)) vs flat",
          workloads=_mixed_locality_workloads)
def _mixed_locality(n_seeds, n_events, options):
    exp = Experiment("mixed-locality", n_seeds=n_seeds, n_events=n_events,
                     options=options)
    flat, *mixes = _mixed_locality_workloads()
    exp.add(flat, label="flat95")
    for frac, w in zip(_MIX_FRACS, mixes):
        exp.add(w, label=f"mix{int(frac * 100)}")
    return _rows(exp.run())


@scenario("node-churn",
          "a node leaves mid-run and rejoins (phased active mask)",
          workloads=_node_churn_workloads)
def _node_churn(n_seeds, n_events, options):
    exp = Experiment("node-churn", n_seeds=n_seeds, n_events=n_events,
                     options=options)
    exp.add(_BASE, label="steady")
    exp.add(_BASE.replace(phases=_CHURN), label="churn")
    res = exp.run()
    rows = _rows(res)
    pto = res["churn"].per_thread_ops.sum(axis=0)   # (T,) over seeds
    tpn = _BASE.threads_per_node
    share = float(pto[3 * tpn:4 * tpn].sum()) / max(float(pto.sum()), 1e-9)
    rows.append({"name": "churn.node3_op_share", "us_per_call": 0.0,
                 "derived": f"{share:.3f} (vs {1 / 4:.3f} steady)",
                 "node3_share": share})
    return rows


@scenario("congested-nic",
          "mid-run NIC-congestion burst (phased cost profile); SLO-gated",
          slo=Slo(p99_ns=2_000_000, min_events_per_sec=10.0),
          workloads=_congested_nic_workloads)
def _congested_nic(n_seeds, n_events, options):
    """The phase-dependent cost model in anger: the middle 40% of the run
    executes under the ``congested-nic`` profile (card past its
    serialization point, inflated wire + PCIe pressure). ALock's
    local-majority traffic never touches the RNIC, so it should shrug the
    burst off while loopback designs (mcs) pay full freight — the same
    asymmetry behind the paper's 29x headline, but driven as a transient.
    """
    exp = Experiment("congested-nic", n_seeds=n_seeds, n_events=n_events,
                     options=options)
    for alg in ("alock", "mcs"):
        exp.add(_BASE.replace(alg=alg), label=f"{alg}.steady")
        exp.add(_BASE.replace(alg=alg, phases=_NIC_BURST),
                label=f"{alg}.congested")
        exp.add(_BASE.replace(alg=alg, cost="congested-nic"),
                label=f"{alg}.always-congested")
    res = exp.run()
    rows = _rows(res)
    for alg in ("alock", "mcs"):
        hit = res[f"{alg}.congested"].mean_mops / \
            max(res[f"{alg}.steady"].mean_mops, 1e-9)
        rows.append({"name": f"{alg}.congestion_throughput_ratio",
                     "us_per_call": 0.0, "derived": f"{hit:.3f}x",
                     "ratio": hit})
    return rows


@scenario("budget-ramp",
          "ALock lease-budget program: tight -> paper -> generous phases",
          slo=Slo(p99_ns=2_000_000, min_events_per_sec=10.0),
          workloads=_budget_ramp_workloads)
def _budget_ramp(n_seeds, n_events, options):
    """The per-phase ``b_init`` program: a run that starts with
    pathologically tight budgets (every handoff re-arms at 1 — constant
    pReacquire churn, Fig. 4's left edge), transitions to the paper's
    (5, 20) tuning, then to generous budgets. Throughput should recover
    along the ramp while the constant-tight control keeps paying; the
    reacquire counters expose the mechanism.
    """
    exp = Experiment("budget-ramp", n_seeds=n_seeds, n_events=n_events,
                     options=options)
    exp.add(_RAMP_BASE, label="paper-budget")
    exp.add(_RAMP_BASE.replace(b_init=(1, 1)), label="tight-budget")
    exp.add(_RAMP_BASE.replace(phases=_RAMP), label="ramp")
    res = exp.run()
    rows = _rows(res)
    for lbl in ("paper-budget", "tight-budget", "ramp"):
        rows.append({"name": f"{lbl}.reacquires", "us_per_call": 0.0,
                     "derived": f"{res[lbl].reacquires.mean():.0f}",
                     "reacquires": float(res[lbl].reacquires.mean())})
    return rows


@scenario("limping-node",
          "one 4x fail-slow node hosting hot vs cold locks; SLO-gated",
          slo=Slo(p99_ns=500_000, min_events_per_sec=10.0),
          workloads=_limping_node_workloads)
def _limping_node(n_seeds, n_events, options):
    """The limplock regime: node 0's card serves every request at 4x
    (``node_mult="limp-node0-4x"``) while the cluster stays up. Placement
    decides the blast radius — with the *hot* locks on the limping node
    every client queues behind the slow card, with them *cold* only node
    0's own work drags. ALock's lease handoffs keep the hot path local to
    each holder, so it degrades by the single slow participant; MCS
    loopback traffic pays the slow card on every hop.
    """
    exp = Experiment("limping-node", n_seeds=n_seeds, n_events=n_events,
                     options=options)
    for alg in ("alock", "mcs"):
        for place, loc in (("hot", _LIMP_HOT), ("cold", _LIMP_COLD)):
            exp.add(_BASE.replace(alg=alg, locality=loc),
                    label=f"{alg}.{place}.healthy")
            exp.add(_BASE.replace(alg=alg, locality=loc, node_mult=_LIMP),
                    label=f"{alg}.{place}.limp")
    res = exp.run()
    rows = _rows(res)
    for alg in ("alock", "mcs"):
        for place in ("hot", "cold"):
            hit = res[f"{alg}.{place}.limp"].mean_mops / \
                max(res[f"{alg}.{place}.healthy"].mean_mops, 1e-9)
            rows.append({"name": f"{alg}.{place}.limp_throughput_ratio",
                         "us_per_call": 0.0, "derived": f"{hit:.3f}x",
                         "ratio": hit})
    return rows


@scenario("fail-slow-cascade",
          "degradation spreading node-to-node over the run; SLO-gated",
          slo=Slo(p99_ns=300_000, min_events_per_sec=10.0),
          workloads=_fail_slow_cascade_workloads)
def _fail_slow_cascade(n_seeds, n_events, options):
    """A fail-slow *program*: the run starts healthy, then node 0 limps
    at 4x, then node 1 joins it, then node 2 — only node 3 stays healthy
    by the final quarter (the cascading-slowdown pattern from the
    limplock literature, where one degraded NIC backs up its peers). The
    per-phase ``node_mult`` rows make the spread a single compiled
    executable; the ratio rows track how much of the healthy baseline
    each algorithm keeps as the cascade widens.
    """
    exp = Experiment("fail-slow-cascade", n_seeds=n_seeds,
                     n_events=n_events, options=options)
    for alg in ("alock", "mcs"):
        exp.add(_BASE.replace(alg=alg), label=f"{alg}.healthy")
        exp.add(_BASE.replace(alg=alg, phases=_CASCADE),
                label=f"{alg}.cascade")
    res = exp.run()
    rows = _rows(res)
    for alg in ("alock", "mcs"):
        hit = res[f"{alg}.cascade"].mean_mops / \
            max(res[f"{alg}.healthy"].mean_mops, 1e-9)
        rows.append({"name": f"{alg}.cascade_throughput_ratio",
                     "us_per_call": 0.0, "derived": f"{hit:.3f}x",
                     "ratio": hit})
    return rows


@scenario("open-loop-ramp",
          "offered-load ramp through each algorithm's saturation knee",
          slo=Slo(p99_ns=2_000_000, min_events_per_sec=10.0),
          workloads=_open_loop_ramp_workloads)
def _open_loop_ramp(n_seeds, n_events, options):
    """Open-loop serving curves: a Poisson arrival stream at each rate in
    ``_RAMP_RATES`` (bounded queue, tail drop) per algorithm. Below the
    knee goodput tracks the offered rate; above it the queue overflows
    and the gap plus the drop counters absorb the difference. The knee
    rows report where ``detect_knee`` places each algorithm's saturation
    point — ALock's local-handoff capacity (~9 req/us here) sits well
    above the loopback designs (~2 req/us), which is the serving-path
    view of the paper's throughput asymmetry.
    """
    exp = Experiment("open-loop-ramp", n_seeds=n_seeds, n_events=n_events,
                     options=options)
    for w in _open_loop_ramp_workloads():
        exp.add(w, label=f"{w.alg}.rate{w.arrivals.rate_per_us:g}")
    res = exp.run()
    rows = _rows(res)
    for lbl, _, br in res:
        rows.append(_serving_rows(lbl, br))
    for alg in _OPEN_ALGS:
        sms = [res[f"{alg}.rate{r:g}"].serving_mean() for r in _RAMP_RATES]
        knee = detect_knee([s["offered_per_us"] for s in sms],
                           [s["goodput_per_us"] for s in sms])
        cap = sms[knee]["goodput_per_us"] if knee is not None else None
        rows.append({
            "name": f"{alg}.knee", "us_per_call": 0.0,
            "derived": (f"knee @ {_RAMP_RATES[knee]:g} req/us offered, "
                        f"~{cap:.2f} served" if knee is not None
                        else "no knee in ramp"),
            "knee_rate_per_us": (None if knee is None
                                 else _RAMP_RATES[knee]),
            "knee_goodput_per_us": cap,
        })
    return rows


@scenario("burst-storm",
          "12x arrival-rate spike vs bounded-queue/token admission",
          slo=Slo(p99_ns=2_000_000, min_events_per_sec=10.0),
          workloads=_burst_storm_workloads)
def _burst_storm(n_seeds, n_events, options):
    """Phase-modulated open loop: the middle 20% of the run offers 12
    req/us against a 1 req/us baseline. The ``open`` control admits
    everything and rides the backlog down; ``queue16`` tail-drops once
    16 requests wait (bounding queue delay at the cost of goodput);
    ``token`` debits a 2 req/us token bucket on arrival, shaving the
    burst before it ever queues. The drop-split rows show which policy
    sheds the storm and what p99 sojourn that buys.
    """
    exp = Experiment("burst-storm", n_seeds=n_seeds, n_events=n_events,
                     options=options)
    for alg in ("alock", "mcs"):
        for pol, arr in _BURST_POLICIES:
            exp.add(_BASE.replace(alg=alg, phases=_BURST_PH, arrivals=arr),
                    label=f"{alg}.{pol}")
    res = exp.run()
    rows = _rows(res)
    for lbl, _, br in res:
        rows.append(_serving_rows(lbl, br))
    for alg in ("alock", "mcs"):
        base = res[f"{alg}.open"].serving_mean()
        for pol in ("queue16", "token"):
            sm = res[f"{alg}.{pol}"].serving_mean()
            ratio = sm["goodput_per_us"] / max(base["goodput_per_us"], 1e-9)
            rows.append({
                "name": f"{alg}.{pol}.vs_open", "us_per_call": 0.0,
                "derived": (f"{ratio:.3f}x goodput, "
                            f"drop {sm['drop_rate']:.3f}"),
                "goodput_ratio": ratio, "drop_rate": sm["drop_rate"],
            })
    return rows


@scenario("read-heavy",
          "alock-rw read mixes (0.5/0.9/0.99) vs writer-only alock; "
          "SLO-gated per label",
          slo=Slo(p99_ns=500_000, min_events_per_sec=10.0,
                  per_label={"alock-rw.rf99": Slo(p99_ns=100_000)}),
          workloads=_read_heavy_workloads)
def _read_heavy(n_seeds, n_events, options):
    """The reader/writer split under increasing read mixes: the same spec
    runs writer-only under plain ``alock`` and under ``alock-rw`` with
    read fractions 0.5 / 0.9 / 0.99. Readers share the critical section
    (writers drain them first and keep exclusivity), so throughput climbs
    with the read mix and should dominate the writer-only control by
    read_frac >= 0.9 — the vs_alock ratio rows state the claim directly,
    and the per-label SLO pins the near-read-only latency tail.
    """
    exp = Experiment("read-heavy", n_seeds=n_seeds, n_events=n_events,
                     options=options)
    exp.add(_BASE, label="alock.writer-only")
    for rf in _READ_FRACS:
        exp.add(_BASE.replace(alg="alock-rw", read_frac=rf),
                label=_rw_label(rf))
    res = exp.run()
    rows = _rows(res)
    base = max(res["alock.writer-only"].mean_mops, 1e-9)
    for rf in _READ_FRACS:
        hit = res[_rw_label(rf)].mean_mops / base
        rows.append({"name": f"rf{int(rf * 100)}.vs_alock_ratio",
                     "us_per_call": 0.0, "derived": f"{hit:.3f}x",
                     "ratio": hit, "read_frac": rf})
    return rows


@scenario("rack-locality",
          "hlock's rack cohorts vs flat alock across a locality sweep; "
          "SLO-gated per label",
          slo=Slo(p99_ns=500_000, min_events_per_sec=10.0,
                  per_label={"hlock.loc50": Slo(p99_ns=200_000)}),
          workloads=_rack_locality_workloads)
def _rack_locality(n_seeds, n_events, options):
    """The hierarchical cohort trade-off, swept over locality on a
    two-rack topology (``racks_of(4, 2)``). hlock prices same-rack remote
    traffic as loopback instead of full RDMA but merges each rack into
    one Peterson cohort, so half its "local"-side lease handoffs ride the
    NIC (loopback serializes on the card) where flat alock's stay on the
    CPU. Against mcs the ALock-family advantage *widens* as locality
    deepens (the hlock_vs_mcs ratio rows); against flat alock the merged
    cohort is a measured cost that shrinks with locality (hlock_vs_alock
    rises toward 1.0) — both trade-offs stated as ratio rows.
    """
    exp = Experiment("rack-locality", n_seeds=n_seeds, n_events=n_events,
                     options=options)
    for w in _rack_locality_workloads():
        loc = w.locality if isinstance(w.locality, float) else w.locality[0]
        exp.add(w, label=f"{w.alg}.loc{int(float(loc) * 100)}")
    res = exp.run()
    rows = _rows(res)
    for loc in _RACK_LOCS:
        tag = int(loc * 100)
        hl = res[f"hlock.loc{tag}"].mean_mops
        for ref in ("alock", "mcs"):
            hit = hl / max(res[f"{ref}.loc{tag}"].mean_mops, 1e-9)
            rows.append({"name": f"loc{tag}.hlock_vs_{ref}_ratio",
                         "us_per_call": 0.0, "derived": f"{hit:.3f}x",
                         "ratio": hit, "locality": loc})
    return rows


def fig5_workloads() -> list[Workload]:
    """The Fig.5-shaped perf grid of the ``paper-fig5`` scenario."""
    return [Workload(alg, n_nodes=10, threads_per_node=8, n_locks=100,
                     locality=loc)
            for alg in ("alock", "spinlock", "mcs")
            for loc in (0.85, 0.95, 1.0)]


@scenario("paper-fig5",
          "the paper's Fig.5 throughput grid (perfcheck's measuring stick)",
          workloads=fig5_workloads)
def _paper_fig5(n_seeds, n_events, options):
    exp = Experiment("paper-fig5", n_seeds=n_seeds, n_events=n_events,
                     options=options)
    for w in fig5_workloads():
        exp.add(w, label=f"{w.alg}.loc{int(float(w.locality[0]) * 100)}"
                if isinstance(w.locality, tuple)
                else f"{w.alg}.loc{int(w.locality * 100)}")
    return _rows(exp.run())


@scenario("coord-stress",
          "threaded coordination plane under churn + lease-expiry storms")
def _coord_stress(n_seeds, n_events, options):
    raise NotImplementedError(COORD_MSG)
