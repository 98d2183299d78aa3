"""The port's spans and counters: ``batch.stage``'s host spans under
``torch.profiler`` and the stage counters of ``exec_stats()`` they feed,
the events the loop ran against the events drawn (``diag``), and the
serving summaries' pass count (``exec_stats()["serving"]``).

CPU tests run a tiny closed-plus-open ``Experiment`` on the plain engine.
The ``card`` tests hold K1's ``diag`` to the plain engine's on a CUDA
device; on the card run ``PYTHONPATH=src python -m pytest -q -m card
--confcutdir=tests tests/test_torch_tracing.py`` (``--confcutdir`` leaves
out the root ``conftest.py``, which imports JAX).
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.core import batch
from repro_torch.core.cost_model import CostModel
from repro_torch.experiments import ExecOptions, Experiment
from repro_torch.kernels.event_loop import kernel
from repro_torch.kernels.event_loop.ops import run_events
from repro_torch.kernels.event_loop.ref import DIAG_COLS
from repro_torch.traffic import metrics
from repro_torch.workloads import Arrivals, Workload, lower

EV = 32
SEEDS = 2
BASE = Workload("alock", 2, 2, 8, locality=0.9, seed=3)
# four requests arriving within the first microseconds: the stream drains
# long before the last event
DRAINS = BASE.replace(arrivals=Arrivals(rate_per_us=8.0, max_requests=4,
                                        queue_cap=4))
SPANS = ("experiment.run", "sweep", "sweep.lower", "sweep.pack",
         "sweep.issue", "sweep.upload", "sweep.draws", "sweep.plan",
         "sweep.launch", "sweep.wait", "sweep.copy_back", "sweep.aggregate",
         "result.latency", "result.serving")
COUNTERS = {"wall": ("sweep",), "lower": ("sweep.lower", "sweep.pack"),
            "issue": ("sweep.issue",), "plan": ("sweep.plan",),
            "wait": ("sweep.wait",),
            "aggregate": ("sweep.copy_back", "sweep.aggregate"),
            "results": ("result.latency", "result.serving")}


@pytest.fixture
def card():
    """``"cuda"``, or a skip where the process sees no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _experiment(*workloads, device="cpu"):
    exp = Experiment("tracing", n_seeds=SEEDS, n_events=EV,
                     options=ExecOptions(device=device))
    for i, w in enumerate(workloads):
        exp.add(w, label=str(i))
    return exp


@pytest.fixture(scope="module")
def traced():
    """One closed and one open bucket, run and reduced under the
    profiler: the profiler's events and ``exec_stats()``."""
    exp = _experiment(BASE, BASE.replace(alg="mcs"), DRAINS)
    batch.reset_exec_stats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = exp.run()
        for _, _, br in res:
            br.mean_lat_us, br.lat_pct(99)
        res["2"].serving_mean()
    # (start, end, name) of the stages' spans, in order
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() in SPANS)
    return spans, batch.exec_stats()


def _parent(spans, k):
    """The innermost other span that holds span ``k``."""
    a, b, _ = spans[k]
    holders = [s for j, s in enumerate(spans)
               if j != k and s[0] <= a and b <= s[1]]
    return min(holders, key=lambda s: s[1] - s[0])[2] if holders else None


def test_span_names_and_nesting(traced):
    spans, _ = traced
    assert {n for _, _, n in spans} == set(SPANS)
    want = {"sweep": "experiment.run", "sweep.lower": "sweep",
            "sweep.pack": "sweep", "sweep.issue": "sweep",
            "sweep.upload": "sweep.issue", "sweep.draws": "sweep.issue",
            "sweep.plan": "sweep.issue", "sweep.launch": "sweep.issue",
            "sweep.wait": "sweep", "sweep.copy_back": "sweep",
            "sweep.aggregate": "sweep"}
    for k, (_, _, name) in enumerate(spans):
        assert _parent(spans, k) == want.get(name), name
    # three buckets: one pack, issue, wait and copy-back each; one plan
    count = {n: sum(x == n for _, _, x in spans) for n in SPANS}
    assert count["sweep.issue"] == count["sweep.wait"] == 3
    assert count["sweep.plan"] == 1 and count["experiment.run"] == 1


def test_counters_equal_their_spans(traced):
    spans, st = traced
    sec = st["seconds"]
    for counter, names in COUNTERS.items():
        mine = [b - a for a, b, n in spans if n in names]
        # a span also holds part of its own opening and closing, which
        # the counter's clock leaves out
        assert sec[counter] == pytest.approx(
            sum(mine) / 1e9, rel=0.05, abs=2e-4 * len(mine)), counter


def test_host_stages_lie_within_the_wall(traced):
    _, st = traced
    sec = st["seconds"]
    host = sec["lower"] + sec["issue"] + sec["wait"] + sec["aggregate"]
    assert 0 < host <= sec["wall"]
    assert 0 < sec["plan"] < sec["issue"] and sec["results"] > 0


def test_events_run_against_events_drawn(traced):
    _, st = traced
    ev = st["events"]
    # three workloads x two seeds, every event drawn
    assert ev["drawn"] == 3 * SEEDS * EV
    # the closed replicas run every event; the open ones stop early
    closed = 2 * SEEDS * EV
    assert closed < ev["run"] < ev["drawn"]


def test_closed_buckets_run_what_they_draw_and_make_no_plan():
    batch.reset_exec_stats()
    _experiment(BASE, BASE.replace(alg="spinlock")).run()
    st = batch.exec_stats()
    ev = st["events"]
    assert (ev["drawn"], ev["run"]) == (2 * SEEDS * EV, 2 * SEEDS * EV)
    # lock operations begun, none of them shared (no alock-rw here) nor
    # on the loopback tier (no hlock), and no node down
    assert 0 < ev["ops"] < ev["run"] and ev["reads"] == 0
    assert ev["loop"] == 0 and ev["down"] == 0
    # 4 threads, closed: every event on the owner-lane body's shape
    assert ev["lane"] == ev["run"]
    assert st["seconds"]["plan"] == 0.0 and st["seconds"]["issue"] > 0
    batch.reset_exec_stats()
    assert batch.exec_stats()["events"] == {"drawn": 0, "run": 0, "ops": 0,
                                            "reads": 0, "loop": 0,
                                            "down": 0, "lane": 0}


@pytest.mark.parametrize("T,R,lane", [
    (1, 0, True), (240, 0, True), (256, 0, True), (257, 0, False),
    (288, 0, False), (16, 256, False), (256, 1, False)])
def test_owner_lane_body_rule(T, R, lane):
    assert kernel.owner_lane(T, R) is lane


def test_lane_events_count_closed_buckets_up_to_256_threads():
    # a closed bucket at T = 240 (20 x 12), one past 256 (T = 288) and an
    # open one: only the first bucket's events count
    wide = BASE.replace(n_nodes=20, threads_per_node=12, n_locks=20)
    past = BASE.replace(n_nodes=24, threads_per_node=12, n_locks=24)
    batch.reset_exec_stats()
    batch.sweep([wide], n_seeds=SEEDS, n_events=EV, device="cpu")
    ev = batch.exec_stats()["events"]
    assert ev["lane"] == ev["run"] == SEEDS * EV
    batch.sweep([past, DRAINS], n_seeds=SEEDS, n_events=EV, device="cpu")
    ev = batch.exec_stats()["events"]
    assert ev["lane"] == SEEDS * EV and ev["run"] > 2 * SEEDS * EV
    batch.reset_exec_stats()
    assert batch.exec_stats()["events"]["lane"] == 0


def test_serving_pass_counts_the_open_loop_seeds(traced):
    _, st = traced
    # one open-loop workload's serving_mean(): one pass over its seeds
    assert st["serving"] == {"passes": 1, "seeds": SEEDS * 1, "fallback": 0}


def test_closed_sweep_makes_no_serving_pass_and_reset_zeroes_it():
    exp = _experiment(DRAINS)
    batch.reset_exec_stats()
    exp.run()["0"].serving_mean()
    assert batch.exec_stats()["serving"]["seeds"] == SEEDS
    batch.reset_exec_stats()
    assert batch.exec_stats()["serving"] == {"passes": 0, "seeds": 0,
                                             "fallback": 0}
    for _, _, br in _experiment(BASE, BASE.replace(alg="mcs")).run():
        br.mean_mops, br.mean_lat_us, br.p99_lat_ns
    assert batch.exec_stats()["serving"] == {"passes": 0, "seeds": 0,
                                             "fallback": 0}


def test_serving_span_wraps_the_pass(monkeypatch):
    br = _experiment(DRAINS).run()["0"]

    def probed(*a):
        with record_function("probe.serving_table"):
            return metrics.serving_table(*a)

    monkeypatch.setattr(batch, "serving_table", probed)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        br.serving_mean()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() in ("result.serving", "probe.serving_table"))
    assert [n for _, _, n in spans] == ["result.serving",
                                        "probe.serving_table"]
    assert _parent(spans, 1) == "result.serving"


def test_stage_counts_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    before = batch.exec_stats()["seconds"]["results"]
    with batch.stage("result.latency", "results"):
        sum(range(10_000))
    assert batch.exec_stats()["seconds"]["results"] > before


def _diag_run(w, n_seeds, device, backend, n_events=EV):
    """``run_events`` of ``w`` x ``n_seeds`` (packed as ``sweep`` packs a
    bucket) with a ``diag``: the outputs and the diag, on the host."""
    low = lower(w, n_events)
    T = w.n_nodes * w.threads_per_node
    tn, ln, _, wl = batch._pack(low.shape_key, [low.operands], n_seeds, 1,
                                CostModel())
    diag = torch.full((n_seeds, DIAG_COLS), -7, dtype=torch.int32,
                      device=device)
    out = run_events(w.alg, T, w.n_nodes, w.n_locks, n_events, wl, tn, ln,
                     backend=backend, device=device, diag=diag)
    return [o.cpu() for o in out], diag.cpu()


def test_plain_diag_counts_by_the_kernel_rule():
    got, diag = _diag_run(DRAINS, SEEDS, "cpu", "plain")
    # the count changes no output
    plain = batch.sweep([DRAINS], n_seeds=SEEDS, n_events=EV,
                        device="cpu")[0]
    assert np.array_equal(got[9].numpy(), plain.rstat)
    assert np.array_equal(got[8].numpy(), plain.sojourn_ns)
    assert (diag[:, 0] < EV).all() and (diag[:, 0] > 0).all()
    assert (diag[:, 1] == 1).all()          # Poisson arrivals: monotone
    # after its last event every thread is idle and every request done
    rstat = got[9]
    assert (rstat != 0).all()
    _, cdiag = _diag_run(BASE, SEEDS, "cpu", "plain")
    assert cdiag[:, :2].tolist() == [[EV, 0]] * SEEDS
    # lock operations begun, none of them shared (no alock-rw here) nor
    # on the loopback tier (no hlock)
    assert (cdiag[:, 2] > 0).all() and (cdiag[:, 3:] == 0).all()


@pytest.mark.card
def test_kernel_diag_equals_the_plain_count(card):
    n = 1500
    ramp = [BASE.replace(n_nodes=4, threads_per_node=4, n_locks=16,
                         locality=0.95, alg=alg,
                         arrivals=Arrivals(rate_per_us=r, max_requests=32,
                                           queue_cap=8))
            for alg in ("alock", "mcs") for r in (0.5, 16.0)]
    stopped = 0
    for w in ramp:
        k_out, k_diag = _diag_run(w, 3, card, "kernel", n)
        p_out, p_diag = _diag_run(w, 3, "cpu", "plain", n)
        assert torch.equal(k_diag, p_diag), w
        assert all(torch.equal(a, b) for a, b in zip(k_out, p_out)), w
        stopped += int((k_diag[:, 0] < n).sum())
    assert stopped > 0


@pytest.mark.card
def test_sharded_sweep_counts_the_events_the_kernel_ran(card):
    ws = [DRAINS, DRAINS.replace(alg="mcs", seed=9), BASE]
    counts = []
    for devices in ([f"{card}:0"] * 2, ["cpu", "cpu"]):
        batch.reset_exec_stats()
        # 3 seeds a workload: odd rows, so the two shards take a pad row
        batch.sweep(ws, n_seeds=3, n_events=EV, devices=devices, chunk=2)
        counts.append(batch.exec_stats()["events"])
    assert counts[0] == counts[1]
    assert counts[0]["run"] < counts[0]["drawn"]
