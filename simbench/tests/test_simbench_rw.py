"""The ``ycsb-rw-grid`` cell on the CPU: its configuration cut to a test's
size in a tree the test owns, run as the harness runs it; the plain
reference against the program's plain engine on YCSB's three mixes with
Zipfian(0.99) keys; and ``draw_read_pct``, which reads nothing from a
program that keeps no ``ops`` count."""
import json
import time
from pathlib import Path

import pytest

from simbench import check, harness, inputs
from simbench.program import to_workload
from simbench.reference import engine, spec
from simbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
CELL, CONFIG = "ycsb-rw-grid", "ycsb-rw-1000"
#: the metrics only a profiler trace gives: none on the CPU
TRACE_ONLY = {"device_idle_pct.rw", "engine_roofline.rw"}
MIXES = (0.5, 0.95, 1.0)
N_EVENTS, N_SEEDS = 120, 2
SEED = 2**31 - 301


def _base(**kw):
    return dict({"alg": "alock-rw", "n_nodes": 2, "threads_per_node": 3,
                 "n_locks": 12, "locality": 0.95, "zipf_s": 0.99,
                 "b_init": [5, 20], "read_frac": 0.5}, **kw)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    harness.WARM_EVENTS, warm = 20, harness.WARM_EVENTS
    root = tiny.make(tmp_path_factory.mktemp("bench"))
    path = root / "simbench" / "configs" / f"{CONFIG}.json"
    cfg = json.loads(path.read_text())
    assert cfg["grids"][0]["axes"] == {"n_nodes": [5, 10, 20],
                                       "read_frac": list(MIXES)}
    # two cluster sizes (two buckets), the three YCSB mixes each
    cfg.update(grids=[{"base": _base(), "axes": {
        "n_nodes": [2, 3], "read_frac": list(MIXES)}}],
        n_seeds=N_SEEDS, n_events=60)
    path.write_text(json.dumps(cfg))
    yield root
    harness.WARM_EVENTS = warm


def _run(root, trace):
    return harness.run_cell(root, CELL, 2**31 + 29, 0.01, trace, "cpu",
                            time.perf_counter())


def test_the_cell_is_correct_and_reports_its_metric(tree):
    r = _run(tree, False)
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"events_per_s", "setup_s"}
    assert r["metrics"]["events_per_s"]["unit"] == "events/s"
    assert r["checks"]["replica_values_differing"]["value"] == 0


def test_the_traced_line_carries_the_rw_metrics(tree):
    r = _run(tree, True)
    assert r["correct"] is True
    want = {m["name"] for m in inputs.benchmark(tree)["per_layer"]
            if CELL in m["workloads"]}
    assert want == {f"{n}.rw" for n in (
        "k1_only_pct", "draws_pct", "wait_pct", "aggregate_pct",
        "results_pct", "device_idle_pct", "engine_roofline",
        "draw_read_pct")}
    # each moves the end-to-end metric the cell reports
    assert {m["moves"] for m in inputs.benchmark(tree)["per_layer"]
            if m["name"] in want} == {"events_per_s"}
    assert set(r["metrics"]) == want - TRACE_ONLY
    # a lock operation reads one event's draws; most events are the
    # steps in between
    assert 0 < r["metrics"]["draw_read_pct.rw"]["value"] < 50


def test_the_configuration_is_the_grid_it_names():
    cell = inputs.cell(ROOT, CELL)
    ws = inputs.grid(cell["config"])
    assert cell["traffic"]["per_job"] == "all" and len(ws) == 9
    assert {(w["n_nodes"], w["read_frac"]) for w in ws} == {
        (n, f) for n in (5, 10, 20) for f in MIXES}
    assert all(w["alg"] == "alock-rw" and w["n_locks"] == 1000
               and w["zipf_s"] == 0.99 and w["threads_per_node"] == 8
               for w in ws)
    entry = next(c for c in inputs.benchmark(ROOT)["configs"]
                 if c["name"] == CONFIG)
    assert entry["reduced"] == []


@pytest.mark.parametrize("read_frac", MIXES)
def test_reference_matches_the_plain_engine(read_frac):
    from repro_torch.core.batch import sweep
    d = dict(_base(n_nodes=3, threads_per_node=2, read_frac=read_frac),
             seed=SEED)
    br = sweep([to_workload(d)], n_seeds=N_SEEDS, n_events=N_EVENTS,
               device="cpu")[0]
    reps = [engine.run(spec.lower(d, N_EVENTS), SEED + s, N_EVENTS)
            for s in range(N_SEEDS)]
    for s, r in enumerate(reps):
        got = {"done": br.per_thread_ops[s], "lat": br.lat_ns[s],
               "sim_ns": br.sim_ns[s], "reacquires": br.reacquires[s],
               "passes": br.passes[s]}
        assert check.differing(got, check.as_arrays(r)) == 0
    rows = {"mean_mops": br.mean_mops, "ci95_mops": br.ci95_mops,
            "mean_lat_us": br.mean_lat_us, "p50_lat_ns": br.p50_lat_ns,
            "p99_lat_ns": br.p99_lat_ns}
    assert check.rows_differing(rows, check.rows_of(reps)) == 0


def test_draw_read_pct_needs_the_ops_count():
    def ctx(events):
        return {"window_s": 4.0, "stats": {"seconds": {}, "events": events}}
    # the parent program's count: no ops
    assert harness.read_metric(ROOT, "draw_read_pct.rw", ctx(
        {"drawn": 3_000_000, "run": 3_000_000})) is None
    assert harness.read_metric(ROOT, "draw_read_pct.rw", ctx(None)) is None
    assert harness.read_metric(ROOT, "draw_read_pct.rw", ctx(
        {"drawn": 0, "run": 0, "ops": 0, "reads": 0})) is None
    got = harness.read_metric(ROOT, "draw_read_pct.rw", ctx(
        {"drawn": 3_000_000, "run": 3_000_000, "ops": 450_000,
         "reads": 400_000}))
    assert got == pytest.approx(15.0)
