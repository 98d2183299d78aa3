"""The harness on the CPU: the result line's shape, the metric arithmetic,
cells and metrics found from their files alone, the imports gate, and
refusing to run without a card or without the program."""
import ast
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from simbench import harness, inputs, peaks
from simbench.tests import tiny

SIMBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def run(root, cell, trace=False, seconds=0.01):
    return harness.run_cell(root, cell, 2**31 + 11, seconds, trace, "cpu",
                            time.perf_counter())


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    harness.WARM_EVENTS, warm = 20, harness.WARM_EVENTS
    yield tiny.make(tmp_path_factory.mktemp("bench"))
    harness.WARM_EVENTS = warm


def test_line_has_the_contract_shape(tree):
    r = run(tree, "fig5-jobs")
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"events_per_s", "job_p95_ms", "setup_s"}
    assert r["metrics"]["events_per_s"]["unit"] == "events/s"
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert r["checks"] == {"replica_values_differing":
                           {"value": 0, "limit": 0},
                           "aggregate_values_differing":
                           {"value": 0, "limit": 0}}
    json.dumps(r)


def test_traced_line_carries_the_per_layer_metrics(tree):
    r = run(tree, "open-ramp", trace=True)
    assert r["correct"] is True
    bench = inputs.benchmark(tree)
    want = {m["name"] for m in bench["per_layer"]
            if "open-ramp" in m["workloads"]}
    # no profiler trace on the CPU: what only the trace gives is left out
    assert set(r["metrics"]) == want - {"device_idle_pct.open"}
    assert "busy_s" not in r["device"] and "window_s" not in r["device"]
    assert list(r)[-1] == "checks" and "breakdown" not in r


def test_metric_arithmetic():
    from simbench import trace
    ctx = {"window_s": 4.0, "setup_s": 2.5, "events": 8_000_000,
           "job_seconds": list(np.arange(1, 101) / 100.0),
           "stats": {"seconds": {"lower": 0.2, "draws": 2.0,
                                 "engine_only": 1.0, "aggregate": 0.4}},
           "peak_window_bytes": 3 * 2**20, "config": {"n_seeds": 2,
                                                      "n_events": 100},
           "jobs": [[{"alg": "alock", "n_nodes": 2, "threads_per_node": 4,
                      "n_locks": 8}]], "trace": None}
    assert harness.read_metric(SIMBENCH.parent, "device_idle_pct",
                               ctx) is None
    assert harness.read_metric(SIMBENCH.parent, "engine_roofline",
                               ctx) is None
    ctx["trace"] = {"busy_s": 3.0, "window_s": 4.0, "jobs": ctx["jobs"]}
    got = {n: harness.read_metric(SIMBENCH.parent, n, ctx) for n in (
        "events_per_s", "job_p95_ms", "setup_s", "lower_pct", "draws_pct",
        "k1_only_pct", "aggregate_pct", "peak_mem_mib", "device_idle_pct",
        "engine_roofline", "events_per_s.open", "draws_pct.open")}
    assert got["events_per_s"] == 2_000_000          # all work, all time
    # a group's split of a quantity reads as the quantity
    assert got["events_per_s.open"] == got["events_per_s"]
    assert got["draws_pct.open"] == got["draws_pct"]
    assert got["job_p95_ms"] == pytest.approx(950.5)  # over every job
    assert got["setup_s"] == 2.5
    assert got["lower_pct"] == pytest.approx(5.0)
    assert got["draws_pct"] == 50.0 and got["k1_only_pct"] == 25.0
    assert got["aggregate_pct"] == pytest.approx(10.0)
    assert got["peak_mem_mib"] == 3.0
    assert got["device_idle_pct"] == 25.0     # the trace's gaps are idle
    w = ctx["jobs"][0][0]
    least = max(peaks.event_ops(w) * 200 / peaks.INT32_OPS_PER_S,
                peaks.replica_bytes(w) * 2 / peaks.HBM_BYTES_PER_S)
    assert got["engine_roofline"] == pytest.approx(100 * least / 3.0)
    # ten hashes of 72, two uniforms, randint, log2(4) + 1, 2T + 64
    assert peaks.event_ops(w) == 720 + 6 + 6 + 3 + 16 + 64
    ctx["trace"]["jobs"] = [[dict(w, arrivals={"rate_per_us": 1.0})]]
    assert harness.read_metric(SIMBENCH.parent, "engine_roofline",
                               ctx) is None
    # the trace: busy time is the union, gaps named by the host span
    s = trace.summarize([(0, 10, "k"), (5, 20, "k"), (40, 50, "c")],
                        [(0, 60, "simbench.job"), (22, 38, "aten::cat")],
                        1e-7)
    assert s["busy_s"] == 30e-9
    assert s["breakdown"]["idle_gaps"] == [["aten::cat", 20e-9]]
    assert s["breakdown"]["device_ops"] == [["k", 25e-9], ["c", 10e-9]]


def test_new_cell_and_metric_come_from_files_alone(tmp_path):
    root = tiny.make(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "fig5-pairs", "config": "fig5-paper",
                               "traffic": "pairs", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "jobs_done", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "events_per_s",
                               "workloads": ["fig5-pairs"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    sb = root / "simbench"
    (sb / "traffic" / "pairs.json").write_text('{"per_job": 2}')
    (sb / "workloads" / "fig5-pairs.json").write_text(
        '{"config": "fig5-paper", "traffic": "pairs"}')
    (sb / "metrics" / "jobs_done.py").write_text(
        "def read(ctx):\n    return len(ctx['job_seconds'])\n")
    r = run(root, "fig5-pairs", trace=True)
    assert r["correct"] is True
    assert r["metrics"]["jobs_done"] == {"value": r["attempted"],
                                         "unit": "jobs"}
    assert "events_per_s" not in r["metrics"]


def test_jobs_are_drawn_from_the_seed():
    cfg = json.loads((SIMBENCH / "configs" / "fig5-paper.json").read_text())
    ws = inputs.grid(cfg)
    assert len(ws) == 87
    one = {"per_job": 1}

    def first(seed, n=100):
        return [w for _, (_, (w,)) in zip(range(n),
                                          inputs.jobs(cfg, one, seed))]
    a, b, c = first(5), first(5), first(6)
    assert a == b and a != c
    cycle = [json.dumps(dict(w, seed=0), sort_keys=True) for w in a[:87]]
    assert len(set(cycle)) == 87             # every workload once a cycle
    seeds = [w["seed"] for w in a]
    assert len(set(seeds)) == 100 and 0 <= min(seeds)
    assert max(seeds) + cfg["n_seeds"] < 2**31


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(SIMBENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    for path in sorted((SIMBENCH / "reference").rglob("*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"numpy", "math", "heapq", "bisect", "typing",
                        "__future__"}, (path, tops)


def test_refuses_without_a_card_or_the_program(tmp_path, capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from simbench import run as entry
    assert entry.main(["--workload", "fig5-grid", "--seed", "1",
                       "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
    root = tiny.make(tmp_path)               # BENCHMARK.json + simbench/
    p = subprocess.run([sys.executable, str(root / "simbench" / "run.py"),
                        "--workload", "fig5-grid", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
