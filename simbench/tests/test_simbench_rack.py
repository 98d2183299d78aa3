"""The ``rack-churn-grid`` cell on the CPU: its configuration cut to a test's
size in a tree the test owns (4 nodes in racks [0, 0, 1, 1] and [0, 1, 1,
1], node 3 parked in the middle phase of half the workloads), run as the
harness runs it; ``down_event_pct`` against its closed form,
``loop_op_pct`` against a recount of the plain route's trajectory, both
readers on a program that keeps no such counts, and the bfloat16 control
in the program's place."""
import json
import time

import pytest
import torch

from simbench import check, control, harness, inputs
from simbench.program import Program, to_workload
from simbench.tests import tiny
from simbench.tests.test_simbench_control import _F32, _judge

CELL, CONFIG = "rack-churn-grid", "rack-churn-20n"
#: the metrics only a profiler trace gives: none on the CPU
TRACE_ONLY = {"device_idle_pct.hl", "engine_roofline.hl"}
RACKS = ([0, 0, 1, 1], [0, 1, 1, 1])
CHURN = [{"frac": 0.3}, {"frac": 0.4, "down_nodes": [3]}, {"frac": 0.3}]
N_EVENTS, N_SEEDS = 200, 2
SEED = 2**31 + 41


def _cut(cfg: dict, n_events: int) -> dict:
    """The configuration at a test's size: its grid's shape (localities x
    rack layouts x steady or churn) over 4 nodes of 2 threads, 5 locks a
    node (a Zipf table that bfloat16 cannot hold exactly, as it cannot
    the configuration's 50)."""
    g = cfg["grids"][0]
    assert g["base"]["alg"] == "hlock" and g["base"]["n_nodes"] == 20
    assert g["axes"]["phases"] == [None, CHURN]
    return dict(cfg, n_seeds=N_SEEDS, n_events=n_events, grids=[{
        "base": dict(g["base"], n_nodes=4, threads_per_node=2, n_locks=20),
        "axes": {"locality": [0.5, 0.95], "topology": list(RACKS),
                 "phases": [None, CHURN]}}])


def _tree(tmp_path_factory, n_events):
    root = tiny.make(tmp_path_factory.mktemp("bench"))
    path = root / "simbench" / "configs" / f"{CONFIG}.json"
    path.write_text(json.dumps(_cut(json.loads(path.read_text()),
                                    n_events)))
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    harness.WARM_EVENTS, warm = 20, harness.WARM_EVENTS
    yield _tree(tmp_path_factory, N_EVENTS)
    harness.WARM_EVENTS = warm


def _run(root, trace):
    return harness.run_cell(root, CELL, SEED, 0.01, trace, "cpu",
                            time.perf_counter())


def test_the_cell_is_correct_and_reports_its_metric(tree):
    r = _run(tree, False)
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"events_per_s", "setup_s"}
    assert r["checks"]["replica_values_differing"]["value"] == 0
    assert r["checks"]["aggregate_values_differing"]["value"] == 0


def _recount(monkeypatch):
    """Counts, from each step's state, the lock operations begun and those
    begun on the loopback tier: thread ``tid`` leaves NCS for a lock whose
    node is another node of its own rack."""
    from repro_torch.core import machine as mc
    from repro_torch.kernels.event_loop import ref as plain
    seen = {"ops": 0, "loop": 0}
    step = plain.sem_step

    def recount(alg, sem, tid, binit, tn, ln, new_t, new_c, new_r, rk):
        out = step(alg, sem, tid, binit, tn, ln, new_t, new_c, new_r, rk)
        rows = torch.arange(sem.pc.shape[0])
        began = sem.pc[rows, tid] == mc.NCS
        mine = tn[rows, tid]
        lnode = ln[rows, out[0].target[rows, tid]]
        loop = began & (lnode != mine) & (rk[rows, lnode] == rk[rows, mine])
        seen["ops"] += int(began.sum())
        seen["loop"] += int(loop.sum())
        return out

    monkeypatch.setattr(plain, "sem_step", recount)
    return seen


def test_the_traced_line_carries_the_hl_metrics(tree, monkeypatch):
    r = _run(tree, True)
    assert r["correct"] is True
    bench = inputs.benchmark(tree)
    want = {m["name"] for m in bench["per_layer"]
            if CELL in m["workloads"]}
    assert want == {f"{n}.hl" for n in (
        "k1_only_pct", "draws_pct", "wait_pct", "aggregate_pct",
        "device_idle_pct", "engine_roofline", "loop_op_pct",
        "down_event_pct")}
    assert {m["moves"] for m in bench["per_layer"]
            if m["name"] in want} == {"events_per_s"}
    assert set(r["metrics"]) == want - TRACE_ONLY
    # half the workloads park node 3 from event 60 to event 140 of 200
    cfg = inputs.cell(tree, CELL)["config"]
    lo, hi = (round(f * N_EVENTS) for f in (0.3, 0.7))
    assert r["metrics"]["down_event_pct.hl"]["value"] == \
        100.0 * 0.5 * (hi - lo) / cfg["n_events"]
    # the window of a 0.01 s run is its first job: the same job again,
    # with the plain route's trajectory recounted
    seen = _recount(monkeypatch)
    prog = Program("cpu")
    prog.reset_stats()
    _, job = next(inputs.jobs(cfg, inputs.cell(tree, CELL)["traffic"],
                              SEED))
    prog.run_job(job, cfg)
    stats = prog.stats()
    assert (stats["events"]["ops"], stats["events"]["loop"]) == (
        seen["ops"], seen["loop"])
    assert 0 < seen["loop"] < seen["ops"]
    assert r["metrics"]["loop_op_pct.hl"]["value"] == \
        100.0 * seen["loop"] / seen["ops"]


def test_the_configuration_is_the_grid_it_names():
    root = tiny.REPO
    cell = inputs.cell(root, CELL)
    ws = inputs.grid(cell["config"])
    assert cell["traffic"]["per_job"] == "all" and len(ws) == 12
    assert cell["config"]["n_seeds"] == 32
    assert cell["config"]["n_events"] == 150_000
    racks = {tuple(w["topology"]) for w in ws}
    assert racks == {tuple([0] * 10 + [1] * 10),
                     tuple(r for r in range(4) for _ in range(5))}
    assert {w["locality"] for w in ws} == {0.5, 0.75, 0.95}
    assert sum(w["phases"] is not None for w in ws) == 6
    assert all(w["alg"] == "hlock" and w["n_nodes"] == 20
               and w["threads_per_node"] == 8 and w["n_locks"] == 1000
               for w in ws)
    # node 3 sits in rack 0 of both layouts
    assert all(w["topology"][3] == 0 for w in ws)
    # one shape bucket: every workload shares the program's shape key
    from repro_torch.core.batch import shape_key
    assert len({shape_key(to_workload(dict(w, seed=0)), 150_000)
                for w in ws}) == 1
    entry = next(c for c in inputs.benchmark(root)["configs"]
                 if c["name"] == CONFIG)
    assert entry["reduced"] == []


@pytest.mark.parametrize("name", ["loop_op_pct.hl", "down_event_pct.hl"])
def test_readers_need_the_counts(name):
    def ctx(events):
        return {"window_s": 4.0, "stats": {"seconds": {}, "events": events}}
    # the parent program's count: no loop, no down
    old = {"drawn": 3_000_000, "run": 3_000_000, "ops": 450_000,
           "reads": 0}
    assert harness.read_metric(tiny.REPO, name, ctx(old)) is None
    assert harness.read_metric(tiny.REPO, name, ctx(None)) is None
    assert harness.read_metric(tiny.REPO, name, ctx(
        dict(old, drawn=0, run=0, ops=0, loop=0, down=0))) is None
    got = harness.read_metric(tiny.REPO, name, ctx(
        dict(old, loop=90_000, down=600_000)))
    assert got == pytest.approx(20.0)


@pytest.fixture(scope="module")
def long_tree(tmp_path_factory):
    """Long enough runs that a lower precision shows on every seed; only
    the reference runs here."""
    return _tree(tmp_path_factory, 600)


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_bfloat16_control_fails(long_tree, seed):
    got = _judge(long_tree, CELL, seed, control.LowPrecision)
    assert got["replica_values_differing"][0] > 0
    assert check.verdict(got, 0, 3) is False
    f32 = _judge(long_tree, CELL, seed, _F32)
    assert f32["replica_values_differing"] == (0, 0)
    assert check.verdict(f32, 0, 3) is True
