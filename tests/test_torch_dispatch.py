"""The sweep's dispatch, on the CPU with the plain engine: every bucket is
issued before any result is forced, within a bound on the device memory
the issued buckets hold; and the precondition of the kernel's open-loop
pointer path (non-decreasing arrival times) holds for every open-loop
workload of the registry.

On a CUDA device the bound is a share of the free memory; on the CPU it is
0 (each bucket is forced before the next one is lowered). The tests set it
through ``batch._in_flight_budget`` to drive the CUDA order on the CPU,
and record the order of engine calls (``run_events``) and forcings
(``_force_bucket``). Outputs are compared with tolerance zero.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import batch
from repro_torch.experiments import scenario_names, scenario_workloads
from repro_torch.traffic.stream import arrival_plan, arrival_times_i64
from repro_torch.workloads import (Arrivals, Phase, Workload, lower,
                                   pad_phases, to_device)

EV = 300
SEEDS = 2
FIELDS = ("seeds", "ops", "sim_ns", "throughput_mops", "lat_ns",
          "per_thread_ops", "reacquires", "passes", "arr_ns", "wait_ns",
          "sojourn_ns", "rstat")


def _grid():
    """Four buckets: three closed algorithms (one bucket mixing phase
    programs) and one open loop; a duplicate rides along."""
    base = Workload("alock", 2, 2, 8, locality=0.9, seed=3)
    return [
        base, base.replace(alg="mcs"),
        base.replace(phases=(Phase(frac=0.5),
                             Phase(frac=0.5, down_nodes=(1,)))),
        base.replace(alg="spinlock", zipf_s=1.2),
        base.replace(arrivals=Arrivals(rate_per_us=4.0, max_requests=32,
                                       queue_cap=4)),
        base,
    ]


def _sweep(monkeypatch, budget, log=None):
    monkeypatch.setattr(batch, "_in_flight_budget", lambda dev: budget)
    if log is not None:
        run, force = batch.run_events, batch._force_bucket

        def run_logged(*a, **kw):
            log.append("run")
            return run(*a, **kw)

        def force_logged(*a, **kw):
            log.append("force")
            return force(*a, **kw)
        monkeypatch.setattr(batch, "run_events", run_logged)
        monkeypatch.setattr(batch, "_force_bucket", force_logged)
    batch.reset_exec_stats()
    res = batch.sweep(_grid(), n_seeds=SEEDS, n_events=EV, device="cpu")
    return res, batch.exec_stats()


def _bucket_needs():
    """Bytes each bucket of the grid holds, in issue order."""
    buckets = {}
    for w in _grid():
        key = batch.shape_key(w, EV)
        buckets[key] = buckets.get(key, 0) + SEEDS
    return [batch._bucket_bytes(k, b) for k, b in buckets.items()]


def test_issue_all_then_force_equals_one_bucket_at_a_time(monkeypatch):
    serial, st_serial = _sweep(monkeypatch, 0)
    issued, st_issued = _sweep(monkeypatch, 1 << 62)
    assert st_serial["dispatches"] == st_issued["dispatches"] == 4
    assert len(serial) == len(issued) == len(_grid())
    for a, b in zip(serial, issued):
        assert a.config == b.config
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            if x is None:
                assert y is None
            else:
                assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert issued[-1].ops.sum() > 0 and issued[4].open_loop


def test_every_bucket_is_issued_before_a_result_is_forced(monkeypatch):
    log = []
    _, st = _sweep(monkeypatch, 1 << 62, log)
    assert log == ["run"] * 4 + ["force"] * 4
    assert st["launches"] == 0 and st["smem_plan"] is None    # plain engine
    sec = st["seconds"]
    assert set(sec) == {"lower", "issue", "plan", "wait", "draws", "engine",
                        "engine_only", "aggregate", "results", "wall"}
    assert sec["engine"] > 0 and sec["wall"] > 0
    # on the CPU the stages run one after another: nothing overlaps
    assert sec["engine_only"] == pytest.approx(sec["engine"])


def test_stage_intervals_union():
    assert batch._union([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]) == 4.0
    assert batch._union([]) == 0.0
    # engine (1, 4) and (7, 8) beside draws (0, 2) and (3, 5): outside
    # them lie (2, 3) and (7, 8)
    assert batch._union_outside([(1.0, 4.0), (7.0, 8.0)],
                                [(0.0, 2.0), (3.0, 5.0)]) == 2.0


def test_in_flight_bound_holds_issues_back(monkeypatch):
    needs = _bucket_needs()
    assert len(needs) == 4
    # room for the first two buckets: the third waits for the first
    budget = needs[0] + needs[1]
    log = []
    _sweep(monkeypatch, budget, log)
    assert log[:3] == ["run", "run", "force"]
    assert log.count("run") == log.count("force") == 4
    # at every issue the issued and unforced buckets fit the bound
    live = []
    it = iter(needs)
    for e in log:
        if e == "run":
            live.append(next(it))
            assert len(live) == 1 or sum(live) <= budget
        else:
            live.pop(0)
    # the CPU's own bound: each bucket forced before the next is issued
    log = []
    _sweep(monkeypatch, 0, log)
    assert log == ["run", "force"] * 4


def test_cpu_default_keeps_one_bucket_at_a_time(monkeypatch):
    assert batch._in_flight_budget(torch.device("cpu")) == 0


def _open_loop_workloads():
    out = []
    for name in scenario_names():
        for w in scenario_workloads(name) or ():
            if getattr(w, "arrivals", None) is not None:
                out.append(w)
    return out


def test_registry_has_open_loop_workloads():
    ws = _open_loop_workloads()
    assert len(ws) >= 24                 # open-loop-ramp 18, burst-storm 6


@pytest.mark.parametrize("n_events", [1500, 150_000])
def test_arrival_times_never_decrease_in_the_registry(n_events):
    """The kernel's pointer path rests on non-decreasing arrival times in
    every request slot (padded slots and padded phases included); the
    kernel checks it per replica and scans where it fails, so this is the
    property that keeps the registry on the fast path."""
    ws = _open_loop_workloads()
    lws = [lower(w.replace(seed=s), n_events) for w in ws
           for s in (0, 1, 7, 2**31 - 1)]
    by_r = {}
    for lw in lws:
        by_r.setdefault(lw.operands.arr_fix.shape[-1], []).append(lw)
    for group in by_r.values():
        pmax = max(lw.operands.n_phases for lw in group)
        ops = [pad_phases(lw.operands, pmax) for lw in group]
        stacked = type(ops[0])(*(np.stack([np.asarray(getattr(o, f))
                                           for o in ops])
                                 for f in type(ops[0])._fields))
        plan = arrival_plan(to_device(stacked, "cpu"), n_events)
        arr = arrival_times_i64(plan.gaps)
        assert bool((plan.gaps >= 0).all())
        assert bool((arr[:, 1:] >= arr[:, :-1]).all())
