"""The scenario registry and SLOs: the port against the JAX reference.

The port registers the reference's scenario names with the same
summaries, SLOs and swept ``Workload`` specs (compared through
``torch_ref.to_port``), and ``run_scenario`` returns the same rows — every
key, wall-clock free by construction, compared with ``==`` (NaN equal to
NaN) — for the two open-loop scenarios and one closed-loop scenario at a
small event count on the CPU. ``coord-stress`` runs the threaded
coordination plane on host threads (``tests/test_torch_coord.py`` holds
its rows against the reference's).
"""
import doctest
import math

import pytest

import torch_ref as R
from repro_torch.experiments import (ExecOptions, Slo, check_slo,
                                     get_scenario, run_scenario,
                                     scenario_names, scenario_workloads)
from repro_torch.experiments import registry, slo

N_EVENTS = 300
N_SEEDS = 2
REF = R.ref_registry


def test_scenario_names_equal_reference():
    assert scenario_names() == REF.scenario_names()
    assert len(scenario_names()) == 14


@pytest.mark.parametrize("name", REF.scenario_names())
def test_scenario_specs_equal_reference(name):
    ref_ws = REF.scenario_workloads(name)
    got = scenario_workloads(name)
    if ref_ws is None:
        assert got is None
    else:
        assert got == [R.to_port(w) for w in ref_ws]
    ref_sc, sc = REF.get_scenario(name), get_scenario(name)
    assert sc.summary == ref_sc.summary
    assert sc.slo == (None if ref_sc.slo is None else R.to_port(ref_sc.slo))


def test_fig5_workloads_equal_reference():
    assert registry.fig5_workloads() == [R.to_port(w) for w in
                                         REF.fig5_workloads()]


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    return a == b


@pytest.mark.parametrize("name", ["open-loop-ramp", "burst-storm",
                                  "node-churn"])
def test_run_scenario_rows_equal_reference(name):
    ref = REF.run_scenario(name, n_seeds=N_SEEDS, n_events=N_EVENTS,
                           options=R.ref_experiments.ExecOptions(
                               backend="xla"))
    got = run_scenario(name, n_seeds=N_SEEDS, n_events=N_EVENTS,
                       options=ExecOptions(device="cpu"))
    assert [r["name"] for r in got] == [r["name"] for r in ref]
    for r, g in zip(ref, got):
        assert g.keys() == r.keys(), r["name"]
        bad = [k for k in r if not _same(r[k], g[k])]
        assert not bad, (r["name"], bad)
    if name == "open-loop-ramp":
        knees = [g for g in got if g["name"].endswith(".knee")]
        assert len(knees) == 3
        assert any(k["knee_rate_per_us"] is not None for k in knees)


def test_slo_doctests_pass():
    res = doctest.testmod(slo, optionflags=doctest.ELLIPSIS)
    assert res.attempted > 0 and res.failed == 0


def test_check_slo_equals_reference():
    rows = [{"name": "a", "p99_lat_ns": 4e6},
            {"name": "w", "events_per_sec": 20.0},
            {"name": "b", "p99_lat_ns": float("nan")}]
    for kw in (dict(p99_ns=5e6), dict(p99_ns=1.0, min_events_per_sec=30.0),
               dict(p99_ns=5e6, per_label={"a": {"p99_ns": 1e6},
                                           "gone": {"p99_ns": 1e6}})):
        pl = {k: Slo(**v) for k, v in kw.pop("per_label", {}).items()}
        ref_pl = {k: R.ref_experiments.Slo(**v.__dict__ | {"per_label": ()})
                  for k, v in pl.items()}
        got = check_slo(Slo(**kw, per_label=pl), rows)
        ref = R.ref_experiments.check_slo(
            R.ref_experiments.Slo(**kw, per_label=ref_pl), rows)
        assert (got.ok, got.checked, got.violations) \
            == (ref.ok, ref.checked, ref.violations)


def test_coord_stress_raises_naming_a9():
    """``coord-stress`` is ported (A9): it runs on host threads and returns
    one churn row per seed, with the default options too, which name a
    CUDA device this host lacks (this test once asserted that it raises
    ``NotImplementedError`` naming A9)."""
    for options in (ExecOptions(device="cpu"), ExecOptions()):
        rows = run_scenario("coord-stress", n_seeds=1, n_events=100,
                            options=options)
        assert [r["name"] for r in rows] == ["coord.churn.seed0"]
        assert rows[0]["ops"] > 0
        assert rows[0]["phase_members"] == [[0, 1, 2], [0, 1], [0, 1, 2]]


def test_unknown_scenario_raises():
    with pytest.raises(ValueError, match="unknown scenario"):
        get_scenario("no-such-scenario")
