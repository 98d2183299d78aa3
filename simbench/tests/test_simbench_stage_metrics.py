"""The readers of the program's host stages and event counts: their
arithmetic over a window, and nothing (not an error) from a program that
keeps no such stage or count."""
from pathlib import Path

import pytest

from simbench import harness

ROOT = Path(__file__).resolve().parents[2]
STAGES = ("issue_pct", "plan_pct", "wait_pct", "results_pct")


def _ctx(seconds: dict, events=None) -> dict:
    stats = {"seconds": seconds}
    if events is not None:
        stats["events"] = events
    return {"window_s": 4.0, "stats": stats}


def test_stage_shares_of_the_window():
    ctx = _ctx({"issue": 0.8, "plan": 0.2, "wait": 0.0, "results": 0.1},
               {"drawn": 3_000_000, "run": 45_000})
    got = {n: harness.read_metric(ROOT, n, ctx) for n in STAGES + tuple(
        f"{n}.open" for n in STAGES) + ("draw_use_pct.open",)}
    assert got["issue_pct"] == pytest.approx(20.0)
    assert got["plan_pct"] == pytest.approx(5.0)
    assert got["wait_pct"] == 0.0          # a number, not None
    assert got["results_pct"] == pytest.approx(2.5)
    # a group's split of a quantity reads as the quantity
    for n in STAGES:
        assert got[f"{n}.open"] == got[n]
    assert got["draw_use_pct.open"] == pytest.approx(1.5)


def test_a_program_without_the_stages_gives_nothing():
    ctx = _ctx({"lower": 0.1, "draws": 2.0, "engine_only": 1.0,
                "aggregate": 0.4})
    for n in STAGES + ("draw_use_pct.open",):
        assert harness.read_metric(ROOT, n, ctx) is None, n
    # nothing drawn: no share
    assert harness.read_metric(ROOT, "draw_use_pct", _ctx(
        {}, {"drawn": 0, "run": 0})) is None
