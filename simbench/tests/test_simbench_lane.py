"""The reader of the program's ``lane`` count (``k1_lane_pct``): the share
of the events the loop ran on K1's owner-lane body, nothing (not an
error) from a program that keeps no such count or ran no event, and the
traced line of a closed cell carrying it, on the CPU and on the card."""
import time
from pathlib import Path

import pytest

from simbench import harness, inputs
from simbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 31


@pytest.mark.parametrize("events,want", [
    ({"run": 4_800_000, "lane": 4_800_000}, 100.0),
    ({"run": 4_800_000, "lane": 1_200_000}, 25.0),
    # nothing run, or a program that keeps no such count
    ({"run": 0, "lane": 0}, None),
    ({"run": 4_800_000}, None),
    (None, None)])
def test_lane_share(events, want):
    ctx = {"window_s": 4.0, "stats": {"seconds": {"engine_only": 1.0}}}
    if events is not None:
        ctx["stats"]["events"] = events
    got = harness.read_metric(ROOT, "k1_lane_pct", ctx)
    assert got == (None if want is None else pytest.approx(want))


def test_the_metric_reads_the_closed_fig5_cells():
    m = next(m for m in inputs.benchmark(ROOT)["per_layer"]
             if m["name"] == "k1_lane_pct")
    assert (m["layer"], m["moves"], m["source"]) == (
        "event loop K1", "events_per_s", "program_counter")
    assert set(m["workloads"]) <= {
        w["name"] for w in inputs.benchmark(ROOT)["workloads"]
        if not w["name"].startswith("open-")}


def _traced(root, cell, device):
    return harness.run_cell(root, cell, SEED, 0.01, True, device,
                            time.perf_counter())


def test_traced_fig5_jobs_line_reads_every_event_on_the_lane_body(
        tmp_path):
    harness.WARM_EVENTS, warm = 20, harness.WARM_EVENTS
    try:
        r = _traced(tiny.make(tmp_path), "fig5-jobs", "cpu")
    finally:
        harness.WARM_EVENTS = warm
    assert r["correct"] is True
    # the tiny configuration's 4 threads: the owner-lane body's shape
    assert r["metrics"]["k1_lane_pct"] == {"value": 100.0, "unit": "%"}


@pytest.mark.card
def test_k1_lane_pct_on_the_card(card, tmp_path):
    root = tiny.make(tmp_path, n_events=3000, n_seeds=4)
    r = _traced(root, "fig5-jobs", card)
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert r["metrics"]["k1_lane_pct"]["value"] == 100.0
