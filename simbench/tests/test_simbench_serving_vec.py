"""The reader of the program's ``serving`` count: the share of seeds that
the one vectorised serving pass summarised, and nothing (not an error)
from a program that keeps no such count or summarised nothing."""
from pathlib import Path

import pytest

from simbench import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("serving,want", [
    ({"passes": 18, "seeds": 576, "fallback": 0}, 100.0),
    ({"passes": 2, "seeds": 48, "fallback": 16}, 75.0),
    # nothing summarised, or a program that keeps no such count
    ({"passes": 0, "seeds": 0, "fallback": 0}, None),
    (None, None)])
def test_serving_vec_share(serving, want):
    ctx = {"window_s": 4.0, "stats": {"seconds": {"results": 0.1}}}
    if serving is not None:
        ctx["stats"]["serving"] = serving
    got = harness.read_metric(ROOT, "serving_vec_pct.open", ctx)
    assert got == (None if want is None else pytest.approx(want))
