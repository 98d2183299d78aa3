"""A small cell through the CUDA kernels, on the card. Skips without one.

On a machine with the card: ``PYTHONPATH=src python -m pytest -q -m card
--confcutdir=simbench simbench/tests`` (``--confcutdir`` leaves out the root
``conftest.py``, which imports JAX)."""
import time

import pytest

from simbench import harness
from simbench.tests import tiny


@pytest.mark.card
@pytest.mark.parametrize("cell", ["fig5-jobs", "open-ramp"])
def test_cell_is_correct_on_the_card(card, tmp_path, cell):
    root = tiny.make(tmp_path, n_events=3000, n_seeds=4)
    r = harness.run_cell(root, cell, 2**31 + 9, 2.0, True, card,
                         time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0
    assert r["checks"]["replica_values_differing"]["value"] == 0
