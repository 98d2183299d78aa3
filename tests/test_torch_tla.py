"""The port's explicit-state model checker (``core/tla.py``) against the
JAX reference's, on the configurations of ``tests/test_alock_properties.py``.

Both run the Python machines of their own ``core/machine.py``; the port's
``CheckResult`` (states, the three property flags, the violations) and
``bounded_overtaking`` must equal the reference's exactly. Tolerance:
zero — every value is an integer or a flag.
"""
import itertools
import random

import pytest

import torch_ref as R
from repro_torch.core import machine as mc
from repro_torch.core.tla import CheckResult, bounded_overtaking, explore

L, REM = mc.LOCAL, mc.REMOTE


def _same(got: CheckResult, want) -> None:
    assert (got.states, got.mutex_ok, got.deadlock_free,
            got.eventual_entry) == (want.states, want.mutex_ok,
                                    want.deadlock_free, want.eventual_entry)
    assert got.violations == want.violations
    assert got.ok == want.ok


@pytest.mark.parametrize("machine", ["alock", "mcs", "spinlock", "hlock",
                                     "alock-rw"])
@pytest.mark.parametrize("cohorts", [(L, REM), (L, L, REM), (L, REM, REM)])
def test_explore_matches_reference(machine, cohorts):
    got = explore(machine, cohorts, b_init=(2, 3))
    _same(got, R.ref_tla.explore(machine, cohorts, b_init=(2, 3)))
    assert got.ok


@pytest.mark.parametrize("b_init", [(1, 1), (1, 3), (3, 1), (2, 2)])
def test_explore_budget_variants_match_reference(b_init):
    _same(explore("alock", (L, L, REM), b_init=b_init),
          R.ref_tla.explore("alock", (L, L, REM), b_init=b_init))


def test_explore_alock_2plus2_matches_reference():
    got = explore("alock", (L, L, REM, REM), b_init=(2, 2))
    _same(got, R.ref_tla.explore("alock", (L, L, REM, REM), b_init=(2, 2)))
    assert got.ok and got.states > 10_000


def test_explore_state_cap_raises_like_reference():
    with pytest.raises(RuntimeError, match="state space exceeds 50"):
        explore("alock", (L, REM), max_states=50)
    with pytest.raises(RuntimeError, match="state space exceeds 50"):
        R.ref_tla.explore("alock", (L, REM), max_states=50)


@pytest.mark.parametrize("machine", ["alock", "spinlock", "mcs"])
@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_bounded_overtaking_matches_reference(machine, seed):
    cohorts, b = (L, L, REM, REM), (2, 3)

    def sched():
        rng = random.Random(seed)
        return (rng.randrange(4) for _ in itertools.count())
    got = bounded_overtaking(machine, cohorts, b, sched(), steps=8_000)
    assert got == R.ref_tla.bounded_overtaking(machine, cohorts, b, sched(),
                                               steps=8_000)
    if machine == "alock":
        assert got <= b[0] + b[1] + 4
