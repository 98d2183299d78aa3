"""The open loop's serving summaries in one pass over a result's seeds:
``traffic.metrics.serving_table`` against ``serving_summary`` row by row,
its percentiles against ``np.percentile`` at every completed count of a
256-slot replica, the 2**53 guard's fallback, and
``BatchResult.serving_mean()`` of a CPU sweep against the per-seed loop,
the JAX reference's ``serving_summary`` and the benchmark's NumPy
reference (``simbench/reference/aggregate.py``). Tolerance: none — floats
are compared by their bits, NaN equal to NaN.
"""
import types

import numpy as np
import pytest

import torch_ref  # noqa: F401  (the reference, importable)
import repro.traffic.metrics as ref_metrics
from repro_torch.core import batch
from repro_torch.experiments import ExecOptions, Experiment
from repro_torch.traffic.metrics import (COMPLETED, DROPPED, IN_SERVICE,
                                         serving_summary, serving_table)
from repro_torch.workloads import Arrivals, Phase, Workload
from simbench.reference import aggregate

S, SLOTS = 16, 256
N_SEEDS, EV = 4, 400
BASE = Workload("alock", 4, 2, 8, locality=0.9, seed=11)


def _bits(x):
    return "nan" if np.isnan(np.float64(x)) else np.float64(x).tobytes()


def _assert_rows_equal(table, rows):
    """Each key of ``table`` equal, row by row, to the dicts ``rows``."""
    for i, row in enumerate(rows):
        assert list(row) == list(table)
        for k, v in row.items():
            assert _bits(table[k][i]) == _bits(v), (i, k, table[k][i], v)
            if isinstance(v, int):
                assert table[k].dtype == np.int64 and table[k][i] == v, k


def _requests(rng, status, horizon=10**6, soj_hi=10**5):
    """``(S, SLOTS)`` request arrays with statuses drawn from ``status``:
    sorted arrivals over ``horizon``, waits for slots that were
    dispatched, sojourns for the completed ones."""
    arr = np.sort(rng.integers(0, horizon, (S, SLOTS)), axis=1)
    rstat = rng.choice(np.asarray(status, np.int32), (S, SLOTS))
    wq = np.where((rstat == IN_SERVICE) | (rstat == COMPLETED),
                  rng.integers(0, 5000, (S, SLOTS)), -1)
    soj = np.where(rstat == COMPLETED,
                   wq + rng.integers(1, soj_hi, (S, SLOTS)), -1)
    return arr, wq, soj, rstat


def _t_end(rng, lo=10**5, hi=10**6):
    return rng.integers(lo, hi, S)


CASES = {
    # every status, the window ending before the last arrivals
    "mixed": lambda g: (*_requests(g, (0, 1, 2, 3)), _t_end(g)),
    # most arrivals after the window's end
    "late_arrivals": lambda g: (*_requests(g, (0, 1, 2, 3), 10**7),
                                _t_end(g, 10**4, 10**6)),
    # t_end <= 0 counts as 1 ns
    "t_end_not_positive": lambda g: (*_requests(g, (0, 1, 2, 3), 10),
                                     g.integers(-3, 1, S)),
    "all_dropped": lambda g: (*_requests(g, (DROPPED,)), _t_end(g)),
    "none_completed": lambda g: (*_requests(g, (0, 1, 2)), _t_end(g)),
    "all_completed": lambda g: (*_requests(g, (COMPLETED,)), _t_end(g)),
    # sojourns from three values: ties at every percentile's neighbours
    "ties": lambda g: (*_requests(g, (2, 3, 3, 3), soj_hi=3), _t_end(g)),
    # sojourns of ~10**12 ns, far from the guard
    "large_sojourns": lambda g: (*_requests(g, (1, 3), soj_hi=10**12),
                                 _t_end(g, 10**12, 10**13)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_table_equals_serving_summary_row_by_row(case, seed):
    arr, wq, soj, rstat, t_end = CASES[case](np.random.default_rng(seed))
    table, fallback = serving_table(arr, wq, soj, rstat, t_end)
    assert not fallback.any()
    _assert_rows_equal(table, [
        serving_summary(arr[i], wq[i], soj[i], rstat[i], int(t_end[i]))
        for i in range(S)])


@pytest.mark.parametrize("hi", [3, 10**4, 2**40])
def test_percentiles_equal_numpy_at_every_completed_count(hi):
    """Row n holds n completed requests at random slots, n = 0..256."""
    g = np.random.default_rng(hi)
    n_rows = SLOTS + 1
    soj = g.integers(0, hi, (n_rows, SLOTS))
    rstat = np.full((n_rows, SLOTS), DROPPED, np.int32)
    for n in range(n_rows):
        rstat[n, g.permutation(SLOTS)[:n]] = COMPLETED
    table, _ = serving_table(np.zeros_like(soj), soj, soj, rstat,
                             np.full(n_rows, 10**6))
    for n in range(n_rows):
        done = soj[n][rstat[n] == COMPLETED]
        assert done.size == n
        for q in (50, 99):
            want = float(np.percentile(done, q)) if n else float("nan")
            assert _bits(table[f"p{q}_sojourn_ns"][n]) == _bits(want), (n, q)


# (completed value, count, whether the guard sends the row one by one):
# n values each at most (2**53 - 1) // n in magnitude stay exact
GUARD = [(2**53 - 1, 1, False), (2**53, 1, True),
         ((2**53 - 1) // 3, 3, False), ((2**53 - 1) // 3 + 1, 3, True),
         (-((2**53 - 1) // 3) - 1, 3, True), (2**62, 2, True)]


@pytest.mark.parametrize("value,n,falls_back", GUARD)
@pytest.mark.parametrize("column", ["sojourn", "wait"])
def test_guard_at_two_to_the_53(value, n, falls_back, column):
    arr = np.zeros((2, 4), np.int64)
    rstat = np.array([[COMPLETED] * n + [DROPPED] * (4 - n),
                      [COMPLETED, DROPPED, DROPPED, DROPPED]], np.int32)
    big = np.where(rstat[:1] == COMPLETED, value, -1)
    small = np.array([[5, -1, -1, -1]])
    soj = np.concatenate([big if column == "sojourn" else big * 0 + 7,
                          small])
    wq = np.concatenate([big if column == "wait" else big * 0 + 3, small])
    t_end = np.array([10**6, 10**6])
    table, fallback = serving_table(arr, wq, soj, rstat, t_end)
    assert fallback.tolist() == [falls_back, False]
    _assert_rows_equal(table, [serving_summary(arr[i], wq[i], soj[i],
                                               rstat[i], t_end[i])
                               for i in range(2)])


def test_guard_keeps_numpys_mean_where_an_integer_mean_differs():
    """Past 2**53 NumPy's float sum rounds: 2**53 + 1 + 1 sums to 2**53."""
    soj = np.array([[2**53, 1, 1]])
    assert float(soj.sum()) / 3 != float(soj.mean())
    rstat = np.full((1, 3), COMPLETED, np.int32)
    table, fallback = serving_table(np.zeros((1, 3)), soj * 0, soj, rstat,
                                    np.array([10]))
    assert fallback.tolist() == [True]
    assert _bits(table["mean_sojourn_ns"][0]) == _bits(soj.mean())


# -- serving_mean() of a sweep ----------------------------------------------

def _open_workloads():
    return [
        BASE.replace(arrivals=Arrivals(rate_per_us=2.0, max_requests=48,
                                       queue_cap=4)),
        BASE.replace(alg="mcs", arrivals=Arrivals(
            rate_per_us=16.0, max_requests=48, queue_cap=4)),
        BASE.replace(phases=(Phase(frac=0.5),
                             Phase(frac=0.5, rate_per_us=6.0)),
                     arrivals=Arrivals(rate_per_us=1.0, max_requests=48,
                                       token_rate_per_us=2.0,
                                       token_burst=3.0)),
    ]


@pytest.fixture(scope="module")
def results():
    exp = Experiment("serving", n_seeds=N_SEEDS, n_events=EV,
                     options=ExecOptions(device="cpu"))
    for i, w in enumerate(_open_workloads()):
        exp.add(w, label=str(i))
    return [br for _, _, br in exp.run()]


def _seed_mean(rows):
    """The per-seed route's seed mean: each key's NumPy mean over its
    finite values."""
    out = {}
    for k in rows[0]:
        v = np.asarray([r[k] for r in rows], np.float64)
        v = v[np.isfinite(v)]
        out[k] = float(v.mean()) if len(v) else float("nan")
    return out


def _assert_same(got, want):
    assert list(got) == list(want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("w", range(3))
def test_serving_mean_equals_the_per_seed_routes(results, w):
    br = results[w]
    assert br.open_loop and br.n_seeds == N_SEEDS
    batch.reset_exec_stats()
    got = br.serving_mean()
    assert batch.exec_stats()["serving"] == {"passes": 1, "seeds": N_SEEDS,
                                             "fallback": 0}
    assert got["completed"] > 0 and np.isfinite(got["p99_sojourn_ns"])
    # the plain per-seed route of the port
    _assert_same(got, _seed_mean([br.serving(i) for i in range(N_SEEDS)]))
    args = [(br.arr_ns[i], br.wait_ns[i], br.sojourn_ns[i], br.rstat[i],
             int(br.sim_ns[i])) for i in range(N_SEEDS)]
    # the JAX reference's serving_summary, averaged the same way
    _assert_same(got, _seed_mean([ref_metrics.serving_summary(*a)
                                  for a in args]))
    # the benchmark's NumPy reference
    reps = [types.SimpleNamespace(arr=a[0], wait=a[1], sojourn=a[2],
                                  rstat=a[3], t_end=a[4]) for a in args]
    _assert_same(got, aggregate.serving_mean(reps))


def test_serving_mean_falls_back_per_seed_past_the_guard(results):
    br = results[0]
    soj = br.sojourn_ns.copy()
    i = np.flatnonzero(br.rstat[1] == COMPLETED)[0]
    soj[1, i] = 2**53
    big = br._replace(sojourn_ns=soj)
    batch.reset_exec_stats()
    got = big.serving_mean()
    assert batch.exec_stats()["serving"] == {
        "passes": 1, "seeds": N_SEEDS - 1, "fallback": 1}
    _assert_same(got, _seed_mean([big.serving(s) for s in range(N_SEEDS)]))
    batch.reset_exec_stats()
    assert batch.exec_stats()["serving"] == {"passes": 0, "seeds": 0,
                                             "fallback": 0}


def test_serving_mean_needs_an_open_loop_run():
    br = batch.sweep([BASE], n_seeds=2, n_events=20, device="cpu")[0]
    with pytest.raises(ValueError, match="open-loop"):
        br.serving_mean()
