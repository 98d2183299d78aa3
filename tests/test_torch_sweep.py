"""The slice as a whole: the port's ``Experiment`` / ``sweep`` against the
reference's, on the CPU with the plain engine.

Every ``BatchResult`` array must be equal with tolerance zero
(``np.array_equal`` with dtype and shape) and every derived aggregate
equal as a float.
"""
import math

import numpy as np
import pytest
import torch

import torch_ref as R
from repro_torch.core import batch
from repro_torch.core.sim import simulate
from repro_torch.experiments import ExecOptions, Experiment

N_EVENTS = 1500
N_SEEDS = 2
ARRAYS = ("seeds", "ops", "sim_ns", "throughput_mops", "lat_ns",
          "per_thread_ops", "reacquires", "passes")
CPU = ExecOptions(device="cpu")
Phase = R.ref_workloads.Phase


def _same_float(a, b):
    return (math.isnan(a) and math.isnan(b)) or a == b


def _assert_batch_equal(ref_br, port_br):
    R.assert_bitwise([getattr(ref_br, f) for f in ARRAYS],
                     [getattr(port_br, f) for f in ARRAYS], ARRAYS)
    assert port_br.n_events == ref_br.n_events
    assert port_br.n_seeds == ref_br.n_seeds
    for prop in ("mean_mops", "ci95_mops", "p50_lat_ns", "p99_lat_ns",
                 "mean_lat_us"):
        assert _same_float(getattr(ref_br, prop), getattr(port_br, prop)), \
            prop
    assert ref_br.lat_pct(99) == port_br.lat_pct(99)
    assert ref_br.lat_pct(50) == port_br.lat_pct(50)


@pytest.fixture(scope="module")
def fig5():
    ref_ws = R.ref_registry.fig5_workloads()
    ref_exp = R.ref_experiments.Experiment(
        "fig5", n_seeds=N_SEEDS, n_events=N_EVENTS,
        options=R.ref_experiments.ExecOptions(backend="xla"))
    port_exp = Experiment("fig5", n_seeds=N_SEEDS, n_events=N_EVENTS,
                          options=CPU)
    for i, w in enumerate(ref_ws):
        ref_exp.add(w, label=f"w{i}")
        port_exp.add(R.to_port(w), label=f"w{i}")
    # a duplicate entry rides the dedupe, as in the paper-scale grid
    ref_exp.add(ref_ws[0], label="dup")
    port_exp.add(R.to_port(ref_ws[0]), label="dup")
    ref_res = ref_exp.run()
    batch.reset_exec_stats()
    port_res = port_exp.run()
    return ref_ws, ref_res, port_res, batch.exec_stats()


@pytest.mark.parametrize("i", range(9))
def test_fig5_workload_equals_reference(fig5, i):
    ref_ws, ref_res, port_res, _ = fig5
    assert port_res.labels == ref_res.labels
    _assert_batch_equal(ref_res[f"w{i}"], port_res[f"w{i}"])
    assert port_res[f"w{i}"].ops.sum() > 0


def test_fig5_one_dispatch_per_bucket(fig5):
    ref_ws, ref_res, port_res, stats = fig5
    assert len(ref_ws) == 9 and len(port_res) == 10
    assert stats["dispatches"] == 3          # one bucket per algorithm
    assert stats["launches"] == 0            # plain engine: no kernel
    assert port_res["dup"] is port_res["w0"]
    assert port_res[R.to_port(ref_ws[4])] is port_res["w4"]


@pytest.mark.parametrize("i,seed_idx", [(0, 0), (4, 1), (8, 1)])
def test_result_equals_simulate_with_that_seed(fig5, i, seed_idx):
    ref_ws, _, port_res, _ = fig5
    br = port_res[f"w{i}"]
    w = R.to_port(ref_ws[i])
    one = simulate(w.replace(seed=int(br.seeds[seed_idx])),
                   n_events=N_EVENTS, device="cpu")
    got = br.result(seed_idx)
    assert (got.ops, got.sim_ns, got.reacquires, got.passes) \
        == (one.ops, one.sim_ns, one.reacquires, one.passes)
    assert got.throughput_mops == one.throughput_mops
    R.assert_bitwise([one.lat_ns, one.per_thread_ops],
                     [got.lat_ns, got.per_thread_ops])


def test_mixed_phase_bucket_equals_reference():
    """Workloads with 1, 2 and 3 phases share one bucket (``pad_phases``)
    and one dispatch."""
    base = R.ref_workloads.Workload("alock", 4, 2, 8, locality=0.85,
                                    b_init=(2, 3), seed=3)
    ref_ws = [
        base,
        base.replace(phases=(Phase(frac=0.5),
                             Phase(frac=0.5, zipf_s=2.5, think=2.0))),
        base.replace(node_mult={1: 3.0}, phases=(
            Phase(frac=0.3), Phase(frac=0.4, down_nodes=(2,)),
            Phase(frac=0.3, cost="congested-nic"))),
    ]
    ref = R.ref_batch.sweep(ref_ws, n_seeds=N_SEEDS, n_events=N_EVENTS,
                            backend="xla")
    batch.reset_exec_stats()
    port = batch.sweep([R.to_port(w) for w in ref_ws], n_seeds=N_SEEDS,
                       n_events=N_EVENTS, device="cpu")
    assert batch.exec_stats()["dispatches"] == 1
    for r, p in zip(ref, port):
        _assert_batch_equal(r, p)


def test_legacy_simconfig_rides_the_adapter():
    from repro_torch.core.sim import SimConfig
    ref = R.ref_batch.sweep(
        [R.ref_sim.SimConfig("mcs", 2, 2, 8, 0.9, seed=1)],
        n_seeds=1, n_events=600, backend="xla")[0]
    port = batch.sweep([SimConfig("mcs", 2, 2, 8, 0.9, seed=1)],
                       n_seeds=1, n_events=600, device="cpu")[0]
    _assert_batch_equal(ref, port)


def _with_lat(mod, lat, *stats):
    z = np.zeros(lat.shape[0], np.int64)
    return mod.BatchResult(None, 1, z, z, z, z.astype(np.float64), lat,
                           np.zeros((lat.shape[0], 2), np.int32), z, z,
                           *stats)


@pytest.mark.parametrize("case", ["ring", "sparse", "below_2_53",
                                  "above_2_53", "empty"])
def test_mean_latency_equals_the_reference_pool_mean(case):
    """``mean_lat_us`` reads the ring's sum and count from ``lat_stats``
    where every partial sum stays below 2**53 and takes the pool's mean
    otherwise: either way the reference's float, ``==``."""
    g = np.random.default_rng(7)
    lat = g.integers(0, 5_000_000, size=(4, 1000), dtype=np.int64)
    if case == "sparse":
        lat[g.random(lat.shape) < 0.9] = -1
    elif case in ("below_2_53", "above_2_53"):
        # the largest sample times the pool's size just below or above
        top = 2**53 // lat.size + (0 if case == "below_2_53" else 1)
        lat = g.integers(top // 2, top, size=lat.shape, dtype=np.int64)
        lat[0, 0] = top - (1 if case == "below_2_53" else 0)
    elif case == "empty":
        lat[:] = -1
    stats = batch._lat_stats(torch.from_numpy(lat)).numpy()
    want = _with_lat(R.ref_batch, lat).mean_lat_us
    got = _with_lat(batch, lat, stats).mean_lat_us
    assert _same_float(want, got), (want, got)
