"""Sharded and chunked dispatch: ``sweep(devices=, chunk=)`` on the CPU.

Mirrors the reference's chunked cases (``tests/test_event_loop_kernel.py``:
``chunk=2`` on one bucket of 6 rows, a ragged three-bucket sweep at
``chunk=1``) and holds every ``BatchResult`` array, with tolerance zero, to
the port's unsharded sweep and to the reference's chunked sweep. A device
list may name the CPU twice, which splits each superchunk into two shards;
an odd row count then takes one padding row that must be cut off.
"""
import numpy as np
import pytest
import torch

import torch_ref as R
from repro_torch.core import batch
from repro_torch.core.sim import SimConfig
from repro_torch.experiments import ExecOptions, Experiment
from repro_torch.parallel import sharding
from repro_torch.workloads import Arrivals, Phase, Workload

EV = 200
ARRAYS = ("seeds", "ops", "sim_ns", "throughput_mops", "lat_ns",
          "per_thread_ops", "reacquires", "passes")
OPEN = ARRAYS + ("arr_ns", "wait_ns", "sojourn_ns", "rstat")


def _assert_same(a, b, fields=ARRAYS):
    for f in fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f


def _one_bucket():
    """One bucket of three alock configs (the reference test's)."""
    return [("alock", 2, 2, 8, l, (2, 3), s, z)
            for l, s, z in ((0.9, 7, 0.0), (0.5, 1, 1.2), (0.95, 3, 0.0))]


def _ragged():
    """Three buckets of 3, 2 and 1 configs (the reference test's)."""
    return ([("alock", 2, 2, 8, l, (2, 3), i)
             for i, l in enumerate((0.85, 0.9, 1.0))]
            + [("mcs", 2, 2, 8, l, (5, 20), 3 + i)
               for i, l in enumerate((0.5, 0.95))]
            + [("spinlock", 2, 2, 8, 0.9, (5, 20), 5)])


def _port_and_ref(specs, n_seeds, chunk):
    """The port's unsharded and chunked sweeps, their dispatch counts, and
    the reference's chunked sweep, on the same SimConfigs."""
    port = [SimConfig(*s) for s in specs]
    ref = [R.ref_sim.SimConfig(*s) for s in specs]
    base = batch.sweep(port, n_seeds=n_seeds, n_events=EV, device="cpu")
    batch.reset_exec_stats()
    got = batch.sweep(port, n_seeds=n_seeds, n_events=EV, device="cpu",
                      chunk=chunk)
    st = batch.exec_stats()
    want = R.ref_batch.sweep(ref, n_seeds=n_seeds, n_events=EV,
                             backend="xla", chunk=chunk)
    return base, got, st, want


def test_chunk_two_on_one_bucket_is_two_dispatches():
    # 6 rows, 3 units of 2 rows: superchunks of 4 and 2 rows
    base, got, st, want = _port_and_ref(_one_bucket(), 2, 2)
    assert st["dispatches"] == 2
    for b, g, w in zip(base, got, want):
        _assert_same(b, g)
        _assert_same(w, g)


def test_ragged_three_buckets_at_chunk_one_is_four_dispatches():
    # 6, 4 and 2 rows: [4, 2], [4] and [2] rows -> 4 dispatches
    specs = _ragged()
    assert len({batch.shape_key(SimConfig(*s), EV) for s in specs}) == 3
    base, got, st, want = _port_and_ref(specs, 2, 1)
    assert st["dispatches"] == 4
    for b, g, w in zip(base, got, want):
        _assert_same(b, g)
        _assert_same(w, g)


def test_two_shards_on_one_device_cut_the_padding_row():
    w = Workload("spinlock", 2, 2, 8, locality=0.9, seed=2,
                 phases=(Phase(frac=0.5), Phase(frac=0.5, zipf_s=1.5)))
    base = batch.sweep([w], n_seeds=3, n_events=EV, device="cpu")[0]
    batch.reset_exec_stats()
    got = batch.sweep([w], n_seeds=3, n_events=EV, device="cpu",
                      devices=["cpu", "cpu"])[0]
    assert batch.exec_stats()["dispatches"] == 1
    assert got.ops.shape == (3,)
    _assert_same(base, got)


def test_open_loop_bucket_all_outputs():
    w = Workload("alock", 2, 2, 8, locality=0.9, seed=4,
                 arrivals=Arrivals(rate_per_us=4.0, max_requests=16,
                                   queue_cap=4))
    ref_w = R.ref_workloads.Workload(
        "alock", 2, 2, 8, locality=0.9, seed=4,
        arrivals=R.ref_workloads.Arrivals(rate_per_us=4.0, max_requests=16,
                                          queue_cap=4))
    base = batch.sweep([w], n_seeds=3, n_events=EV, device="cpu")[0]
    batch.reset_exec_stats()
    got = batch.sweep([w], n_seeds=3, n_events=EV, device="cpu",
                      devices=["cpu", "cpu"], chunk=1)[0]
    # 3 rows padded to 4: two units of 2 rows -> one superchunk
    assert batch.exec_stats()["dispatches"] == 1
    want = R.ref_batch.sweep([ref_w], n_seeds=3, n_events=EV,
                             backend="xla", chunk=1)[0]
    assert got.open_loop and got.rstat.shape == (3, 16)
    _assert_same(base, got, OPEN)
    _assert_same(want, got, OPEN)


@pytest.mark.parametrize("B,D,chunk,parts", [
    (6, 1, 2, [(0, 4), (4, 2)]),
    (4, 1, 1, [(0, 4)]),
    (7, 2, None, [(0, 8)]),
    (96, 1, 32, [(0, 64), (64, 32)]),
    (96, 1, 40, [(0, 80), (80, 16)]),
    (5, 2, 1, [(0, 4), (4, 2)]),
    (1, 3, 4, [(0, 3)]),
])
def test_superchunks_follow_the_reference_arithmetic(B, D, chunk, parts):
    assert sharding.superchunks(B, D, chunk) == parts
    n_units = sharding.units(B, D, chunk)
    assert len(parts) == bin(n_units).count("1")
    # every superchunk splits into D equal shards that tile its rows
    for off, nrows in parts:
        cut = sharding.shards(off, nrows, D)
        assert [n for _, n in cut] == [nrows // D] * D
        assert cut[0][0] == off and sum(n for _, n in cut) == nrows
    assert sum(n for _, n in parts) == sharding.padded_rows(B, D)
    assert sharding.padded_rows(B, D) - B < D


def test_pad_rows_repeats_the_last_row():
    a = np.arange(6).reshape(3, 2)
    assert sharding.pad_rows(a, 0) is a
    np.testing.assert_array_equal(sharding.pad_rows(a, 2)[3:], [[4, 5]] * 2)


def test_chunk_below_one_and_mixed_devices_raise():
    w = Workload("alock", 2, 2, 8, locality=0.9)
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        batch.sweep([w], n_events=50, device="cpu", chunk=0)
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        sharding.rows_per_unit(4, 1, 0)
    with pytest.raises(ValueError, match="one type"):
        sharding.resolve_devices(["cpu", "meta"], "cpu")
    with pytest.raises(ValueError, match="one type"):
        batch.sweep([w], n_events=50, device="cpu", devices=["cpu", "cuda"])
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        ExecOptions(device="cpu", chunk=0)


def test_device_list_and_experiment_run():
    assert ExecOptions(device="cpu").device_list() is None
    assert ExecOptions(device="cpu", devices=1).device_list() \
        == [torch.device("cpu")]
    with pytest.raises(ValueError, match="only 1 cpu device"):
        ExecOptions(device="cpu", devices=2).device_list()
    opts = ExecOptions(device="cpu", devices=1, chunk=1)
    assert opts.sweep_kwargs() == {"backend": "auto", "device": "cpu",
                                   "devices": [torch.device("cpu")],
                                   "chunk": 1}
    exp = Experiment("chunked", n_seeds=3, n_events=EV, options=opts)
    exp.add(Workload("mcs", 2, 2, 8, locality=0.8, seed=1), label="m")
    batch.reset_exec_stats()
    got = exp.run()["m"]
    assert batch.exec_stats()["dispatches"] == 2      # units 3 -> [2, 1]
    want = batch.sweep([Workload("mcs", 2, 2, 8, locality=0.8, seed=1)],
                       n_seeds=3, n_events=EV, device="cpu")[0]
    _assert_same(want, got)


def test_from_env_reads_the_port_backend_names(monkeypatch):
    monkeypatch.delenv("REPRO_BACKEND", raising=False)
    assert ExecOptions.from_env().backend == "auto"
    monkeypatch.setenv("REPRO_BACKEND", "plain")
    o = ExecOptions.from_env(device="cpu", chunk=4, devices=None,
                             backend=None)
    assert (o.backend, o.device, o.chunk, o.devices) == ("plain", "cpu", 4,
                                                         None)
    assert ExecOptions.from_env(backend="kernel").backend == "kernel"
    for name in ("xla", "pallas", "bogus"):
        monkeypatch.setenv("REPRO_BACKEND", name)
        with pytest.raises(ValueError, match="'auto', 'kernel', 'plain'"):
            ExecOptions.from_env()
