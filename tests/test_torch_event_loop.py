"""The module that holds the kernel: the port's plain event loop against
the JAX reference, bit for bit.

``run_events_plain`` (through the port's ``run_events(backend="plain",
device="cpu")``) is held against ``repro.kernels.event_loop.ref.
run_events_ref`` on all six outputs. Tolerance: none — every comparison is
``np.array_equal`` with dtype and shape. Each case runs once with the
port's own draw stream (``own_streams``) and once with the reference's
stream injected (``ref_streams``), so a fault in the engine can be told
from a fault in the generator.
"""
import numpy as np
import pytest
import torch

import torch_ref as R
from repro_torch.core import machine as mc
from repro_torch.kernels.event_loop import ref as plain
from repro_torch.kernels.event_loop.ops import run_events
from repro_torch.workloads import operands_from_numpy

jax, jnp = R.jax, R.jnp
Workload, Phase = R.ref_workloads.Workload, R.ref_workloads.Phase

EV = 600
ALGS = ("alock", "mcs", "spinlock", "hlock", "alock-rw")
N, TPN, K = 4, 2, 8


def _base(alg, **kw):
    extra = dict(locality=0.8, b_init=(2, 3), seed=5)
    if alg == "hlock":
        extra["topology"] = R.ref_workloads.racks_of(N, 2)
    if alg == "alock-rw":
        extra["read_frac"] = 0.6
    extra.update(kw)
    return Workload(alg, N, TPN, K, **extra)


def _buckets(alg):
    """bucket -> (scenario names, reference workloads). Each bucket is one
    shape bucket: the reference compiles once per bucket, so the phased
    scenarios share one (padded to three phases, as a sweep would)."""
    return {
        "single": (["single_phase", "single_phase_zipf"],
                   [_base(alg), _base(alg, locality=1.0, zipf_s=1.3)]),
        "phased": (["churn_storm", "node_mult_edge", "binit_cost"], [
            _base(alg, phases=(
                Phase(frac=0.3),
                Phase(frac=0.4, down_nodes=(1,), zipf_s=3.0),
                Phase(frac=0.3))),
            _base(alg, node_mult={0: 4.0}, phases=(
                Phase(frac=0.5), Phase(frac=0.5, node_mult={2: 1.25}))),
            _base(alg, phases=(
                Phase(frac=0.34, b_init=(1, 1)),
                Phase(frac=0.33, cost="congested-nic", think=2.0),
                Phase(frac=0.33, b_init=(20, 80)))),
        ]),
    }


SCENARIOS = [(b, s) for b in ("single", "phased")
             for s in _buckets("alock")[b][0]]


def _reference(alg, wl, n_events, lat_samples=None):
    """(reference outputs, reference draw streams) as numpy."""
    T = N * TPN
    tn, ln, _ = R.ref_sim.topology(alg, N, TPN, K)
    kw = {} if lat_samples is None else {"lat_samples": lat_samples}
    with jax.enable_x64(True):
        wj = type(wl)(*(jnp.asarray(a) for a in wl))
        out = R.ref_ref.run_events_ref(alg, T, N, K, n_events, wj, tn, ln,
                                       **kw)
        streams = R.ref_ops.precompute_draws(
            wj.seed, wj.edges, wj.zcdf, n_events, N, K // N,
            rw=alg == "alock-rw")
        return ([np.asarray(o) for o in out],
                [np.asarray(s) for s in streams])


def _port(alg, wl, n_events, streams=None, lat_samples=None):
    T = N * TPN
    tn, ln, _ = R.ref_sim.topology(alg, N, TPN, K)
    ops = operands_from_numpy(tuple(np.asarray(a) for a in wl), "cpu")
    kw = {} if lat_samples is None else {"lat_samples": lat_samples}
    return run_events(alg, T, N, K, n_events, ops, np.asarray(tn),
                      np.asarray(ln), backend="plain", device="cpu",
                      streams=streams, **kw)


_CACHE = {}


def _cached_reference(alg, bucket):
    key = ("ref", alg, bucket)
    if key not in _CACHE:
        wl = R.ref_lowered_batched(_buckets(alg)[bucket][1], EV)
        _CACHE[key] = (wl,) + _reference(alg, wl, EV)
    return _CACHE[key]


def _cached_port(alg, bucket, inject):
    key = ("port", alg, bucket, inject)
    if key not in _CACHE:
        wl, _, streams = _cached_reference(alg, bucket)
        _CACHE[key] = _port(alg, wl, EV, streams=streams if inject else None)
    return _CACHE[key]


def _row(outs, i):
    return [np.asarray(o)[i:i + 1] for o in outs]


def _check_scenario(alg, bucket, scen, inject):
    _, ref, _ = _cached_reference(alg, bucket)
    i = _buckets(alg)[bucket][0].index(scen)
    port = [o.numpy() for o in _cached_port(alg, bucket, inject)]
    assert int(ref[0][i].sum()) > 0                     # work was done
    R.assert_bitwise(_row(ref, i), _row(port, i), R.OUT_NAMES)


@pytest.mark.parametrize("bucket,scen", SCENARIOS)
@pytest.mark.parametrize("alg", ALGS)
def test_plain_own_streams_bitwise(alg, bucket, scen):
    _check_scenario(alg, bucket, scen, inject=False)


@pytest.mark.parametrize("bucket,scen", SCENARIOS)
@pytest.mark.parametrize("alg", ALGS)
def test_plain_ref_streams_bitwise(alg, bucket, scen):
    _check_scenario(alg, bucket, scen, inject=True)


@pytest.mark.parametrize("alg", ["alock", "spinlock"])
def test_ring_overflow_small_lat_samples(alg):
    """More completions than ring slots: the slot index wraps."""
    wl = R.ref_lowered_batched([_base(alg, locality=1.0)], EV)
    ref, _ = _reference(alg, wl, EV, lat_samples=16)
    assert int(ref[2][0]) > 16
    R.assert_bitwise(ref, _port(alg, wl, EV, lat_samples=16), R.OUT_NAMES)


@pytest.mark.parametrize("B", [1, 5])
def test_replica_counts(B):
    ws = [_base("alock", locality=l) for l in
          (0.5, 0.7, 0.85, 0.95, 1.0)[:B]]
    wl = R.ref_lowered_batched(ws, EV, seeds=np.arange(B) + 11)
    ref, _ = _reference("alock", wl, EV)
    out = _port("alock", wl, EV)
    assert tuple(out[0].shape) == (B, N * TPN)
    R.assert_bitwise(ref, out, R.OUT_NAMES)


def test_plain_matches_pallas_interpret():
    """One case also against the Pallas kernel itself, run as the
    reference's own tests run it on the CPU (interpret mode)."""
    alg = "alock"
    wl, _, _ = _cached_reference(alg, "phased")
    tn, ln, _ = R.ref_sim.topology(alg, N, TPN, K)
    with jax.enable_x64(True):
        wj = type(wl)(*(jnp.asarray(a) for a in wl))
        out = R.ref_ops.run_events(alg, N * TPN, N, K, EV, wj, tn, ln,
                                   tile=2, ev_chunk=256, interpret=True)
        out = [np.asarray(o) for o in out]
    R.assert_bitwise(out, _port(alg, wl, EV), R.OUT_NAMES)


def test_zero_events_is_the_empty_run():
    wl = R.ref_lowered_batched([_base("alock")], 10)
    done, lat, lat_n, t_end, nreacq, npass = _port("alock", wl, 0)
    assert int(done.sum()) == 0 and int(lat_n) == 0 and int(t_end) == 0
    assert bool((lat == -1).all())


def test_open_loop_bucket_returns_ten_outputs():
    """An open-loop bucket returns the ten outputs, the last four ``(B, R)``
    (``tests/test_torch_open_loop.py`` holds them against the
    reference)."""
    arr = R.ref_workloads.Arrivals(rate_per_us=1.0, max_requests=8)
    wl = R.ref_lowered_batched([_base("alock", arrivals=arr)], 200)
    out = _port("alock", wl, 200)
    assert len(out) == 10
    assert [tuple(o.shape) for o in out[6:]] == [(1, 8)] * 4


@pytest.mark.parametrize("racks", [(0, 0, 1, 1), (0, 1, 1, 1)])
def test_hlock_churn_shares_a_bucket_with_steady(racks, monkeypatch):
    """The benchmark's ``rack-churn-20n`` in small: hlock, steady and with
    node 3 parked for the middle 40 % of the events, padded into one
    bucket (three phases), against the reference; the ``diag``'s lock
    operations begun and begun on the loopback tier against a recount of
    the plain route's trajectory (a lock step of another node of the
    taker's rack)."""
    ws = [_base("hlock", topology=racks, locality=0.6),
          _base("hlock", topology=racks, locality=0.6, phases=(
              Phase(frac=0.3), Phase(frac=0.4, down_nodes=(3,)),
              Phase(frac=0.3)))]
    wl = R.ref_lowered_batched(ws, EV, seeds=[21, 22])
    assert wl.edges.shape == (2, 3)
    ref, _ = _reference("hlock", wl, EV)
    seen = {"ops": torch.zeros(2, dtype=torch.int64),
            "loop": torch.zeros(2, dtype=torch.int64)}
    step = plain.sem_step

    def recount(alg, sem, tid, binit, tn, ln, new_t, new_c, new_r, rk):
        out = step(alg, sem, tid, binit, tn, ln, new_t, new_c, new_r, rk)
        rows = torch.arange(sem.pc.shape[0])
        began = sem.pc[rows, tid] == mc.NCS
        mine = tn[rows, tid]
        lnode = ln[rows, out[0].target[rows, tid]]
        seen["ops"] += began
        seen["loop"] += (began & (lnode != mine)
                         & (rk[rows, lnode] == rk[rows, mine]))
        return out

    monkeypatch.setattr(plain, "sem_step", recount)
    tn, ln, _ = R.ref_sim.topology("hlock", N, TPN, K)
    diag = torch.full((2, plain.DIAG_COLS), -7, dtype=torch.int32)
    out = run_events("hlock", N * TPN, N, K, EV,
                     operands_from_numpy(tuple(np.asarray(a) for a in wl),
                                         "cpu"),
                     np.asarray(tn), np.asarray(ln), backend="plain",
                     device="cpu", diag=diag)
    R.assert_bitwise(ref, out, R.OUT_NAMES)
    # parked threads made no step: node 3's threads did less than their
    # steady twins
    assert (ref[0][1, 6:].sum() < ref[0][0, 6:].sum())
    assert diag[:, 0].tolist() == [EV, EV] and (diag[:, 1] == 0).all()
    assert diag[:, 2].tolist() == seen["ops"].tolist()
    assert diag[:, 3].tolist() == [0, 0]
    assert diag[:, 4].tolist() == seen["loop"].tolist()
    assert (0 < diag[:, 4]).all() and (diag[:, 4] < diag[:, 2]).all()
