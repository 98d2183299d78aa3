"""The hi/lo int32 output contract: ``i32pair``, ``arrival_times_pairs`` and
``run_events_pairs`` of the port against the reference's.

``pack`` / ``unpack`` (torch) and ``pack_np`` / ``unpack_np`` are held to
the reference's numpy helpers at the carry edges, at INT64 min and max and
at ``NEVER``; ``run_events_pairs(device="cpu")`` (the plain engine, its
clocks split) to the reference's ``run_events_pairs(interpret=True)`` (its
Pallas kernel in the hi/lo representation, run as its own tests run it on
the CPU), element for element, closed and open, with zero events too.
"""
import numpy as np
import pytest
import torch

import torch_ref as R
from repro_torch.kernels.event_loop import i32pair
from repro_torch.kernels.event_loop.ops import run_events, run_events_pairs
from repro_torch.traffic import arrival_times_i64, arrival_times_pairs
from repro_torch.workloads import operands_from_numpy

jax, jnp = R.jax, R.jnp
I64 = np.iinfo(np.int64)
EDGES = np.array(
    [I64.min, I64.min + 1, I64.max, I64.max - 1, -1, 0, 1,
     2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 1, -2**31, -2**31 - 1,
     -2**32, -2**32 - 1, -2**32 + 1, 2**62 + 2**31, -(2**62) - 2**31,
     int(i32pair.pack_np(*i32pair.NEVER))], np.int64)
LAT = 64
EV = 200


def _pairs_np(p):
    return tuple(np.asarray(a) for a in p)


def test_never_is_int64_max():
    assert i32pair.NEVER == R.ref_i32pair.NEVER
    assert i32pair.NEVER[0].dtype == np.int32
    assert int(i32pair.pack_np(*i32pair.NEVER)) == I64.max


def test_unpack_and_pack_equal_reference_at_the_edges():
    rng = np.random.default_rng(0)
    x = np.concatenate([EDGES, rng.integers(I64.min, I64.max, 4096,
                                            dtype=np.int64)])
    want_hi, want_lo = R.ref_i32pair.unpack_np(x)
    hi, lo = i32pair.unpack(torch.from_numpy(x))
    assert hi.dtype == lo.dtype == torch.int32
    np.testing.assert_array_equal(hi.numpy(), want_hi)
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    np_hi, np_lo = i32pair.unpack_np(x)
    assert np_hi.dtype == np_lo.dtype == np.int32
    np.testing.assert_array_equal(np_hi, want_hi)
    np.testing.assert_array_equal(np_lo, want_lo)
    back = i32pair.pack((hi, lo))
    assert back.dtype == torch.int64
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(i32pair.pack_np(want_hi, want_lo), x)
    np.testing.assert_array_equal(
        i32pair.pack_np(want_hi, want_lo),
        R.ref_i32pair.pack_np(want_hi, want_lo))


def test_pack_of_any_int32_pair_equals_reference():
    rng = np.random.default_rng(1)
    hi = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    lo = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    hi[:4] = [-2**31, 2**31 - 1, 0, -1]
    lo[:4] = [-1, -2**31, 2**31 - 1, 0]
    want = R.ref_i32pair.pack_np(hi, lo)
    got = i32pair.pack((torch.from_numpy(hi), torch.from_numpy(lo)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_arrival_times_pairs_equal_reference():
    rng = np.random.default_rng(2)
    gaps = rng.integers(0, 2**31 - 1, (3, 40), dtype=np.int64).astype(
        np.int32)
    gaps[1] = 2**31 - 1                       # the sum carries into hi
    gaps[2, ::3] = -5
    want = jax.vmap(R.ref_traffic_stream.arrival_times_pairs)(
        jnp.asarray(gaps))
    got = arrival_times_pairs(torch.from_numpy(gaps))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        i32pair.pack(got).numpy(),
        arrival_times_i64(torch.from_numpy(gaps)).numpy())
    assert int(i32pair.pack(got)[1, -1]) > 2**32


def _workloads(open_loop):
    W = R.ref_workloads
    base = W.Workload("alock", 2, 2, 8, locality=0.8, b_init=(2, 3), seed=5)
    if not open_loop:
        return [base, base.replace(phases=(
            W.Phase(frac=0.5), W.Phase(frac=0.5, down_nodes=(1,),
                                       zipf_s=2.0)))]
    arr = W.Arrivals(rate_per_us=4.0, max_requests=16, queue_cap=4)
    return [base.replace(arrivals=arr),
            base.replace(seed=6, arrivals=arr)]


def _flat(out):
    """A pairs tuple as a flat list of numpy arrays."""
    flat = []
    for o in out:
        flat.extend(_pairs_np(o) if isinstance(o, tuple) else
                    [np.asarray(o)])
    return flat


@pytest.mark.parametrize("n_events", [0, EV])
@pytest.mark.parametrize("open_loop", [False, True], ids=["closed", "open"])
def test_run_events_pairs_equals_reference_interpret(open_loop, n_events):
    wl = R.ref_lowered_batched(_workloads(open_loop), EV)
    alg, N, TPN, K = "alock", 2, 2, 8
    T = N * TPN
    tn, ln, _ = R.ref_sim.topology(alg, N, TPN, K)
    wj = type(wl)(*(jnp.asarray(a) for a in wl))
    want = R.ref_ops.run_events_pairs(alg, T, N, K, n_events, wj, tn, ln,
                                      tile=2, ev_chunk=128, interpret=True,
                                      lat_samples=LAT)
    ops = operands_from_numpy(tuple(np.asarray(a) for a in wl), "cpu")
    got = run_events_pairs(alg, T, N, K, n_events, ops, np.asarray(tn),
                           np.asarray(ln), lat_samples=LAT, backend="plain",
                           device="cpu")
    assert len(got) == len(want) == (10 if open_loop else 6)
    assert [isinstance(o, tuple) for o in got] \
        == [isinstance(o, tuple) for o in want]
    R.assert_bitwise(_flat(want), _flat(got))
    # packed back, the pairs are run_events' int64 outputs
    plain = run_events(alg, T, N, K, n_events, ops, np.asarray(tn),
                       np.asarray(ln), lat_samples=LAT, backend="plain",
                       device="cpu")
    for p, o in zip(got, plain):
        if isinstance(p, tuple):
            assert torch.equal(i32pair.pack(p), o)
        else:
            assert torch.equal(p, o)
    if n_events:
        assert int(plain[0].sum()) > 0


def test_run_events_pairs_kernel_backend_needs_cuda():
    wl = R.ref_lowered_batched(_workloads(False)[:1], 10)
    ops = operands_from_numpy(tuple(np.asarray(a) for a in wl), "cpu")
    tn, ln, _ = R.ref_sim.topology("alock", 2, 2, 8)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        run_events_pairs("alock", 4, 2, 8, 10, ops, tn, ln,
                         backend="kernel", device="cpu")
