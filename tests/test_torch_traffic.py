"""The open loop's arrival plan and serving metrics: the port against the
JAX reference, bit for bit.

``log1p_f32`` is held against ``jnp.log1p`` as jitted f32 code on 2·10⁶
uniform inputs in (-1, 0], the 10⁴ f32 values nearest -1 and 0, as raw
bit patterns. The port's ``arrival_plan`` (batched over replicas) is held
against the reference's ``arrival_plan`` vmapped over replicas, on every
case ``chip_smoke.py`` uses plus trace replay with jitter and the
unbounded queue. Tolerance: none — every comparison is
``np.array_equal`` with dtype and shape.
"""
import fractions

import numpy as np
import pytest
import torch

import torch_ref as R
import repro.traffic.metrics as ref_metrics
import repro.traffic.stream as ref_stream
from repro_torch.traffic import metrics, stream
from repro_torch.workloads import operands_from_numpy

jax, jnp = R.jax, R.jnp
Workload, Phase = R.ref_workloads.Workload, R.ref_workloads.Phase
Arrivals = R.ref_workloads.Arrivals
PLAN_NAMES = ("gaps", "tok", "tokcum", "qcap")
N_EVENTS = 150_000
SEEDS = (0, 1, 7, 2**31 - 1)
BASE = Workload("alock", 4, 4, 16, locality=0.95)
RAMP_RATES = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0)
BURST_PH = (Phase(frac=0.4), Phase(frac=0.2, rate_per_us=12.0),
            Phase(frac=0.4))


@pytest.fixture(scope="module")
def uniforms():
    """2·10⁶ f32 uniforms, the 10⁴ f32 values just below 1, and 0."""
    u = np.random.default_rng(0).random(2_000_000, dtype=np.float32)
    near_one = (1.0 - np.arange(1, 10_001) * 2.0**-24).astype(np.float32)
    return np.concatenate([u, near_one, np.float32([0.0])])


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_log1p_f32_equals_xla_bitwise(uniforms):
    x = -uniforms
    ref = np.asarray(jax.jit(jnp.log1p)(jnp.asarray(x)))
    got = stream.log1p_f32(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert int((_bits(ref) != _bits(got)).sum()) == 0


def test_torch_log1p_is_not_enough(uniforms):
    """Why ``log1p_f32`` exists: ``torch.log1p`` rounds differently from
    XLA's f32 log1p, and at 1 req/us that moves integer arrival gaps by
    1 ns (each such gap shifts every later arrival of its replica)."""
    u = torch.from_numpy(uniforms)
    gap = np.float32(1000.0)
    ref = np.asarray(jax.jit(
        lambda v: jnp.round(-jnp.log1p(-v) * gap).astype(jnp.int32))(
            jnp.asarray(uniforms)))
    mine = torch.round(-stream.log1p_f32(-u) * gap).to(torch.int32)
    plain = torch.round(-torch.log1p(-u) * gap).to(torch.int32)
    assert int((mine.numpy() != ref).sum()) == 0
    assert int((plain.numpy() != ref).sum()) > 0
    assert int((_bits(torch.log1p(-u)) != _bits(
        np.asarray(jax.jit(jnp.log1p)(jnp.asarray(-uniforms))))).sum()) > 0


def test_unfused_sequence_is_not_enough(uniforms, monkeypatch):
    """Why ``fma_f32`` exists: XLA's sequence with every multiply-add
    rounded twice misses the reference on some inputs (its code generator
    fuses them)."""
    x = -uniforms
    ref = np.asarray(jax.jit(jnp.log1p)(jnp.asarray(x)))
    monkeypatch.setattr(stream, "fma_f32", lambda a, b, c: a * b + c)
    got = stream.log1p_f32(torch.from_numpy(x)).numpy()
    assert int((_bits(ref) != _bits(got)).sum()) > 0


def test_fma_f32_is_correctly_rounded():
    """``fma_f32`` against exact rational arithmetic, including products
    that cancel against the addend."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    c = rng.standard_normal(3000).astype(np.float32)
    c[:1000] = -(a[:1000].astype(np.float64) * b[:1000]).astype(np.float32)
    got = stream.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(c)).numpy()
    for ai, bi, ci, gi in zip(a, b, c, got):
        exact = (fractions.Fraction(float(ai)) * fractions.Fraction(float(bi))
                 + fractions.Fraction(float(ci)))
        # the correctly rounded f32 is this f32 or a neighbour of it: take
        # the nearest to the exact value, ties to the even bit pattern
        want = np.float32(float(exact))
        lo, hi = np.nextafter(want, -np.inf), np.nextafter(want, np.inf)
        best = min((want, lo, hi),
                   key=lambda v: (abs(fractions.Fraction(float(v)) - exact),
                                  int(np.float32(v).view(np.uint32)) & 1))
        assert gi.view(np.uint32) == np.float32(best).view(np.uint32)


def _plan_cases():
    ramp = [BASE.replace(arrivals=Arrivals(rate_per_us=r, max_requests=256,
                                           queue_cap=32))
            for r in RAMP_RATES]
    burst = [BASE.replace(phases=BURST_PH, arrivals=a) for a in (
        Arrivals(rate_per_us=1.0, max_requests=256),
        Arrivals(rate_per_us=1.0, max_requests=256, queue_cap=16),
        Arrivals(rate_per_us=1.0, max_requests=256, token_rate_per_us=2.0,
                 token_burst=16.0))]
    trace = tuple(int(t) for t in np.cumsum(
        np.random.default_rng(1).integers(0, 900, 200)))
    return {
        "ramp_rates": ramp,
        "token": [BASE.replace(arrivals=Arrivals(
            rate_per_us=4.0, max_requests=256, token_rate_per_us=2.0,
            token_burst=16.0))],
        "burst_storm_phased": burst,
        "trace_replay_jitter": [BASE.replace(arrivals=Arrivals(
            trace_ns=trace, rate_per_us=3.0))],
        "trace_replay_exact": [BASE.replace(arrivals=Arrivals(
            trace_ns=trace))],
        "unbounded_queue": [BASE.replace(arrivals=Arrivals(
            rate_per_us=16.0, max_requests=256))],
    }


@pytest.mark.parametrize("case", list(_plan_cases()))
def test_arrival_plan_equals_reference(case):
    ws = _plan_cases()[case]
    # every workload of the case at every seed, one batch
    seeds = np.repeat(np.asarray(SEEDS, np.int64), len(ws)).astype(np.int32)
    wl = R.ref_lowered_batched([w for _ in SEEDS for w in ws], N_EVENTS,
                               seeds=seeds)
    with jax.enable_x64(True):
        wj = type(wl)(*(jnp.asarray(a) for a in wl))
        ref = jax.vmap(lambda w: ref_stream.arrival_plan(w, N_EVENTS))(wj)
        ref_arr = jax.vmap(ref_stream.arrival_times_i64)(ref.gaps)
        ref = [np.asarray(a) for a in ref] + [np.asarray(ref_arr)]
    ops = operands_from_numpy(tuple(np.asarray(a) for a in wl), "cpu")
    got = stream.arrival_plan(ops, N_EVENTS)
    got = list(got) + [stream.arrival_times_i64(got.gaps)]
    R.assert_bitwise(ref, got, PLAN_NAMES + ("arr",))
    assert int(np.asarray(ref[0]).sum()) > 0


def test_token_bucket_rejects_some():
    """The token case really exercises the bucket (rejects happen)."""
    wl = R.ref_lowered_batched(_plan_cases()["token"], N_EVENTS)
    got = stream.arrival_plan(
        operands_from_numpy(tuple(np.asarray(a) for a in wl), "cpu"),
        N_EVENTS)
    tok = got.tok.numpy()
    assert 0 < tok.sum() < tok.size


def _request_arrays(seed):
    rng = np.random.default_rng(seed)
    R_ = 64
    arr = np.cumsum(rng.integers(0, 2000, R_)).astype(np.int64)
    rstat = rng.integers(0, 4, R_).astype(np.int32)
    wq = np.where(rstat % 2 == 1, rng.integers(0, 5000, R_), -1)
    soj = np.where(rstat == 3, wq + rng.integers(100, 9000, R_), -1)
    return arr, wq.astype(np.int64), soj.astype(np.int64), rstat


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_serving_summary_equals_reference(seed):
    a = _request_arrays(seed)
    t_end = int(a[0][40])
    assert metrics.serving_summary(*a, t_end=t_end) \
        == ref_metrics.serving_summary(*a, t_end=t_end)


def test_serving_summary_empty_equals_reference():
    a = _request_arrays(0)
    rstat = np.zeros_like(a[3])
    got = metrics.serving_summary(a[0], a[1], a[2], rstat, t_end=0)
    ref = ref_metrics.serving_summary(a[0], a[1], a[2], rstat, t_end=0)
    assert got.keys() == ref.keys()
    for k in ref:
        assert (np.isnan(ref[k]) and np.isnan(got[k])) or got[k] == ref[k]


@pytest.mark.parametrize("offered,goodput", [
    ([1.0, 2.0, 4.0, 8.0], [1.0, 2.0, 3.9, 4.1]),
    ([1.0, 2.0], [1.0, 2.0]),
    ([0.5, 1.0, 2.0], [0.2, 1.0, 2.0]),
])
def test_detect_knee_equals_reference(offered, goodput):
    assert metrics.detect_knee(offered, goodput) \
        == ref_metrics.detect_knee(offered, goodput)
    assert metrics.detect_knee(offered, goodput, 0.5) \
        == ref_metrics.detect_knee(offered, goodput, 0.5)


def test_status_codes_equal_reference():
    assert (metrics.PENDING, metrics.IN_SERVICE, metrics.DROPPED,
            metrics.COMPLETED) == (ref_metrics.PENDING,
                                   ref_metrics.IN_SERVICE,
                                   ref_metrics.DROPPED,
                                   ref_metrics.COMPLETED)
