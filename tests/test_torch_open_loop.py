"""The open loop through the module that holds the kernel, and through the
slice's entry points: the port against the JAX reference, bit for bit.

``run_events_plain`` (through ``run_events(backend="plain",
device="cpu")``) with ``R > 0`` request slots is held against the
reference's ``run_events_ref`` on all ten outputs, for five algorithms x
{ramp with a queue bound, ramp with an unbounded queue, phased burst with
a token bucket, trace replay with jitter}. Each case runs once with the
port's own draw stream and arrival plan and once with the reference's
draws and plan injected, so a fault in the engine can be told from a
fault in a generator. Then ``simulate`` / ``sweep`` / ``Experiment``
results, request arrays and ``serving_mean()`` against the reference's.
Tolerance: none — ``np.array_equal`` with dtype and shape, and floats
compared with ``==``.
"""
import math

import numpy as np
import pytest

import torch_ref as R
import repro.traffic.stream as ref_stream
from repro_torch.core import batch
from repro_torch.core.sim import simulate
from repro_torch.experiments import ExecOptions, Experiment
from repro_torch.kernels.event_loop.ops import run_events
from repro_torch.workloads import operands_from_numpy

jax, jnp = R.jax, R.jnp
Workload, Phase = R.ref_workloads.Workload, R.ref_workloads.Phase
Arrivals = R.ref_workloads.Arrivals

EV = 500
ALGS = ("alock", "mcs", "spinlock", "hlock", "alock-rw")
N, TPN, K, REQ = 4, 2, 8, 64
NAMES = R.OUT_NAMES + ("arr", "wq", "soj", "rstat")
TRACE = tuple(range(0, REQ * 400, 400))


def _base(alg, **kw):
    extra = dict(locality=0.8, b_init=(2, 3), seed=5)
    if alg == "hlock":
        extra["topology"] = R.ref_workloads.racks_of(N, 2)
    if alg == "alock-rw":
        extra["read_frac"] = 0.6
    extra.update(kw)
    return Workload(alg, N, TPN, K, **extra)


SCENARIOS = {
    "ramp_queue_bound": dict(arrivals=Arrivals(
        rate_per_us=8.0, max_requests=REQ, queue_cap=4)),
    "ramp_unbounded": dict(arrivals=Arrivals(
        rate_per_us=16.0, max_requests=REQ)),
    "burst_token": dict(
        phases=(Phase(frac=0.4), Phase(frac=0.2, rate_per_us=12.0),
                Phase(frac=0.4)),
        arrivals=Arrivals(rate_per_us=1.0, max_requests=REQ,
                          token_rate_per_us=2.0, token_burst=4.0)),
    "trace_replay_jitter": dict(arrivals=Arrivals(trace_ns=TRACE,
                                                  rate_per_us=4.0)),
}


def _workloads(alg):
    return [_base(alg, **kw) for kw in SCENARIOS.values()]


_CACHE = {}


def _reference(alg):
    """(operands, reference outputs, reference draws, reference plan) for
    the algorithm's bucket (every scenario, one engine call)."""
    if ("ref", alg) not in _CACHE:
        wl = R.ref_lowered_batched(_workloads(alg), EV)
        tn, ln, _ = R.ref_sim.topology(alg, N, TPN, K)
        with jax.enable_x64(True):
            wj = type(wl)(*(jnp.asarray(a) for a in wl))
            out = R.ref_ref.run_events_ref(alg, N * TPN, N, K, EV, wj, tn,
                                           ln)
            streams = R.ref_ops.precompute_draws(
                wj.seed, wj.edges, wj.zcdf, EV, N, K // N,
                rw=alg == "alock-rw")
            plan = jax.vmap(lambda w: ref_stream.arrival_plan(w, EV))(wj)
            _CACHE[("ref", alg)] = (
                wl, [np.asarray(o) for o in out],
                [np.asarray(s) for s in streams],
                [np.asarray(p) for p in plan])
    return _CACHE[("ref", alg)]


def _port(alg, inject):
    if ("port", alg, inject) not in _CACHE:
        wl, _, streams, plan = _reference(alg)
        tn, ln, _ = R.ref_sim.topology(alg, N, TPN, K)
        ops = operands_from_numpy(tuple(np.asarray(a) for a in wl), "cpu")
        kw = dict(streams=streams, plan=plan) if inject else {}
        out = run_events(alg, N * TPN, N, K, EV, ops, np.asarray(tn),
                         np.asarray(ln), backend="plain", device="cpu", **kw)
        _CACHE[("port", alg, inject)] = [o.numpy() for o in out]
    return _CACHE[("port", alg, inject)]


@pytest.mark.parametrize("scen", list(SCENARIOS))
@pytest.mark.parametrize("inject", [False, True],
                         ids=["own_streams_plan", "ref_streams_plan"])
@pytest.mark.parametrize("alg", ALGS)
def test_plain_open_loop_bitwise(alg, inject, scen):
    _, ref, _, _ = _reference(alg)
    port = _port(alg, inject)
    i = list(SCENARIOS).index(scen)
    assert len(port) == 10
    assert int(ref[0][i].sum()) > 0                     # work was done
    R.assert_bitwise([o[i:i + 1] for o in ref], [o[i:i + 1] for o in port],
                     NAMES)


def test_cases_cover_every_request_status():
    """Across the cases the final statuses include queued, in-service,
    dropped and completed requests, and some no-op events happened
    (a drained stream leaves every thread idle)."""
    seen = set()
    for alg in ALGS:
        seen |= set(np.unique(_reference(alg)[1][9]).tolist())
    assert seen == {0, 1, 2, 3}
    _, ref, _, _ = _reference("alock")
    i = list(SCENARIOS).index("ramp_queue_bound")
    assert int(ref[9][i].min()) >= 2        # drained: all done or dropped


def test_zero_events_open_loop():
    wl = R.ref_lowered_batched(_workloads("alock")[:1], 10)
    tn, ln, _ = R.ref_sim.topology("alock", N, TPN, K)
    ops = operands_from_numpy(tuple(np.asarray(a) for a in wl), "cpu")
    out = run_events("alock", N * TPN, N, K, 0, ops, np.asarray(tn),
                     np.asarray(ln), backend="plain", device="cpu")
    with jax.enable_x64(True):
        wj = type(wl)(*(jnp.asarray(a) for a in wl))
        ref = R.ref_ref.run_events_ref("alock", N * TPN, N, K, 0, wj, tn, ln)
        ref = [np.asarray(o) for o in ref]
    R.assert_bitwise(ref, out, NAMES)


# -- the slice's entry points ------------------------------------------------

N_EVENTS = 800
N_SEEDS = 2
ARRAYS = ("seeds", "ops", "sim_ns", "throughput_mops", "lat_ns",
          "per_thread_ops", "reacquires", "passes", "arr_ns", "wait_ns",
          "sojourn_ns", "rstat")
REG_BASE = Workload("alock", 4, 2, 8, locality=0.9, seed=3)


def _same(a, b):
    return (isinstance(a, float) and math.isnan(a) and math.isnan(b)) \
        or a == b


def _entry_workloads():
    return [
        REG_BASE.replace(arrivals=Arrivals(rate_per_us=2.0, max_requests=48,
                                           queue_cap=8)),
        REG_BASE.replace(arrivals=Arrivals(rate_per_us=8.0, max_requests=48,
                                           queue_cap=8)),
        REG_BASE.replace(phases=(Phase(frac=0.5),
                                 Phase(frac=0.5, rate_per_us=6.0)),
                         arrivals=Arrivals(rate_per_us=1.0, max_requests=48,
                                           token_rate_per_us=2.0,
                                           token_burst=3.0)),
    ]


@pytest.fixture(scope="module")
def swept():
    ref_ws = _entry_workloads()
    ref_exp = R.ref_experiments.Experiment(
        "open", n_seeds=N_SEEDS, n_events=N_EVENTS,
        options=R.ref_experiments.ExecOptions(backend="xla"))
    port_exp = Experiment("open", n_seeds=N_SEEDS, n_events=N_EVENTS,
                          options=ExecOptions(device="cpu"))
    for i, w in enumerate(ref_ws):
        ref_exp.add(w, label=f"w{i}")
        port_exp.add(R.to_port(w), label=f"w{i}")
    ref_res = ref_exp.run()
    batch.reset_exec_stats()
    port_res = port_exp.run()
    return ref_ws, ref_res, port_res, batch.exec_stats()


@pytest.mark.parametrize("i", range(3))
def test_experiment_open_loop_equals_reference(swept, i):
    _, ref_res, port_res, _ = swept
    r, p = ref_res[f"w{i}"], port_res[f"w{i}"]
    assert p.open_loop and r.open_loop
    R.assert_bitwise([getattr(r, f) for f in ARRAYS],
                     [getattr(p, f) for f in ARRAYS], ARRAYS)
    for prop in ("mean_mops", "ci95_mops", "p50_lat_ns", "p99_lat_ns"):
        assert _same(getattr(r, prop), getattr(p, prop)), prop
    ref_sm, port_sm = r.serving_mean(), p.serving_mean()
    assert ref_sm.keys() == port_sm.keys()
    for k in ref_sm:
        assert _same(ref_sm[k], port_sm[k]), k
    for s in range(N_SEEDS):
        rs, ps = r.serving(s), p.serving(s)
        assert rs.keys() == ps.keys()
        assert all(_same(rs[k], ps[k]) for k in rs)


def test_open_loop_bucket_is_one_dispatch(swept):
    _, _, _, stats = swept
    assert stats["dispatches"] == 1 and stats["launches"] == 0
    assert stats["seconds"]["draws"] > 0.0


@pytest.mark.parametrize("i,seed_idx", [(0, 0), (2, 1)])
def test_result_equals_simulate_open_loop(swept, i, seed_idx):
    ref_ws, _, port_res, _ = swept
    br = port_res[f"w{i}"]
    w = R.to_port(ref_ws[i]).replace(seed=int(br.seeds[seed_idx]))
    one = simulate(w, n_events=N_EVENTS, device="cpu")
    got = br.result(seed_idx)
    ref_one = R.ref_sim.simulate(ref_ws[i].replace(seed=int(
        br.seeds[seed_idx])), n_events=N_EVENTS, backend="xla")
    fields = ("lat_ns", "per_thread_ops", "arr_ns", "wait_ns",
              "sojourn_ns", "rstat")
    R.assert_bitwise([getattr(ref_one, f) for f in fields],
                     [getattr(one, f) for f in fields], fields)
    R.assert_bitwise([getattr(one, f) for f in fields],
                     [getattr(got, f) for f in fields], fields)
    assert (one.ops, one.sim_ns, one.reacquires, one.passes) \
        == (got.ops, got.sim_ns, got.reacquires, got.passes) \
        == (ref_one.ops, ref_one.sim_ns, ref_one.reacquires, ref_one.passes)
    assert one.throughput_mops == got.throughput_mops \
        == ref_one.throughput_mops


def test_closed_loop_result_has_no_request_arrays():
    br = batch.sweep([R.to_port(REG_BASE)], n_events=200, device="cpu")[0]
    assert not br.open_loop and br.result(0).arr_ns is None
    with pytest.raises(ValueError, match="open-loop"):
        br.serving(0)
