"""The arrival-plan kernel's contract on the CPU: its routing, its
refusals, its build registration, and the constants of
``csrc/arrival_plan.cu`` against ``traffic/stream.py``'s.

The kernel itself runs only on the card: the ``card`` tests below hold it
bit for bit against the plain route on the card where a CUDA device is
present (``PYTHONPATH=src python -m pytest -q -m card --confcutdir=tests
tests/test_torch_arrival_plan.py``, ``--confcutdir`` leaving out the root
``conftest.py``, which imports JAX), and ``chip_smoke.py``'s
``traffic_plan`` phase does the same at the registry's open-loop
workloads; ``tests/test_torch_traffic.py`` holds the plain route against
the reference. This file imports no JAX.
"""
import re
import shutil

import numpy as np
import pytest
import torch

from repro_torch.analysis import rules
from repro_torch.core import batch
from repro_torch.experiments import scenario_workloads
from repro_torch.kernels import _build
from repro_torch.kernels.event_loop import arrivals, ops
from repro_torch.kernels.event_loop.ops import precompute_plan
from repro_torch.traffic import stream
from repro_torch.workloads import (Arrivals, Workload, WorkloadOperands,
                                   lower, pad_phases, to_device)

N_EVENTS = 1500
SEEDS = (0, 1, 7, 2**31 - 1)
SOURCE = (_build.CSRC / "arrival_plan.cu").read_text()


@pytest.fixture
def card():
    """``"cuda"``, or a skip where the process sees no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _stacked(ws, seeds=SEEDS, n_events=N_EVENTS) -> WorkloadOperands:
    """Each workload at each seed, lowered, phases padded to the widest and
    stacked on a leading replica axis (numpy leaves)."""
    lws = [lower(w.replace(seed=s), n_events).operands
           for w in ws for s in seeds]
    pmax = max(o.n_phases for o in lws)
    lws = [pad_phases(o, pmax) for o in lws]
    return WorkloadOperands(*(np.stack([np.asarray(getattr(o, f))
                                        for o in lws])
                              for f in WorkloadOperands._fields))


def _open(R=256, **arr):
    arr.setdefault("rate_per_us", 4.0)
    return Workload("alock", 4, 4, 16, locality=0.9,
                    arrivals=Arrivals(max_requests=R, **arr))


def _token_late(wl: WorkloadOperands) -> WorkloadOperands:
    """burst-storm's token policy with the bucket off in its first phase
    and the first phase starting at request 5 (lowering starts it at 0):
    the credit runs through rate-0 requests, and requests before the first
    edge take 0 for every per-phase value."""
    token = wl.arr_token.copy()
    token[:, 0] = 0.0
    edges = wl.arr_edges.copy()
    edges[:, 0] = 5
    return wl._replace(arr_token=token, arr_edges=edges)


def _kernel_args(B=2, R=8, P=2):
    seed = torch.arange(B, dtype=torch.int32)
    return dict(seed=seed, arr_fix=torch.zeros((B, R), dtype=torch.int32),
                arr_edges=torch.zeros((B, P), dtype=torch.int32),
                arr_gap_ns=torch.full((B, P), 250.0),
                arr_token=torch.zeros((B, P, 2)),
                arr_qcap=torch.full((B, P), 32, dtype=torch.int32))


# -- refusals -----------------------------------------------------------------

def test_kernel_backend_on_the_cpu_raises():
    wl = _stacked([_open()], seeds=(3,))
    with pytest.raises(ValueError, match="needs a CUDA device"):
        precompute_plan(wl, N_EVENTS, device="cpu", backend="kernel")
    with pytest.raises(ValueError, match="backend must be one of"):
        precompute_plan(wl, N_EVENTS, device="cpu", backend="xla")


def test_plan_wrapper_raises_for_cpu_tensors():
    before = arrivals.LIB.launches()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        arrivals.arrival_plan(**_kernel_args(), n_events=N_EVENTS)
    assert arrivals.LIB.launches() == before


@pytest.mark.parametrize("name,bad", [
    ("seed", torch.zeros(2, dtype=torch.int64)),
    ("seed", torch.zeros((2, 1), dtype=torch.int32)),
    ("arr_fix", torch.zeros((3, 8), dtype=torch.int32)),
    ("arr_fix", torch.zeros((2, 8), dtype=torch.float32)),
    ("arr_edges", torch.zeros((2, 2), dtype=torch.int64)),
    ("arr_gap_ns", torch.zeros((2, 3))),
    ("arr_gap_ns", torch.zeros((2, 2), dtype=torch.float64)),
    ("arr_token", torch.zeros((2, 2))),
    ("arr_token", torch.zeros((2, 2, 2), dtype=torch.float64)),
    ("arr_qcap", torch.zeros((2, 2))),
])
def test_plan_wrapper_raises_for_wrong_dtypes_or_shapes(name, bad):
    args = {**_kernel_args(), name: bad}
    before = arrivals.LIB.launches()
    with pytest.raises(ValueError, match=f"{name} must be"):
        arrivals.arrival_plan(**args, n_events=N_EVENTS)
    assert arrivals.LIB.launches() == before


# -- routing ------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["auto", "plain"])
def test_cpu_and_plain_routes_are_the_stream_plan(backend):
    wl = _stacked([_open(token_rate_per_us=2.0, token_burst=16.0),
                   _open(R=256, rate_per_us=8.0, queue_cap=32)])
    batch.reset_exec_stats()
    got = precompute_plan(wl, N_EVENTS, device="cpu", backend=backend)
    want = stream.arrival_plan(to_device(wl, "cpu"), N_EVENTS)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got.tok.sum() < got.tok.numel()     # the bucket refused some
    assert batch.exec_stats()["plan_launches"] == arrivals.LIB.launches() == 0


def test_kernel_route_hands_the_operands_over(monkeypatch):
    """``backend="kernel"`` calls the wrapper once with the operands in
    their contract dtypes and returns what it returns."""
    calls = []

    def fake(*a):
        calls.append(a)
        return "plan"
    monkeypatch.setattr(ops, "resolve_backend", lambda b, d: "kernel")
    monkeypatch.setattr(ops._arrivals, "arrival_plan", fake)
    wl = _stacked([_open(R=40)], seeds=(5, 6))
    assert precompute_plan(wl, 99, device="cpu", backend="kernel") == "plan"
    assert len(calls) == 1
    seed, fix, edges, gap_ns, token, qcap, n_events = calls[0]
    want = to_device(wl, "cpu")
    assert n_events == 99
    for got, w in ((seed, want.seed), (fix, want.arr_fix),
                   (edges, want.arr_edges), (gap_ns, want.arr_gap_ns),
                   (token, want.arr_token), (qcap, want.arr_qcap)):
        assert got.dtype == w.dtype and torch.equal(got, w)


@pytest.mark.parametrize("backend", ["plain", "auto"])
def test_run_events_and_sweep_pass_their_backend(monkeypatch, backend):
    seen = []
    real = ops.precompute_plan

    def spy(*a, backend="auto", **kw):
        seen.append(backend)
        return real(*a, backend=backend, **kw)
    monkeypatch.setattr(ops, "precompute_plan", spy)
    monkeypatch.setattr(batch, "precompute_plan", spy)
    w = _open(R=16).replace(n_nodes=2, threads_per_node=2, n_locks=8,
                            seed=3)
    batch.reset_exec_stats()
    batch.sweep([w], n_seeds=2, n_events=64, backend=backend, device="cpu")
    from repro_torch.core.sim import simulate
    simulate(w, n_events=64, backend=backend, device="cpu")
    assert seen == ["plain", "plain"]
    assert batch.exec_stats()["plan_launches"] == 0


def test_exec_stats_count_plan_launches():
    batch.reset_exec_stats()
    for _ in range(3):
        arrivals.LIB.count()
    assert batch.exec_stats()["plan_launches"] == 3
    batch.reset_exec_stats()
    assert batch.exec_stats()["plan_launches"] == arrivals.LIB.launches() == 0


# -- the source against traffic/stream.py -------------------------------------

def _bits(x: float) -> int:
    return int(np.array(x, np.float32).view(np.uint32))


def _source_const(name: str) -> int:
    m = re.search(rf"constexpr uint32_t {name} = (0x[0-9A-Fa-f]+)u;", SOURCE)
    assert m, f"{name} is not in arrival_plan.cu"
    return int(m.group(1), 16)


@pytest.mark.parametrize("name,value", [
    ("SMALL_X", stream._SMALL_X), ("MIN_NORMAL", stream._MIN_NORMAL),
    ("SQRT_HALF", stream._SQRT_HALF), ("LN2_LO", stream._LN2_LO),
    ("LN2_HI", stream._LN2_HI)]
    + [(f"LOG_Y{i + 1}_{j}", c) for i, ys in enumerate(
        (stream._LOG_Y1, stream._LOG_Y2, stream._LOG_Y3))
       for j, c in enumerate(ys)]
    + [(f"Q_{j}", c) for j, c in enumerate(stream._Q)]
    + [(f"P_{j}", c) for j, c in enumerate(stream._P)])
def test_log1p_constants_match_stream(name, value):
    assert _source_const(name) == _bits(value)


def test_every_fused_step_is_one_fma():
    """The plain route rounds 25 steps of a request once each
    (``fma_f32``): 11 in ``_log_f32``, 6 + 6 + 1 in ``log1p_f32``'s
    rational branch, the token bucket's refill. The kernel writes exactly
    that many ``__fmaf_rn`` and rounds every other step on its own."""
    import inspect
    calls = (inspect.getsource(stream._log_f32).count("fma_f32(")
             + len(stream._Q) + len(stream._P) - 1 + 1
             + inspect.getsource(stream.token_admit).count("fma_f32("))
    assert SOURCE.count("__fmaf_rn(") == calls == 25


def test_one_device_threefry():
    assert '#include "threefry.cuh"' in SOURCE
    assert "0x1BD11BDA" not in SOURCE and "TF_ROUND" not in SOURCE


# -- the lint covers the library ----------------------------------------------

def test_lint_registers_the_plan_kernel():
    builds = {stem: (src, fl) for stem, src, fl, _ in rules.kernel_builds()}
    assert builds["arrival_plan"] == (arrivals.LIB.source, arrivals.LIB.flags)
    assert arrivals.LIB.source == _build.CSRC / "arrival_plan.cu"
    assert rules.check_kernel_build() == []
    fast = rules.check_kernel_build(flag_sets={
        "arrival_plan": arrivals.LIB.flags + ("--use_fast_math",)})
    assert len(fast) == 1 and "arrival_plan" in fast[0].format()
    contracted = SOURCE.replace("rintf(__fmul_rn(-log1p_f32(-u), g_ns))",
                                "rintf(-log1p_f32(-u) * g_ns)")
    assert contracted != SOURCE
    found = rules.check_kernel_build(
        sources={"csrc/arrival_plan.cu": contracted})
    assert len(found) == 1 and "arrival_plan.cu" in found[0].format()


@pytest.mark.parametrize("edit", ["arrival_plan.cu", "threefry.cuh"])
def test_build_key_changes_with_the_source(tmp_path, edit):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    src = csrc / "arrival_plan.cu"
    before = _build.build_key(src, arrivals.LIB.flags, "nvcc A")
    path = csrc / edit
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build.build_key(src, arrivals.LIB.flags, "nvcc A") != before


# -- on the card --------------------------------------------------------------

def _card_cases():
    ramp = [w for w in scenario_workloads("open-loop-ramp")
            if w.alg == "alock"]
    burst = [w for w in scenario_workloads("burst-storm") if w.alg == "alock"]
    trace = tuple(int(t) for t in np.cumsum(
        np.random.default_rng(27).integers(0, 900, 300)))
    return {
        "ramp_rates": _stacked(ramp),
        "token": _stacked([_open(token_rate_per_us=2.0, token_burst=16.0)]),
        "burst_storm_phased": _stacked(burst),
        "token_late_in_the_run": _token_late(_stacked(
            [w for w in burst if w.arrivals.token_rate_per_us > 0.0])),
        "one_request": _stacked([_open(R=1, token_rate_per_us=2.0,
                                       token_burst=1.0), _open(R=1)]),
        "ragged_tiles": _stacked([
            _open(R=300, rate_per_us=8.0, token_rate_per_us=2.0,
                  token_burst=16.0),
            _open(R=300, rate_per_us=8.0, queue_cap=32)]),
        "gap_ns_zero": _stacked([_open(R=300, rate_per_us=0.0,
                                       trace_ns=trace)]),
    }


@pytest.mark.card
@pytest.mark.parametrize("case", [
    "ramp_rates", "token", "burst_storm_phased", "token_late_in_the_run",
    "one_request", "ragged_tiles", "gap_ns_zero"])
def test_kernel_equals_the_plain_route(card, case):
    wl = to_device(_card_cases()[case], card)
    before = arrivals.LIB.launches()
    got = precompute_plan(wl, N_EVENTS, device=card, backend="kernel")
    assert arrivals.LIB.launches() == before + 1
    want = precompute_plan(wl, N_EVENTS, device=card, backend="plain")
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.card
def test_sweep_plans_each_open_shard_in_one_launch(card):
    ws = [_open(R=64).replace(n_nodes=2, threads_per_node=2, n_locks=8),
          Workload("mcs", 3, 2, 12, locality=0.8, seed=4)]
    batch.reset_exec_stats()
    batch.sweep(ws, n_seeds=3, n_events=500, device=card)
    st = batch.exec_stats()
    assert st["launches"] == 2 and st["plan_launches"] == 1
