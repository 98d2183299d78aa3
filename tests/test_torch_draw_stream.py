"""The draw-stream kernel's contract on the CPU: its routing, its host-side
launch words, its refusals, and ``csrc/threefry.cuh`` against
``core/prng.py``.

The kernel itself runs only on the card (``chip_smoke.py``'s
``draw_stream`` phase holds it bit for bit against the plain version at
every case of its grid, and the ``card`` tests below do the same where a
CUDA device is present: ``PYTHONPATH=src python -m pytest -q -m card
--confcutdir=tests tests/test_torch_draw_stream.py``, ``--confcutdir``
leaving out the root ``conftest.py``, which imports JAX);
``tests/test_torch_prng.py`` holds ``backend="plain"`` against the
reference. This file imports no JAX.
"""
import inspect
import re
import shutil

import numpy as np
import pytest
import torch

from repro_torch.analysis import rules
from repro_torch.core import batch, prng
from repro_torch.kernels import _build
from repro_torch.kernels.event_loop import draws, ops
from repro_torch.kernels.event_loop.ops import precompute_draws
from repro_torch.workloads import Workload

SEEDS = np.array([0, 1, 7, 2**31 - 1], np.int32)
N_EVENTS = 257
HEADER = (_build.CSRC / "threefry.cuh").read_text()


@pytest.fixture
def card():
    """``"cuda"``, or a skip where the process sees no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _operands(B, P, kpn, seed=0, late_start=False):
    """``late_start`` starts replica b's first phase at event 3b, which
    lowering never does (its ``edges[0]`` is 0): the plain version then
    takes phase 0 before it, where the reference indexes phase -1."""
    rng = np.random.default_rng(seed)
    edges = np.zeros((B, P), np.int32)
    if P > 1:
        edges[:, 0] = 3 * np.arange(B) if late_start else 0
        edges[:, 1] = N_EVENTS // 2 + np.arange(B)
        edges[:, 2:] = np.iinfo(np.int32).max  # pad_phases' padded phases
    w = rng.random((B, P, kpn)) ** 3 + 1e-3
    zcdf = np.cumsum(w / w.sum(-1, keepdims=True), -1).astype(np.float32)
    return (torch.from_numpy(SEEDS[:B].copy()), torch.from_numpy(edges),
            torch.from_numpy(zcdf))


# -- refusals -----------------------------------------------------------------

def test_kernel_backend_on_the_cpu_raises():
    seed, edges, zcdf = _operands(2, 1, 4)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        precompute_draws(seed, edges, zcdf, 16, 2, 4, device="cpu",
                         backend="kernel")
    with pytest.raises(ValueError, match="backend must be one of"):
        precompute_draws(seed, edges, zcdf, 16, 2, 4, device="cpu",
                         backend="xla")


@pytest.mark.parametrize("rw", [False, True])
def test_draw_wrapper_raises_for_cpu_tensors(rw):
    seed, edges, zcdf = _operands(2, 3, 4)
    before = draws.LIB.launches()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        draws.draw_stream(seed, edges, zcdf, 16, 2, 4, rw=rw)
    assert draws.LIB.launches() == before


# -- routing ------------------------------------------------------------------

def test_kernel_route_hands_the_operands_over(monkeypatch):
    """``backend="kernel"`` calls the wrapper once with the seed as int32
    (``prng.key``'s low 32 bits) and returns what it returns."""
    calls = []

    def fake(seed, edges, zcdf, n_events, N, kpn, rw=False):
        calls.append((seed, edges, zcdf, n_events, N, kpn, rw))
        return ("streams",)
    monkeypatch.setattr(ops, "resolve_backend", lambda b, d: "kernel")
    monkeypatch.setattr(ops._draws, "draw_stream", fake)
    seed, edges, zcdf = _operands(2, 3, 5)
    got = precompute_draws(seed.to(torch.int64) + (1 << 32), edges, zcdf, 99,
                           7, 5, rw=True, device="cpu", backend="kernel")
    assert got == ("streams",) and len(calls) == 1
    s, e, z, n, N, kpn, rw = calls[0]
    assert s.dtype == torch.int32 and torch.equal(s, seed)
    assert torch.equal(e, edges) and torch.equal(z, zcdf)
    assert (n, N, kpn, rw) == (99, 7, 5, True)


@pytest.mark.parametrize("backend", ["plain", "auto"])
def test_run_events_and_sweep_pass_their_backend(monkeypatch, backend):
    seen = []
    real = ops.precompute_draws

    def spy(*a, backend="auto", **kw):
        seen.append(backend)
        return real(*a, backend=backend, **kw)
    monkeypatch.setattr(ops, "precompute_draws", spy)
    monkeypatch.setattr(batch, "precompute_draws", spy)
    w = Workload("alock", 2, 2, 8, locality=0.9, seed=3)
    batch.reset_exec_stats()
    batch.sweep([w], n_seeds=2, n_events=64, backend=backend, device="cpu")
    from repro_torch.core.sim import simulate
    simulate(w, n_events=64, backend=backend, device="cpu")
    assert seen == ["plain", "plain"]
    assert batch.exec_stats()["draw_launches"] == 0


def test_exec_stats_count_draw_launches():
    batch.reset_exec_stats()
    for _ in range(3):
        draws.LIB.count()
    assert batch.exec_stats()["draw_launches"] == 3
    batch.reset_exec_stats()
    assert batch.exec_stats()["draw_launches"] == draws.LIB.launches() == 0


# -- the launch words ---------------------------------------------------------

@pytest.mark.parametrize("N", [1, 2, 3, 20, 1001, 70000])
def test_randint_words_reproduce_prng_randint(N):
    """The kernel's combine ``((hi % span) * mult + lo % span) % span`` in
    uint32 from ``randint_words(N)`` gives ``prng.randint``'s draws."""
    span, mult = draws.randint_words(N)
    k = prng.fold_in(prng.key(torch.from_numpy(SEEDS)), 11)
    sub = prng.split(k, 2)
    hi = prng.bits32((sub[0][0], sub[1][0])).numpy().astype(np.uint32)
    lo = prng.bits32((sub[0][1], sub[1][1])).numpy().astype(np.uint32)
    with np.errstate(over="ignore"):
        got = ((hi % np.uint32(span)) * np.uint32(mult)
               + lo % np.uint32(span)) % np.uint32(span)
    want = prng.randint(k, (), 0, max(N - 1, 1)).numpy()
    assert np.array_equal(got.astype(np.int32), want)


# -- one device threefry, word for word core/prng.py's ------------------------

def test_threefry_header_rounds_match_prng():
    rounds = [int(r) for r in re.findall(r"TF_ROUND\((\d+)\)", HEADER)]
    want = [r for i in range(5)
            for r in (prng._ROT_A if i % 2 == 0 else prng._ROT_B)]
    assert rounds == want


def test_threefry_header_key_schedule_matches_prng():
    parity = re.search(r"PARITY = (0x[0-9A-Fa-f]+)u;", HEADER)
    assert parity and int(parity.group(1), 16) == prng._PARITY
    names = {"k0": 0, "k1": 1, "k2": 2}
    inj = re.findall(r"x0 \+= (k\d); x1 \+= (k\d) \+ (\d)u;", HEADER)
    assert [(names[a], names[b], int(c)) for a, b, c in inj] == [
        ((r + 1) % 3, (r + 2) % 3, r + 1) for r in range(5)]


def test_threefry_header_uniform_matches_prng():
    src = inspect.getsource(prng.uniform_from_bits)
    shift, one = re.search(r">> (\d+)\) \| (0x[0-9A-Fa-f]+)", src).groups()
    assert re.search(rf"ONE_BITS = {one}u;", HEADER)
    assert re.search(rf"MANTISSA_SHIFT = {shift};", HEADER)
    assert "(bits >> MANTISSA_SHIFT) | ONE_BITS) - 1.0f" in HEADER


@pytest.mark.parametrize("source", ["alock_tick.cu", "draw_stream.cu"])
def test_one_device_threefry(source):
    text = (_build.CSRC / source).read_text()
    assert '#include "threefry.cuh"' in text
    assert "0x1BD11BDA" not in text and "TF_ROUND" not in text


# -- the lint covers the library ----------------------------------------------

def test_lint_registers_the_draw_kernel():
    builds = {stem: (src, fl) for stem, src, fl, _ in rules.kernel_builds()}
    assert builds["draw_stream"] == (draws.LIB.source, draws.LIB.flags)
    assert draws.LIB.source == _build.CSRC / "draw_stream.cu"
    assert rules.check_kernel_build() == []
    fast = rules.check_kernel_build(
        flag_sets={"draw_stream": draws.LIB.flags + ("--use_fast_math",)})
    assert len(fast) == 1 and "draw_stream" in fast[0].format()


def test_build_key_covers_the_threefry_header(tmp_path):
    """An edit of ``threefry.cuh`` rebuilds the draw kernel's library (and
    K2's: the key hashes every header beside a source)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    keys = {}
    for stem in ("draw_stream", "alock_tick"):
        src = csrc / f"{stem}.cu"
        before = _build.build_key(src, draws.LIB.flags, "nvcc A")
        header = csrc / "threefry.cuh"
        text = header.read_text()
        header.write_text(text.replace("0x1BD11BDAu", "0x1BD11BDBu"))
        keys[stem] = before != _build.build_key(src, draws.LIB.flags,
                                                "nvcc A")
        header.write_text(text)
    assert keys == {"draw_stream": True, "alock_tick": True}


# -- on the card --------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("rw", [False, True])
def test_kernel_equals_the_plain_version(card, rw):
    for P, N, kpn in ((1, 1, 1), (3, 2, 50), (3, 20, 200)):
        seed, edges, zcdf = (t.to(card) for t in _operands(
            4, P, kpn, late_start=True))
        before = draws.LIB.launches()
        got = precompute_draws(seed, edges, zcdf, 2047, N, kpn, rw=rw,
                               device=card, backend="kernel")
        assert draws.LIB.launches() == before + 1
        want = precompute_draws(seed, edges, zcdf, 2047, N, kpn, rw=rw,
                                device=card, backend="plain")
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.card
def test_sweep_draws_each_shard_in_one_launch(card):
    ws = [Workload("alock", 2, 2, 8, locality=0.9, seed=3),
          Workload("mcs", 3, 2, 12, locality=0.8, seed=4)]
    batch.reset_exec_stats()
    batch.sweep(ws, n_seeds=3, n_events=500, device=card)
    st = batch.exec_stats()
    assert st["draw_launches"] == st["launches"] == 2
