"""The port's draw stream against the reference's, as bit patterns.

``precompute_draws`` (threefry2x32 in torch integer ops) is held against
``repro.kernels.event_loop.ops.precompute_draws`` run under
``jax.enable_x64(True)``, as the engine runs it. Tolerance: none — floats
are compared through their int32 bit patterns.
"""
import numpy as np
import pytest
import torch

import torch_ref as R
from repro_torch.core import prng
from repro_torch.kernels.event_loop.ops import precompute_draws

jax, jnp = R.jax, R.jnp

SEEDS = np.array([0, 1, 7, 2**31 - 1], np.int32)
N_EVENTS = 300


def _skewed_zcdf(B, P, kpn, rng):
    w = rng.random((B, P, kpn)) ** 3 + 1e-3
    return np.cumsum(w / w.sum(-1, keepdims=True), -1).astype(np.float32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("rw", [False, True])
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("N", [1, 2, 5])
def test_precompute_draws_bitwise(N, P, rw):
    rng = np.random.default_rng(100 * N + 10 * P + rw)
    B, kpn = len(SEEDS), 7
    edges = np.zeros((B, P), np.int32)
    for p in range(1, P):
        edges[:, p] = p * N_EVENTS // P + np.arange(B)
    zcdf = _skewed_zcdf(B, P, kpn, rng)
    with jax.enable_x64(True):
        ref = R.ref_ops.precompute_draws(
            jnp.asarray(SEEDS), jnp.asarray(edges), jnp.asarray(zcdf),
            N_EVENTS, N, kpn, rw=rw)
        ref = [np.asarray(r) for r in ref]
    got = precompute_draws(torch.from_numpy(SEEDS), torch.from_numpy(edges),
                           torch.from_numpy(zcdf), N_EVENTS, N, kpn, rw=rw,
                           device="cpu")
    assert len(got) == len(ref) == (4 if rw else 3)
    names = ["u1", "r2", "r3", "u4"][:len(ref)]
    R.assert_bitwise([_bits(r) for r in ref],
                     [_bits(g.numpy()) for g in got], names)
    if N > 2:
        assert len(np.unique(ref[1])) == N - 1      # every offset drawn


def test_chunked_equals_unchunked(monkeypatch):
    """The event-axis chunking bounds temporaries and changes nothing."""
    from repro_torch.kernels.event_loop import ref
    rng = np.random.default_rng(3)
    B, P, kpn = len(SEEDS), 2, 5
    edges = np.tile(np.int32([0, 130]), (B, 1))
    zcdf = _skewed_zcdf(B, P, kpn, rng)
    args = (torch.from_numpy(SEEDS), torch.from_numpy(edges),
            torch.from_numpy(zcdf), N_EVENTS, 4, kpn)
    whole = precompute_draws(*args, rw=True, device="cpu")
    monkeypatch.setattr(ref, "DRAW_CHUNK_ELEMS", 4 * 37)
    monkeypatch.setattr(ref, "CDF_CHUNK_ELEMS", 4 * 5 * 11)
    parts = precompute_draws(*args, rw=True, device="cpu")
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_key_fold_split_words(seed):
    """The key-derivation layout word for word (uint32 key data)."""
    with jax.enable_x64(True):
        k = jax.random.fold_in(jax.random.key(jnp.int32(seed)), 12345)
        ref = np.asarray(jax.random.key_data(jax.random.split(k, 4)))
    pk = prng.fold_in(prng.key(torch.tensor(seed, dtype=torch.int32)),
                      12345)
    sub = prng.split(pk, 4)
    got = np.stack([sub[0].numpy(), sub[1].numpy()], -1).astype(np.uint32)
    assert ref.dtype == np.uint32 and np.array_equal(ref, got)


def test_uniform_is_mantissa_construction():
    bits = torch.tensor([0, 1 << 9, 0xFFFFFFFF, 0x80000000],
                        dtype=torch.int64)
    u = prng.uniform_from_bits(bits)
    assert u.dtype == torch.float32
    assert u.tolist() == [0.0, 2.0 ** -23, 1.0 - 2.0 ** -23, 0.5]


@pytest.mark.parametrize("rw", [False, True])
@pytest.mark.parametrize("P,N,kpn", [(1, 1, 1), (3, 2, 50), (3, 20, 200)])
def test_plain_backend_equals_the_reference(P, N, kpn, rw):
    """``backend="plain"`` (the version the draw kernel is held against on
    the card) is the default CPU route, bit for bit the reference's; P = 3
    pads its last phase as ``pad_phases`` does."""
    rng = np.random.default_rng(P * N + kpn)
    B = len(SEEDS)
    edges = np.zeros((B, P), np.int32)
    if P > 1:
        edges[:, 1] = N_EVENTS // 2 + np.arange(B)
        edges[:, 2:] = np.iinfo(np.int32).max
    zcdf = _skewed_zcdf(B, P, kpn, rng)
    with jax.enable_x64(True):
        ref = R.ref_ops.precompute_draws(
            jnp.asarray(SEEDS), jnp.asarray(edges), jnp.asarray(zcdf),
            N_EVENTS, N, kpn, rw=rw)
        ref = [np.asarray(r) for r in ref]
    args = (torch.from_numpy(SEEDS), torch.from_numpy(edges),
            torch.from_numpy(zcdf), N_EVENTS, N, kpn)
    got = precompute_draws(*args, rw=rw, device="cpu", backend="plain")
    auto = precompute_draws(*args, rw=rw, device="cpu")
    names = ["u1", "r2", "r3", "u4"][:len(ref)]
    R.assert_bitwise([_bits(r) for r in ref],
                     [_bits(g.numpy()) for g in got], names)
    assert all(torch.equal(a, b) for a, b in zip(got, auto))
