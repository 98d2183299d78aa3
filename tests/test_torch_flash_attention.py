"""The port's attention (K3, K4, K5 and ``mha`` / ``mha_vjp``) against the
JAX reference, on the CPU.

The same seeded numpy inputs go through the reference's Pallas kernels in
interpret mode (as ``tests/test_sim_and_kernels.py`` runs them) and
through the port, which on CPU tensors takes the kernels' plain PyTorch
versions. Tolerances are the reference tests' own: f32 2e-5, bf16 2e-2
(bf16 outputs compared in f32). The CUDA kernels themselves run only on
the card, where ``chip_smoke.py`` holds them against these plain versions.
"""
import numpy as np
import pytest
import torch

import torch_ref as R
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import kernel_bwd as fkb
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.kernel_bwd import \
    flash_attention_bwd
from repro_torch.kernels.flash_attention.ops import mha, mha_vjp
from repro_torch.kernels.flash_attention.ref import attention_ref

MASKS = [(True, None), (False, None), (True, 16), (False, 16)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, shape, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(n)]


def _ref(x, dtype):
    return R.jnp.asarray(x).astype(getattr(R.jnp, dtype))


def _port(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(R.jnp.asarray(a).astype(R.jnp.float32))


def _close(a, b, tol):
    np.testing.assert_allclose(_f32(a), _f32(b), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("S,hd", [(64, 16), (64, 64), (128, 16), (128, 64)])
def test_flash_forward_matches_reference(S, hd, causal, window, dtype):
    xs = _inputs(S * 1000 + hd, (2, 2, S, hd))
    o_ref, lse_ref = R.ref_flash_kernel.flash_attention(
        *(_ref(x, dtype) for x in xs), causal=causal, window=window, bq=64,
        bk=64, interpret=True, return_lse=True)
    q, k, v = (_port(x, dtype) for x in xs)
    o, lse = flash_attention(q, k, v, causal=causal, window=window, bq=64,
                             bk=64, return_lse=True)
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert tuple(o.shape) == (2, 2, S, hd) and tuple(lse.shape) == (2, 2, S)
    tol = TOL[dtype]
    _close(o, o_ref, tol)
    _close(lse, lse_ref, tol)
    _close(o, attention_ref(q, k, v, causal=causal, window=window), tol)


@pytest.mark.parametrize("causal,window", MASKS)
def test_attention_oracle_matches_reference_oracle(causal, window):
    xs = _inputs(7, (2, 2, 64, 16))
    ref = R.ref_flash_ref.attention_ref(*map(R.jnp.asarray, xs),
                                        causal=causal, window=window)
    port = attention_ref(*map(torch.from_numpy, xs), causal=causal,
                         window=window)
    _close(port, ref, 2e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 16),
                                           (False, None)])
def test_mha_vjp_gradients_match_reference(causal, window):
    xs = _inputs(11, (2, 2, 64, 16))

    def f_ref(q, k, v):
        return R.ref_flash_ops.mha_vjp(q, k, v, causal=causal, window=window,
                                       bq=16, bk=16, interpret=True).sum()
    g_ref = R.jax.grad(f_ref, argnums=(0, 1, 2))(*map(R.jnp.asarray, xs))

    q, k, v = (torch.from_numpy(x).requires_grad_() for x in xs)
    mha_vjp(q, k, v, causal=causal, window=window, bq=16, bk=16).sum() \
        .backward()
    qo, ko, vo = (torch.from_numpy(x).requires_grad_() for x in xs)
    attention_ref(qo, ko, vo, causal=causal, window=window).sum().backward()
    for name, g, gr, go in zip("qkv", (q.grad, k.grad, v.grad), g_ref,
                               (qo.grad, ko.grad, vo.grad)):
        assert g.dtype == torch.float32, name
        _close(g, gr, 2e-5)
        _close(g, go, 2e-5)


def test_flash_bwd_plain_matches_reference_bwd():
    """``flash_attention_bwd`` from the same lse and drow as the
    reference's backward kernels, with a non-trivial ``do``."""
    q, k, v, do = _inputs(13, (2, 2, 64, 16), n=4)
    _, lse = R.ref_flash_kernel.flash_attention(
        *map(R.jnp.asarray, (q, k, v)), causal=True, window=16, bq=32,
        bk=32, interpret=True, return_lse=True)
    lse = np.array(lse)
    drow = np.random.default_rng(14).standard_normal((2, 2, 64),
                                                     dtype=np.float32)
    ref = R.ref_flash_kernel_bwd.flash_attention_bwd(
        *map(R.jnp.asarray, (q, k, v, do, lse, drow)), causal=True,
        window=16, bq=32, bk=32, interpret=True)
    port = flash_attention_bwd(*map(torch.from_numpy, (q, k, v, do, lse,
                                                       drow)),
                               causal=True, window=16, bq=32, bk=32)
    for a, b in zip(port, ref):
        _close(a, b, 2e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (False, 16)])
def test_mha_matches_reference_mha(causal, window):
    xs = _inputs(17, (2, 2, 128, 64))
    ref = R.ref_flash_ops.mha(*map(R.jnp.asarray, xs), causal=causal,
                              window=window, bq=64, bk=64,
                              force_interpret=True)
    port = mha(*map(torch.from_numpy, xs), causal=causal, window=window,
               bq=64, bk=64)
    _close(port, ref, 2e-5)


def test_bf16_mha_vjp_returns_bf16_gradients():
    q, k, v = (_port(x, "bfloat16").requires_grad_()
               for x in _inputs(19, (1, 2, 64, 16)))
    o = mha_vjp(q, k, v, causal=True)
    assert o.dtype == torch.bfloat16
    o.float().sum().backward()
    assert [t.grad.dtype for t in (q, k, v)] == [torch.bfloat16] * 3
    assert all(bool(torch.isfinite(t.grad.float()).all()) for t in (q, k, v))


@pytest.mark.parametrize("S,bq,bk", [(64, 48, 64), (64, 64, 40),
                                     (96, 64, 64)])
def test_tile_checks_raise_like_the_reference(S, bq, bk):
    xs = _inputs(23, (1, 1, S, 16))
    with pytest.raises(AssertionError):
        R.ref_flash_kernel.flash_attention(*map(R.jnp.asarray, xs), bq=bq,
                                           bk=bk, interpret=True)
    t = [torch.from_numpy(x) for x in xs]
    with pytest.raises(ValueError, match="multiple of the tiles"):
        flash_attention(*t, bq=bq, bk=bk)
    with pytest.raises(ValueError, match="multiple of the tiles"):
        mha_vjp(*t, bq=bq, bk=bk)
    with pytest.raises(ValueError, match="multiple of the tiles"):
        flash_attention_bwd(*t, t[0], torch.zeros(1, 1, S),
                            torch.zeros(1, 1, S), bq=bq, bk=bk)


def test_shape_and_window_checks_raise():
    q = torch.zeros(1, 1, 64, 16)
    with pytest.raises(ValueError, match="one \\(B, H, S, hd\\) shape"):
        flash_attention(q, torch.zeros(1, 1, 64, 8), q)
    with pytest.raises(ValueError, match="window must be None or at least"):
        flash_attention(q, q, q, window=0)


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what a caller's CUDA
    tensors look like to the entry points, on a host without a card."""

    @property
    def device(self):
        return torch.device("cuda")


def test_cuda_tensors_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = torch.zeros(1, 1, 64, 16).as_subclass(_ClaimsCuda)
    for fn in (flash_attention, mha, mha_vjp):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(q, q, q)


def test_kernel_backend_on_cpu_tensors_raises():
    q = torch.zeros(1, 1, 64, 16)
    lse = torch.zeros(1, 1, 64)
    for call in (lambda: flash_attention(q, q, q, backend="kernel"),
                 lambda: mha(q, q, q, backend="kernel"),
                 lambda: mha_vjp(q, q, q, backend="kernel"),
                 lambda: flash_attention_bwd(q, q, q, q, lse, lse,
                                             backend="kernel")):
        with pytest.raises(ValueError, match="needs a CUDA device"):
            call()


def test_mixed_devices_raise():
    q = torch.zeros(1, 1, 64, 16)
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, q.to("meta"), q)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch for CUDA tensors or raise — they never hand a
    CPU tensor to the plain version, and count nothing."""
    q = torch.zeros(1, 1, 64, 16)
    lse = torch.zeros(1, 1, 64)
    before = (fk.LIB.launches(), fkb.LIB.launches())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fk.flash_fwd_kernel(q, q, q)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fkb.flash_dq_kernel(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fkb.flash_dkv_kernel(q, q, q, q, lse, lse)
    assert (fk.LIB.launches(), fkb.LIB.launches()) == before


def test_shared_memory_fits_a_block():
    """The tiles at every head dimension the kernels take fit the 227 KB
    one block may use. Forward: a 128-row q tile up to hd = 128, 64 above;
    at hd = 128 the bf16 route's (the larger) — 1,024 bytes of alignment
    slack, the resident 128-row q tile and a ring of 3 stages x a 128-row k
    and v tile, rows of 256 bytes (128 bf16, swizzled), seven mbarriers.
    Backward: the f32
    route's at hd = 128 — the slack, two resident 128-row tiles and a ring
    of 2 stages x two 32-row tiles, rows of 132 floats, K5's lse and drow
    per stage, five mbarriers."""
    for hd in (16, 64, 128, 256):
        worst = max(fk.smem_bytes(hd), *fkb.smem_bytes(hd).values())
        assert worst <= 227 * 1024, hd
    assert fk.block_rows(128) == 128 and fk.block_rows(256) == 64
    assert fk.smem_bytes(128) == 1024 + 256 * (128 + 3 * 2 * 128) + 7 * 8
    tiles = 1024 + 4 * 132 * (2 * 128 + 2 * 2 * 32) + 5 * 8
    assert fkb.smem_bytes(128) == {"dq": tiles,
                                   "dkv": tiles + 4 * 2 * 2 * 32}
