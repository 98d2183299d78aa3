"""The port's SSD (K6's plain version, ``ssd_intra_chunk`` and
``ssd_forward``) against the JAX reference, on the CPU.

The same seeded numpy inputs go through the reference (its Pallas
intra-chunk kernel in interpret mode, as ``tests/test_sim_and_kernels.py``
runs it, and its exact recurrence ``ssd_sequential``) and through the
port, which on CPU tensors takes the plain version. Tolerance 2e-4, the
reference tests' own; shapes are theirs (``test_sim_and_kernels.py:77-79``).
The CUDA kernel itself runs only on the card, where ``chip_smoke.py`` holds
it against the plain version.
"""
import numpy as np
import pytest
import torch

import torch_ref as R
from repro_torch.kernels.ssd_scan import kernel as sk
from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk
from repro_torch.kernels.ssd_scan.ops import ssd_forward
from repro_torch.kernels.ssd_scan.ref import ssd_sequential

SHAPES = [(64, 4, 16, 8, 16), (128, 2, 32, 16, 32), (32, 8, 8, 4, 8)]
TOL = 2e-4


def _inputs(seed, S, H, P, N, B=2):
    """xh, dt, a, b, c as the reference tests make them (softplus dt,
    negative a), from numpy."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    b = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    return xh, dt, a, b, c


def _chunked(xh, dt, a, b, c, chunk):
    """The intra-chunk kernel's operands, as ``ssd_forward`` forms them."""
    B, S, H, P = xh.shape
    N, nc = b.shape[-1], S // chunk
    return ((xh * dt[..., None]).reshape(B, nc, chunk, H, P),
            (dt * a).reshape(B, nc, chunk, H),
            b.reshape(B, nc, chunk, N), c.reshape(B, nc, chunk, N))


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("S,H,P,N,chunk", SHAPES)
def test_intra_chunk_matches_reference_kernel(S, H, P, N, chunk):
    ops = _chunked(*_inputs(S + H, S, H, P, N), chunk)
    ref = R.ref_ssd_kernel.ssd_intra_chunk(*map(R.jnp.asarray, ops),
                                           hb=min(2, H), interpret=True)
    port = ssd_intra_chunk(*map(torch.from_numpy, ops), hb=min(2, H))
    B, nc = 2, S // chunk
    assert [tuple(t.shape) for t in port] == [(B, nc, chunk, H, P),
                                              (B, nc, H, P, N), (B, nc, H)]
    assert all(t.dtype == torch.float32 for t in port)
    for p, r in zip(port, ref):
        _close(p, r)


@pytest.mark.parametrize("S,H,P,N,chunk", SHAPES)
def test_ssd_forward_matches_reference_and_recurrence(S, H, P, N, chunk):
    xs = _inputs(S * 7 + N, S, H, P, N)
    y_ref, h_ref = R.ref_ssd_ops.ssd_forward(*map(R.jnp.asarray, xs),
                                             chunk=chunk, hb=min(2, H),
                                             interpret=True)
    t = [torch.from_numpy(x) for x in xs]
    y, h = ssd_forward(*t, chunk=chunk, hb=min(2, H))
    assert tuple(y.shape) == (2, S, H, P) and tuple(h.shape) == (2, H, P, N)
    _close(y, y_ref)
    _close(h, h_ref)
    y_seq, h_seq = ssd_sequential(*t)
    _close(y, y_seq.numpy())
    _close(h, h_seq.numpy())


@pytest.mark.parametrize("S,H,P,N,chunk", SHAPES[:2])
def test_sequential_matches_reference_sequential(S, H, P, N, chunk):
    xs = _inputs(S * 3 + P, S, H, P, N)
    y_ref, h_ref = R.ref_ssd_ref.ssd_sequential(*map(R.jnp.asarray, xs))
    y, h = ssd_sequential(*map(torch.from_numpy, xs))
    _close(y, y_ref)
    _close(h, h_ref)


def test_chunk_and_head_tile_checks_raise_like_the_reference():
    xh, dt, a, b, c = _inputs(5, 64, 4, 8, 4)
    t = [torch.from_numpy(x) for x in (xh, dt, a, b, c)]
    with pytest.raises(AssertionError):
        R.ref_ssd_ops.ssd_forward(*map(R.jnp.asarray, (xh, dt, a, b, c)),
                                  chunk=24, interpret=True)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_forward(*t, chunk=24)
    ops = _chunked(xh, dt, a, b, c, 16)
    with pytest.raises(AssertionError):
        R.ref_ssd_kernel.ssd_intra_chunk(*map(R.jnp.asarray, ops), hb=3,
                                         interpret=True)
    with pytest.raises(ValueError, match="multiple of the head tile"):
        ssd_intra_chunk(*map(torch.from_numpy, ops), hb=3)
    with pytest.raises(ValueError, match="multiple of the head tile"):
        ssd_forward(*t, chunk=16, hb=3)


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what a caller's CUDA
    tensors look like to the entry points, on a host without a card."""

    @property
    def device(self):
        return torch.device("cuda")


def test_device_policy():
    xh, dt, a, b, c = (torch.from_numpy(x) for x in _inputs(5, 32, 2, 8, 4))
    ops = [torch.from_numpy(x) for x in _chunked(*(t.numpy() for t in (
        xh, dt, a, b, c)), 8)]
    with pytest.raises(ValueError, match="needs a CUDA device"):
        ssd_forward(xh, dt, a, b, c, chunk=8, backend="kernel")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        ssd_intra_chunk(*ops, backend="kernel")
    with pytest.raises(ValueError, match="one device"):
        ssd_forward(xh, dt, a.to("meta"), b, c, chunk=8)
    before = sk.launches()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        sk.ssd_kernel(*ops)
    assert sk.launches() == before


def test_cuda_tensors_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xh, dt, a, b, c = (torch.from_numpy(x).as_subclass(_ClaimsCuda)
                       for x in _inputs(5, 32, 2, 8, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssd_forward(xh, dt, a, b, c, chunk=8)


def test_shared_memory_budget():
    """One chunk's tiles at the source's own width (L = 128, P = 64,
    N = 128) fit a block; a chunk that cannot raises, naming the fix."""
    assert sk.smem_bytes(128, 64, 128) == 4 * (128 + 128 * 129 + 128 * 64
                                               + 32 * 128 + 32 * 128)
    assert sk.smem_bytes(128, 64, 128) <= 227 * 1024
    with pytest.raises(ValueError, match="shorter chunk"):
        sk.smem_bytes(256, 64, 128)
