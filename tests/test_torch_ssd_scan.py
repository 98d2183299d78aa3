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
    before = sk.LIB.launches()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        sk.ssd_kernel(*ops)
    assert sk.LIB.launches() == before


def test_cuda_tensors_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xh, dt, a, b, c = (torch.from_numpy(x).as_subclass(_ClaimsCuda)
                       for x in _inputs(5, 32, 2, 8, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssd_forward(xh, dt, a, b, c, chunk=8)


def test_shared_memory_budget():
    """One chunk's tiles at the source's own width (L = 128, P = 64,
    N = 128) fit a block: b's big and small TF32 halves (c's rows until
    c b^T is formed), two xd buffers, each head's cumulative sum and state
    weights and a tile counter; a chunk that cannot raises, naming the
    fix."""
    assert sk.smem_bytes(128, 64, 128, 4) == 4 * (2 * 128 * 132
                                                  + 2 * 128 * 68
                                                  + 2 * 4 * 128 + 4)
    assert sk.smem_bytes(128, 64, 128, 4) <= 227 * 1024
    with pytest.raises(ValueError, match="shorter chunk"):
        sk.smem_bytes(256, 64, 128)


def test_plan_fills_the_card_at_the_path_shape():
    """B=2, S=2048 (nc=16), H=16, L=128, P=64, N=128: the largest head
    tile that keeps the SMs busy, c b^T shared by 4 heads, 128 CTAs on
    132 SMs in one wave, within a block's shared memory."""
    plan = sk.ssd_plan(2, 16, 16, 128, 64, 128)
    assert plan.hb == 4 and plan.ctas == 128 >= 120 and plan.waves == 1
    assert plan.smem_bytes == sk.smem_bytes(128, 64, 128, 4) <= 227 * 1024
    assert plan.as_dict()["hb"] == 4


@pytest.mark.parametrize("B,nc,H,L,P,N", [(2, 2, 6, 128, 64, 128),
                                          (2, 64, 6, 32, 32, 16),
                                          (2, 4, 1, 64, 64, 128),
                                          (1, 1, 1, 8, 8, 4),
                                          (2, 16, 32, 128, 64, 128),
                                          (2, 16, 64, 128, 64, 128),
                                          (66, 2, 32, 128, 64, 128)])
def test_plan_takes_any_head_count(B, nc, H, L, P, N):
    """H = 6 (no multiple of the path's tile 4), H = 1 and head counts
    whose whole tile would pass a block's shared memory at the path's
    widths (H = 32, Mamba-2 370m's, and 64) are planned: the tile divides
    H and fits, no wave is emptier than the best fitting tile's."""
    plan = sk.ssd_plan(B, nc, H, L, P, N)
    assert H % plan.hb == 0 and plan.ctas == B * nc * H // plan.hb
    assert plan.waves == -(-plan.ctas // 132)
    assert plan.smem_bytes == sk.smem_bytes(L, P, N, plan.hb) <= 227 * 1024

    def fits(d):
        try:
            return sk.smem_bytes(L, P, N, d) > 0
        except ValueError:
            return False
    best = max(B * nc * (H // d) / (-(-B * nc * (H // d) // 132) * 132)
               for d in range(1, H + 1) if H % d == 0 and fits(d))
    assert plan.ctas / (plan.waves * 132) == best


@pytest.mark.parametrize("L,P,N", [(256, 64, 128), (160, 8, 8),
                                   (128, 64, 320)])
def test_plan_raises_where_a_chunk_cannot_fit(L, P, N):
    """Chunks above 128 steps (c b^T stays in registers) or whose tiles
    pass a block's shared memory raise, naming the fix."""
    with pytest.raises(ValueError, match="shorter chunk"):
        sk.ssd_plan(2, 4, 8, L, P, N)
