"""The numerics K3, K4 and K5 use on the tensor cores, modelled in plain
torch and held against the JAX reference on the CPU.

The CUDA kernels run only on the card; what their arithmetic does to the
result can be sized here. ``bwd_model`` repeats the backward's roundings:
f32 products as 3xTF32 (each operand split into a big and a small TF32
half, both rounded to nearest, ties away, and the three products
small*big + big*small + big*big summed in f32); bf16 inputs multiplied
exactly in f32 with p and ds rounded to bf16 before the second products
(dq = ds k, dk = ds^T q, dv = p^T do), as ``wgmma`` takes them.
``fwd_model`` repeats the forward's: the online softmax over the kernel's
kv stages (128 keys in bf16, 64 in f32), s = (q k^T) scale with q k^T as 3xTF32 (f32) or exact in
f32 (bf16), p v as 3xTF32 (f32) or with p rounded to bf16 (bf16), l summing
the f32 p. Each model must meet the reference tests' tolerances (f32
2e-5, bf16 2e-2) against the reference's interpret-mode kernels, and the
tolerances at a wider head (1e-4, 2e-2) against the plain versions; one
TF32 product without the split must not meet 2e-5 (the negative
controls).
"""
import numpy as np
import pytest
import torch

import torch_ref as R
from repro_torch.kernels.flash_attention.ref import (NEG_INF, allowed,
                                                     flash_bwd_plain,
                                                     flash_fwd_plain)

MASKS = [(True, None), (False, None), (True, 16), (False, 16)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def tf32_rna(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: add half of the dropped bits'
    weight to the magnitude's bits, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(a, b):
    big_a, big_b = tf32_rna(a), tf32_rna(b)
    small_a, small_b = tf32_rna(a - big_a), tf32_rna(b - big_b)
    return small_a @ big_b + big_a @ small_b + big_a @ big_b


def mm_tf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def bwd_model(q, k, v, do, lse, drow, *, causal, window, mm=None):
    """(dq, dk, dv) with the kernels' roundings. ``mm`` is the f32
    product (3xTF32 by default); bf16 inputs use exact f32 products."""
    bf16 = q.dtype == torch.bfloat16
    if mm is None:
        mm = torch.matmul if bf16 else mm_3xtf32
    S, hd = q.shape[-2:]
    scale = hd ** -0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = (mm(qf, kf.transpose(-1, -2)) * scale).masked_fill(
        ~allowed(S, causal, window, q.device), NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = mm(dof, vf.transpose(-1, -2))
    ds = p * (dp - drow[..., None]) * scale
    if bf16:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dq = mm(ds, kf)
    dk = mm(ds.transpose(-1, -2), qf)
    dv = mm(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fwd_model(q, k, v, *, causal, window, mm=None):
    """(o, lse) with K3's roundings, over kv tiles of the kernel's stage
    rows (hd <= 128: 128 keys in bf16, 64 in f32). ``mm`` is the f32
    product (3xTF32 by default); bf16 inputs use exact f32 products."""
    bf16 = q.dtype == torch.bfloat16
    if mm is None:
        mm = torch.matmul if bf16 else mm_3xtf32
    blk = 128 if bf16 else 64
    S, hd = q.shape[-2:]
    scale = hd ** -0.5
    qf, kf, vf = (t.float() for t in (q, k, v))
    ok = allowed(S, causal, window, q.device)
    m = torch.full(q.shape[:-1], NEG_INF)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, S, blk):
        kt, vt = kf[..., k0:k0 + blk, :], vf[..., k0:k0 + blk, :]
        s = (mm(qf, kt.transpose(-1, -2)) * scale).masked_fill(
            ~ok[:, k0:k0 + blk], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + mm(p.bfloat16().float() if bf16
                                         else p, vt)
        m = m_new
    lc = l.clamp_min(1e-30)
    return (acc / lc[..., None]).to(q.dtype), m + torch.log(lc)


def _inputs(seed, shape, dtype, causal, window):
    """q, k, v, do in ``dtype`` from a seeded numpy stream, and the
    forward's lse and drow = rowsum(do * o) in f32."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape,
                                                        dtype=np.float32))
                   .to(getattr(torch, dtype)) for _ in range(4))
    o, lse = flash_fwd_plain(q, k, v, causal=causal, window=window)
    drow = (do.float() * o.float()).sum(-1)
    return q, k, v, do, lse, drow


def _max_err(got, want):
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))


def _close(got, want, tol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=tol, rtol=tol)


def _reference_bwd(xs, causal, window):
    """The reference's interpret-mode backward on the same inputs, as f32
    torch tensors."""
    q, k, v, do, lse, drow = xs
    dt = getattr(R.jnp, str(q.dtype).split(".")[1])
    args = [R.jnp.asarray(t.float().numpy()).astype(dt) for t in (q, k, v,
                                                                    do)]
    args += [R.jnp.asarray(t.numpy()) for t in (lse, drow)]
    out = R.ref_flash_kernel_bwd.flash_attention_bwd(
        *args, causal=causal, window=window, bq=32, bk=32, interpret=True)
    return [torch.from_numpy(np.array(o.astype(R.jnp.float32))) for o in out]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
def test_model_matches_reference_bwd(causal, window, dtype):
    """At the reference tests' shape (B=2, H=2, S=64, hd=16)."""
    xs = _inputs(31, (2, 2, 64, 16), dtype, causal, window)
    _close(bwd_model(*xs, causal=causal, window=window),
           _reference_bwd(xs, causal, window), TOL[dtype])


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_model_matches_plain_at_a_wide_head(dtype, tol):
    """One head at S = 512, hd = 128 (the path's head dimension), causal,
    against ``flash_bwd_plain`` at the card's tolerances."""
    xs = _inputs(37, (1, 1, 512, 128), dtype, True, None)
    _close(bwd_model(*xs, causal=True, window=None),
           flash_bwd_plain(*xs, causal=True), tol)


def test_one_tf32_product_misses_the_f32_tolerance():
    """The negative control: TF32 without the small halves is ~1e-3 off,
    so the f32 route needs 3xTF32 (and the test above can fail)."""
    xs = _inputs(31, (2, 2, 64, 16), "float32", True, None)
    want = _reference_bwd(xs, True, None)
    split = _max_err(bwd_model(*xs, causal=True, window=None), want)
    plain_tf32 = _max_err(bwd_model(*xs, causal=True, window=None,
                                    mm=mm_tf32), want)
    assert split <= TOL["float32"] < plain_tf32


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                     # a TF32 value
    half = 2.0 ** -11                          # half of TF32's last place
    x = torch.tensor([1.0 + half, -(1.0 + half), one + half,
                      1.0 + half * 0.99, 3.0], dtype=torch.float32)
    want = torch.tensor([one, -one, one + 2 * half, 1.0, 3.0])
    assert torch.equal(tf32_rna(x), want)
    small = tf32_rna(x - tf32_rna(x))
    assert torch.equal(tf32_rna(small), small)


def _reference_fwd(xs):
    """The reference's interpret-mode forward with lse on q, k, v (and
    the mask in ``kw``), as f32 torch tensors."""
    def run(q, k, v, **kw):
        dt = getattr(R.jnp, str(q.dtype).split(".")[1])
        args = [R.jnp.asarray(t.float().numpy()).astype(dt)
                for t in (q, k, v)]
        out = R.ref_flash_kernel.flash_attention(
            *args, bq=32, bk=32, interpret=True, return_lse=True, **kw)
        return [torch.from_numpy(np.array(o.astype(R.jnp.float32)))
                for o in out]
    return lambda **kw: run(*xs[:3], **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
def test_fwd_model_matches_reference_fwd(causal, window, dtype):
    """o and lse at the reference tests' shape (B=2, H=2, S=128, hd=16):
    one or two of the kernel's kv stages, four of the reference's tiles."""
    xs = _inputs(41, (2, 2, 128, 16), dtype, causal, window)
    _close(fwd_model(*xs[:3], causal=causal, window=window),
           _reference_fwd(xs)(causal=causal, window=window), TOL[dtype])


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_fwd_model_matches_plain_at_a_wide_head(dtype, tol):
    """One head at S = 512, hd = 128, causal: o and lse against
    ``flash_fwd_plain`` at the card's tolerances."""
    xs = _inputs(43, (1, 1, 512, 128), dtype, True, None)
    _close(fwd_model(*xs[:3], causal=True, window=None),
           flash_fwd_plain(*xs[:3], causal=True), tol)


def test_fwd_one_tf32_product_misses_the_f32_tolerance():
    """The forward's negative control: o through single TF32 products
    misses 2e-5, so the f32 route needs 3xTF32 there too."""
    xs = _inputs(41, (2, 2, 128, 16), "float32", True, None)
    want = _reference_fwd(xs)(causal=True, window=None)[:1]
    split = _max_err(fwd_model(*xs[:3], causal=True, window=None)[:1], want)
    plain_tf32 = _max_err(fwd_model(*xs[:3], causal=True, window=None,
                                    mm=mm_tf32)[:1], want)
    assert split <= TOL["float32"] < plain_tf32
