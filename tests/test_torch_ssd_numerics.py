"""The numerics K6 uses on the tensor cores, modelled in plain torch and
held against the JAX reference on the CPU.

The CUDA kernel runs only on the card; what its arithmetic does to the
result can be sized here. ``ssd_model`` repeats its roundings and its
order: the cumulative sum of dA as the kernel's warp scan associates it
(each lane sums its consecutive values in order, a Hillis-Steele scan
over the 32 lanes' totals adds the sum before each lane); c b^T once
(the kernel forms it once per tile of heads, in the same k order whatever
the tile, so the tile changes no bit: ``chip_smoke.py`` checks that on the
card, which this model cannot), then per head W = c b^T * exp(cs_l - cs_m)
on m <= l, y = W xd and states = (xd * exp(cs_{L-1} - cs_l))^T b, each
product as 3xTF32 (each operand split into a big and a small TF32 half,
both rounded to nearest, ties away, and small*big + big*small + big*big
added to the f32 accumulator one k step of 8 at a time, in the kernel's
order). The model must meet the reference tests' tolerance (2e-4) against
the reference's interpret-mode kernel at the reference tests' shapes and
at the path's widths, whose cumulative sums fall to about -100 over a
chunk; single TF32 products must not (the negative control), and the
decay factored as exp(cs_l) exp(-cs_m) is not finite there.
"""
import numpy as np
import pytest
import torch

import torch_ref as R

#: the reference tests' shapes (S, H, P, N, chunk), as in
#: test_torch_ssd_scan.py, and one at the path's widths (L = 128, P = 64,
#: N = 128) with B = 1, nc = 2, H = 2
SHAPES = [(64, 4, 16, 8, 16), (128, 2, 32, 16, 32), (32, 8, 8, 4, 8)]
PATH_WIDTHS = (256, 2, 64, 128, 128)
TOL = 2e-4


def tf32_rna(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as the kernel's ``tf32_rna``: add half of the dropped
    bits' weight to the magnitude's bits, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _pad(x, dim, size):
    pad = size - x.shape[dim]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim)


def mm_3xtf32(a, b):
    """a @ b with the kernel's 3xTF32 products, one k step of 8 at a time
    (k zero-padded to a multiple of 8, as the kernel pads L and N)."""
    K = -(-a.shape[-1] // 8) * 8
    a, b = _pad(a, -1, K), _pad(b, -2, K)
    ab, bb = tf32_rna(a), tf32_rna(b)
    as_, bs = tf32_rna(a - ab), tf32_rna(b - bb)
    acc = a.new_zeros(a.shape[:-1] + b.shape[-1:])
    for k in range(0, K, 8):
        s = slice(k, k + 8)
        acc = acc + as_[..., s] @ bb[..., s, :]
        acc = acc + ab[..., s] @ bs[..., s, :]
        acc = acc + ab[..., s] @ bb[..., s, :]
    return acc


def mm_tf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def warp_scan_cumsum(x):
    """cumsum over the last axis (L values) as the kernel's warp scan
    associates it: L padded to a multiple of 16 (LP), lane i of 32 holds
    values [i E, i E + E) with E = ceil(LP / 32)."""
    L = x.shape[-1]
    LP = -(-L // 16) * 16
    E = -(-LP // 32)
    v = _pad(x, -1, 32 * E).reshape(*x.shape[:-1], 32, E)
    run, tot = [], torch.zeros(v.shape[:-1])
    for e in range(E):
        tot = tot + v[..., e]
        run.append(tot)
    inc = tot
    for d in (1, 2, 4, 8, 16):
        inc = torch.cat([inc[..., :d], inc[..., d:] + inc[..., :-d]], -1)
    before = torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], -1)
    cs = before[..., None] + torch.stack(run, -1)
    return cs.reshape(*x.shape[:-1], 32 * E)[..., :L]


def ssd_model(xd, dA, b, c, *, mm=mm_3xtf32, factored=False):
    """(y_diag, states, chunk_decay) with K6's roundings, head by head.
    ``mm`` is the product (3xTF32 by default); ``factored`` forms the
    decay as exp(cs_l) exp(-cs_m), which the kernel does not."""
    B, nc, L, H, P = xd.shape
    cs = warp_scan_cumsum(dA.permute(0, 1, 3, 2))        # (B,nc,H,L)
    last = cs[..., -1:]
    tril = torch.tril(torch.ones(L, L, dtype=torch.bool))
    att = mm(c, b.transpose(-1, -2))
    ys, sts = [], []
    for h in range(H):
        cl, xh = cs[:, :, h], xd[:, :, :, h]
        if factored:
            dec = (torch.exp(cl)[..., :, None]
                   * torch.exp(-cl)[..., None, :])
        else:
            dec = torch.exp(cl[..., :, None] - cl[..., None, :])
        w = torch.where(tril, att * dec, 0.0)
        ys.append(mm(w, xh))
        xw = xh * torch.exp(last[:, :, h] - cl)[..., None]
        sts.append(mm(xw.transpose(-1, -2), b))
    return (torch.stack(ys, 3), torch.stack(sts, 2),
            torch.exp(last[..., 0]))


def _inputs(seed, S, H, P, N, chunk, B=2):
    """The kernel's operands (xd, dA, b, c) as ``ssd_forward`` forms them
    from xh, dt, a, b, c made as the reference tests make them (softplus
    dt, negative a), from numpy."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    b = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    nc = S // chunk
    return ((xh * dt[..., None]).reshape(B, nc, chunk, H, P),
            (dt * a).reshape(B, nc, chunk, H),
            b.reshape(B, nc, chunk, N), c.reshape(B, nc, chunk, N))


def _reference(ops, hb):
    out = R.ref_ssd_kernel.ssd_intra_chunk(*map(R.jnp.asarray, ops), hb=hb,
                                           interpret=True)
    return [torch.from_numpy(np.array(o)) for o in out]


def _excess(got, want):
    """The largest |got - want| / (TOL + TOL |want|): at most 1 where
    every element meets the tolerance ``_close`` holds it to."""
    return max(float(((a - b).abs() / (TOL + TOL * b.abs())).max())
               for a, b in zip(got, want))


def _close(got, want):
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("S,H,P,N,chunk", SHAPES)
def test_model_matches_reference_kernel(S, H, P, N, chunk):
    """The reference at head tiles of 2 (its hb at these shapes)."""
    ops = _inputs(S + H, S, H, P, N, chunk)
    hb = min(2, H)
    _close(ssd_model(*map(torch.from_numpy, ops)), _reference(ops, hb))


@pytest.fixture(scope="module")
def path_widths():
    ops = _inputs(19, *PATH_WIDTHS, B=1)
    return [torch.from_numpy(o) for o in ops], _reference(ops, 2)


def test_model_matches_reference_at_the_path_widths(path_widths):
    """L = 128, P = 64, N = 128: cs falls to about -100 over a chunk, so
    chunk_decay is about e^-100, a denormal in f32 (the kernel's expf keeps
    it; the reference's CPU exp may flush it to zero: within TOL either
    way). The model stays finite."""
    ops, want = path_widths
    cs = torch.cumsum(ops[1], dim=2)
    assert float(cs[:, :, -1].max()) < -80
    got = ssd_model(*ops)
    _close(got, want)
    assert float(got[2].max()) < 1e-30


def test_one_tf32_product_misses_the_tolerance(path_widths):
    """The negative control: TF32 without the small halves misses 2e-4
    at the path's widths, so the kernel needs 3xTF32 (and the test above
    can fail)."""
    ops, want = path_widths
    split = _excess(ssd_model(*ops), want)
    plain_tf32 = _excess(ssd_model(*ops, mm=mm_tf32), want)
    assert split <= 1 < plain_tf32


def test_factored_decay_is_not_finite_at_the_path_widths(path_widths):
    """Why the kernel keeps exp(cs_l - cs_m): exp(-cs_m) overflows and
    exp(cs_l) underflows there, and inf * 0 is NaN."""
    ops, _ = path_widths
    y = ssd_model(*ops, factored=True)[0]
    assert not bool(torch.isfinite(y).all())


def test_warp_scan_association():
    """The warp scan's association stays within f32 rounding of a
    sequential cumsum at every padded length the kernel takes."""
    rng = np.random.default_rng(3)
    for L in (8, 16, 40, 64, 128):
        x = torch.from_numpy(-np.abs(rng.standard_normal((3, L)))
                             .astype(np.float32))
        torch.testing.assert_close(warp_scan_cumsum(x),
                                   torch.cumsum(x, -1), atol=1e-5,
                                   rtol=1e-6)
