"""The oracle and the plain PyTorch versions of the attention kernels.

``attention_ref`` is the oracle: it materialises the ``(S, S)`` scores
with ``-inf`` masking and a softmax, as the reference's
``repro/kernels/flash_attention/ref.py``. ``flash_fwd_plain`` (K3) and
``flash_bwd_plain`` (K4 and K5) compute what the kernels compute, with
their own math: scores ``(q * hd**-0.5) @ k^T`` in f32, masked at
``-1e30``, ``l`` clamped at ``1e-30``, outputs cast to the inputs'
dtypes. They run on any device: the CPU tests use them, and
``chip_smoke.py`` holds the kernels against them on the card.

These functions take no parameters: the tests make every input with
numpy from a seed and hand the same arrays to both packages, so nothing
needs converting.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def allowed(S: int, causal: bool, window, device) -> torch.Tensor:
    """(S, S) bool mask: causal keeps ``k <= q``; a window keeps
    ``k > q - window``."""
    qp = torch.arange(S, device=device)[:, None]
    kp = torch.arange(S, device=device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    return ok


def attention_ref(q, k, v, *, causal: bool = True, window=None):
    """q, k, v: (B, H, S, hd). Materialises (S, S) scores — oracle only."""
    S, hd = q.shape[-2:]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (hd ** -0.5)
    s = s.masked_fill(~allowed(S, causal, window, q.device), -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _scores(q, k, causal, window):
    """(q * scale) @ k^T in f32 with masked scores at -1e30."""
    S, hd = q.shape[-2:]
    s = (q.float() * (hd ** -0.5)) @ k.float().transpose(-1, -2)
    return s.masked_fill(~allowed(S, causal, window, q.device), NEG_INF)


def flash_fwd_plain(q, k, v, *, causal: bool = True, window=None):
    """K3's function: ``(o, lse)``, o in q's dtype, lse (B, H, S) f32."""
    s = _scores(q, k, causal, window)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    lc = p.sum(-1).clamp_min(1e-30)
    o = (p @ v.float()) / lc[..., None]
    return o.to(q.dtype), m + torch.log(lc)


def flash_bwd_plain(q, k, v, do, lse, drow, *, causal: bool = True,
                    window=None):
    """K4's and K5's function: ``(dq, dk, dv)`` from the forward's lse and
    ``drow = rowsum(do * o)``, recomputing ``p = exp(s - lse)``."""
    scale = q.shape[-1] ** -0.5
    p = torch.exp(_scores(q, k, causal, window) - lse.float()[..., None])
    dof = do.float()
    dp = dof @ v.float().transpose(-1, -2)
    ds = p * (dp - drow.float()[..., None]) * scale
    dq = ds @ k.float()
    dk = ds.transpose(-1, -2) @ q.float()
    dv = p.transpose(-1, -2) @ dof
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
