"""Oracles and the plain PyTorch version of the SSD (Mamba-2) kernel.

``ssd_sequential`` is the exact O(S) recurrence — the strongest
reference:
    h_t = exp(dt_t * a) * h_{t-1} + dt_t * x_t ⊗ b_t
    y_t = c_t · h_t
``ssd_chunk_ref`` is the reference's per-chunk oracle batched over
``(B, nc)``: the plain version of K6, which ``chip_smoke.py`` holds the
kernel against on the card and the CPU path runs. Both take no
parameters; the tests make every input with numpy from a seed and hand
the same arrays to both packages.
"""
from __future__ import annotations

import torch


def ssd_sequential(xh, dt, a, b, c, h0=None):
    """xh: (B,S,H,P); dt: (B,S,H); a: (H,)<0; b,c: (B,S,N).
    Returns y: (B,S,H,P) f32, h_final: (B,H,P,N) f32."""
    B, S, H, P = xh.shape
    N = b.shape[-1]
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0)
    af = a.float()
    ys = []
    for t in range(S):
        dtt = dt[:, t].float()                              # (B,H)
        dec = torch.exp(dtt * af)                           # (B,H)
        upd = torch.einsum("bhp,bn->bhpn", xh[:, t].float() * dtt[..., None],
                           b[:, t].float())
        h = h * dec[..., None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", c[:, t].float(), h))
    return torch.stack(ys, 1), h


def ssd_chunk_ref(xd, dA, b, c):
    """K6's function over every chunk at once. xd: (B,nc,L,H,P) already
    dt-scaled; dA: (B,nc,L,H); b,c: (B,nc,L,N). Returns y_diag
    (B,nc,L,H,P), states (B,nc,H,P,N), chunk_decay (B,nc,H), all f32."""
    xd, dA, b, c = xd.float(), dA.float(), b.float(), c.float()
    L = xd.shape[2]
    cs = torch.cumsum(dA, dim=2)                            # (B,nc,L,H)
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]      # (B,nc,L,L,H)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=xd.device))[:, :, None]
    decay = torch.where(mask, torch.exp(diff), 0.0)
    att = torch.einsum("bcln,bcmn->bclm", c, b)             # (B,nc,L,L)
    y = torch.einsum("bclmh,bcmhp->bclhp", att[..., None] * decay, xd)
    dstates = torch.exp(cs[:, :, -1:, :] - cs)              # (B,nc,L,H)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", b, dstates, xd)
    return y, states, torch.exp(cs[:, :, -1])
