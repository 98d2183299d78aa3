"""Full SSD forward: the intra-chunk kernel K6 plus plain-torch glue, as
``repro/kernels/ssd_scan/ops.py``.

The inter-chunk recurrence (the reference's ``lax.scan``) is a loop over
the ``nc`` chunks and the final contraction an ``einsum``: the reference
keeps both outside any kernel, and so does the port. The op runs where
its inputs lie (``backend=`` as ``ssd_intra_chunk``; the reference's
``use_kernel=False`` is ``backend="plain"``). No parameters are carried
across: the inputs are the caller's tensors.
"""
from __future__ import annotations

import torch

from repro_torch.device import device_of
from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk


def ssd_forward(xh, dt, a, b, c, *, chunk: int = 128, hb: int = 8,
                backend: str = "auto"):
    """SSD with the intra-chunk kernel. Same contract as
    ``ref.ssd_sequential``. xh: (B,S,H,P); dt: (B,S,H); a: (H,);
    b,c: (B,S,N). Returns y (B,S,H,P) f32 and the last state (B,H,P,N)."""
    B, S, H, P = xh.shape
    N = b.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} must be a multiple of chunk={chunk}")
    device_of(xh=xh, dt=dt, a=a, b=b, c=c)
    nc = S // chunk
    dtf = dt.float()
    dA = (dtf * a.float()).reshape(B, nc, chunk, H)
    xd = (xh.float() * dtf[..., None]).reshape(B, nc, chunk, H, P)
    bc = b.float().reshape(B, nc, chunk, N)
    cc = c.float().reshape(B, nc, chunk, N)
    y_d, states, chunk_decay = ssd_intra_chunk(xd, dA, bc, cc, hb=hb,
                                               backend=backend)

    # inter-chunk recurrence (tiny): h_{i+1} = decay_i * h_i + states_i
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
    h_prevs = []
    for i in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, i, :, None, None] + states[:, i]
    h_prevs = torch.stack(h_prevs, 1)                    # (B,nc,H,P,N)

    dA_cs = torch.cumsum(dA, dim=2)                      # (B,nc,L,H)
    y_o = torch.einsum("bcln,bchpn,bclh->bclhp", cc, h_prevs,
                       torch.exp(dA_cs))
    return (y_d + y_o).reshape(B, S, H, P), h
