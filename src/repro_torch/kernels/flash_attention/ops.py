"""Public attention ops: ``mha`` (forward) and ``mha_vjp`` (forward and
backward as kernels), as ``repro/kernels/flash_attention/ops.py``.

The reference's ``force_interpret`` / ``interpret`` flags become
``backend=`` (``"auto" | "kernel" | "plain"``): the ops run where their
inputs lie, CUDA tensors through the kernels K3, K4 and K5, CPU tensors
through the plain PyTorch versions. No parameters are carried across:
the inputs are the caller's tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.kernel_bwd import \
    flash_attention_bwd


def mha(q, k, v, *, causal: bool = True, window=None, bq: int = 256,
        bk: int = 256, backend: str = "auto"):
    """q, k, v: (B, H, S, hd). Forward only: K3 on CUDA tensors, its plain
    version on CPU tensors."""
    return flash_attention(q, k, v, causal=causal, window=window, bq=bq,
                           bk=bk, backend=backend)


class _MhaVjp(torch.autograd.Function):
    """Forward: K3 with lse. Backward: ``drow = rowsum(do * o)`` in f32 as
    plain torch (the reference's ``ops.py:49`` does it in jnp), then K4
    and K5."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, bq, bk, backend):
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 bq=bq, bk=bk, return_lse=True,
                                 backend=backend)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = dict(causal=causal, window=window, bq=bq, bk=bk,
                       backend=backend)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        drow = (do.float() * o.float()).sum(-1)
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse, drow, **ctx.cfg)
        return dq, dk, dv, None, None, None, None, None


def mha_vjp(q, k, v, *, causal: bool = True, window=None, bq: int = 256,
            bk: int = 256, backend: str = "auto"):
    """Differentiable flash attention: K3 forward, K4 + K5 backward."""
    return _MhaVjp.apply(q, k, v, bool(causal), window, int(bq), int(bk),
                         backend)
