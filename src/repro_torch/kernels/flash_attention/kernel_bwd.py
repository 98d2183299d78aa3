"""Flash-attention backward: the wrappers of the CUDA kernels K4 (dq) and
K5 (dk, dv) (``csrc/flash_attention_bwd.cu``) and
``flash_attention_bwd``.

Replace the TPU kernels ``repro/kernels/flash_attention/kernel_bwd.py::
_dq_kernel`` and ``::_dkv_kernel``. Both recompute ``p = exp(s - lse)``
from (q, k, lse), so nothing O(S^2) reaches device memory: K4 runs one
block per ``(b, h, q tile)`` over the kv tiles, K5 one block per ``(b, h,
kv tile)`` over the q tiles, each with its accumulators in registers and
without atomics. Every product runs on the tensor cores: ``wgmma`` for
bf16 inputs (p and ds rounded to bf16 before the second products), 3xTF32
``mma.sync`` for f32 (see the header of the ``.cu`` file). Built at the
first launch; importing this module needs neither ``nvcc`` nor a CUDA
device.

``flash_dq_kernel`` and ``flash_dkv_kernel`` launch for CUDA tensors or
raise. ``LIB`` declares the library; it counts their launches as ``dq``
and ``dkv`` (one per call), and nothing else does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import device_of, resolve_backend
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (
    DTYPES, check_kernel_operands, check_qkv, check_window,
    window_arg)
from repro_torch.kernels.flash_attention.ref import flash_bwd_plain

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = _build.Library("flash_attention_bwd", {
    "flash_dq_launch": [_vp] * 7 + [_ci] * 5 + [_cf, _ci, _vp],
    "flash_dkv_launch": [_vp] * 8 + [_ci] * 5 + [_cf, _ci, _vp],
    "flash_dq_smem_bytes": [_ci],
    "flash_dkv_smem_bytes": [_ci],
}, _build.REPORT_FLAGS, counts=("dq", "dkv"))


def _geometry(hd: int, dtype) -> dict:
    """The tiles of one block at head dimension ``hd`` (mirrors ``Geo`` in
    the ``.cu``): hd padded to 64, 128 or 256; ``res`` rows resident,
    ``stream`` rows per stage of the ring; above 128 the two consumer
    warpgroups share 64 rows and split the columns."""
    bf16 = dtype == torch.bfloat16
    hdp = 64 if hd <= 64 else 128 if hd <= 128 else 256
    return {"res": 128 if hdp <= 128 else 64,
            "stream": 64 if bf16 or hdp == 64 else 32 if hdp == 128 else 16,
            "row_bytes": 2 * hdp if bf16 else 4 * (hdp + 4)}


def _smem(g: dict, stages: int, dkv: bool) -> int:
    return (1024 + 2 * g["res"] * g["row_bytes"]
            + stages * 2 * g["stream"] * g["row_bytes"]
            + (stages * 2 * g["stream"] * 4 if dkv else 0)
            + (1 + 2 * stages) * 8)


def _stages(hd: int, dtype) -> int:
    """Stages of the streamed ring: three where they fit in 227 KB."""
    fits = _smem(_geometry(hd, dtype), 3, True) <= _build.SMEM_LIMIT
    return 3 if fits else 2


def smem_bytes(hd: int) -> dict:
    """Shared memory of one dq and one dk/dv block, the larger of the f32
    and bf16 routes' (mirrors the ``.cu``): 1,024 bytes of alignment
    slack, two resident tiles, a ring of ``stages`` x two streamed tiles
    (dk/dv: with their rows' lse and drow) and the mbarriers."""
    return {name: max(_smem(_geometry(hd, dt), _stages(hd, dt), dkv)
                      for dt in (torch.float32, torch.bfloat16))
            for name, dkv in (("dq", False), ("dkv", True))}


def _operands(q, k, v, do, lse, drow, what):
    B, H, S, hd = q.shape
    check_kernel_operands(what, hd, q=q, k=k, v=v, do=do, lse=lse,
                          drow=drow)
    if do.shape != q.shape or lse.shape != (B, H, S) \
            or drow.shape != (B, H, S):
        raise ValueError(f"{what}: do must be {tuple(q.shape)} and lse, drow "
                         f"{(B, H, S)}; got {tuple(do.shape)}, "
                         f"{tuple(lse.shape)}, {tuple(drow.shape)}")
    return B, H, S, hd


def flash_dq_kernel(q, k, v, do, lse, drow, *, causal=True, window=None):
    """Launch K4: dq (B, H, S, hd) in q's dtype. Same operands as
    ``ref.flash_bwd_plain``, contiguous CUDA tensors."""
    what = "flash-attention dq kernel"
    B, H, S, hd = _operands(q, k, v, do, lse, drow, what)
    lib = LIB.load()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), drow.data_ptr(), dq.data_ptr(), B * H, S, hd,
            int(causal), window_arg(window), hd ** -0.5, DTYPES[q.dtype],
            _build.stream_of(q))
    _build.check_launch(lib, err, f"{what} (B={B}, H={H}, S={S}, hd={hd})")
    LIB.count("dq")
    return dq


def flash_dkv_kernel(q, k, v, do, lse, drow, *, causal=True, window=None):
    """Launch K5: (dk, dv), each (B, H, S, hd) in k's and v's dtype."""
    what = "flash-attention dk/dv kernel"
    B, H, S, hd = _operands(q, k, v, do, lse, drow, what)
    lib = LIB.load()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.flash_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), drow.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B * H, S, hd, int(causal), window_arg(window), hd ** -0.5,
            DTYPES[q.dtype], _build.stream_of(q))
    _build.check_launch(lib, err, f"{what} (B={B}, H={H}, S={S}, hd={hd})")
    LIB.count("dkv")
    return dk, dv


def flash_attention_bwd(q, k, v, do, lse, drow, *, causal: bool = True,
                        window=None, bq: int = 256, bk: int = 256,
                        backend: str = "auto"):
    """q, k, v, do: (B, H, S, hd); lse, drow: (B, H, S) f32. Returns
    ``(dq, dk, dv)``. Runs where the inputs lie, as ``flash_attention``;
    on CUDA tensors it launches K4 and then K5."""
    check_qkv(q, k, v, bq, bk)
    check_window(window)
    dev = device_of(q=q, k=k, v=v, do=do, lse=lse, drow=drow)
    if resolve_backend(backend, dev) == "plain":
        return flash_bwd_plain(q, k, v, do, lse, drow, causal=causal,
                               window=window)
    q, k, v, do, lse, drow = (t.contiguous() for t in (q, k, v, do, lse,
                                                        drow))
    dq = flash_dq_kernel(q, k, v, do, lse, drow, causal=causal,
                         window=window)
    dk, dv = flash_dkv_kernel(q, k, v, do, lse, drow, causal=causal,
                              window=window)
    return dq, dk, dv
