"""Flash-attention forward: the wrapper of the CUDA kernel K3
(``csrc/flash_attention.cu``) and ``flash_attention``.

Replaces the TPU kernel ``repro/kernels/flash_attention/kernel.py::
_flash_kernel``. The kernel is bound by operations and runs both products
on the tensor cores: ``wgmma`` for bf16 inputs (p rounded to bf16 before
``p v``), 3xTF32 ``mma.sync`` for f32, with the backward's machinery
(``csrc/flash_hopper.cuh``). Every ``(S, S)`` quantity stays inside the
CTA: one CTA per ``(b, h, 128-row q tile)`` (64 rows above hd = 128), a
producer warpgroup streaming k and v tiles through a ring of shared-memory
stages, each row's running max, sum and accumulator in the consumers'
registers (see the header of the ``.cu`` file). It is built by ``nvcc`` at
the first launch (``kernels/_build``); importing this module needs neither
``nvcc`` nor a CUDA device.

``flash_fwd_kernel`` launches the kernel for CUDA tensors or raises — no
path leads from it to the plain version. ``LIB`` declares the library; it
counts the launches (one per call), and nothing else does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import device_of, resolve_backend
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_fwd_plain

#: the input dtypes the kernel is instantiated for (code passed to C)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the largest head dimension the kernel's tiles take
MAX_HD = 256

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = _build.Library("flash_attention", {
    "flash_fwd_launch": [_vp] * 5 + [_ci] * 5 + [_cf, _ci, _vp],
    "flash_fwd_smem_bytes": [_ci],
}, _build.REPORT_FLAGS)


def block_rows(hd: int) -> int:
    """Rows of one CTA's q tile at head dimension ``hd``: 128, two
    consumer warpgroups of 64; above 128 the two share 64 rows and split
    the output columns."""
    return 128 if hd <= 128 else 64


def _geometry(hd: int, dtype) -> dict:
    """The tiles of one CTA (mirrors ``FwdGeo`` in the ``.cu``): hd padded
    to 64, 128 or 256, the resident q tile, ``stream`` kv rows a stage."""
    bf16 = dtype == torch.bfloat16
    hdp = 64 if hd <= 64 else 128 if hd <= 128 else 256
    if bf16:
        stream = 64 if hdp == 256 else 128
    else:
        stream = 32 if hdp == 256 else 64
    return {"res": block_rows(hd), "stream": stream,
            "row_bytes": 2 * hdp if bf16 else 4 * (hdp + 4)}


def _smem(g: dict, stages: int) -> int:
    return (1024 + g["res"] * g["row_bytes"]
            + stages * 2 * g["stream"] * g["row_bytes"] + (1 + 2 * stages) * 8)


def smem_bytes(hd: int) -> int:
    """Shared memory of one forward CTA, the larger of the f32 and bf16
    routes' (mirrors the ``.cu``): 1,024 bytes of alignment slack, the q
    tile, a ring of three stages (two where three do not fit in 227 KB) of
    a k and a v tile, and the mbarriers."""
    def one(g):
        return _smem(g, 3 if _smem(g, 3) <= _build.SMEM_LIMIT else 2)
    return max(one(_geometry(hd, dt)) for dt in (torch.float32,
                                                   torch.bfloat16))


def check_kernel_operands(what, hd, **tensors):
    """The checks every attention kernel wrapper makes before a launch."""
    _build.require_cuda(what, **tensors)
    dts = {t.dtype for n, t in tensors.items() if n not in ("lse", "drow")}
    if len(dts) != 1 or next(iter(dts)) not in DTYPES:
        raise ValueError(f"{what} takes q, k, v (and do) of one dtype, "
                         f"float32 or bfloat16; got {sorted(map(str, dts))}")
    for n in ("lse", "drow"):
        if n in tensors and tensors[n].dtype != torch.float32:
            raise ValueError(f"{what}: {n} must be float32")
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"{what} takes head dimensions 1..{MAX_HD}, got "
                         f"{hd}; use backend='plain'")


def window_arg(window) -> int:
    return 0 if window is None else int(window)


def flash_fwd_kernel(q, k, v, *, causal: bool = True, window=None):
    """Launch K3 on the current stream: ``(o, lse)`` as
    ``ref.flash_fwd_plain``. q, k, v: contiguous (B, H, S, hd) CUDA
    tensors of one dtype (float32 or bfloat16)."""
    B, H, S, hd = q.shape
    check_kernel_operands("flash-attention forward kernel", hd, q=q, k=k,
                          v=v)
    lib = LIB.load()
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B * H, S, hd, int(causal), window_arg(window),
            hd ** -0.5, DTYPES[q.dtype], _build.stream_of(q))
    _build.check_launch(lib, err, f"flash-attention forward (B={B}, H={H}, "
                                  f"S={S}, hd={hd}, {q.dtype})")
    LIB.count()
    return o, lse


def check_qkv(q, k, v, bq, bk):
    """The reference's argument checks (``kernel.py:78-80``), raising
    ``ValueError`` where it asserts. Returns ``(B, H, S, hd)``."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, S, hd) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    S = q.shape[2]
    bq, bk = min(bq, S), min(bk, S)
    if S % bq or S % bk:
        raise ValueError(f"S must be a multiple of the tiles, got "
                         f"(S, bq, bk) = {(S, bq, bk)}")
    return tuple(q.shape)


def check_window(window):
    if window is not None and window < 1:
        raise ValueError(f"window must be None or at least 1 (a window of "
                         f"{window} masks every score of a row), got "
                         f"{window}")


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    bq: int = 256, bk: int = 256, return_lse: bool = False,
                    backend: str = "auto"):
    """q, k, v: (B, H, S, hd) — H layout, GQA pre-repeated. Returns o
    (B, H, S, hd) in q's dtype [, lse (B, H, S) f32 — consumed by the
    backward].

    Runs where the inputs lie: CUDA tensors launch K3 (``backend="auto"``
    or ``"kernel"``), CPU tensors take the plain version (``"auto"`` or
    ``"plain"``); ``"kernel"`` on CPU tensors raises. ``bq``/``bk`` are
    accepted and checked as the reference does; the CUDA kernel chooses
    its own tiles (``block_rows`` q rows a CTA, 64 kv rows a stage): the
    TPU's 256 x 256 f32 k and v tiles would need 256 KB of shared memory,
    more than a CTA may use.
    """
    check_qkv(q, k, v, bq, bk)
    check_window(window)
    dev = device_of(q=q, k=k, v=v)
    if resolve_backend(backend, dev) == "plain":
        o, lse = flash_fwd_plain(q, k, v, causal=causal, window=window)
    else:
        o, lse = flash_fwd_kernel(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  window=window)
    return (o, lse) if return_lse else o
