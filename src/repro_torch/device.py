"""Device and backend policy of the port — explicit, never a fallback.

Every entry point that makes its own tensors takes ``device=`` and
defaults to ``"cuda"``. Asking for CUDA (by default or by name) on a host
without a CUDA device raises; the CPU is used only when the caller writes
``device="cpu"``. The entry points that take tensors (attention, SSD) run
where those tensors lie: CPU tensors are the caller asking for the CPU.
"""
from __future__ import annotations

import torch

BACKENDS = ("auto", "kernel", "plain")


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but no CUDA device is "
            f"available; this package does not carry on on the CPU on its "
            f"own — pass device=\"cpu\" explicitly to run the plain "
            f"PyTorch version there")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA device or 'cpu', got "
                         f"{str(device)!r}")
    return dev


def resolve_backend(backend: str, device) -> str:
    """'auto' -> the hand-written CUDA kernel on a CUDA device, the plain
    PyTorch version on an explicitly requested CPU. 'kernel' needs CUDA
    tensors; 'plain' runs on whatever device was asked for."""
    if backend not in BACKENDS:
        raise ValueError(
            f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = torch.device(device)
    if backend == "auto":
        return "kernel" if dev.type == "cuda" else "plain"
    if backend == "kernel" and dev.type != "cuda":
        raise ValueError(
            "backend='kernel' is the hand-written CUDA kernel and needs a "
            f"CUDA device, got device={str(device)!r}; use backend='plain' "
            "for the PyTorch version")
    return backend


def device_of(**tensors) -> torch.device:
    """The one device every tensor lies on (checked with
    ``resolve_device``); mixed devices raise."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        detail = ", ".join(f"{n} on {t.device}" for n, t in tensors.items())
        raise ValueError(f"all inputs must lie on one device, got {detail}")
    return resolve_device(devs.pop())
