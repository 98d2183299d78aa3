"""Execution options as an explicit immutable object.

``ExecOptions`` carries everything about *how* a sweep executes — backend
and device — as one frozen value that callers thread explicitly through
``Experiment.run``; there is no process-wide execution state.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.device import BACKENDS


@dataclass(frozen=True)
class ExecOptions:
    """How to execute a sweep: (backend, device), immutably.

    backend: "auto" | "kernel" | "plain" — per-replica engine
      (``repro_torch.device.resolve_backend`` semantics).
    device: where the sweep runs. The default ``"cuda"`` raises at run
      time without a CUDA device; ``"cpu"`` must be asked for by name.
    devices, chunk: sharded dispatch over several devices. Accepted so
      that callers written for it construct, refused at run time
      (``sweep`` raises ``NotImplementedError``) until it is ported.
    """
    backend: str = "auto"
    device: str = "cuda"
    devices: int | None = None
    chunk: int | None = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{self.backend!r}")
        for name in ("devices", "chunk"):
            v = getattr(self, name)
            if v is not None:
                v = int(v)
                if v < 1:
                    raise ValueError(f"{name} must be >= 1, got {v}")
                object.__setattr__(self, name, v)

    def sweep_kwargs(self) -> dict:
        """Keyword arguments for ``repro_torch.core.batch.sweep``."""
        return {"backend": self.backend, "device": self.device,
                "devices": self.devices, "chunk": self.chunk}
