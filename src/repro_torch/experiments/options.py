"""Execution options as an explicit immutable object.

``ExecOptions`` carries everything about *how* a sweep executes — backend,
device, sharding and chunking — as one frozen value that callers thread
explicitly through ``Experiment.run``; there is no process-wide execution
state.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from repro_torch.device import BACKENDS


@dataclass(frozen=True)
class ExecOptions:
    """How to execute a sweep: (backend, device, devices, chunk),
    immutably.

    backend: "auto" | "kernel" | "plain" — per-replica engine
      (``repro_torch.device.resolve_backend`` semantics).
    device: where the sweep runs. The default ``"cuda"`` raises at run
      time without a CUDA device; ``"cpu"`` must be asked for by name.
    devices: shard sweep buckets over the first N devices of ``device``'s
      type (``device_list``); None keeps the single-dispatch layout.
    chunk: rows per device per dispatch unit (``core/batch.py``).
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

    @classmethod
    def from_env(cls, **kw) -> "ExecOptions":
        """Defaults with ``REPRO_BACKEND`` honored (``auto``, ``kernel`` or
        ``plain``; any other name raises); non-None kwargs override (an
        explicit ``backend=None`` means "not given", so the variable still
        applies)."""
        kw = {k: v for k, v in kw.items() if v is not None}
        kw.setdefault("backend", os.environ.get("REPRO_BACKEND", "auto"))
        return cls(**kw)

    def device_list(self):
        """The resolved device list for ``batch.sweep(devices=)``: the
        first ``devices`` devices of ``device``'s type (the CPU counts as
        one), or None."""
        if self.devices is None:
            return None
        from repro_torch.parallel.sharding import resolve_devices
        devs = resolve_devices(None, self.device)
        if self.devices > len(devs):
            raise ValueError(f"devices={self.devices} but only {len(devs)} "
                             f"{devs[0].type} device(s) are visible")
        return devs[:self.devices]

    def sweep_kwargs(self) -> dict:
        """Keyword arguments for ``repro_torch.core.batch.sweep``."""
        return {"backend": self.backend, "device": self.device,
                "devices": self.device_list(), "chunk": self.chunk}
