"""Row arithmetic of the sharded sweep, and its device list.

``repro_torch.core.batch.sweep(devices=, chunk=)`` measures a bucket's
flattened (workload x seed) axis of ``B`` rows in dispatch *units* of
``chunk`` rows per device (``chunk * D`` rows for ``D`` devices; ``chunk``
None gives one unit of ``ceil(B / D)`` rows per device). The unit count is
split greedily into power-of-two **superchunks**, one dispatch each, so a
bucket costs ``popcount(units)`` dispatches. Rows are padded only up to a
multiple of ``D`` (the last row repeated, the copies cut off after), and
the trailing superchunk is trimmed to the rows that remain. Each
superchunk splits into ``D`` equal shards, one per listed device.

These are plain functions of integers (and numpy rows): the device work
and its order live in ``core/batch.py``. A list may name one device more
than once; its shards then run side by side on that device.

>>> units(6, 1, 2), superchunks(6, 1, 2)
(3, [(0, 4), (4, 2)])
>>> superchunks(7, 2, None), shards(0, 8, 2)
([(0, 8)], [(0, 4), (4, 4)])
>>> superchunks(96, 1, 40)          # 3 units: 2 whole, then 16 rows
[(0, 80), (80, 16)]
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["padded_rows", "pad_rows", "resolve_devices", "rows_per_unit",
           "shards", "superchunk_units", "superchunks", "units"]


def rows_per_unit(B: int, D: int, chunk: int | None) -> int:
    """Rows each device takes per unit: ``chunk``, or ``ceil(B / D)``."""
    rows = int(chunk) if chunk is not None else math.ceil(B / D)
    if rows < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return rows


def padded_rows(B: int, D: int) -> int:
    """``B`` rounded up to a multiple of the device count ``D``."""
    return math.ceil(B / D) * D


def units(B: int, D: int, chunk: int | None) -> int:
    """Dispatch units of ``rows_per_unit * D`` rows in the padded rows."""
    return math.ceil(padded_rows(B, D) / (rows_per_unit(B, D, chunk) * D))


def superchunk_units(n_units: int) -> list[int]:
    """Greedy power-of-two split of ``n_units``, largest first:
    ``popcount(n_units)`` parts."""
    sizes, rem = [], n_units
    while rem:
        p = 1 << (rem.bit_length() - 1)
        sizes.append(p)
        rem -= p
    return sizes


def superchunks(B: int, D: int, chunk: int | None) -> list[tuple[int, int]]:
    """``(offset, rows)`` of each superchunk over the padded rows, in
    dispatch order; every ``rows`` is a multiple of ``D`` and the last one
    is trimmed to what remains."""
    step = rows_per_unit(B, D, chunk) * D
    Bp = padded_rows(B, D)
    out, off = [], 0
    for sz in superchunk_units(units(B, D, chunk)):
        nrows = min(sz * step, Bp - off)
        out.append((off, nrows))
        off += nrows
    return out


def shards(off: int, nrows: int, D: int) -> list[tuple[int, int]]:
    """``(offset, rows)`` of the ``D`` equal shards of one superchunk."""
    per = nrows // D
    return [(off + j * per, per) for j in range(D)]


def pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Pad the leading axis by ``n`` copies of the last row."""
    if n == 0:
        return a
    return np.concatenate([a, np.repeat(a[-1:], n, axis=0)], axis=0)


def resolve_devices(devices, device="cuda") -> list[torch.device]:
    """The shard devices as ``torch.device``s with an index (a CUDA device
    without one is the current device). ``devices=None`` is every visible
    device of ``device``'s type (the CPU is one device). Devices of more
    than one type raise; so does asking for CUDA without it."""
    if devices is None:
        kind = resolve_device(device).type
        devices = (["cpu"] if kind == "cpu" else
                   [f"cuda:{i}" for i in range(torch.cuda.device_count())])
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("devices must name at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"devices must all be of one type, got "
                         f"{[str(d) for d in devs]}")
    devs = [resolve_device(d) for d in devs]
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
