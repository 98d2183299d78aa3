"""The hi/lo int32 output contract of the event loop's 64-bit clocks.

The reference engine can hand its int64 outputs (latency stamps, end
times, the open loop's arrival, wait and sojourn times) back as **pairs**
``(hi, lo)`` of equal-shaped int32 arrays encoding

    value = hi * 2**32 + u32(lo)

where ``lo`` is the *unsigned* low word reinterpreted as int32
(``run_events_pairs``, ``traffic.arrival_times_pairs``). That form exists
there because its TPU compiler has no 64-bit vectors; on this card the
clocks are native int64 and only the conversion is kept, so that callers of
the pairs contract get the same arrays. ``lo`` is derived in int64
arithmetic and cast, with no view through an unsigned dtype.

>>> import numpy as np
>>> hi, lo = unpack_np(np.int64([2**32 + 5, -1, 2**31]))
>>> (hi.tolist(), lo.tolist())
([1, -1, 0], [5, -1, -2147483648])
>>> pack_np(hi, lo).tolist()
[4294967301, -1, 2147483648]
"""
from __future__ import annotations

import numpy as np
import torch

_U32_MASK = 0xFFFFFFFF
_SIGN32 = 0x80000000

#: int64 max as a pair — the "parked thread" sentinel that loses every
#: argmin. hi carries INT32_MAX, lo carries the all-ones low word (-1).
NEVER = (np.int32(2**31 - 1), np.int32(-1))


def pack(p) -> torch.Tensor:
    """Pair of int32 tensors -> int64 tensor."""
    hi, lo = p
    # hi * 2**32 stays inside int64 for every int32 hi; the low word adds
    # into the 32 zero bits below it
    return (hi.to(torch.int64) * (1 << 32)) | (lo.to(torch.int64)
                                               & _U32_MASK)


def unpack(x: torch.Tensor):
    """int64 tensor -> pair ``(hi, lo)`` of int32 tensors."""
    x = x.to(torch.int64)
    hi = (x >> 32).to(torch.int32)
    # the low word as a signed 32-bit value: bias, mask, unbias
    lo = (((x & _U32_MASK) ^ _SIGN32) - _SIGN32).to(torch.int32)
    return (hi, lo)


def pack_np(hi, lo) -> np.ndarray:
    """Numpy pair -> int64."""
    return ((np.asarray(hi, np.int64) * (1 << 32))
            | (np.asarray(lo, np.int64) & _U32_MASK))


def unpack_np(x):
    """Numpy int64 -> pair of int32 arrays."""
    x = np.asarray(x, np.int64)
    hi = (x >> 32).astype(np.int32)
    lo = (((x & _U32_MASK) ^ _SIGN32) - _SIGN32).astype(np.int32)
    return (hi, lo)
