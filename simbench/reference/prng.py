"""Counter-based Threefry-2x32 draws in plain NumPy (uint32 arithmetic).

The simulator draws every random number from ``(seed, counter)``: per
event ``i`` it takes ``split(fold_in(key(seed), i), n)`` and turns the
subkeys into f32 uniforms and int32 ``randint`` values; an open-loop
request ``k`` takes its jitter uniform from ``fold_in(key(seed),
n_events + 1 + k)``. This module is that generator written from its
definition (Salmon et al., "Parallel Random Numbers: As Easy as 1, 2, 3",
20 rounds; the key layout of the "partitionable" threefry stream), over
NumPy ``uint32`` arrays, which wrap modulo 2**32 as the cipher needs.
"""
from __future__ import annotations

import numpy as np

U32 = np.uint32
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = U32(0x1BD11BDA)


def threefry2x32(k1, k2, x1, x2):
    """The two output words of Threefry-2x32 of counter ``(x1, x2)``
    under key ``(k1, k2)``; all uint32, broadcast against each other."""
    k1, k2, x1, x2 = (np.asarray(a, U32) for a in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = x1 + k1
    x1 = x2 + k2
    for r in range(5):
        for rot in (_ROT_A if r % 2 == 0 else _ROT_B):
            x0 = x0 + x1
            x1 = (x1 << U32(rot)) | (x1 >> U32(32 - rot))
            x1 = x0 ^ x1
        x0 = x0 + ks[(r + 1) % 3]
        x1 = x1 + ks[(r + 2) % 3] + U32(r + 1)
    return x0, x1


def key(seed: int):
    """Key pair of a 32-bit seed: ``(0, seed mod 2**32)``."""
    return U32(0), U32(int(seed) & 0xFFFFFFFF)


def fold_in(k, data):
    """Fold the 32-bit integers ``data`` (an array) into the key ``k``."""
    d = np.asarray(data, np.int64) & 0xFFFFFFFF
    return threefry2x32(k[0], k[1], U32(0), d.astype(U32))


def split(k, num: int):
    """``num`` subkeys of each key of ``k``, as a list of key pairs."""
    return [threefry2x32(k[0], k[1], U32(0), U32(j)) for j in range(num)]


def bits32(k) -> np.ndarray:
    """One 32-bit draw per key: ``b1 ^ b2`` of counter ``(0, 0)``."""
    b1, b2 = threefry2x32(k[0], k[1], U32(0), U32(0))
    return b1 ^ b2


def uniform(k) -> np.ndarray:
    """One f32 uniform in [0, 1) per key: 23 random mantissa bits under
    the exponent of 1.0, bit-cast, minus 1.0."""
    fb = (bits32(k) >> U32(9)) | U32(0x3F800000)
    return fb.view(np.float32) - np.float32(1.0)


def randint(k, minval: int, maxval: int) -> np.ndarray:
    """One int32 draw in ``[minval, maxval)`` per key: the key is split in
    two, one 32-bit draw from each, combined as ``(hi % span) * (2**32 %
    span) + lo % span`` modulo ``span`` in uint32 arithmetic."""
    hi_k, lo_k = split(k, 2)
    higher, lower = bits32(hi_k), bits32(lo_k)
    span = maxval - minval if maxval > minval else 1
    mult = (1 << 16) % span
    mult = U32((mult * mult) % span)
    sp = U32(span)
    off = (higher % sp) * mult + (lower % sp)
    return ((off % sp).astype(np.int64) + minval).astype(np.int32)
