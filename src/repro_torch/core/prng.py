"""Counter-based threefry2x32 draw stream in torch integer ops.

The simulator's workload draws are a pure function of ``(seed, event
index)``: per event ``i`` the engine takes ``split(fold_in(key(seed), i),
3 or 4)`` and turns the subkeys into ``uniform(f32)`` / ``randint(i32)``
values. This module is that generator — the Threefry-2x32 block cipher
(Salmon et al., "Parallel Random Numbers: As Easy as 1, 2, 3", 20 rounds)
plus the key-derivation layout the reference stream uses:

  * ``key(seed)``      a 32-bit seed becomes the key pair ``(0, seed)``;
  * ``fold_in(k, d)``  ``threefry(k, counter=(0, d))`` — both output words
                       form the new key;
  * ``split(k, n)``    subkey ``j`` is ``threefry(k, counter=(0, j))``
                       (the "partitionable" layout: a 64-bit iota over the
                       output shape, split into hi/lo counter words);
  * ``bits32(k)``      one scalar draw: ``b1 ^ b2`` of
                       ``threefry(k, counter=(0, 0))``;
  * ``uniform(k)``     ``bitcast((bits >> 9) | 0x3F800000) - 1.0`` in f32,
                       i.e. the 23 mantissa bits of a float in [1, 2);
  * ``randint(k, lo, hi)``  splits ``k`` in two, draws 32 bits from each
                       and combines ``(hi_bits % span) * (2**32 % span) +
                       lo_bits % span`` modulo ``span`` in uint32
                       arithmetic.

Torch has next to no ``uint32`` arithmetic, so every 32-bit word rides in
an ``int64`` tensor and is masked back to 32 bits after each add or shift;
rotations are written out as two shifts. All functions broadcast: a key is
a pair ``(k1, k2)`` of equally-shaped tensors, so a whole ``(replica,
event)`` grid of keys is hashed by one call.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of counter words ``(x1, x2)`` under key
    ``(k1, k2)``; all four are int64 tensors (or ints) holding uint32
    values and broadcast against each other. Returns the two output words
    in the same representation."""
    k3 = k1 ^ k2 ^ _PARITY
    ks = (k1, k2, k3)
    x0 = (x1 + k1) & _M32
    x1 = (x2 + k2) & _M32
    for r in range(5):
        for rot in (_ROT_A if r % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << rot) & _M32) | (x1 >> (32 - rot))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(r + 1) % 3]) & _M32
        x1 = (x1 + ks[(r + 2) % 3] + (r + 1)) & _M32
    return x0, x1


def key(seed: torch.Tensor):
    """Key pair of an int32 seed tensor: ``(0, seed as uint32)``."""
    s = seed.to(torch.int64) & _M32
    return torch.zeros_like(s), s


def fold_in(k, data):
    """Fold a 32-bit integer (tensor or int, broadcastable) into a key."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64)
    return threefry2x32(k[0], k[1], 0, data & _M32)


def split(k, num: int):
    """``num`` subkeys, stacked on a new leading axis: a key pair whose
    tensors have shape ``(num, *k[0].shape)``."""
    k1, k2 = k
    j = torch.arange(num, dtype=torch.int64, device=k1.device)
    j = j.reshape((num,) + (1,) * k1.dim())
    return threefry2x32(k1[None], k2[None], 0, j)


def bits32(k) -> torch.Tensor:
    """One 32-bit draw per key (int64 tensor holding uint32 values)."""
    b1, b2 = threefry2x32(k[0], k[1], 0, 0)
    return b1 ^ b2


def uniform(k) -> torch.Tensor:
    """One float32 uniform in [0, 1) per key."""
    return uniform_from_bits(bits32(k))


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Mantissa construction: 23 random bits under the exponent of 1.0,
    bit-cast to f32, minus 1.0."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def randint(k, minval: int, maxval: int) -> torch.Tensor:
    """One int32 in ``[minval, maxval)`` per key (``minval`` where the
    range is empty), with the double-width modulus combine described in
    the module docstring. The bounds are Python ints within int32."""
    sub = split(k, 2)
    bits = bits32(sub)                       # (2, ...) higher, lower
    higher, lower = bits[0], bits[1]
    span = maxval - minval if maxval > minval else 1
    mult = (1 << 16) % span
    mult = (mult * mult) % span
    off = (((higher % span) * mult) & _M32) + (lower % span)
    off = (off & _M32) % span
    return (off + minval).to(torch.int32)
