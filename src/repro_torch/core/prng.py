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
  * ``random_bits(k, shape)``  32 bits per element of ``shape`` from one
                       key: element ``c`` of the flat row-major index is
                       ``b1 ^ b2`` of ``threefry(k, counter=(c >> 32,
                       c & 0xFFFFFFFF))`` (the same partitionable layout;
                       ``bits32`` is its ``shape=()`` case, counter 0);
  * ``randint(k, shape, lo, hi)``  splits ``k`` in two, draws
                       ``random_bits`` of ``shape`` from each and combines
                       ``(hi_bits % span) * (2**32 % span) + lo_bits %
                       span`` modulo ``span`` in uint32 arithmetic — what
                       ``jax.random.randint(key, shape, lo, hi, int32)``
                       gives.

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


def random_bits(k, shape=(), rows=None) -> torch.Tensor:
    """32 random bits (int64 tensor holding uint32 values) per element of
    ``shape`` from each key of ``k``: the result has shape ``k[0].shape +
    shape``. The flat row-major index over ``shape`` is the 64-bit
    counter, split into its hi and lo words. ``rows=(r0, r1)`` draws only
    rows ``r0 .. r1-1`` of the leading axis (counters ``r0 * inner ..
    r1 * inner - 1``, ``inner`` the product of the other axes), so a
    large shape can be drawn a slab at a time with bounded temporaries."""
    shape = tuple(int(d) for d in shape)
    k1, k2 = k
    if not shape:
        b1, b2 = threefry2x32(k1, k2, 0, 0)
        return b1 ^ b2
    r0, r1 = (0, shape[0]) if rows is None else rows
    if not 0 <= r0 <= r1 <= shape[0]:
        raise ValueError(f"rows {rows} outside the leading axis of {shape}")
    inner = 1
    for d in shape[1:]:
        inner *= d
    dev = k1.device if isinstance(k1, torch.Tensor) else None
    c = torch.arange(r0 * inner, r1 * inner, dtype=torch.int64,
                     device=dev).reshape((r1 - r0,) + shape[1:])

    def widen(a):
        if isinstance(a, torch.Tensor):
            return a.reshape(a.shape + (1,) * len(shape))
        return a
    b1, b2 = threefry2x32(widen(k1), widen(k2), c >> 32, c & _M32)
    return b1 ^ b2


def bits32(k) -> torch.Tensor:
    """One 32-bit draw per key (int64 tensor holding uint32 values)."""
    return random_bits(k)


def uniform(k) -> torch.Tensor:
    """One float32 uniform in [0, 1) per key."""
    return uniform_from_bits(bits32(k))


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Mantissa construction: 23 random bits under the exponent of 1.0,
    bit-cast to f32, minus 1.0."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def randint(k, shape, minval: int, maxval: int, rows=None) -> torch.Tensor:
    """int32 draws in ``[minval, maxval)`` (``minval`` where the range is
    empty) of ``shape`` per key, with the double-width modulus combine
    described in the module docstring; ``shape=()`` gives one draw per
    key. The bounds are Python ints within int32. ``rows`` as in
    ``random_bits``: rows ``r0 .. r1-1`` of the full draw."""
    sub = split(k, 2)
    higher = random_bits((sub[0][0], sub[1][0]), shape, rows)
    lower = random_bits((sub[0][1], sub[1][1]), shape, rows)
    span = maxval - minval if maxval > minval else 1
    mult = (1 << 16) % span
    mult = (mult * mult) % span
    off = (((higher % span) * mult) & _M32) + (lower % span)
    off = (off & _M32) % span
    return (off + minval).to(torch.int32)
