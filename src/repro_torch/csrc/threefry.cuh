// The project's one device threefry2x32: core/prng.py's generator in
// uint32 arithmetic, shared by K2 (alock_tick.cu, its drawn schedule) and
// the draw stream (draw_stream.cu). Constants, rounds and key injections
// are core/prng.py's, word for word (tests/test_torch_draw_stream.py
// holds them equal).
#pragma once

#include <stdint.h>

namespace threefry {

// the key schedule's parity word (core/prng.py::_PARITY)
constexpr uint32_t PARITY = 0x1BD11BDAu;
// the exponent of 1.0f under 23 mantissa bits (prng.uniform_from_bits)
constexpr uint32_t ONE_BITS = 0x3F800000u;
constexpr int MANTISSA_SHIFT = 9;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32 (20 rounds) of counter words (c0, c1) under key (k0, k1):
// core/prng.py::threefry2x32; both output words in (*y0, *y1).
__device__ __forceinline__ void hash(uint32_t k0, uint32_t k1, uint32_t c0,
                                     uint32_t c1, uint32_t* y0,
                                     uint32_t* y1) {
  const uint32_t k2 = k0 ^ k1 ^ PARITY;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r); \
  x1 ^= x0;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef TF_ROUND
  *y0 = x0;
  *y1 = x1;
}

// b1 ^ b2 of the hash: prng.random_bits' element at counter (c0, c1)
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t c0, uint32_t c1) {
  uint32_t y0, y1;
  hash(k0, k1, c0, c1, &y0, &y1);
  return y0 ^ y1;
}

// prng.uniform_from_bits: 23 random bits under the exponent of 1.0,
// bit-cast to f32, minus 1.0 (exact: the result is in [0, 1))
__device__ __forceinline__ float uniform(uint32_t bits) {
  return __uint_as_float((bits >> MANTISSA_SHIFT) | ONE_BITS) - 1.0f;
}

}  // namespace threefry
