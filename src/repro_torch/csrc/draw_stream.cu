// The event loop's draw stream, hand-written for Hopper (sm_90a): a
// shard's whole (u1, r2, r3[, u4]) in one launch. Plain C interface at the
// bottom; loaded with ctypes by repro_torch/kernels/event_loop/draws.py.
//
// Not a TPU kernel: the reference builds this stream in XLA
// (src/repro/kernels/event_loop/ops.py::precompute_draws). Its plain
// PyTorch version is ops.precompute_draws(backend="plain") on
// core/prng.py; the two are held equal bit for bit on the card.
//
// What it computes, per replica b and event i (all uint32 arithmetic, as
// core/prng.py): k = fold_in((0, seed[b]), i), split(k, 3 | 4); u1 the
// uniform of subkey 0, u3 of subkey 2, u4 (alock-rw) of subkey 3, each
// b1 ^ b2 of the hash at counter (0, 0) under the mantissa construction;
// r2 = randint(subkey 1, 0, max(N - 1, 1)), the split in two and the
// double-width modulus combine; the phase ph = count(i >= edges[b, p]
// over all P entries) - 1, phase 0 where that is below 1; r3 =
// min(count(u3 >= zcdf[b, ph, k] over all kz entries), kpn - 1), the plain
// version's sum, so no monotonicity of the rows is assumed.
//
// What bounds it on this card: ten threefry2x32 hashes an event (twelve
// with u4) of ~72 integer instructions, and kz compares; ~1 ms for the
// widest Fig. 5 bucket's 14.4 M events at the INT32 rate. The bytes, 12 or
// 16 written an event, take under half of that.
//
// What the design does about it. One thread per event, EPT events a
// thread a block-stride apart, so every write is coalesced along the event
// axis straight into the (B, n_events) outputs; a block covers
// THREADS * EPT events of one replica and stages that replica's edges and
// zcdf rows in shared memory once (every lane reads the same entry at
// once: a broadcast). Rows too large for the default 48 KB are read from
// global memory instead (template flag STAGED).
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

using threefry::hash;
using threefry::threefry_bits;
using threefry::uniform;

constexpr int THREADS = 256;
constexpr int EPT = 4;                 // events a thread
constexpr int EVENTS_PER_BLOCK = THREADS * EPT;
constexpr int STAGE_LIMIT = 48 * 1024;  // bytes staged in shared memory

struct Args {
  const int* seed;     // (B,)
  const int* edges;    // (B, P)
  const float* zcdf;   // (B, P, kz)
  float* u1;           // (B, n_events) each
  int* r2;
  int* r3;
  float* u4;           // alock-rw only
  int n_events, P, kz, kpn;
  uint32_t span, mult;  // randint's max(N - 1, 1) and (2**16 % span)**2 % span
  int blocks_per_replica;
};

template <bool RW, bool STAGED>
__global__ void __launch_bounds__(THREADS)
    draw_stream_kernel(const Args a) {
  extern __shared__ int smem[];
  const int b = blockIdx.x / a.blocks_per_replica;
  const int i0 = (blockIdx.x % a.blocks_per_replica) * EVENTS_PER_BLOCK;
  const int* edges = a.edges + (long long)b * a.P;
  const float* zcdf = a.zcdf + (long long)b * a.P * a.kz;
  if constexpr (STAGED) {
    int* s_edges = smem;
    float* s_zcdf = reinterpret_cast<float*>(smem + a.P);
    for (int t = threadIdx.x; t < a.P; t += THREADS) s_edges[t] = edges[t];
    for (int t = threadIdx.x; t < a.P * a.kz; t += THREADS)
      s_zcdf[t] = zcdf[t];
    __syncthreads();
    edges = s_edges;
    zcdf = s_zcdf;
  }
  const uint32_t seed = (uint32_t)a.seed[b];
  const long long row = (long long)b * a.n_events;
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int i = i0 + j * THREADS + (int)threadIdx.x;
    if (i >= a.n_events) break;
    uint32_t k0, k1;  // fold_in(key(seed), i)
    hash(0u, seed, 0u, (uint32_t)i, &k0, &k1);
    uint32_t s0, s1;  // subkey 0: the locality uniform
    hash(k0, k1, 0u, 0u, &s0, &s1);
    const float u1 = uniform(threefry_bits(s0, s1, 0u, 0u));
    hash(k0, k1, 0u, 1u, &s0, &s1);  // subkey 1: randint's key
    uint32_t h0, h1, l0, l1;
    hash(s0, s1, 0u, 0u, &h0, &h1);
    hash(s0, s1, 0u, 1u, &l0, &l1);
    const uint32_t hi = threefry_bits(h0, h1, 0u, 0u);
    const uint32_t lo = threefry_bits(l0, l1, 0u, 0u);
    const uint32_t r2 = ((hi % a.span) * a.mult + lo % a.span) % a.span;
    hash(k0, k1, 0u, 2u, &s0, &s1);  // subkey 2: the Zipf uniform
    const float u3 = uniform(threefry_bits(s0, s1, 0u, 0u));
    int ph = 0;
    if (a.P > 1) {
      int c = 0;
      for (int p = 0; p < a.P; ++p) c += i >= edges[p];
      ph = c > 1 ? c - 1 : 0;
    }
    const float* z = zcdf + ph * a.kz;
    int cnt = 0;
#pragma unroll 4
    for (int k = 0; k < a.kz; ++k) cnt += u3 >= z[k];
    a.u1[row + i] = u1;
    a.r2[row + i] = (int)r2;
    a.r3[row + i] = min(cnt, a.kpn - 1);
    if constexpr (RW) {
      hash(k0, k1, 0u, 3u, &s0, &s1);  // subkey 3: the reader/writer coin
      a.u4[row + i] = uniform(threefry_bits(s0, s1, 0u, 0u));
    }
  }
}

// shared memory one block stages for P phases of kz entries, or 0 where
// the rows are read from global memory instead
int stage_bytes(int P, int kz) {
  const long long b = 4LL * P + 4LL * P * kz;
  return b <= STAGE_LIMIT ? (int)b : 0;
}

template <bool RW, bool STAGED>
int launch(const Args& a, int B, int smem, cudaStream_t stream) {
  const long long blocks = (long long)B * a.blocks_per_replica;
  draw_stream_kernel<RW, STAGED>
      <<<(unsigned)blocks, THREADS, STAGED ? smem : 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// seed (B,) int32, edges (B, P) int32, zcdf (B, P, kz) f32, all
// contiguous; outputs (B, n_events): u1 f32, r2 int32, r3 int32 and, when
// u4 is not null (alock-rw), u4 f32. span = max(N - 1, 1) and mult =
// (2**16 % span)**2 % span. Returns the launch's cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int draw_stream_launch(const void* seed, const void* edges,
                                  const void* zcdf, void* u1, void* r2,
                                  void* r3, void* u4, int B, int n_events,
                                  int P, int kz, int kpn, unsigned span,
                                  unsigned mult, void* stream) {
  if (B < 1 || n_events < 1 || P < 1 || kz < 1 || kpn < 1 || span < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.seed = static_cast<const int*>(seed);
  a.edges = static_cast<const int*>(edges);
  a.zcdf = static_cast<const float*>(zcdf);
  a.u1 = static_cast<float*>(u1);
  a.r2 = static_cast<int*>(r2);
  a.r3 = static_cast<int*>(r3);
  a.u4 = static_cast<float*>(u4);
  a.n_events = n_events;
  a.P = P;
  a.kz = kz;
  a.kpn = kpn;
  a.span = span;
  a.mult = mult;
  a.blocks_per_replica = (n_events + EVENTS_PER_BLOCK - 1) / EVENTS_PER_BLOCK;
  if ((long long)B * a.blocks_per_replica > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const int smem = stage_bytes(P, kz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool rw = a.u4 != nullptr;
  if (smem > 0)
    return rw ? launch<true, true>(a, B, smem, st)
              : launch<false, true>(a, B, smem, st);
  return rw ? launch<true, false>(a, B, smem, st)
            : launch<false, false>(a, B, smem, st);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
