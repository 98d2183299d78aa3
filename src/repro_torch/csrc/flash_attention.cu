// K3: causal / sliding-window attention forward with online softmax, on
// Hopper's tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py ::
// _flash_kernel (launched by flash_attention, pallas_call at kernel.py:86).
// Computes what it computes: s = (q * hd^-0.5) k^T with masked scores at
// -1e30, a running max m, sum l and f32 accumulator over the kv tiles
// (corr = exp(m_prev - m_new)), o = acc / max(l, 1e-30) in q's dtype
// (round to nearest even) and lse = m + log(max(l, 1e-30)) in f32. q, k, v
// are (B, H, S, hd) in f32 or bf16, hd <= 256.
//
// What bounds it on this card: operations. A causal call does about
// S^2 hd / 2 multiply-adds twice (q k^T and p v) per (b, h) against 4 S hd
// elements moved: ~256 operations per byte in bf16 at S = 2048, hd = 128,
// about the H100's tensor-core ridge (295), far above it in f32 at the
// 3xTF32 rate.
//
// What the design does about it: both products run on the tensor cores,
// with the machinery of the backward (flash_hopper.cuh), and nothing
// O(S^2) leaves the CTA.
// - bf16: wgmma m64nNk16 with f32 accumulators. s = q k^T reads both
//   operands from shared memory, K-major in the 128-byte-swizzled layout,
//   and scale multiplies the f32 scores (q * scale is not a bf16 value;
//   the reference rounds once less). p is rounded to bf16 in registers and
//   is the A operand of o += p v, whose B is the stage's V tile read
//   MN-major (transposed) from the same bytes. l sums the f32 p.
// - f32: 3xTF32 with mma.sync m16n8k8 (each operand split into a big and a
//   small TF32 half, small*big + big*small + big*big summed in f32); p stays
//   f32 and is split like any operand, the accumulator layout doubling as
//   the A fragment with its k index permuted.
// One CTA = a producer warpgroup (16-byte cp.async with zero-fill, or
// element copies when rows are not 16-byte aligned, into a ring of two or
// three stages of a K and a V tile, an mbarrier per stage; its registers
// go to the consumers by setmaxnreg) and two consumer warpgroups, each
// owning 64 rows of the CTA's 128-row q tile, its row statistics (two rows
// a thread, reduced over the quad of lanes that shares them) and its
// accumulator in registers. A stage holds 128 kv rows in bf16 (64 in f32):
// fewer, larger stages mean fewer barrier round trips, waits and
// accumulator rescales per key. At hd > 128 the two warpgroups share 64
// rows and split the output columns, as the backward's dq does: a 128-row
// f32 q tile of 256 columns would not leave room for two stages, and each
// warpgroup's 64 x 128 accumulator stays at 64 registers a thread; both
// compute the same scores (the same bits, so m and l agree). kv tiles no
// pair of which is visible are skipped; the mask is applied only on tiles
// that straddle the diagonal or the window's edge. The q tile is the
// grid's slow dimension, taken from the last: the CTAs of the causal q
// tiles that see the most kv tiles start first (at S = 2048, 512 CTAs at
// one an SM make about four waves; this order measured faster than the
// backward's tile-per-head order). o leaves through shared memory in whole
// 16-byte units (store_o): written element by element from the
// accumulator layout, it took a measurable share of bf16's time. hd is
// zero-padded in shared memory to 64, 128 or 256; rows past S are
// zero-filled and masked. Accurate expf/logf, no fast math. No atomics,
// and each output element is written once by one thread, so every run
// gives the same bits.
#include <algorithm>

#include "flash_hopper.cuh"

namespace {

using namespace flash;

// The forward's tiles at padded head dim HD: the resident q tile (RES
// rows) and STR kv rows a stage. bf16: 128 (half the stages, barrier
// round trips and accumulator rescales of 64), at hd 256 64; f32: 64, at
// hd 256 32, so that two stages fit.
template <typename T, int HD>
struct FwdGeo : Tiles<T, HD> {
  using Base = Tiles<T, HD>;
  static constexpr int STR =
      Base::BF16 ? (HD == 256 ? 64 : 128) : (HD == 256 ? 32 : 64);
  static constexpr int STR_BYTES = STR * Base::LD * (int)sizeof(T);
  // 1,024 bytes of slack for the swizzle's alignment, the q tile, the ring
  // (a K and a V tile a stage), the mbarriers (q, nst full, nst empty)
  static constexpr int smem_at(int nst) {
    return 1024 + Base::RES_BYTES + nst * 2 * STR_BYTES + (1 + 2 * nst) * 8;
  }
  // stages of the ring: three where they fit in 227 KB, else two
  static constexpr int NST = smem_at(3) <= 227 * 1024 ? 3 : 2;
  static constexpr int SMEM = smem_at(NST);
  static_assert(SMEM <= 227 * 1024, "a CTA's tiles exceed 227 KB");
};

// One kv tile's online-softmax step on the scores s (64 x N, accumulator
// layout) of q rows from q0 and keys from k0: scale, mask (MASK), the new
// row max m, corr = exp(m_prev - m), p = exp(s - m) in place of s,
// l = l corr + rowsum(p), acc *= corr. A thread holds rows h = 0, 1 (g and
// g + 8 of its warp); the four lanes of a quad share them.
template <bool MASK, int N, int NA>
__device__ __forceinline__ void softmax_step(float (&s)[N], float (&m)[2],
                                             float (&l)[2], float (&acc)[NA],
                                             int q0, int k0, int S,
                                             int causal, int window,
                                             float scale, int wi, int lane) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int e = 0; e < N; ++e) {
    float x = s[e] * scale;
    if (MASK && !allowed(q0 + acc_row(e, wi, lane), k0 + acc_col(e, lane), S,
                         causal, window))
      x = NEG_INF;
    s[e] = x;
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
  }
  float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = expf(m[h] - mx[h]);
    m[h] = mx[h];
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float p = expf(s[e] - m[(e >> 1) & 1]);
    s[e] = p;
    sum[(e >> 1) & 1] += p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l[h] = l[h] * corr[h] + sum[h];
  }
#pragma unroll
  for (int e = 0; e < NA; ++e) acc[e] *= corr[(e >> 1) & 1];
}

// Write this warpgroup's output tile (its 64 rows from qb, columns col0 to
// col0 + NC, accumulator layout, already divided by l) to o through its
// rows of the q tile, which no product reads any more: each thread puts its
// pairs of columns there, then each reads whole 16-byte units back and
// writes them to o, neighbouring threads on neighbouring units of a row
// (vec), or element by element. At hd > 128 the two warpgroups share the
// rows: they first wait for each other's last scores.
template <class G>
__device__ __forceinline__ void store_o(typename G::T* o, const float* acc,
                                        uint8_t* qtile, int qb, int rb,
                                        int col0, int S, int hd, int vec,
                                        int wg, int wi, int lane) {
  using T = typename G::T;
  if (G::NSPLIT > 1)
    asm volatile("bar.sync 1, %0;\n" ::"n"(2 * WG) : "memory");
  // byte offset of element (r, c) of the q tile: the q tile's own layout
  auto at = [&](int r, int c) {
    return unit_offset<G, G::RES>(64 * rb + r, c / G::EPU) +
           (c % G::EPU) * (int)sizeof(T);
  };
#pragma unroll
  for (int e = 0; e < G::NC / 2; e += 2) {
    const int r = acc_row(e, wi, lane), c = col0 + acc_col(e, lane);
    if constexpr (G::BF16)
      *reinterpret_cast<uint32_t*>(qtile + at(r, c)) =
          pack_bf16(acc[e], acc[e + 1]);
    else
      *reinterpret_cast<float2*>(qtile + at(r, c)) =
          make_float2(acc[e], acc[e + 1]);
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(WG) : "memory");
  const int p = threadIdx.x % WG;
  if (vec) {
    constexpr int UPR = G::NC / G::EPU, STEP = WG / UPR;
    const int u = p % UPR, c = col0 + u * G::EPU;
#pragma unroll 1
    for (int r = p / UPR; r < 64; r += STEP)
      if (qb + r < S && c < hd)
        *reinterpret_cast<uint4*>(o + (size_t)(qb + r) * hd + c) =
            *reinterpret_cast<const uint4*>(qtile + at(r, c));
  } else {
#pragma unroll 1
    for (int i = p; i < 64 * G::NC; i += WG) {
      const int r = i / G::NC, c = col0 + i % G::NC;
      if (qb + r < S && c < hd)
        o[(size_t)(qb + r) * hd + c] =
            *reinterpret_cast<const T*>(qtile + at(r, c));
    }
  }
}

// o and lse for 128 (hd > 128: 64) q rows, over the kv tiles they can see
template <typename T, int HD>
__global__ void __launch_bounds__(CTA_THREADS, 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int hd, int causal,
                     int window, float scale, int vec) {
  using G = FwdGeo<T, HD>;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve<G, 1, false>(smem_raw);
  // the last q tiles see the most kv tiles (causal): start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * G::RES;
  const size_t base = (size_t)blockIdx.x * S * hd;
  int lo, hi;
  kv_range(q0, min(q0 + G::RES, S) - 1, G::STR, (S + G::STR - 1) / G::STR,
           causal, window, &lo, &hi);
  const int n = hi - lo + 1;

  if (threadIdx.x < WG) {
    setmaxnreg_dec<G::PRODUCER_REGS>();
    produce<G, 1>(sm, q + base, nullptr, q0, k + base, v + base, nullptr,
                  nullptr, lo, n, S, hd, vec);
    return;
  }
  setmaxnreg_inc<G::CONSUMER_REGS>();
  const int wg = threadIdx.x / WG - 1, rb = wg / G::NSPLIT;
  const int col0 = (wg % G::NSPLIT) * G::NC;
  const int wi = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
  const int qb = q0 + 64 * rb;  // this warpgroup's first q row
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[G::NC / 2];
#pragma unroll
  for (int e = 0; e < G::NC / 2; ++e) acc[e] = 0.f;

  bar_wait(&sm.bars[0], 0);
  for (int i = 0; i < n; ++i) {
    const int st = i % G::NST, k0 = (lo + i) * G::STR;
    bar_wait(&sm.bars[1 + st], (i / G::NST) & 1);
    stage_landed<G>();
    if (visible(qb, min(qb + 64, S) - 1, k0, min(k0 + G::STR, S) - 1, causal,
                window)) {
      const uint8_t* Kt = stage_tile<G>(sm, st, 0);
      const uint8_t* Vt = stage_tile<G>(sm, st, 1);
      float s[G::STR / 2];
      begin_products<G>();
      score<G, G::STR>(s, sm.res0, 64 * rb, Kt, wi, lane);
      end_products<G>(s, acc);
      if (all_visible(qb, qb + 63, k0, k0 + G::STR - 1, S, causal, window))
        softmax_step<false>(s, m, l, acc, qb, k0, S, causal, window, scale,
                            wi, lane);
      else
        softmax_step<true>(s, m, l, acc, qb, k0, S, causal, window, scale,
                           wi, lane);
      accumulate<G, G::NC, G::STR>(acc, s, Vt, col0, lane);
      end_products<G>(acc, s);
    }
    bar_arrive(&sm.bars[1 + G::NST + st]);
  }

  float lc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) lc[h] = fmaxf(l[h], 1e-30f);
#pragma unroll
  for (int e = 0; e < G::NC / 2; ++e) acc[e] = acc[e] / lc[(e >> 1) & 1];
  store_o<G>(o + base, acc, sm.res0, qb, rb, col0, S, hd, vec, wg, wi, lane);
  if (col0 == 0 && lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = qb + acc_row(2 * h, wi, lane);
      if (r < S) lse[(size_t)blockIdx.x * S + r] = m[h] + logf(lc[h]);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int BH, int S, int hd, int causal, int window, float scale,
           cudaStream_t stream) {
  using G = FwdGeo<T, HD>;
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int vec = vec_ok<G>(hd, {q, k, v, o});
  dim3 grid(BH, (S + G::RES - 1) / G::RES);
  kern<<<grid, CTA_THREADS, G::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), S, hd, causal, window, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int BH, int S, int hd, int causal, int window, float scale,
             cudaStream_t s) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, lse, BH, S, hd, causal, window, scale, s);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, lse, BH, S, hd, causal, window, scale,
                          s);
  if (hd <= 256)
    return launch<T, 256>(q, k, v, o, lse, BH, S, hd, causal, window, scale,
                          s);
  return (int)cudaErrorInvalidValue;
}

// a CTA's shared memory at head dim hd: the larger of the two routes'
template <int HD>
int smem_of() {
  return std::max(FwdGeo<float, HD>::SMEM, FwdGeo<__nv_bfloat16, HD>::SMEM);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window. Returns
// the launch's cudaGetLastError() (0 = launched).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int BH, int S, int hd,
                                int causal, int window, float scale,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, lse, BH, S, hd, causal, window, scale,
                           s);
  return dispatch<__nv_bfloat16>(q, k, v, o, lse, BH, S, hd, causal, window,
                                 scale, s);
}

// shared memory of one CTA, the larger of the f32 and bf16 routes'
extern "C" int flash_fwd_smem_bytes(int hd) {
  if (hd <= 64) return smem_of<64>();
  if (hd <= 128) return smem_of<128>();
  return smem_of<256>();
}
