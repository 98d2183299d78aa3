// K4 (dq) and K5 (dk, dv): the attention backward on Hopper's tensor cores,
// recomputing the probabilities p = exp(s - lse) from (q, k, lse) so that
// nothing O(S^2) reaches device memory.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention/kernel_bwd.py ::
// _dq_kernel (pallas_call at kernel_bwd.py:110) and :: _dkv_kernel
// (pallas_call at kernel_bwd.py:132). Same math: s = (q * scale) k^T masked
// at -1e30, p = exp(s - lse), dp = do v^T, ds = p (dp - drow) scale;
// dq = ds k, dv = p^T do, dk = ds^T q with the unscaled q (ds carries the
// scale). q, k, v, do are (B, H, S, hd) in f32 or bf16; lse and
// drow = rowsum(do * o) are (B, H, S) f32. Sums in f32; outputs take q's,
// k's and v's dtypes, rounded to nearest even.
//
// What bounds it on this card: operations. dq does three (S x S x hd)
// products over the visible pairs, dk/dv four, against 6-8 S hd elements
// moved: hundreds of operations per byte at S = 2048.
//
// What the design does about it: every product runs on the tensor cores.
// - bf16: wgmma m64nNk16 with f32 accumulators. The scores s (or s^T) and
//   dp (dp^T) read both operands from shared memory, K-major in the
//   128-byte-swizzled layout; p and ds are rounded to bf16 in registers
//   and are the A operand of dq += ds k, dv += p^T do, dk += ds^T q, whose
//   B (k, do, q) is the same shared tile read MN-major (transposed).
// - f32: 3xTF32 with mma.sync m16n8k8: each operand x splits into
//   big = tf32_rna(x) and small = tf32_rna(x - big), and a product is
//   small*big + big*small + big*big, summed in f32 (about f32's accuracy
//   at three TF32 products' cost). mma.sync, not wgmma, because wgmma's
//   tf32 form takes only K-major operands, which p^T do, ds^T q and ds k
//   are not. p and ds stay f32 and are split like any operand; the
//   accumulator layout doubles as the A fragment with the k index
//   permuted (and the B rows read in the same order), so nothing moves
//   between lanes.
// Both routes share one CTA shape: a producer warpgroup (its 128 threads
// start 16-byte cp.async with zero-fill into a ring of two or three stages
// and signal an mbarrier per stage; it gives its registers to the
// consumers with setmaxnreg) and two consumer warpgroups of 64 rows each.
// (One producer warp could not start a stage's copies in the time the
// consumers took to use the last one.) K5 takes each bf16 stage's q rows
// in two halves, so that s^T and dp^T fit beside dk and dv. K4: one CTA per
// (b, h, 128 q rows) holds q and do and streams the kv tiles it can see;
// K5: one CTA per (b, h, 128 kv rows) holds k and v and streams the q
// tiles (with their lse and drow) that see it. At hd > 128 the two
// warpgroups share 64 rows and split the output columns, so that each one's
// accumulators fit its registers. Each output element is written once by
// one thread: no atomics, so every run gives the same bits. Tiles no pair
// of which is visible are skipped (their p is an exact 0 in the
// reference). hd is zero-padded in shared memory to 64, 128 or 256 (the
// swizzled layout's 64-element rows); rows past S are zero-filled and
// masked. Accurate expf, no fast math. The CTA's machinery and the
// products are flash_hopper.cuh's, shared with the forward (K3).
#include <algorithm>

#include "flash_hopper.cuh"

namespace {

using namespace flash;

// Tile geometry at padded head dim HD (64, 128 or 256). RES rows stay
// resident (q, do in K4; k, v in K5), STR rows stream per stage.
template <typename T, int HD>
struct Geo : Tiles<T, HD> {
  using Base = Tiles<T, HD>;
  static constexpr int STR =
      Base::BF16 ? 64 : HD <= 64 ? 64 : HD <= 128 ? 32 : 16;
  // K5 takes a bf16 stage's q rows half at a time, so that s^T and dp^T
  // (HALF / 2 registers each) fit beside the dk and dv accumulators
  static constexpr int HALF = Base::BF16 ? STR / 2 : STR;
  static constexpr int STR_BYTES = STR * Base::LD * (int)sizeof(T);
  // 1,024 bytes of slack for the swizzle's alignment, the resident tiles,
  // the ring (two tiles a stage; K5 also a stage's lse and drow), the
  // mbarriers (resident, nst full, nst empty)
  static constexpr int smem_at(int nst, bool dkv) {
    return 1024 + 2 * Base::RES_BYTES + nst * 2 * STR_BYTES +
           (dkv ? nst * 2 * STR * 4 : 0) + (1 + 2 * nst) * 8;
  }
  // stages of the ring: three where they fit in 227 KB, else two
  static constexpr int NST = smem_at(3, true) <= 227 * 1024 ? 3 : 2;
  static constexpr int smem(bool dkv) { return smem_at(NST, dkv); }
};

// p = exp(s scale - lse) (0 where masked) and ds = p (dp - drow) scale in
// place of dp. K4: query rows x key columns, lse and drow per row held in
// registers (rows g and g + 8 of the thread's warp).
template <bool MASK, int N>
__device__ __forceinline__ void ds_rows(const float (&s)[N], float (&dp)[N],
                                        const float (&lse)[2],
                                        const float (&dr)[2], int q0, int k0,
                                        int S, int causal, int window,
                                        float scale, int wi, int lane) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int h = (e >> 1) & 1;
    const bool ok = !MASK || allowed(q0 + acc_row(e, wi, lane),
                                     k0 + acc_col(e, lane), S, causal, window);
    const float p = ok ? expf(s[e] * scale - lse[h]) : 0.f;
    dp[e] = p * (dp[e] - dr[h]) * scale;
  }
}

// K5: the transpose, key rows x query columns, lse and drow per column in
// shared memory; p^T replaces s^T
template <bool MASK, int N>
__device__ __forceinline__ void ds_cols(float (&s)[N], float (&dp)[N],
                                        const float* lse, const float* dr,
                                        int q0, int k0, int S, int causal,
                                        int window, float scale, int wi,
                                        int lane) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    // this block's two columns' lse and drow, loaded here: held for all
    // blocks at once they would push the accumulators out of registers
    asm volatile("" ::: "memory");
    const int c0 = acc_col(4 * j, lane);
    const float2 l = *reinterpret_cast<const float2*>(lse + c0);
    const float2 d = *reinterpret_cast<const float2*>(dr + c0);
#pragma unroll
    for (int e = 4 * j; e < 4 * j + 4; ++e) {
      const bool ok = !MASK || allowed(q0 + c0 + (e & 1),
                                       k0 + acc_row(e, wi, lane), S, causal,
                                       window);
      const float p = ok ? expf(s[e] * scale - (e & 1 ? l.y : l.x)) : 0.f;
      dp[e] = p * (dp[e] - (e & 1 ? d.y : d.x)) * scale;
      s[e] = p;
    }
  }
}

// -- the kernels --------------------------------------------------------------

// K4: dq for 128 (hd > 128: 64) q rows, over the kv tiles they can see
template <typename T, int HD>
__global__ void __launch_bounds__(CTA_THREADS, 1)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ drow,
              T* __restrict__ dq, T* __restrict__ /*unused*/, int S, int hd,
              int causal, int window, float scale, int vec) {
  using G = Geo<T, HD>;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve<G, 2, false>(smem_raw);
  // the last q tiles see the most kv tiles (causal): start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * G::RES;
  const size_t base = (size_t)blockIdx.y * S * hd;
  const size_t rbase = (size_t)blockIdx.y * S;
  int lo, hi;
  kv_range(q0, min(q0 + G::RES, S) - 1, G::STR, (S + G::STR - 1) / G::STR,
           causal, window, &lo, &hi);
  const int n = hi - lo + 1;

  if (threadIdx.x < WG) {
    setmaxnreg_dec<G::PRODUCER_REGS>();
    produce<G, 2>(sm, q + base, dout + base, q0, k + base, v + base,
                   nullptr, nullptr, lo, n, S, hd, vec);
    return;
  }
  setmaxnreg_inc<G::CONSUMER_REGS>();
  const int wg = threadIdx.x / WG - 1, rb = wg / G::NSPLIT;
  const int col0 = (wg % G::NSPLIT) * G::NC;
  const int wi = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
  const int qb = q0 + 64 * rb;  // this warpgroup's first q row
  float lse_r[2], dr_r[2], acc[G::NC / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qb + acc_row(2 * h, wi, lane);
    lse_r[h] = r < S ? lse[rbase + r] : 0.f;
    dr_r[h] = r < S ? drow[rbase + r] : 0.f;
  }
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
      float s[G::STR / 2], dp[G::STR / 2];
      begin_products<G>();
      scores<G, G::STR>(s, dp, sm.res0, sm.res1, 64 * rb, Kt, Vt, wi,
                            lane);
      end_products<G>(s, dp);
      if (all_visible(qb, qb + 63, k0, k0 + G::STR - 1, S, causal, window))
        ds_rows<false>(s, dp, lse_r, dr_r, qb, k0, S, causal, window, scale,
                       wi, lane);
      else
        ds_rows<true>(s, dp, lse_r, dr_r, qb, k0, S, causal, window, scale,
                      wi, lane);
      accumulate<G, G::NC, G::STR>(acc, dp, Kt, col0, lane);
      end_products<G>(acc, dp);
    }
    bar_arrive(&sm.bars[1 + G::NST + st]);
  }
  store_acc<T>(dq + base, acc, qb, col0, S, hd, wi, lane);
}

// K5: dk and dv for 128 (hd > 128: 64) kv rows, over the q tiles that see
// them
template <typename T, int HD>
__global__ void __launch_bounds__(CTA_THREADS, 1)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ drow,
               T* __restrict__ dk, T* __restrict__ dv, int S, int hd,
               int causal, int window, float scale, int vec) {
  using G = Geo<T, HD>;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve<G, 2, true>(smem_raw);
  const int k0 = blockIdx.x * G::RES;
  const size_t base = (size_t)blockIdx.y * S * hd;
  const size_t rbase = (size_t)blockIdx.y * S;
  int lo, hi;
  q_range(k0, min(k0 + G::RES, S) - 1, G::STR, (S + G::STR - 1) / G::STR,
          causal, window, &lo, &hi);
  const int n = hi - lo + 1;

  if (threadIdx.x < WG) {
    setmaxnreg_dec<G::PRODUCER_REGS>();
    produce<G, 2>(sm, k + base, v + base, k0, q + base, dout + base,
                   lse + rbase, drow + rbase, lo, n, S, hd, vec);
    return;
  }
  setmaxnreg_inc<G::CONSUMER_REGS>();
  const int wg = threadIdx.x / WG - 1, rb = wg / G::NSPLIT;
  const int col0 = (wg % G::NSPLIT) * G::NC;
  const int wi = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
  const int kb = k0 + 64 * rb;  // this warpgroup's first kv row
  float dk_acc[G::NC / 2], dv_acc[G::NC / 2];
#pragma unroll
  for (int e = 0; e < G::NC / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  bar_wait(&sm.bars[0], 0);
  for (int i = 0; i < n; ++i) {
    const int st = i % G::NST, q0 = (lo + i) * G::STR;
    bar_wait(&sm.bars[1 + st], (i / G::NST) & 1);
    stage_landed<G>();
    const uint8_t* Qt = stage_tile<G>(sm, st, 0);
    const uint8_t* Dt = stage_tile<G>(sm, st, 1);
#pragma unroll 1
    for (int h = 0; h < G::STR; h += G::HALF) {
      const int qh = q0 + h;
      if (!visible(qh, min(qh + G::HALF, S) - 1, kb, min(kb + 64, S) - 1,
                   causal, window))
        continue;
      const uint8_t* Qh = tile_row<G>(Qt, h);
      const uint8_t* Dh = tile_row<G>(Dt, h);
      const float* lse_s = sm.rows + st * 2 * G::STR + h;
      const float* dr_s = lse_s + G::STR;
      // s^T and dp^T: kv rows x q columns
      float s[G::HALF / 2], dp[G::HALF / 2];
      begin_products<G>();
      scores<G, G::HALF>(s, dp, sm.res0, sm.res1, 64 * rb, Qh, Dh, wi,
                             lane);
      end_products<G>(s, dp);
      if (all_visible(qh, qh + G::HALF - 1, kb, kb + 63, S, causal, window))
        ds_cols<false>(s, dp, lse_s, dr_s, qh, kb, S, causal, window, scale,
                       wi, lane);
      else
        ds_cols<true>(s, dp, lse_s, dr_s, qh, kb, S, causal, window, scale,
                      wi, lane);
      accumulate<G, G::NC, G::HALF>(dv_acc, s, Dh, col0, lane);
      accumulate<G, G::NC, G::HALF>(dk_acc, dp, Qh, col0, lane);
      end_products<G>(dv_acc, dk_acc);
    }
    bar_arrive(&sm.bars[1 + G::NST + st]);
  }
  store_acc<T>(dk + base, dk_acc, kb, col0, S, hd, wi, lane);
  store_acc<T>(dv + base, dv_acc, kb, col0, S, hd, wi, lane);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *drow;
  void *o0, *o1;  // dq; or dk, dv
  int BH, S, hd, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD, bool DKV>
int launch(const Args& a) {
  using G = Geo<T, HD>;
  const int smem = G::smem(DKV);
  auto kern = DKV ? dkv_kernel<T, HD> : dq_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = vec_ok<G>(a.hd, {a.q, a.k, a.v, a.dout, a.lse, a.drow});
  dim3 grid((a.S + G::RES - 1) / G::RES, a.BH);
  kern<<<grid, CTA_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.drow),
      static_cast<T*>(a.o0), static_cast<T*>(a.o1), a.S, a.hd, a.causal,
      a.window, a.scale, vec);
  return (int)cudaGetLastError();
}

template <typename T, bool DKV>
int dispatch(const Args& a) {
  if (a.hd <= 64) return launch<T, 64, DKV>(a);
  if (a.hd <= 128) return launch<T, 128, DKV>(a);
  if (a.hd <= 256) return launch<T, 256, DKV>(a);
  return (int)cudaErrorInvalidValue;
}

template <bool DKV>
int run(const Args& a, int dtype) {
  return dtype == 0 ? dispatch<float, DKV>(a)
                    : dispatch<__nv_bfloat16, DKV>(a);
}

// a block's shared memory at head dim hd: the larger of the two routes'
template <int HD>
int smem_of(bool dkv) {
  return std::max(Geo<float, HD>::smem(dkv),
                  Geo<__nv_bfloat16, HD>::smem(dkv));
}

int smem_bytes(int hd, bool dkv) {
  if (hd <= 64) return smem_of<64>(dkv);
  if (hd <= 128) return smem_of<128>(dkv);
  return smem_of<256>(dkv);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; window <= 0 means no window. Each
// returns the launch's cudaGetLastError() (0 = launched).
extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* drow, void* dq, int BH, int S,
                               int hd, int causal, int window, float scale,
                               int dtype, void* stream) {
  Args a{q, k, v, dout, lse, drow, dq, nullptr, BH, S, hd, causal,
         window, scale, static_cast<cudaStream_t>(stream)};
  return run<false>(a, dtype);
}

extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* drow, void* dk, void* dv, int BH,
                                int S, int hd, int causal, int window,
                                float scale, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, drow, dk, dv, BH, S, hd, causal,
         window, scale, static_cast<cudaStream_t>(stream)};
  return run<true>(a, dtype);
}

// shared memory of one block, the larger of the f32 and bf16 routes'
extern "C" int flash_dq_smem_bytes(int hd) { return smem_bytes(hd, false); }

extern "C" int flash_dkv_smem_bytes(int hd) { return smem_bytes(hd, true); }
