// The Hopper machinery both attention kernels run on, the forward (K3,
// flash_attention.cu) and the backward (K4, K5, flash_attention_bwd.cu):
// one CTA of a producer warpgroup and two consumer warpgroups, the producer
// filling a ring of shared-memory stages with cp.async and an mbarrier per
// stage, and the consumers' two kinds of product on the tensor cores (wgmma
// for bf16, 3xTF32 mma.sync for f32). The helpers take the kernel's tile
// geometry G, a struct derived from Tiles below that adds STR (rows a stage
// streams), STR_BYTES and NST (stages).
#pragma once

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "flash_common.cuh"

namespace flash {

constexpr int WG = 128;                // threads of one warpgroup
constexpr int CTA_THREADS = 3 * WG;    // producer + two consumers

// What the two kernels' geometries share at padded head dim HD (64, 128 or
// 256): each consumer warpgroup owns 64 resident rows and NC output
// columns, RES rows a resident tile (at hd > 128 the two warpgroups share
// 64 rows and split the output columns, so that each one's accumulators fit
// its registers). Shared rows are HD bf16 (swizzled) or HD + 4 f32 (padded:
// conflict-free fragment loads).
template <typename T_, int HD>
struct Tiles {
  using T = T_;
  static constexpr int HDP = HD;
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int NSPLIT = HD == 256 ? 2 : 1;
  static constexpr int NC = HD / NSPLIT;
  static constexpr int RES = 128 / NSPLIT;
  static constexpr int LD = BF16 ? HD : HD + 4;
  static constexpr int EPU = 16 / (int)sizeof(T);  // elements per 16 bytes
  static constexpr int RES_BYTES = RES * LD * (int)sizeof(T);
  // registers per thread after setmaxnreg. The launch gives the block 168
  // a thread (65,536 / 384, in steps of 8), and the two sides must add up
  // to exactly that: an increase waits for registers the other side has
  // released. These splits leave every instantiation without spills.
  static constexpr int PRODUCER_REGS = BF16 ? 40 : 24;
  static constexpr int CONSUMER_REGS = BF16 ? 232 : 240;
  static_assert(PRODUCER_REGS * WG + CONSUMER_REGS * 2 * WG == 168 * 3 * WG,
                "the register split must use the launch's registers exactly");
};

// -- shared memory, barriers, copies ------------------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(b))
               : "memory");
}

// arrive once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void bar_arrive_copies(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   saddr(b))
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity. A wait
// that never ends traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* b, int parity) {
  for (long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(b)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1l << 28)) __trap();
  }
}

// 16 bytes, or zeros when src_bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Byte offset of 16-byte unit u of row r in a ROWS-row tile. bf16: HD / 64
// column blocks of ROWS x 128 bytes, unit u ^ (r % 8) within a row (the
// 128-byte swizzle wgmma reads); f32: rows of HD + 4 floats.
template <class G, int ROWS>
__device__ __forceinline__ int unit_offset(int r, int u) {
  if constexpr (G::BF16)
    return (u >> 3) * ROWS * 128 + r * 128 + (((u & 7) ^ (r & 7)) << 4);
  else
    return r * G::LD * 4 + u * 16;
}

// rows [row0, row0 + ROWS) of a (S, hd) matrix into a tile, zeros past S
// and past hd, by thread p of the producer warpgroup. vec: 16-byte
// cp.async (rows 16-byte aligned), thread p always on unit p % UPR of its
// rows; otherwise element by element.
template <class G, int ROWS>
__device__ __forceinline__ void load_tile(uint8_t* dst, const typename G::T* src,
                                          int row0, int S, int hd, int vec,
                                          int p) {
  using T = typename G::T;
  constexpr int HD = G::HDP;
  if (vec) {
    constexpr int UPR = HD / G::EPU, STEP = WG / UPR;
    const int u = p % UPR, c = u * G::EPU;
    const T* at = src + (size_t)(row0 + p / UPR) * hd + c;
#pragma unroll 1
    for (int r = p / UPR; r < ROWS; r += STEP, at += (size_t)STEP * hd) {
      const bool in = row0 + r < S && c < hd;
      cp_async16(dst + unit_offset<G, ROWS>(r, u), in ? at : src,
                 in ? 16 : 0);
    }
  } else {
#pragma unroll 1
    for (int i = p; i < ROWS * HD; i += WG) {
      const int r = i / HD, c = i - r * HD, g = row0 + r;
      const T x = g < S && c < hd ? src[(size_t)g * hd + c] : from_f32<T>(0.f);
      *reinterpret_cast<T*>(dst + unit_offset<G, ROWS>(r, c / G::EPU) +
                            (c % G::EPU) * (int)sizeof(T)) = x;
    }
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int rows, int S, int vec,
                                          int p) {
#pragma unroll 1
  for (int r = p; r < rows; r += WG) {
    const int g = row0 + r;
    if (vec)
      cp_async4(dst + r, g < S ? src + g : src, g < S ? 4 : 0);
    else
      dst[r] = g < S ? src[g] : 0.f;
  }
}

// a producer thread's arrival once its part of a stage is in place
__device__ __forceinline__ void signal(uint64_t* b, int vec) {
  if (vec)
    bar_arrive_copies(b);
  else
    bar_arrive(b);
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// whether any (query, key) pair of [qa, qb] x [ka, kb] is visible
__device__ __forceinline__ bool visible(int qa, int qb, int ka, int kb,
                                        int causal, int window) {
  if (qb < qa || kb < ka) return false;
  if (causal && qb < ka) return false;
  if (window > 0 && qa > kb + window - 1) return false;
  return true;
}

// whether every pair of [qa, qb] x [ka, kb] is visible (and inside S):
// such a tile needs no mask
__device__ __forceinline__ bool all_visible(int qa, int qb, int ka, int kb,
                                            int S, int causal, int window) {
  if (qb >= S || kb >= S) return false;
  if (causal && kb > qa) return false;
  if (window > 0 && qb > ka + window - 1) return false;
  return true;
}

// -- bf16 route: wgmma --------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from touching accumulators across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// -- generated shapes of wgmma (the register lists PTX needs spelled out) --

// d (64 x 32, f32) (+)= A B^T, A and B K-major bf16 in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64, f32) (+)= A B^T, A and B K-major bf16 in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 128, f32) (+)= A B^T, A and B K-major bf16 in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                               uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// the m64nNk16 SS shape of N = 32, 64 or 128 columns
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int acc) {
  static_assert(N == 32 || N == 64 || N == 128,
                "wgmma shapes m64n32, m64n64 and m64n128");
  if constexpr (N == 128)
    wgmma_ss_n128(d, da, db, acc);
  else if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, acc);
  else
    wgmma_ss_n32(d, da, db, acc);
}

// d (64 x 64, f32) += A B, A (64 x 16 bf16) in registers, B MN-major
// bf16 in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 x 128, f32) += A B, A (64 x 16 bf16) in registers, B MN-major
// bf16 in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// -- f32 route: 3xTF32 mma.sync ----------------------------------------------

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32's result for every finite x, with an integer add
// and a mask, which run faster than the conversion (half a rounding
// step added to the magnitude's bits carries into the kept bits, the
// exponent included)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, each TF32, both rounded to nearest
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b as small*big + big*small + big*big
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// -- the two kinds of product, one per route ---------------------------------
//
// A warpgroup's accumulator for a (64 x N) product: element e of a thread
// (warp wi, lane) sits at row 16 wi + lane / 4 + 8 ((e >> 1) & 1), column
// 8 (e >> 2) + 2 (lane % 4) + (e & 1) — wgmma's layout, and mma.sync's
// when warp wi owns rows 16 wi to 16 wi + 15.
__device__ __forceinline__ int acc_row(int e, int wi, int lane) {
  return 16 * wi + lane / 4 + 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int e, int lane) {
  return 8 * (e >> 2) + 2 * (lane % 4) + (e & 1);
}

// The score product c (64 x N) += A B^T over the 8 f32 columns from d0:
// A (this warp's 16 rows, stride LD) and B (N rows), 3xTF32, each A
// fragment split once and used for every B fragment. g = lane / 4,
// t = lane % 4.
template <class G, int N>
__device__ __forceinline__ void tf32_score_step(float* c, const float* A,
                                                const float* B, int d0, int g,
                                                int t) {
  constexpr int LD = G::LD;
  uint32_t ab[4], as[4];
  split_tf32(A[g * LD + d0 + t], ab[0], as[0]);
  split_tf32(A[(g + 8) * LD + d0 + t], ab[1], as[1]);
  split_tf32(A[g * LD + d0 + t + 4], ab[2], as[2]);
  split_tf32(A[(g + 8) * LD + d0 + t + 4], ab[3], as[3]);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    uint32_t bb[2], bs[2];
    split_tf32(B[(8 * j + g) * LD + d0 + t], bb[0], bs[0]);
    split_tf32(B[(8 * j + g) * LD + d0 + t + 4], bb[1], bs[1]);
    mma_3xtf32(&c[4 * j], ab, as, bb, bs);
  }
}

// the 64-column block and the offset of k step kk in a swizzled bf16 tile
// of ROWS rows, in the descriptor's 16-byte units
template <int ROWS>
__device__ __forceinline__ int kstep_units(int kk) {
  return ((kk / 4) * ROWS * 128 + (kk % 4) * 32) >> 4;
}

// One score product of a stage, c = A B^T (64 x N) over the HD columns: A
// is rows [a0, a0 + 64) of a resident tile, B all N rows of a stage's
// tile. bf16: started, not waited. f32: two column steps a pass, so that
// twice the independent products are in flight.
template <class G, int N>
__device__ __forceinline__ void score(float (&c)[N / 2], const uint8_t* A,
                                      int a0, const uint8_t* B, int wi,
                                      int lane) {
  constexpr int HD = G::HDP;
  if constexpr (G::BF16) {
    uint64_t d[2] = {gmma_desc(A + a0 * 128, 16, 1024),
                     gmma_desc(B, 16, 1024)};
    // opaque, so that the compiler builds the 2 HD / 16 descriptors here
    // and does not hold them in registers across the caller's loop
    asm volatile("" : "+l"(d[0]), "+l"(d[1]));
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<N>(c, d[0] + kstep_units<G::RES>(kk),
                  d[1] + kstep_units<G::STR>(kk), kk > 0);
  } else {
    const float* Af = reinterpret_cast<const float*>(A) + (a0 + 16 * wi) * G::LD;
    const float* Bf = reinterpret_cast<const float*>(B);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) c[e] = 0.f;
#pragma unroll 1
    for (int d0 = 0; d0 < HD; d0 += 16) {
      tf32_score_step<G, N>(c, Af, Bf, d0, lane / 4, lane % 4);
      tf32_score_step<G, N>(c, Af, Bf, d0 + 8, lane / 4, lane % 4);
    }
  }
}

// The two score products of a stage, c1 = A1 B1^T and c2 = A2 B2^T (64 x
// N each) over the HD columns: A1, A2 are rows [a0, a0 + 64) of the
// resident tiles, B1, B2 all N rows of the stage's tiles. bf16: started,
// not waited. f32: each A fragment split once and used for every B
// fragment.
template <class G, int N>
__device__ __forceinline__ void scores(float (&c1)[N / 2], float (&c2)[N / 2],
                                       const uint8_t* A1, const uint8_t* A2,
                                       int a0, const uint8_t* B1,
                                       const uint8_t* B2, int wi, int lane) {
  constexpr int HD = G::HDP;
  if constexpr (G::BF16) {
    uint64_t d[4] = {gmma_desc(A1 + a0 * 128, 16, 1024),
                     gmma_desc(B1, 16, 1024),
                     gmma_desc(A2 + a0 * 128, 16, 1024),
                     gmma_desc(B2, 16, 1024)};
    // opaque, so that the compiler builds the 4 HD / 16 descriptors here
    // and does not hold them in registers across the caller's loop
    asm volatile("" : "+l"(d[0]), "+l"(d[1]), "+l"(d[2]), "+l"(d[3]));
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int ra = kstep_units<G::RES>(kk), rb = kstep_units<G::STR>(kk);
      wgmma_ss<N>(c1, d[0] + ra, d[1] + rb, kk > 0);
      wgmma_ss<N>(c2, d[2] + ra, d[3] + rb, kk > 0);
    }
  } else {
    const int r0 = (a0 + 16 * wi) * G::LD;
    const float* A[2] = {reinterpret_cast<const float*>(A1) + r0,
                         reinterpret_cast<const float*>(A2) + r0};
    const float* B[2] = {reinterpret_cast<const float*>(B1),
                         reinterpret_cast<const float*>(B2)};
#pragma unroll
    for (int e = 0; e < N / 2; ++e) c1[e] = c2[e] = 0.f;
    // both products in one pass: twice the independent products in flight
#pragma unroll 1
    for (int d0 = 0; d0 < HD; d0 += 8) {
      tf32_score_step<G, N>(c1, A[0], B[0], d0, lane / 4, lane % 4);
      tf32_score_step<G, N>(c2, A[1], B[1], d0, lane / 4, lane % 4);
    }
  }
}

// c (64 x NC) += W X[:, col0 : col0 + NC]: W (64 x K) is an accumulator in
// registers (p, p^T, ds or ds^T), X the K rows of a streamed tile.
// bf16: W rounded to bf16 is wgmma's A operand, X is read MN-major;
// started, not waited. f32: k runs in the order 2t, 2t + 1 of each block of
// eight, so W's accumulator registers are the A fragment as they are.
template <class G, int NC, int K>
__device__ __forceinline__ void accumulate(float (&c)[NC / 2],
                                           const float (&w)[K / 2],
                                           const uint8_t* X, int col0,
                                           int lane) {
  if constexpr (G::BF16) {
    uint32_t a[K / 16][4];
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[kk][r] = pack_bf16(w[8 * kk + 2 * r], w[8 * kk + 2 * r + 1]);
        asm volatile("" : "+r"(a[kk][r])::"memory");
      }
    wgmma_fence();  // the A fragments were written by the code above
    uint64_t db = gmma_desc(X + (col0 / 64) * G::STR * 128, G::STR * 128, 1024);
    asm volatile("" : "+l"(db));
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      const uint64_t d = db + ((kk * 16 * 128) >> 4);  // 16 rows further
      if constexpr (NC == 64)
        wgmma_rs_n64(c, a[kk], d, 1);
      else
        wgmma_rs_n128(c, a[kk], d, 1);
    }
  } else {
    constexpr int LD = G::LD;
    const float* Xf = reinterpret_cast<const float*>(X) + col0;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kb = 0; kb < K / 8; ++kb) {
      uint32_t ab[4], as[4];
      split_tf32(w[4 * kb], ab[0], as[0]);
      split_tf32(w[4 * kb + 2], ab[1], as[1]);
      split_tf32(w[4 * kb + 1], ab[2], as[2]);
      split_tf32(w[4 * kb + 3], ab[3], as[3]);
      const float* X0 = Xf + (8 * kb + 2 * t) * LD + g;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        uint32_t bb[2], bs[2];
        split_tf32(X0[8 * j], bb[0], bs[0]);
        split_tf32(X0[LD + 8 * j], bb[1], bs[1]);
        mma_3xtf32(&c[4 * j], ab, as, bb, bs);
      }
    }
  }
}

// Once a stage has landed, before its products: cp.async wrote it through
// the generic proxy, wgmma reads it through the async proxy.
template <class G>
__device__ __forceinline__ void stage_landed() {
  if constexpr (G::BF16)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <class G>
__device__ __forceinline__ void begin_products() {
  if constexpr (G::BF16) wgmma_fence();
}

template <class G, int N1, int N2>
__device__ __forceinline__ void end_products(float (&a)[N1], float (&b)[N2]) {
  if constexpr (G::BF16) {
    wgmma_commit();
    wgmma_wait();
    fence_regs(a);
    fence_regs(b);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_acc(T* out, const float (&acc)[N],
                                          int row0, int col0, int S, int hd,
                                          int wi, int lane) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int r = row0 + acc_row(e, wi, lane), c = col0 + acc_col(e, lane);
    if (r < S && c < hd) out[(size_t)r * hd + c] = from_f32<T>(acc[e]);
  }
}

// -- the CTA's shared memory and its producer ---------------------------------

struct Smem {
  uint8_t *res0, *res1, *ring;
  float* rows;
  uint64_t* bars;  // [0] resident tiles, [1, 1 + NST) full, then empty
};

// NRES resident tiles, the ring of NST stages of two streamed tiles (ROWS:
// and each stage's 2 STR floats of per-row values), the mbarriers
template <class G, int NRES, bool ROWS>
__device__ __forceinline__ Smem carve(uint8_t* raw) {
  Smem s;
  s.res0 = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  s.res1 = NRES > 1 ? s.res0 + G::RES_BYTES : nullptr;
  s.ring = s.res0 + NRES * G::RES_BYTES;
  s.rows = reinterpret_cast<float*>(s.ring + G::NST * 2 * G::STR_BYTES);
  s.bars = reinterpret_cast<uint64_t*>(s.rows +
                                       (ROWS ? G::NST * 2 * G::STR : 0));
  if (threadIdx.x == 0) {
    bar_init(&s.bars[0], WG);
    for (int i = 0; i < G::NST; ++i) {
      bar_init(&s.bars[1 + i], WG);
      bar_init(&s.bars[1 + G::NST + i], 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return s;
}

template <class G>
__device__ __forceinline__ uint8_t* stage_tile(const Smem& s, int stage,
                                               int which) {
  return s.ring + (2 * stage + which) * G::STR_BYTES;
}

// row r of a streamed tile, as the start of a tile of the rows from r on
template <class G>
__device__ __forceinline__ const uint8_t* tile_row(const uint8_t* tile,
                                                   int r) {
  return tile + r * (G::BF16 ? 128 : G::LD * 4);
}

// The producer warpgroup: the NRES resident tiles (rows res_row0 on of r0
// and r1) once, then for each streamed tile i (rows (lo + i) STR) its two
// tiles of s0 and s1 (and, with lse, its lse and drow rows) into stage
// i % NST once the consumers have released it.
template <class G, int NRES>
__device__ __forceinline__ void produce(const Smem& s, const typename G::T* r0,
                                        const typename G::T* r1, int res_row0,
                                        const typename G::T* s0,
                                        const typename G::T* s1,
                                        const float* lse, const float* drow,
                                        int lo, int n, int S, int hd,
                                        int vec) {
  const int p = threadIdx.x;
  load_tile<G, G::RES>(s.res0, r0, res_row0, S, hd, vec, p);
  if constexpr (NRES > 1)
    load_tile<G, G::RES>(s.res1, r1, res_row0, S, hd, vec, p);
  signal(&s.bars[0], vec);
  for (int i = 0; i < n; ++i) {
    const int st = i % G::NST, row0 = (lo + i) * G::STR;
    if (i >= G::NST)
      bar_wait(&s.bars[1 + G::NST + st], (i / G::NST - 1) & 1);
    load_tile<G, G::STR>(stage_tile<G>(s, st, 0), s0, row0, S, hd, vec, p);
    load_tile<G, G::STR>(stage_tile<G>(s, st, 1), s1, row0, S, hd, vec, p);
    if (lse != nullptr) {
      load_rows(s.rows + st * 2 * G::STR, lse, row0, G::STR, S, vec, p);
      load_rows(s.rows + st * 2 * G::STR + G::STR, drow, row0, G::STR, S,
                vec, p);
    }
    signal(&s.bars[1 + st], vec);
  }
}

// whether 16-byte copies may be used: rows of hd elements are 16-byte
// aligned and so is every base pointer (torch's allocations are 256-byte
// aligned)
template <class G>
inline int vec_ok(int hd, std::initializer_list<const void*> ptrs) {
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= reinterpret_cast<uintptr_t>(p);
  return hd % G::EPU == 0 && any % 16 == 0;
}

}  // namespace flash
