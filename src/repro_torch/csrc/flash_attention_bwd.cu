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
// masked. Accurate expf, no fast math.
#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int WG = 128;                // threads of one warpgroup
constexpr int BWD_THREADS = 3 * WG;    // producer + two consumers

// Tile geometry at padded head dim HD (64, 128 or 256). RES rows stay
// resident (q, do in K4; k, v in K5), STR rows stream per stage; each
// consumer warpgroup owns 64 resident rows and NC output columns. Shared
// rows are HD bf16 (swizzled) or HD + 4 f32 (padded: conflict-free
// fragment loads).
template <typename T, int HD>
struct Geo {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int NSPLIT = HD == 256 ? 2 : 1;
  static constexpr int NC = HD / NSPLIT;
  static constexpr int RES = 128 / NSPLIT;
  static constexpr int STR = BF16 ? 64 : HD <= 64 ? 64 : HD <= 128 ? 32 : 16;
  // K5 takes a bf16 stage's q rows half at a time, so that s^T and dp^T
  // (HALF / 2 registers each) fit beside the dk and dv accumulators
  static constexpr int HALF = BF16 ? STR / 2 : STR;
  static constexpr int LD = BF16 ? HD : HD + 4;
  static constexpr int EPU = 16 / (int)sizeof(T);  // elements per 16 bytes
  static constexpr int RES_BYTES = RES * LD * (int)sizeof(T);
  static constexpr int STR_BYTES = STR * LD * (int)sizeof(T);
  // 1,024 bytes of slack for the swizzle's alignment, the resident tiles,
  // the ring (two tiles a stage; K5 also a stage's lse and drow), the
  // mbarriers (resident, nst full, nst empty)
  static constexpr int smem_at(int nst, bool dkv) {
    return 1024 + 2 * RES_BYTES + nst * 2 * STR_BYTES +
           (dkv ? nst * 2 * STR * 4 : 0) + (1 + 2 * nst) * 8;
  }
  // stages of the ring: three where they fit in 227 KB, else two
  static constexpr int NST = smem_at(3, true) <= 227 * 1024 ? 3 : 2;
  static constexpr int smem(bool dkv) { return smem_at(NST, dkv); }
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
template <typename T, int HD, int ROWS>
__device__ __forceinline__ int unit_offset(int r, int u) {
  if constexpr (Geo<T, HD>::BF16)
    return (u >> 3) * ROWS * 128 + r * 128 + (((u & 7) ^ (r & 7)) << 4);
  else
    return r * Geo<T, HD>::LD * 4 + u * 16;
}

// rows [row0, row0 + ROWS) of a (S, hd) matrix into a tile, zeros past S
// and past hd, by thread p of the producer warpgroup. vec: 16-byte
// cp.async (rows 16-byte aligned), thread p always on unit p % UPR of its
// rows; otherwise element by element.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(uint8_t* dst, const T* src,
                                          int row0, int S, int hd, int vec,
                                          int p) {
  using G = Geo<T, HD>;
  if (vec) {
    constexpr int UPR = HD / G::EPU, STEP = WG / UPR;
    const int u = p % UPR, c = u * G::EPU;
    const T* at = src + (size_t)(row0 + p / UPR) * hd + c;
#pragma unroll 1
    for (int r = p / UPR; r < ROWS; r += STEP, at += (size_t)STEP * hd) {
      const bool in = row0 + r < S && c < hd;
      cp_async16(dst + unit_offset<T, HD, ROWS>(r, u), in ? at : src,
                 in ? 16 : 0);
    }
  } else {
#pragma unroll 1
    for (int i = p; i < ROWS * HD; i += WG) {
      const int r = i / HD, c = i - r * HD, g = row0 + r;
      const T x = g < S && c < hd ? src[(size_t)g * hd + c] : from_f32<T>(0.f);
      *reinterpret_cast<T*>(dst + unit_offset<T, HD, ROWS>(r, c / G::EPU) +
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

// -- the two products, one per route -----------------------------------------
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

// The two score products of a stage, c1 = A1 B1^T and c2 = A2 B2^T (64 x
// N each) over the HD columns: A1, A2 are rows [a0, a0 + 64) of the
// resident tiles, B1, B2 all N rows of the stage's tiles. bf16: started,
// not waited. f32: each A fragment split once and used for every B
// fragment.
template <typename T, int HD, int N>
__device__ __forceinline__ void scores(float (&c1)[N / 2], float (&c2)[N / 2],
                                       const uint8_t* A1, const uint8_t* A2,
                                       int a0, const uint8_t* B1,
                                       const uint8_t* B2, int wi, int lane) {
  using G = Geo<T, HD>;
  if constexpr (G::BF16) {
    static_assert(N == 32 || N == 64, "wgmma shapes m64n32 and m64n64");
    uint64_t d[4] = {gmma_desc(A1 + a0 * 128, 16, 1024),
                     gmma_desc(B1, 16, 1024),
                     gmma_desc(A2 + a0 * 128, 16, 1024),
                     gmma_desc(B2, 16, 1024)};
    // opaque, so that the compiler builds the 4 HD / 16 descriptors here
    // and does not hold them in registers across the caller's loop
    asm volatile("" : "+l"(d[0]), "+l"(d[1]), "+l"(d[2]), "+l"(d[3]));
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int blk = kk / 4, off = (kk % 4) * 32;  // 64-column blocks
      const int ra = (blk * G::RES * 128 + off) >> 4;
      const int rb = (blk * G::STR * 128 + off) >> 4;
      if constexpr (N == 64) {
        wgmma_ss_n64(c1, d[0] + ra, d[1] + rb, kk > 0);
        wgmma_ss_n64(c2, d[2] + ra, d[3] + rb, kk > 0);
      } else {
        wgmma_ss_n32(c1, d[0] + ra, d[1] + rb, kk > 0);
        wgmma_ss_n32(c2, d[2] + ra, d[3] + rb, kk > 0);
      }
    }
  } else {
    constexpr int LD = G::LD;
    const int g = lane / 4, t = lane % 4, r0 = (a0 + 16 * wi) * LD;
    const float* A[2] = {reinterpret_cast<const float*>(A1) + r0,
                         reinterpret_cast<const float*>(A2) + r0};
    const float* B[2] = {reinterpret_cast<const float*>(B1),
                         reinterpret_cast<const float*>(B2)};
#pragma unroll
    for (int e = 0; e < N / 2; ++e) c1[e] = c2[e] = 0.f;
    // the product m over the 8 columns from d0
    auto step = [&](int m, int d0) {
      float* c = m == 0 ? c1 : c2;
      uint32_t ab[4], as[4];
      split_tf32(A[m][g * LD + d0 + t], ab[0], as[0]);
      split_tf32(A[m][(g + 8) * LD + d0 + t], ab[1], as[1]);
      split_tf32(A[m][g * LD + d0 + t + 4], ab[2], as[2]);
      split_tf32(A[m][(g + 8) * LD + d0 + t + 4], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        uint32_t bb[2], bs[2];
        split_tf32(B[m][(8 * j + g) * LD + d0 + t], bb[0], bs[0]);
        split_tf32(B[m][(8 * j + g) * LD + d0 + t + 4], bb[1], bs[1]);
        mma_3xtf32(&c[4 * j], ab, as, bb, bs);
      }
    };
    // both products in one pass: twice the independent products in flight
#pragma unroll 1
    for (int d0 = 0; d0 < HD; d0 += 8) {
      step(0, d0);
      step(1, d0);
    }
  }
}

// c (64 x NC) += W X[:, col0 : col0 + NC]: W (64 x K) is an accumulator in
// registers (p, p^T, ds or ds^T), X the K rows of a streamed tile.
// bf16: W rounded to bf16 is wgmma's A operand, X is read MN-major;
// started, not waited. f32: k runs in the order 2t, 2t + 1 of each block of
// eight, so W's accumulator registers are the A fragment as they are.
template <typename T, int HD, int NC, int K>
__device__ __forceinline__ void accumulate(float (&c)[NC / 2],
                                           const float (&w)[K / 2],
                                           const uint8_t* X, int col0,
                                           int lane) {
  using G = Geo<T, HD>;
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
template <typename T, int HD>
__device__ __forceinline__ void stage_landed() {
  if constexpr (Geo<T, HD>::BF16)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <typename T, int HD>
__device__ __forceinline__ void begin_products() {
  if constexpr (Geo<T, HD>::BF16) wgmma_fence();
}

template <typename T, int HD, int N1, int N2>
__device__ __forceinline__ void end_products(float (&a)[N1], float (&b)[N2]) {
  if constexpr (Geo<T, HD>::BF16) {
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

struct Smem {
  uint8_t *res0, *res1, *ring;
  float* rows;
  uint64_t* bars;  // [0] resident tiles, [1, 1 + NST) full, then empty
};

template <typename T, int HD, bool DKV>
__device__ __forceinline__ Smem carve(uint8_t* raw) {
  using G = Geo<T, HD>;
  Smem s;
  s.res0 = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  s.res1 = s.res0 + G::RES_BYTES;
  s.ring = s.res1 + G::RES_BYTES;
  s.rows = reinterpret_cast<float*>(s.ring + G::NST * 2 * G::STR_BYTES);
  s.bars = reinterpret_cast<uint64_t*>(s.rows +
                                       (DKV ? G::NST * 2 * G::STR : 0));
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

template <typename T, int HD>
__device__ __forceinline__ uint8_t* stage_tile(const Smem& s, int stage,
                                               int which) {
  return s.ring + (2 * stage + which) * Geo<T, HD>::STR_BYTES;
}

// row r of a streamed tile, as the start of a tile of the rows from r on
template <typename T, int HD>
__device__ __forceinline__ const uint8_t* tile_row(const uint8_t* tile,
                                                   int r) {
  using G = Geo<T, HD>;
  return tile + r * (G::BF16 ? 128 : G::LD * 4);
}

// The producer warpgroup: the resident tiles once, then for each streamed
// tile i (rows (lo + i) STR) its two tiles (and, for K5, its lse and drow
// rows) into stage i % NST once the consumers have released it.
template <typename T, int HD>
__device__ __forceinline__ void produce(const Smem& s, const T* r0,
                                        const T* r1, int res_row0,
                                        const T* s0, const T* s1,
                                        const float* lse, const float* drow,
                                        int lo, int n, int S, int hd,
                                        int vec) {
  using G = Geo<T, HD>;
  const int p = threadIdx.x;
  load_tile<T, HD, G::RES>(s.res0, r0, res_row0, S, hd, vec, p);
  load_tile<T, HD, G::RES>(s.res1, r1, res_row0, S, hd, vec, p);
  signal(&s.bars[0], vec);
  for (int i = 0; i < n; ++i) {
    const int st = i % G::NST, row0 = (lo + i) * G::STR;
    if (i >= G::NST)
      bar_wait(&s.bars[1 + G::NST + st], (i / G::NST - 1) & 1);
    load_tile<T, HD, G::STR>(stage_tile<T, HD>(s, st, 0), s0, row0, S, hd,
                             vec, p);
    load_tile<T, HD, G::STR>(stage_tile<T, HD>(s, st, 1), s1, row0, S, hd,
                             vec, p);
    if (lse != nullptr) {
      load_rows(s.rows + st * 2 * G::STR, lse, row0, G::STR, S, vec, p);
      load_rows(s.rows + st * 2 * G::STR + G::STR, drow, row0, G::STR, S,
                vec, p);
    }
    signal(&s.bars[1 + st], vec);
  }
}

// K4: dq for 128 (hd > 128: 64) q rows, over the kv tiles they can see
template <typename T, int HD>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ drow,
              T* __restrict__ dq, T* __restrict__ /*unused*/, int S, int hd,
              int causal, int window, float scale, int vec) {
  using G = Geo<T, HD>;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve<T, HD, false>(smem_raw);
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
    produce<T, HD>(sm, q + base, dout + base, q0, k + base, v + base,
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
    stage_landed<T, HD>();
    if (visible(qb, min(qb + 64, S) - 1, k0, min(k0 + G::STR, S) - 1, causal,
                window)) {
      const uint8_t* Kt = stage_tile<T, HD>(sm, st, 0);
      const uint8_t* Vt = stage_tile<T, HD>(sm, st, 1);
      float s[G::STR / 2], dp[G::STR / 2];
      begin_products<T, HD>();
      scores<T, HD, G::STR>(s, dp, sm.res0, sm.res1, 64 * rb, Kt, Vt, wi,
                            lane);
      end_products<T, HD>(s, dp);
      if (all_visible(qb, qb + 63, k0, k0 + G::STR - 1, S, causal, window))
        ds_rows<false>(s, dp, lse_r, dr_r, qb, k0, S, causal, window, scale,
                       wi, lane);
      else
        ds_rows<true>(s, dp, lse_r, dr_r, qb, k0, S, causal, window, scale,
                      wi, lane);
      accumulate<T, HD, G::NC, G::STR>(acc, dp, Kt, col0, lane);
      end_products<T, HD>(acc, dp);
    }
    bar_arrive(&sm.bars[1 + G::NST + st]);
  }
  store_acc<T>(dq + base, acc, qb, col0, S, hd, wi, lane);
}

// K5: dk and dv for 128 (hd > 128: 64) kv rows, over the q tiles that see
// them
template <typename T, int HD>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ drow,
               T* __restrict__ dk, T* __restrict__ dv, int S, int hd,
               int causal, int window, float scale, int vec) {
  using G = Geo<T, HD>;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve<T, HD, true>(smem_raw);
  const int k0 = blockIdx.x * G::RES;
  const size_t base = (size_t)blockIdx.y * S * hd;
  const size_t rbase = (size_t)blockIdx.y * S;
  int lo, hi;
  q_range(k0, min(k0 + G::RES, S) - 1, G::STR, (S + G::STR - 1) / G::STR,
          causal, window, &lo, &hi);
  const int n = hi - lo + 1;

  if (threadIdx.x < WG) {
    setmaxnreg_dec<G::PRODUCER_REGS>();
    produce<T, HD>(sm, k + base, v + base, k0, q + base, dout + base,
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
    stage_landed<T, HD>();
    const uint8_t* Qt = stage_tile<T, HD>(sm, st, 0);
    const uint8_t* Dt = stage_tile<T, HD>(sm, st, 1);
#pragma unroll 1
    for (int h = 0; h < G::STR; h += G::HALF) {
      const int qh = q0 + h;
      if (!visible(qh, min(qh + G::HALF, S) - 1, kb, min(kb + 64, S) - 1,
                   causal, window))
        continue;
      const uint8_t* Qh = tile_row<T, HD>(Qt, h);
      const uint8_t* Dh = tile_row<T, HD>(Dt, h);
      const float* lse_s = sm.rows + st * 2 * G::STR + h;
      const float* dr_s = lse_s + G::STR;
      // s^T and dp^T: kv rows x q columns
      float s[G::HALF / 2], dp[G::HALF / 2];
      begin_products<T, HD>();
      scores<T, HD, G::HALF>(s, dp, sm.res0, sm.res1, 64 * rb, Qh, Dh, wi,
                             lane);
      end_products<T, HD>(s, dp);
      if (all_visible(qh, qh + G::HALF - 1, kb, kb + 63, S, causal, window))
        ds_cols<false>(s, dp, lse_s, dr_s, qh, kb, S, causal, window, scale,
                       wi, lane);
      else
        ds_cols<true>(s, dp, lse_s, dr_s, qh, kb, S, causal, window, scale,
                      wi, lane);
      accumulate<T, HD, G::NC, G::HALF>(dv_acc, s, Dh, col0, lane);
      accumulate<T, HD, G::NC, G::HALF>(dk_acc, dp, Qh, col0, lane);
      end_products<T, HD>(dv_acc, dk_acc);
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
  // 16-byte copies need 16-byte rows and bases (torch's allocations are
  // 256-byte aligned; hd a multiple of 8 bf16 or 4 f32 elements)
  uintptr_t any = 0;
  for (const void* p : {a.q, a.k, a.v, a.dout, (const void*)a.lse,
                        (const void*)a.drow})
    any |= reinterpret_cast<uintptr_t>(p);
  const int vec = a.hd % G::EPU == 0 && any % 16 == 0;
  dim3 grid((a.S + G::RES - 1) / G::RES, a.BH);
  kern<<<grid, BWD_THREADS, smem, a.stream>>>(
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
