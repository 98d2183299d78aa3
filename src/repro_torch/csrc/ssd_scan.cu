// K6: the Mamba-2 SSD intra-chunk block, on Hopper's tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py :: _ssd_kernel
// (launched by ssd_intra_chunk, pallas_call at kernel.py:66). Per (batch,
// chunk, head), with cs = cumsum(dA) over the chunk's L steps:
//   y[l, p]      = sum_{m <= l} (c_l . b_m) exp(cs_l - cs_m) xd[m, p]
//   states[p, n] = sum_l b[l, n] exp(cs_{L-1} - cs_l) xd[l, p]
//   chunk_decay  = exp(cs_{L-1})
// Inputs xd (B, nc, L, H, P), dA (B, nc, L, H), b and c (B, nc, L, N);
// outputs y_diag (B, nc, L, H, P), states (B, nc, H, P, N) and chunk_decay
// (B, nc, H), all f32.
//
// What bounds it on this card: bytes. At L = 128, P = 64, N = 128 a chunk
// of 16 heads does ~52 M multiply-adds against ~1.7 MB it must move: the
// three products at the tensor cores' 3xTF32 rate take less time than the
// bytes at the memory's rate.
//
// What the design does about it: every product runs on the tensor cores,
// c b^T is formed once per head tile, and nothing O(L^2) leaves the CTA.
// One CTA of 8 warps per (batch, chunk, tile of hb heads; the plan,
// kernel.py::ssd_plan, picks hb). b, c and the first head's xd arrive by
// 16-byte cp.async (element copies when rows are not 16-byte aligned),
// rows padded to 4 mod 32 floats, zeros past the chunk and past P and N.
// - att = c b^T: warp w holds rows 16w .. 16w + 15 of it in registers, the
//   column blocks on or below the diagonal only, for the whole tile.
// - dA of the tile's heads is summed by a warp-shuffle scan, one warp a
//   head; the state weights exp(cs_{L-1} - cs_l) and chunk_decay follow.
// - Per head, W = att * exp(cs_l - cs_m) is formed in registers as the A
//   fragment of y += W xd (the accumulator's k order doubles as the
//   fragment's, as in K3's p v); k steps above the diagonal are skipped,
//   only the two that straddle it are masked. The decay keeps the exponent
//   of the difference: exp(cs_l) exp(-cs_m) overflows at the path's inputs
//   (cs reaches about -100 over a chunk).
// - Per head, states = (xd * w)^T b over tiles of 16 x 64 that the warps
//   take in turn from a counter in shared memory, so that warps whose rows
//   of y held fewer k steps take more tiles. b's TF32 halves are split
//   once, after c b^T, into the space c held.
// - xd is double-buffered across the tile's heads: the next head's copy is
//   in flight while this one's products run.
// f32 products as 3xTF32 with mma.sync m16n8k8 (each operand split into a
// big and a small TF32 half, small*big + big*small + big*big summed in
// f32), each of the three over all of a warp's accumulators in turn, so
// that consecutive mma.sync do not wait on each other. The path's shape
// (L = 128, P and N multiples of 64) has its own instantiation without
// column guards (FULL, below). Accurate expf, no fast math, no flush to
// zero: chunk_decay is a denormal at the path's inputs. No atomics on
// outputs: each output element is written once by one thread, so every
// run gives the same bits.
#include "flash_hopper.cuh"

namespace {

using namespace flash;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_L = 128;  // c b^T in registers: 16 rows a warp
constexpr int YC = 64;      // columns of y a pass
constexpr int TI = 1;       // 16-row blocks (of p) of a state tile
constexpr int TN = 64;      // columns (n) of a state tile

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// One CTA's shared memory, in floats: b's big halves (c's rows until c b^T
// is formed) and small halves, LP rows of NP + 4; two xd buffers, LP rows
// of PP + 4; the tile's cs and state weights, LP each a head; a state-tile
// counter a head.
struct Layout {
  int LP, PP, NP, LDB, LDX, small, xbuf, cs, wst, ctr, bytes;
  __host__ __device__ Layout(int L, int P, int N, int hb) {
    LP = round_up(L, 16);
    PP = round_up(P, 16);
    NP = round_up(N, 8);
    LDB = NP + 4;
    LDX = PP + 4;
    small = LP * LDB;
    xbuf = 2 * LP * LDB;
    cs = xbuf + 2 * LP * LDX;
    wst = cs + hb * LP;
    ctr = wst + hb * LP;
    bytes = (ctr + hb) * 4;
  }
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, LP) x columns [0, CP) of a (rows x cols) matrix of row stride
// `stride` into rows of `ld` floats, zeros past rows and cols
__device__ __forceinline__ void stage(float* dst, const float* src, int rows,
                                      int cols, size_t stride, int LP, int CP,
                                      int ld, int vec) {
  if (vec) {
    const int upr = CP / 4;
#pragma unroll 1
    for (int i = threadIdx.x; i < LP * upr; i += THREADS) {
      const int r = i / upr, col = 4 * (i - r * upr);
      const bool in = r < rows && col < cols;
      cp_async16(dst + r * ld + col, in ? src + r * stride + col : src,
                 in ? 16 : 0);
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < LP * CP; i += THREADS) {
      const int r = i / CP, col = i - r * CP;
      dst[r * ld + col] = r < rows && col < cols ? src[r * stride + col] : 0.f;
    }
  }
}

// cs = cumsum of one head's dA (LP values, zeros past L) in place: lane i
// sums its E consecutive values in order, a Hillis-Steele scan over the
// lanes' totals gives each lane the sum before it. Then the state weights
// exp(cs_{L-1} - cs_l) and chunk_decay exp(cs_{L-1}).
__device__ __forceinline__ void scan_head(float* cs, float* wst, int LP, int L,
                                          float* decay, int lane) {
  const int E = (LP + 31) / 32;
  float run[MAX_L / 32], tot = 0.f;
#pragma unroll
  for (int e = 0; e < MAX_L / 32; ++e) {
    const int l = lane * E + e;
    if (e < E && l < LP) tot += cs[l];
    run[e] = tot;
  }
  float inc = tot;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const float u = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += u;
  }
  float before = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) before = 0.f;
#pragma unroll
  for (int e = 0; e < MAX_L / 32; ++e) {
    const int l = lane * E + e;
    if (e < E && l < LP) cs[l] = before + run[e];
  }
  __syncwarp();
  const float last = cs[L - 1];
  for (int l = lane; l < LP; l += 32) wst[l] = expf(last - cs[l]);
  if (lane == 0) *decay = expf(last);
}

// c[j] += a b_j for j < n, 3xTF32: each of the three products in turn over
// every j, so that consecutive mma.sync are independent and pipeline (in
// the order small*big, big*small, big*big for each c[j], as ever)
template <int J>
__device__ __forceinline__ void mma3_row(float (*c)[4], const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4],
                                         const uint32_t (&bb)[J][2],
                                         const uint32_t (&bs)[J][2], int n) {
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j < n) mma_tf32(c[j], as, bb[j]);
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j < n) mma_tf32(c[j], ab, bs[j]);
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j < n) mma_tf32(c[j], ab, bb[j]);
}

// (v0, v1) at columns col, col + 1 of a row of `cols` (col even; vec:
// rows of y and states are 8-byte aligned)
__device__ __forceinline__ void store2(float* row, int col, int cols,
                                       float v0, float v1, int vec) {
  if (vec && col + 1 < cols) {
    *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
  } else {
    if (col < cols) row[col] = v0;
    if (col + 1 < cols) row[col + 1] = v1;
  }
}

// FULL: L = 128, P a multiple of YC and N of TN, so that no column block
// of c b^T, y or a state tile needs a guard (a guarded load or product
// becomes a branch or a predicated mma.sync, and the loads of one block
// can no longer be issued ahead of the last one's products). Warps whose
// rows hold fewer than 8 column blocks of c b^T then form 8, unused.
template <bool FULL>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_kernel(const float* __restrict__ xd, const float* __restrict__ dA,
               const float* __restrict__ b, const float* __restrict__ c,
               float* __restrict__ y, float* __restrict__ states,
               float* __restrict__ decay, int nc, int L, int H, int P, int N,
               int hb, int vec) {
  extern __shared__ __align__(16) float smem[];
  const Layout g(L, P, N, hb);
  const int LP = g.LP, PP = g.PP, NP = g.NP, LDB = g.LDB, LDX = g.LDX;
  float* bB = smem;               // b's big halves (b itself until split)
  float* bS = smem + g.small;     // c, then b's small halves
  float* X = smem + g.xbuf;       // xd, two buffers
  float* cs = smem + g.cs;
  float* wst = smem + g.wst;
  int* ctr = reinterpret_cast<int*>(smem + g.ctr);

  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int h0 = blockIdx.x * hb, ci = blockIdx.y, bi = blockIdx.z;
  const size_t chunk = (size_t)bi * nc + ci;
  const size_t hp = (size_t)H * P;
  const float* xd_c = xd + chunk * L * hp;

  stage(bB, b + chunk * L * N, L, N, N, LP, NP, LDB, vec);
  stage(bS, c + chunk * L * N, L, N, N, LP, NP, LDB, vec);
  cp_async_commit();
  stage(X, xd_c + (size_t)h0 * P, L, P, hp, LP, PP, LDX, vec);
  cp_async_commit();
  for (int i = tid; i < hb * LP; i += THREADS) {
    const int hh = i / LP, l = i - hh * LP;
    cs[i] = l < L ? dA[(chunk * L + l) * H + h0 + hh] : 0.f;
  }
  if (tid < hb) ctr[tid] = 0;
  cp_async_wait<1>();  // b and c; the first head's xd may still be in flight
  __syncthreads();

  for (int hh = wi; hh < hb; hh += WARPS)
    scan_head(cs + hh * LP, wst + hh * LP, LP, L,
              decay + chunk * H + h0 + hh, lane);

  // att = c b^T, this warp's 16 rows x the column blocks j < nj
  const int r0 = 16 * wi;
  const bool has_rows = r0 < LP;
  const int nj = min(2 * wi + 2, LP / 8);
  float att[MAX_L / 8][4];
#pragma unroll
  for (int j = 0; j < MAX_L / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) att[j][e] = 0.f;
  if (has_rows) {
    const float* A = bS + (r0 + gq) * LDB + tq;
#pragma unroll 1
    for (int d0 = 0; d0 < NP; d0 += 8) {
      uint32_t ab[4], as[4];
      split_tf32(A[d0], ab[0], as[0]);
      split_tf32(A[8 * LDB + d0], ab[1], as[1]);
      split_tf32(A[d0 + 4], ab[2], as[2]);
      split_tf32(A[8 * LDB + d0 + 4], ab[3], as[3]);
      const float* Bp = bB + gq * LDB + d0 + tq;
#pragma unroll
      for (int j0 = 0; j0 < MAX_L / 8; j0 += 8) {
        if (j0 < nj) {
          uint32_t bb[8][2], bs[8][2];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (FULL || j0 + j < nj) {
              split_tf32(Bp[8 * (j0 + j) * LDB], bb[j][0], bs[j][0]);
              split_tf32(Bp[8 * (j0 + j) * LDB + 4], bb[j][1], bs[j][1]);
            }
          }
          mma3_row<8>(&att[j0], ab, as, bb, bs, FULL ? 8 : nj - j0);
        }
      }
    }
  }
  __syncthreads();  // c is read: its space takes b's small halves
#pragma unroll 4
  for (int i = tid; i < LP * LDB; i += THREADS) {
    const float x = bB[i];
    const uint32_t big = tf32_rna(x);
    bB[i] = __uint_as_float(big);
    bS[i] = __uint_as_float(tf32_rna(x - __uint_as_float(big)));
  }

  const int tiles_n = (NP + TN - 1) / TN;
  const int ntiles = (PP + 16 * TI - 1) / (16 * TI) * tiles_n;
  const int l0 = r0 + gq, l1 = l0 + 8;
#pragma unroll 1
  for (int hh = 0; hh < hb; ++hh) {
    const float* xs = X + (hh & 1) * LP * LDX;
    cp_async_wait<0>();  // this thread's copies of this head's xd
    __syncthreads();     // everyone's; the other buffer is free
    if (hh + 1 < hb) {
      stage(X + ((hh + 1) & 1) * LP * LDX, xd_c + (size_t)(h0 + hh + 1) * P,
            L, P, hp, LP, PP, LDX, vec);
      cp_async_commit();
    }
    const int h = h0 + hh;
    const float* csh = cs + hh * LP;
    const float* wh = wst + hh * LP;

    // y = W xd over this warp's rows, YC columns a pass
    if (has_rows) {
      const float cl0 = csh[l0], cl1 = csh[l1];
#pragma unroll 1
      for (int p0 = 0; p0 < PP; p0 += YC) {
        float acc[YC / 8][4];
#pragma unroll
        for (int j = 0; j < YC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
        for (int kb = 0; kb < MAX_L / 8; ++kb) {
          if (kb < nj) {
            const int m = 8 * kb + 2 * tq;
            const float2 cm = *reinterpret_cast<const float2*>(csh + m);
            float w0 = att[kb][0] * expf(cl0 - cm.x);
            float w1 = att[kb][1] * expf(cl0 - cm.y);
            float w2 = att[kb][2] * expf(cl1 - cm.x);
            float w3 = att[kb][3] * expf(cl1 - cm.y);
            if (kb >= 2 * wi) {  // straddles the diagonal: keep m <= l
              w0 = m <= l0 ? w0 : 0.f;
              w1 = m + 1 <= l0 ? w1 : 0.f;
              w2 = m <= l1 ? w2 : 0.f;
              w3 = m + 1 <= l1 ? w3 : 0.f;
            }
            // k in the order 2t, 2t + 1: the accumulator is the fragment
            uint32_t ab[4], as[4];
            split_tf32(w0, ab[0], as[0]);
            split_tf32(w2, ab[1], as[1]);
            split_tf32(w1, ab[2], as[2]);
            split_tf32(w3, ab[3], as[3]);
            const float* X0 = xs + m * LDX + p0 + gq;
            uint32_t bb[YC / 8][2], bs[YC / 8][2];
#pragma unroll
            for (int j = 0; j < YC / 8; ++j) {
              if (FULL || p0 + 8 * j < PP) {
                split_tf32(X0[8 * j], bb[j][0], bs[j][0]);
                split_tf32(X0[LDX + 8 * j], bb[j][1], bs[j][1]);
              }
            }
            mma3_row<YC / 8>(acc, ab, as, bb, bs,
                             FULL ? YC / 8 : (PP - p0) / 8);
          }
        }
#pragma unroll
        for (int j = 0; j < YC / 8; ++j) {
          const int col = p0 + 8 * j + 2 * tq;
          if (l0 < L)
            store2(y + ((chunk * L + l0) * H + h) * P, col, P, acc[j][0],
                   acc[j][1], vec);
          if (l1 < L)
            store2(y + ((chunk * L + l1) * H + h) * P, col, P, acc[j][2],
                   acc[j][3], vec);
        }
      }
    }

    // states = (xd * w)^T b, a tile of 16 TI x TN at a time
    float* st = states + (chunk * H + h) * (size_t)P * N;
#pragma unroll 1
    for (;;) {
      int tile = 0;
      if (lane == 0) tile = atomicAdd(ctr + hh, 1);
      tile = __shfl_sync(0xffffffffu, tile, 0);
      if (tile >= ntiles) break;
      const int pt = tile / tiles_n;
      const int p0 = pt * 16 * TI, n0 = (tile - pt * tiles_n) * TN;
      const int ni = FULL ? TI : min(TI, (PP - p0) / 16);
      const int nj = FULL ? TN / 8 : min(TN, NP - n0) / 8;
      float acc[TI][TN / 8][4];
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll 1
      for (int lb = 0; lb < LP; lb += 8) {
        // k in the order 2t, 2t + 1, so that A's and B's reads are both
        // free of bank conflicts at rows of 4 mod 32 floats
        const int la = lb + 2 * tq;
        const float2 w = *reinterpret_cast<const float2*>(wh + la);
        uint32_t ab[TI][4], as[TI][4];
#pragma unroll
        for (int i = 0; i < TI; ++i) {
          if (i < ni) {
            const float* xa = xs + la * LDX + p0 + 16 * i + gq;
            split_tf32(xa[0] * w.x, ab[i][0], as[i][0]);
            split_tf32(xa[8] * w.x, ab[i][1], as[i][1]);
            split_tf32(xa[LDX] * w.y, ab[i][2], as[i][2]);
            split_tf32(xa[LDX + 8] * w.y, ab[i][3], as[i][3]);
          }
        }
        const float* Bb = bB + la * LDB + n0 + gq;
        const float* Bs = bS + la * LDB + n0 + gq;
        uint32_t bb[TN / 8][2], bs[TN / 8][2];
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          if (j < nj) {
            bb[j][0] = __float_as_uint(Bb[8 * j]);
            bb[j][1] = __float_as_uint(Bb[LDB + 8 * j]);
            bs[j][0] = __float_as_uint(Bs[8 * j]);
            bs[j][1] = __float_as_uint(Bs[LDB + 8 * j]);
          }
        }
        // as mma3_row, over every (i, j) of the tile
#pragma unroll
        for (int i = 0; i < TI; ++i)
#pragma unroll
          for (int j = 0; j < TN / 8; ++j)
            if (i < ni && j < nj) mma_tf32(acc[i][j], as[i], bb[j]);
#pragma unroll
        for (int i = 0; i < TI; ++i)
#pragma unroll
          for (int j = 0; j < TN / 8; ++j)
            if (i < ni && j < nj) mma_tf32(acc[i][j], ab[i], bs[j]);
#pragma unroll
        for (int i = 0; i < TI; ++i)
#pragma unroll
          for (int j = 0; j < TN / 8; ++j)
            if (i < ni && j < nj) mma_tf32(acc[i][j], ab[i], bb[j]);
      }
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        const int pa = p0 + 16 * i + gq, pb = pa + 8;
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * tq;
          if (pa < P)
            store2(st + (size_t)pa * N, col, N, acc[i][j][0], acc[i][j][1],
                   vec);
          if (pb < P)
            store2(st + (size_t)pb * N, col, N, acc[i][j][2], acc[i][j][3],
                   vec);
        }
      }
    }
  }
}

}  // namespace

extern "C" int ssd_smem_bytes(int L, int P, int N, int hb) {
  return Layout(L, P, N, hb).bytes;
}

// All tensors f32 and contiguous; hb divides H, L <= 128. Returns the
// launch's cudaGetLastError() (0 = launched).
extern "C" int ssd_launch(const void* xd, const void* dA, const void* b,
                          const void* c, void* y, void* states, void* decay,
                          int B, int nc, int L, int H, int P, int N, int hb,
                          void* stream) {
  if (L < 1 || L > MAX_L || hb < 1 || H % hb)
    return (int)cudaErrorInvalidValue;
  const int smem = ssd_smem_bytes(L, P, N, hb);
  const auto kernel = L == MAX_L && P % YC == 0 && N % TN == 0
                          ? ssd_kernel<true>
                          : ssd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t any = reinterpret_cast<uintptr_t>(xd) |
                        reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(c) |
                        reinterpret_cast<uintptr_t>(y) |
                        reinterpret_cast<uintptr_t>(states);
  const int vec = P % 4 == 0 && N % 4 == 0 && any % 16 == 0;
  dim3 grid(H / hb, nc, B);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xd), static_cast<const float*>(dA),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(y), static_cast<float*>(states),
      static_cast<float*>(decay), nc, L, H, P, N, hb, vec);
  return (int)cudaGetLastError();
}
