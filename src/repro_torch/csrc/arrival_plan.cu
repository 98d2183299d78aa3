// The open loop's arrival plan, hand-written for Hopper (sm_90a): a shard's
// whole (gaps, tok, tokcum, qcap) in one launch. Plain C interface at the
// bottom; loaded with ctypes by repro_torch/kernels/event_loop/arrivals.py.
//
// Not a TPU kernel: the reference builds the plan in XLA
// (src/repro/traffic/stream.py::arrival_plan). Its plain PyTorch version is
// traffic/stream.py::arrival_plan, which ops.precompute_plan runs on the CPU
// and for backend="plain"; the two are held equal bit for bit on the card.
//
// What it computes, per replica b and request k < R, stream.py's functions
// operation for operation:
//  * the phase ph = count(k >= arr_edges[b, p] over all P entries) - 1; a
//    request before the first edge (ph = -1) takes 0 for every per-phase
//    value, as request_phase_onehot's empty one-hot row does in per_request;
//  * gaps[k] = arr_fix[k] + rint(-log1p_f32(-u) * gap_ns[ph]), u the uniform
//    of fold_in(key(seed), n_events + 1 + k). log1p_f32 is XLA's op order
//    with stream.py's constants (below, as bit patterns): __fmaf_rn exactly
//    where fma_f32 stands, __fmul_rn / __fadd_rn / __fdiv_rn wherever the
//    plain route rounds an operation of its own. nvcc contracts a plain
//    a * b + c into an FMA by default, and one contraction moves a gap by
//    1 ns and every later arrival of the replica with it;
//  * tok[k]: the debit-on-arrival token bucket, serial over the requests.
//    The credit starts at request 0's burst; each request takes
//    fma(gap, rate, credit), the NaN-propagating min with its burst (as
//    torch.minimum), >= 1 and the debit. tok is 1 where the rate is not > 0;
//  * tokcum[k], the exclusive prefix count of tok; qcap[k], the phase's bound.
//
// What bounds it on this card: the credit chain, R dependent steps of an
// FMA, a min, a compare and a subtraction (~20 cycles a step, ~3 us for
// R = 256); the rest, one threefry hash and ~50 f32 operations a request, is
// parallel and small. Bytes: 16 written a request.
//
// What the design does about it. One block a replica, a thread a request,
// THREADS requests a tile and the tiles in turn where R exceeds it. The
// threads make a tile's gaps and per-request rows in parallel and stage the
// chain's operands in shared memory; thread 0 then runs the chain over the
// tile, carrying the credit and the running count of admissions from tile
// to tile (the count rides beside the credit, so tokcum needs no scan of its
// own), and every thread stores the tile's tok and tokcum coalesced. A
// replica none of whose requests has a rate > 0 skips the chain (all ones,
// tokcum[k] = k): each block decides that from its own rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

using threefry::hash;
using threefry::threefry_bits;
using threefry::uniform;

constexpr int THREADS = 256;

// stream.py's log1p_f32 constants, f32 bit patterns (tests hold them equal)
constexpr uint32_t SMALL_X = 0x3ED413CDu;
constexpr uint32_t MIN_NORMAL = 0x00800000u;
constexpr uint32_t SQRT_HALF = 0x3F3504F3u;
constexpr uint32_t LOG_Y1_0 = 0x3D9021BBu;
constexpr uint32_t LOG_Y1_1 = 0xBDEBD1B8u;
constexpr uint32_t LOG_Y1_2 = 0x3DEF251Au;
constexpr uint32_t LOG_Y2_0 = 0xBDFE5D4Fu;
constexpr uint32_t LOG_Y2_1 = 0x3E11E9BFu;
constexpr uint32_t LOG_Y2_2 = 0xBE2AAE50u;
constexpr uint32_t LOG_Y3_0 = 0x3E4CCEACu;
constexpr uint32_t LOG_Y3_1 = 0xBE7FFFFCu;
constexpr uint32_t LOG_Y3_2 = 0x3EAAAAAAu;
constexpr uint32_t LN2_LO = 0xB95E8083u;
constexpr uint32_t LN2_HI = 0x3F318000u;
constexpr uint32_t Q_0 = 0x417101ADu;
constexpr uint32_t Q_1 = 0x42A6185Bu;
constexpr uint32_t Q_2 = 0x435DC32Du;
constexpr uint32_t Q_3 = 0x439A8CA3u;
constexpr uint32_t Q_4 = 0x43586D8Au;
constexpr uint32_t Q_5 = 0x42707982u;
constexpr uint32_t P_0 = 0x383DE04Bu;
constexpr uint32_t P_1 = 0x3EFF40C5u;
constexpr uint32_t P_2 = 0x40D284FAu;
constexpr uint32_t P_3 = 0x41EF4B9Cu;
constexpr uint32_t P_4 = 0x4273CC76u;
constexpr uint32_t P_5 = 0x426473ADu;
constexpr uint32_t P_6 = 0x41A05101u;
constexpr uint32_t NAN_BITS = 0x7FC00000u;
constexpr uint32_t INF_BITS = 0x7F800000u;

__device__ __forceinline__ float f32(uint32_t bits) {
  return __uint_as_float(bits);
}

// stream.py::_log_f32: XLA's f32 log of v, the large-|x| branch of log1p
__device__ __forceinline__ float log_f32(float v) {
  const bool bad = !(v > 0.0f);
  const bool is_zero = v == 0.0f;
  const bool is_inf = v == f32(INF_BITS);
  const float vc = v > f32(MIN_NORMAL) ? v : f32(MIN_NORMAL);
  const int bits = __float_as_int(vc);
  float e = __int2float_rn((bits >> 23) - 127);
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  e = __fadd_rn(e, 1.0f);
  const bool lo = m < f32(SQRT_HALF);
  const float tmp = lo ? m : 0.0f;
  e = __fsub_rn(e, lo ? 1.0f : 0.0f);
  const float x = __fadd_rn(__fadd_rn(m, -1.0f), tmp);
  const float z = __fmul_rn(x, x);
  const float x3 = __fmul_rn(z, x);
  float y1 = __fmaf_rn(x, f32(LOG_Y1_0), f32(LOG_Y1_1));
  float y2 = __fmaf_rn(x, f32(LOG_Y2_0), f32(LOG_Y2_1));
  float y3 = __fmaf_rn(x, f32(LOG_Y3_0), f32(LOG_Y3_1));
  y1 = __fmaf_rn(y1, x, f32(LOG_Y1_2));
  y2 = __fmaf_rn(y2, x, f32(LOG_Y2_2));
  y3 = __fmaf_rn(y3, x, f32(LOG_Y3_2));
  float y = __fmaf_rn(y1, x3, y2);
  y = __fmaf_rn(y, x3, y3);
  y = __fmaf_rn(y, x3, __fmul_rn(e, f32(LN2_LO)));
  float r = __fmaf_rn(z, -0.5f, x);
  r = __fadd_rn(r, y);
  r = __fmaf_rn(e, f32(LN2_HI), r);
  r = bad ? f32(NAN_BITS) : r;
  r = is_zero ? -f32(INF_BITS) : r;
  return is_inf ? f32(INF_BITS) : r;
}

// stream.py::log1p_f32: the rational branch for |x| below SMALL_X, else
// log_f32(1 + x); both made, as the plain route makes them
__device__ __forceinline__ float log1p_f32(float x) {
  const float large = log_f32(__fadd_rn(x, 1.0f));
  const float zero = __fmul_rn(x, 0.0f);
  float q = __fadd_rn(zero, 1.0f);
  q = __fmaf_rn(q, x, f32(Q_0));
  q = __fmaf_rn(q, x, f32(Q_1));
  q = __fmaf_rn(q, x, f32(Q_2));
  q = __fmaf_rn(q, x, f32(Q_3));
  q = __fmaf_rn(q, x, f32(Q_4));
  q = __fmaf_rn(q, x, f32(Q_5));
  float p = __fadd_rn(zero, f32(P_0));
  p = __fmaf_rn(p, x, f32(P_1));
  p = __fmaf_rn(p, x, f32(P_2));
  p = __fmaf_rn(p, x, f32(P_3));
  p = __fmaf_rn(p, x, f32(P_4));
  p = __fmaf_rn(p, x, f32(P_5));
  p = __fmaf_rn(p, x, f32(P_6));
  const float ratio = __fdiv_rn(p, q);
  const float x2 = __fmul_rn(x, x);
  const float small = __fadd_rn(
      x, __fmaf_rn(x2, -0.5f, __fmul_rn(__fmul_rn(x, x2), ratio)));
  return fabsf(x) < f32(SMALL_X) ? small : large;
}

struct Args {
  const int* seed;       // (B,)
  const int* arr_fix;    // (B, R)
  const int* arr_edges;  // (B, P)
  const float* arr_gap_ns;  // (B, P)
  const float* arr_token;   // (B, P, 2): refill a ns, burst
  const int* arr_qcap;   // (B, P)
  int* gaps;             // (B, R) each
  int* tok;
  int* tokcum;
  int* qcap;
  int R, P;
  uint32_t counter0;     // (n_events + 1) mod 2**32: request 0's counter
};

// request k's phase, -1 before the replica's first edge
__device__ __forceinline__ int phase(const int* edges, int P, int k) {
  int c = 0;
  for (int p = 0; p < P; ++p) c += k >= edges[p];
  return c - 1;
}

__global__ void __launch_bounds__(THREADS) arrival_plan_kernel(const Args a) {
  __shared__ float s_gap[THREADS], s_rate[THREADS], s_burst[THREADS];
  __shared__ int s_tok[THREADS], s_cum[THREADS];
  const int b = blockIdx.x;
  const int* edges = a.arr_edges + (long long)b * a.P;
  const float* gap_ns = a.arr_gap_ns + (long long)b * a.P;
  const float* token = a.arr_token + (long long)b * a.P * 2;
  const int* qcap = a.arr_qcap + (long long)b * a.P;
  const long long row = (long long)b * a.R;
  const int j = threadIdx.x;

  int rated = 0;  // does one of this thread's requests have a rate > 0?
  for (int k = j; k < a.R; k += THREADS) {
    const int ph = phase(edges, a.P, k);
    rated |= ph >= 0 && token[2 * ph] > 0.0f;
  }
  const bool chain = __syncthreads_or(rated) != 0;

  const uint32_t seed = (uint32_t)a.seed[b];
  float credit = 0.0f;  // thread 0's, carried from tile to tile
  int count = 0;
  for (int t0 = 0; t0 < a.R; t0 += THREADS) {
    const int k = t0 + j;
    if (k < a.R) {
      const int ph = phase(edges, a.P, k);
      float g_ns = 0.0f, rate = 0.0f, burst = 0.0f;
      int qc = 0;
      if (ph >= 0) {
        g_ns = gap_ns[ph];
        rate = token[2 * ph];
        burst = token[2 * ph + 1];
        qc = qcap[ph];
      }
      uint32_t k0, k1;  // fold_in(key(seed), n_events + 1 + k)
      hash(0u, seed, 0u, a.counter0 + (uint32_t)k, &k0, &k1);
      const float u = uniform(threefry_bits(k0, k1, 0u, 0u));
      const int jit = (int)rintf(__fmul_rn(-log1p_f32(-u), g_ns));
      const int gap = (int)((uint32_t)a.arr_fix[row + k] + (uint32_t)jit);
      a.gaps[row + k] = gap;
      a.qcap[row + k] = qc;
      s_gap[j] = __int2float_rn(gap);
      s_rate[j] = rate;
      s_burst[j] = burst;
    }
    __syncthreads();
    if (chain && j == 0) {
      if (t0 == 0) credit = s_burst[0];
      const int n = min(THREADS, a.R - t0);
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        const float bu = s_burst[i];
        float c = __fmaf_rn(s_gap[i], s_rate[i], credit);
        c = c != c ? c : (bu != bu ? bu : fminf(c, bu));
        const bool ok = c >= 1.0f;
        credit = ok ? __fsub_rn(c, 1.0f) : c;
        const int t = s_rate[i] > 0.0f ? (int)ok : 1;
        s_tok[i] = t;
        s_cum[i] = count;
        count += t;
      }
    }
    __syncthreads();
    if (k < a.R) {
      a.tok[row + k] = chain ? s_tok[j] : 1;
      a.tokcum[row + k] = chain ? s_cum[j] : k;
    }
    __syncthreads();  // the next tile overwrites the staged rows
  }
}

}  // namespace

// seed (B,) int32, arr_fix (B, R) int32, arr_edges (B, P) int32, arr_gap_ns
// (B, P) f32, arr_token (B, P, 2) f32, arr_qcap (B, P) int32, all contiguous;
// outputs gaps, tok, tokcum, qcap (B, R) int32. counter0 = (n_events + 1)
// mod 2**32. Returns the launch's cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int arrival_plan_launch(const void* seed, const void* arr_fix,
                                   const void* arr_edges,
                                   const void* arr_gap_ns,
                                   const void* arr_token,
                                   const void* arr_qcap, void* gaps,
                                   void* tok, void* tokcum, void* qcap, int B,
                                   int R, int P, unsigned counter0,
                                   void* stream) {
  if (B < 1 || R < 1 || P < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.seed = static_cast<const int*>(seed);
  a.arr_fix = static_cast<const int*>(arr_fix);
  a.arr_edges = static_cast<const int*>(arr_edges);
  a.arr_gap_ns = static_cast<const float*>(arr_gap_ns);
  a.arr_token = static_cast<const float*>(arr_token);
  a.arr_qcap = static_cast<const int*>(arr_qcap);
  a.gaps = static_cast<int*>(gaps);
  a.tok = static_cast<int*>(tok);
  a.tokcum = static_cast<int*>(tokcum);
  a.qcap = static_cast<int*>(qcap);
  a.R = R;
  a.P = P;
  a.counter0 = counter0;
  arrival_plan_kernel<<<(unsigned)B, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
