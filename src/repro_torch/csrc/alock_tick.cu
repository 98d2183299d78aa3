// K2: a thread schedule applied to many independent single-lock ALock
// tables, hand-written for Hopper (sm_90a). Plain C interface at the
// bottom; loaded with ctypes by repro_torch/kernels/alock_tick/kernel.py.
//
// Replaces the TPU kernel src/repro/kernels/alock_tick/kernel.py ::
// _tick_kernel (launched by alock_tick, pallas_call at kernel.py:162).
// Its plain PyTorch version is repro_torch/kernels/alock_tick/ref.py ::
// alock_tick_plain; the two are held equal bit for bit on the card.
//
// What it computes: for each of Tab tables (T threads, one lock), `steps`
// ALock transitions in order; step i moves thread sched[tab, i] by one
// program-counter step of core/machine.py::alock_step. State per table:
// the two cohort tails, the victim and pc/budget/next/prev per thread, all
// int32; cohorts (Tab, T) say which threads are local (0) or remote (any
// other value). A scheduled thread outside [0, T) leaves the table as it
// was, a predecessor or successor outside [0, T) is never written, and a
// PC outside the twelve changes nothing: the reference's one-hot masks
// select nothing in each case.
//
// Two modes share one transition. GIVEN takes the (Tab, steps) schedule
// from device memory (the TPU kernel's contract). DRAWN draws it inside
// the kernel, bit for bit core/prng.py::randint(key(seed), (rows, pitch),
// 0, T) from launch words the wrapper derives on the host (the two
// subkeys, span, 2**32 mod span, a division magic, the first row): the
// Monte-Carlo path's 2.46 GB schedule is never written. DRAW_ONLY is
// DRAWN writing the drawn schedule out instead of running the tables (the
// check of the in-kernel stream).
//
// What bounds it on this card: a table is one chain of `steps` dependent
// transitions; in DRAWN mode two threefry2x32 hashes per table-step (one
// where span is a power of two) add ~75-165 integer instructions each, on
// the order of the chain's own time; the bytes (state, and in GIVEN mode
// the schedule read once) are well under a millisecond.
//
// What the design does about it. A block is `chain_warps` chain warps (one
// table per lane) and `draw_warps` draw warps, ~one block per SM at the
// path shape. The draw warps fill a ring of `stages` stages of
// `stage_steps` steps for the block's tables, laid out [table][step] with
// rows of stage_steps + 4 words (conflict-free for both sides): hashes in
// DRAWN mode, coalesced 4-byte cp.async copies of the schedule rows in
// GIVEN mode. Full and empty mbarriers per stage hand the stages over, so
// the hashes run on other warps' issue slots beside the chain. Each table
// thread is one 16-byte record {pc, budget, next, prev} in shared memory,
// laid out [thread][table], so a warp's 32 lanes touch 32 consecutive
// records whichever thread each one steps: one ld.shared.v4 and one
// st.shared.v4 a step. The transition is branch-free (selects, as
// ref.py::alock_transition), so the 32 tables of a warp never diverge, and
// the next step's record is loaded before this step's stores and fixed up
// from them in registers (the same thread: the new record; the thread
// this step wrote remotely: the written field), which takes the load's
// latency off the chain. Tails, victim and the next step's cohort live in
// registers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_hopper.cuh"
#include "threefry.cuh"

namespace {

using flash::bar_arrive;
using flash::bar_arrive_copies;
using flash::bar_init;
using flash::bar_wait;
using flash::saddr;
using threefry::threefry_bits;

// core/machine.py program counters (the ALock's twelve)
enum : int {
  NCS = 0, SWAP = 1, WRITE_NEXT = 2, SPIN_BUDGET = 3, SET_VICTIM = 4,
  PET_WAIT = 5, SET_VICTIM_R = 6, PET_WAIT_R = 7, CS = 8, REL_CAS = 9,
  SPIN_NEXT = 10, PASS = 11
};

enum : int { GIVEN = 0, DRAWN = 1, DRAW_ONLY = 2 };

constexpr int MAX_THREADS = 256;

// The launch words of the drawn schedule (core/prng.py::randint): element
// (t, i) is the combine of b1 ^ b2 of threefry2x32 under the two subkeys of
// split(key(seed), 2) at the 64-bit counter (r0 + t) * pitch + i.
struct Words {
  uint32_t hi0, hi1;  // subkey 0: the "higher" bits
  uint32_t lo0, lo1;  // subkey 1: the "lower" bits
  uint32_t span;      // max(T, 1)
  uint32_t mult;      // 2**32 mod span (0 iff span is a power of two)
  uint32_t magic;     // x / span == ((((x - h) >> 1) + h) >> shift),
  uint32_t shift;     //   h = umulhi(magic, x), for span not a power of two
  unsigned long long r0, pitch;
};

struct Args {
  const int* sched;  // GIVEN: (n_tab, steps)
  const int* cohorts;
  const int* tails;
  const int* victim;
  const int* pc;
  const int* budget;
  const int* nxt;
  const int* prev;
  int* tails_out;
  int* victim_out;
  int* pc_out;
  int* budget_out;
  int* nxt_out;
  int* prev_out;
  int* sched_out;  // DRAW_ONLY: (n_tab, steps)
  long long steps;
  int n_tab, T, b_local, b_remote;
  int per;  // tables per block, at most 32 * chain_warps
  int chain_warps, draw_warps, stage_steps, stages;
  Words w;
};

// The carve-up of one block's dynamic shared memory: full and empty
// barriers per stage, the records (16 B per table thread, and one scratch
// record per table that takes the remote store of a step without one),
// the cohorts (4 B), the ring. Mirrored by kernel.py::smem_table.
struct Layout {
  int ps;  // table stride of the records and cohorts: 32 x chain warps
  int ld;  // words in one ring row: stage_steps + 4
  long long rec, coh, ring, total;
};

__host__ __device__ inline long long round16(long long b) {
  return (b + 15) / 16 * 16;
}

__host__ __device__ inline Layout layout(int T, int chain_warps, int S,
                                         int stages) {
  Layout L;
  L.ps = 32 * chain_warps;
  L.ld = S + 4;
  L.rec = round16(16LL * stages);
  L.coh = L.rec + 16LL * (T + 1) * L.ps;
  L.ring = round16(L.coh + 4LL * T * L.ps);
  L.total = round16(L.ring + 4LL * stages * L.ps * L.ld);
  return L;
}

// -- the drawn schedule -------------------------------------------------------

__device__ __forceinline__ uint32_t mod_span(uint32_t x, const Words& w) {
  const uint32_t h = __umulhi(w.magic, x);
  return x - ((((x - h) >> 1) + h) >> w.shift) * w.span;
}

// element at counter c: randint's (hi % span * mult + lo % span) % span in
// uint32; where span is a power of two, mult is 0 and hi drops out
template <bool POW2>
__device__ __forceinline__ int draw(const Words& w, unsigned long long c) {
  const uint32_t c0 = (uint32_t)(c >> 32), c1 = (uint32_t)c;
  const uint32_t lo = threefry_bits(w.lo0, w.lo1, c0, c1);
  if constexpr (POW2) {
    return (int)(lo & (w.span - 1u));
  } else {
    const uint32_t hi = threefry_bits(w.hi0, w.hi1, c0, c1);
    return (int)mod_span(mod_span(hi, w) * w.mult + mod_span(lo, w), w);
  }
}

// 4 bytes, global -> shared, asynchronous
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr(dst)),
               "l"(src)
               : "memory");
}

// -- the draw warps -----------------------------------------------------------

// Fill the ring stage by stage: each draw warp takes whole table rows of a
// stage, its lanes consecutive steps.
template <int MODE, bool POW2>
__device__ __forceinline__ void fill(const Args& a, const Layout& L,
                                     int* ring, uint64_t* full,
                                     uint64_t* empty, long long tab0,
                                     int per, long long n_stage) {
  const int dw = (threadIdx.x >> 5) - a.chain_warps;
  const int lane = threadIdx.x & 31;
  const int S = a.stage_steps;
  for (long long g = 0; g < n_stage; ++g) {
    const int s = (int)(g % a.stages);
    bar_wait(&empty[s], (int)(((g / a.stages) + 1) & 1));
    const long long base = g * S;
    const int cnt = (int)min((long long)S, a.steps - base);
    int* stage = ring + (long long)s * L.ps * L.ld;
    for (int k = dw; k < per; k += a.draw_warps) {
      int* row = stage + k * L.ld;
      if constexpr (MODE == GIVEN) {
        const int* src = a.sched + (tab0 + k) * a.steps + base;
        for (int j = lane; j < cnt; j += 32) cp_async4(row + j, src + j);
      } else {
        const unsigned long long c0 =
            (a.w.r0 + (unsigned long long)(tab0 + k)) * a.w.pitch +
            (unsigned long long)base;
        for (int j = lane; j < cnt; j += 32) row[j] = draw<POW2>(a.w, c0 + j);
      }
    }
    if constexpr (MODE == GIVEN)
      bar_arrive_copies(&full[s]);  // once this thread's copies have landed
    else
      bar_arrive(&full[s]);
  }
}

// -- the chain warps ----------------------------------------------------------

// One lane's table: the step pending in registers (its thread, record and
// cohort) and the tails and victim. advance(x) runs the pending step and
// makes scheduled thread x the pending one: x's record and cohort are
// loaded before the pending step's stores and then fixed up from them, so
// the load's latency is off the chain.
struct Lane {
  int4* my;         // this table's records, thread t at my[t * ps]
  const int* mc;    // its cohorts, mc[t * ps]
  int ps, T, b_local, b_remote;
  int tid, idx;     // the pending step's thread (idx: clamped to [0, T))
  int4 r;           // its record as the stores so far leave it
  int c;            // its cohort
  int t0, t1, v;

  __device__ __forceinline__ void advance(int x) {
    const int idx_n = (unsigned)x < (unsigned)T ? x : 0;
    const int4 rn = my[idx_n * ps];
    const int cn = mc[idx_n * ps];

    // -- one ALock step of thread tid, branch-free ------------------------
    // an out-of-range tid takes thread 0's record and matches no PC: it
    // writes that record back unchanged
    const int p = (unsigned)tid < (unsigned)T ? r.x : -1;
    const int bud = r.y, nx = r.z, pv = r.w;
    const bool local = c == 0;
    const int tail_c = local ? t0 : t1;
    const int tail_o = local ? t1 : t0;
    const int B = local ? b_local : b_remote;
    const int me = tid + 1;
    const bool can = (tail_o == 0) | (v != c);
    const bool solo = tail_c == me;
    const bool is_ncs = p == NCS, is_swap = p == SWAP;
    const bool is_wn = p == WRITE_NEXT;
    const bool is_sv = (p == SET_VICTIM) | (p == SET_VICTIM_R);
    const bool is_pw = (p == PET_WAIT) | (p == PET_WAIT_R);
    const bool is_pwr = p == PET_WAIT_R;
    const bool is_rc = p == REL_CAS, is_pass = p == PASS;
    // the next PC by a chain of selects (an OR of the disjoint classes'
    // terms compiles to a divergent branch); NCS, WRITE_NEXT, SET_VICTIM(_R)
    // and CS step forward by one, and a PC outside the twelve stays
    int np = (is_ncs | is_wn | is_sv | (p == CS)) ? p + 1 : r.x;
    np = is_swap ? (tail_c == 0 ? SET_VICTIM : WRITE_NEXT) : np;
    np = ((p == SPIN_BUDGET) & (bud != -1)) ? (bud == 0 ? SET_VICTIM_R : CS)
                                            : np;
    np = (is_pw & can) ? CS : np;
    np = is_rc ? (solo ? NCS : SPIN_NEXT) : np;
    np = ((p == SPIN_NEXT) & (nx != 0)) ? PASS : np;
    np = is_pass ? NCS : np;
    int4 nr;
    nr.x = np;
    nr.y = is_ncs ? -1
                  : (((is_swap & (tail_c == 0)) | (is_pwr & can)) ? B : bud);
    nr.z = is_ncs ? 0 : nx;
    nr.w = is_swap ? tail_c : pv;
    // at most one remote write: WRITE_NEXT links into the predecessor's
    // next, PASS hands the budget to the successor
    const int tgt = is_wn ? pv - 1 : nx - 1;
    const bool rem = (is_wn | is_pass) & ((unsigned)tgt < (unsigned)T);
    const int to = rem ? tgt : T;  // the scratch record: no remote write
    const int rval = is_wn ? me : bud - 1;
    v = is_sv ? c : v;
    const int ntc = is_swap ? me : ((is_rc & solo) ? 0 : tail_c);
    t0 = local ? ntc : t0;
    t1 = local ? t1 : ntc;

    // stores, unconditional (a predicated store compiles to a branch in
    // some instantiations): the own record, then the remote field (so
    // that a predecessor or successor equal to tid ends as the reference's
    // masks leave it)
    my[idx * ps] = nr;
    reinterpret_cast<int*>(my + to * ps)[is_wn ? 2 : 1] = rval;

    // the next record as these stores leave it
    r = idx_n == idx ? nr : rn;
    const bool hit = rem & (tgt == idx_n);
    r.z = (hit & is_wn) ? rval : r.z;
    r.y = (hit & is_pass) ? rval : r.y;
    tid = x;
    idx = idx_n;
    c = cn;
  }
};

// Run this lane's table over the ring's stages: four thread ids at a time
// (one ld.shared.v4: rows of ld = stage_steps + 4 words, a multiple of 4
// that is 4 mod 32, are conflict-free for the quarter-warp phases).
template <int MODE>
__device__ __forceinline__ void chain(const Args& a, const Layout& L,
                                      const int* ring, uint64_t* full,
                                      uint64_t* empty, int4* rec,
                                      const int* coh, long long tab0,
                                      int per, long long n_stage) {
  const int k = threadIdx.x;  // table in block (chain warps come first)
  const bool live = k < per;
  const long long tab = tab0 + k;
  const int S = a.stage_steps;
  const long long steps = a.steps;
  Lane ln;
  ln.my = rec + k;
  ln.mc = coh + k;
  ln.ps = L.ps;
  ln.T = a.T;
  ln.b_local = a.b_local;
  ln.b_remote = a.b_remote;
  ln.t0 = ln.t1 = ln.v = 0;
  if (MODE != DRAW_ONLY && live) {
    ln.t0 = a.tails[2 * tab];
    ln.t1 = a.tails[2 * tab + 1];
    ln.v = a.victim[tab];
  }
  // nothing pending: a step of no thread (it rewrites thread 0's record)
  ln.tid = -1;
  ln.idx = 0;
  if constexpr (MODE != DRAW_ONLY) {
    ln.r = ln.my[0];
    ln.c = ln.mc[0];
  }

  for (long long g = 0; g < n_stage; ++g) {
    const int s = (int)(g % a.stages);
    bar_wait(&full[s], (int)((g / a.stages) & 1));
    const int* row = ring + ((long long)s * L.ps + k) * L.ld;
    const int cnt = (int)min((long long)S, steps - g * S);
    int j = 0;
    for (; j + 4 <= cnt; j += 4) {
      int4 q = *reinterpret_cast<const int4*>(row + j);
      if (!live) q = make_int4(-1, -1, -1, -1);
      if constexpr (MODE == DRAW_ONLY) {
        if (live) {
          int* o = a.sched_out + tab * steps + g * S + j;
          o[0] = q.x;
          o[1] = q.y;
          o[2] = q.z;
          o[3] = q.w;
        }
      } else {
        ln.advance(q.x);
        ln.advance(q.y);
        ln.advance(q.z);
        ln.advance(q.w);
      }
    }
    for (; j < cnt; ++j) {
      const int x = live ? row[j] : -1;
      if constexpr (MODE == DRAW_ONLY) {
        if (live) a.sched_out[tab * steps + g * S + j] = x;
      } else {
        ln.advance(x);
      }
    }
    bar_arrive(&empty[s]);
  }
  if constexpr (MODE != DRAW_ONLY) {
    ln.advance(-1);  // the last step
    if (live) {
      a.tails_out[2 * tab] = ln.t0;
      a.tails_out[2 * tab + 1] = ln.t1;
      a.victim_out[tab] = ln.v;
    }
  }
}

template <int MODE, bool POW2>
__global__ void __launch_bounds__(MAX_THREADS)
    alock_tick_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(a.T, a.chain_warps, a.stage_steps, a.stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + a.stages;
  int4* rec = reinterpret_cast<int4*>(smem + L.rec);
  int* coh = reinterpret_cast<int*>(smem + L.coh);
  int* ring = reinterpret_cast<int*>(smem + L.ring);
  const int T = a.T;
  const long long tab0 = (long long)blockIdx.x * a.per;
  const int per = (int)min((long long)a.per, (long long)a.n_tab - tab0);
  const long long n_stage = (a.steps + a.stage_steps - 1) / a.stage_steps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      bar_init(&full[s], 32 * a.draw_warps);
      bar_init(&empty[s], 32 * a.chain_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (MODE != DRAW_ONLY) {
    // every table's state into its records, the block's rows in order
    for (int e = threadIdx.x; e < per * T; e += blockDim.x) {
      const int k = e / T, t = e - k * T;
      const long long gi = (tab0 + k) * T + t;
      rec[t * L.ps + k] =
          make_int4(a.pc[gi], a.budget[gi], a.nxt[gi], a.prev[gi]);
      coh[t * L.ps + k] = a.cohorts[gi];
    }
  }
  __syncthreads();

  if ((int)(threadIdx.x >> 5) < a.chain_warps)
    chain<MODE>(a, L, ring, full, empty, rec, coh, tab0, per, n_stage);
  else
    fill<MODE, POW2>(a, L, ring, full, empty, tab0, per, n_stage);

  if constexpr (MODE != DRAW_ONLY) {
    __syncthreads();
    for (int e = threadIdx.x; e < per * T; e += blockDim.x) {
      const int k = e / T, t = e - k * T;
      const long long gi = (tab0 + k) * T + t;
      const int4 x = rec[t * L.ps + k];
      a.pc_out[gi] = x.x;
      a.budget_out[gi] = x.y;
      a.nxt_out[gi] = x.z;
      a.prev_out[gi] = x.w;
    }
  }
}

template <int MODE, bool POW2>
int launch(const Args& a, int smem, cudaStream_t stream) {
  auto fn = alock_tick_kernel<MODE, POW2>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (a.n_tab + a.per - 1) / a.per;
  fn<<<(unsigned)blocks, 32 * (a.chain_warps + a.draw_warps), smem,
       stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block: T threads a table, `chain_warps`
// warps of tables, a ring of `stages` x `stage_steps` steps.
extern "C" int alock_tick_smem_bytes(int T, int chain_warps, int stage_steps,
                                     int stages) {
  return (int)layout(T, chain_warps, stage_steps, stages).total;
}

// mode 0 (GIVEN), 1 (DRAWN) or 2 (DRAW_ONLY). All tensors int32 and
// contiguous: sched (n_tab, steps) (GIVEN only), cohorts, pc, budget,
// next, prev (n_tab, T), tails (n_tab, 2), victim (n_tab, 1); the outputs
// have the inputs' shapes; sched_out (n_tab, steps) (DRAW_ONLY only).
// `words` holds hi0 hi1 lo0 lo1 span mult magic shift (DRAWN,
// DRAW_ONLY). `per` tables per block. Returns the launch's
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a plan
// the kernel does not take.
extern "C" int alock_tick_launch(
    int mode, const void* sched, const void* cohorts, const void* tails,
    const void* victim, const void* pc, const void* budget, const void* nxt,
    const void* prev, void* tails_out, void* victim_out, void* pc_out,
    void* budget_out, void* nxt_out, void* prev_out, void* sched_out,
    int n_tab, int T, long long steps, int b_local, int b_remote, int per,
    int chain_warps, int draw_warps, int stage_steps, int stages,
    const unsigned* words, unsigned long long r0, unsigned long long pitch,
    void* stream) {
  Args a;
  a.sched = static_cast<const int*>(sched);
  a.cohorts = static_cast<const int*>(cohorts);
  a.tails = static_cast<const int*>(tails);
  a.victim = static_cast<const int*>(victim);
  a.pc = static_cast<const int*>(pc);
  a.budget = static_cast<const int*>(budget);
  a.nxt = static_cast<const int*>(nxt);
  a.prev = static_cast<const int*>(prev);
  a.tails_out = static_cast<int*>(tails_out);
  a.victim_out = static_cast<int*>(victim_out);
  a.pc_out = static_cast<int*>(pc_out);
  a.budget_out = static_cast<int*>(budget_out);
  a.nxt_out = static_cast<int*>(nxt_out);
  a.prev_out = static_cast<int*>(prev_out);
  a.sched_out = static_cast<int*>(sched_out);
  a.steps = steps;
  a.n_tab = n_tab;
  a.T = T;
  a.b_local = b_local;
  a.b_remote = b_remote;
  a.per = per;
  a.chain_warps = chain_warps;
  a.draw_warps = draw_warps;
  a.stage_steps = stage_steps;
  a.stages = stages;
  a.w = Words{words[0], words[1], words[2], words[3], words[4],
              words[5], words[6], words[7], r0, pitch};
  if (n_tab < 1 || T < 1 || steps < 0 || per < 1 || chain_warps < 1 ||
      draw_warps < 1 || 32 * (chain_warps + draw_warps) > MAX_THREADS ||
      per > 32 * chain_warps || stage_steps < 4 || stage_steps % 4 || stages < 1 ||
      (mode != GIVEN && a.w.span < 1))
    return (int)cudaErrorInvalidValue;
  const int smem = alock_tick_smem_bytes(T, chain_warps, stage_steps, stages);
  const bool pow2 = (a.w.span & (a.w.span - 1)) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case GIVEN:
      return launch<GIVEN, false>(a, smem, st);
    case DRAWN:
      return pow2 ? launch<DRAWN, true>(a, smem, st)
                  : launch<DRAWN, false>(a, smem, st);
    case DRAW_ONLY:
      return pow2 ? launch<DRAW_ONLY, true>(a, smem, st)
                  : launch<DRAW_ONLY, false>(a, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// kernel_error_string comes with flash_common.cuh
