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
// was, and a predecessor or successor of -1 (none) is never written: the
// reference's one-hot masks select nothing in both cases.
//
// What bounds it on this card: latency. A table is one chain of `steps`
// dependent transitions (each reads what the last one wrote), and the
// work per step is a few integer operations; the bytes that must move
// (the schedule, read once) would take well under a millisecond at the
// HBM rate even at 4,096 tables x 150,000 steps.
//
// What the design does about it: one CUDA thread per table, `per` tables
// per block. The table's pc/budget/next/prev rows and its cohort row live
// in dynamic shared memory for the whole run, laid out field by field as
// [thread][table in block], so the 32 tables of a warp sit in 32
// consecutive words whichever thread each one steps: no bank conflicts.
// Tails and victim live in registers. The transition is a real switch on
// the PC with direct indexed writes. Each table reads its own schedule
// row, 16 bytes (four steps) at a time with the next four already in
// flight; a warp's 32 rows lie `steps` words apart, so these loads are not
// coalesced (the first thing to fix). No thread reads another's table, so
// the block never synchronises.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// core/machine.py program counters (the ALock's twelve)
enum : int {
  NCS = 0, SWAP = 1, WRITE_NEXT = 2, SPIN_BUDGET = 3, SET_VICTIM = 4,
  PET_WAIT = 5, SET_VICTIM_R = 6, PET_WAIT_R = 7, CS = 8, REL_CAS = 9,
  SPIN_NEXT = 10, PASS = 11
};
constexpr int FIELDS = 5;  // pc, budget, next, prev, cohort

struct Table {
  int* pc;
  int* bud;
  int* nxt;
  int* prev;
  const int* coh;
  int per;  // stride between one thread's words of consecutive tables
  int T;
  int t0, t1, v;
  int b_local, b_remote;

  __device__ __forceinline__ int& at(int* f, int t) const {
    return f[t * per];
  }

  __device__ __forceinline__ void step(int tid) {
    if ((unsigned)tid >= (unsigned)T) return;
    const int c = coh[tid * per];
    const bool local = c == 0;
    const int me = tid + 1;
    int tail_c = local ? t0 : t1;
    const int tail_o = local ? t1 : t0;
    const int p = at(pc, tid);
    int np = p;
    switch (p) {
      case NCS:
        at(bud, tid) = -1;
        at(nxt, tid) = 0;
        np = SWAP;
        break;
      case SWAP:
        at(prev, tid) = tail_c;
        if (tail_c == 0) {
          at(bud, tid) = local ? b_local : b_remote;
          np = SET_VICTIM;
        } else {
          np = WRITE_NEXT;
        }
        tail_c = me;
        break;
      case WRITE_NEXT: {
        const int pred = at(prev, tid) - 1;
        if ((unsigned)pred < (unsigned)T) at(nxt, pred) = me;
        np = SPIN_BUDGET;
        break;
      }
      case SPIN_BUDGET: {
        const int b = at(bud, tid);
        np = b == -1 ? SPIN_BUDGET : (b == 0 ? SET_VICTIM_R : CS);
        break;
      }
      case SET_VICTIM:
        v = c;
        np = PET_WAIT;
        break;
      case SET_VICTIM_R:
        v = c;
        np = PET_WAIT_R;
        break;
      case PET_WAIT:
        np = (tail_o == 0 || v != c) ? CS : PET_WAIT;
        break;
      case PET_WAIT_R:
        if (tail_o == 0 || v != c) {
          at(bud, tid) = local ? b_local : b_remote;
          np = CS;
        } else {
          np = PET_WAIT_R;
        }
        break;
      case CS:
        np = REL_CAS;
        break;
      case REL_CAS:
        if (tail_c == me) {
          tail_c = 0;
          np = NCS;
        } else {
          np = SPIN_NEXT;
        }
        break;
      case SPIN_NEXT:
        np = at(nxt, tid) != 0 ? PASS : SPIN_NEXT;
        break;
      case PASS: {
        const int succ = at(nxt, tid) - 1;
        if ((unsigned)succ < (unsigned)T) at(bud, succ) = at(bud, tid) - 1;
        np = NCS;
        break;
      }
      default:  // no ALock PC: the reference's masks select nothing
        break;
    }
    at(pc, tid) = np;
    if (local)
      t0 = tail_c;
    else
      t1 = tail_c;
  }
};

__global__ void alock_tick_kernel(
    const int* __restrict__ sched, const int* __restrict__ cohorts,
    const int* __restrict__ tails_in, const int* __restrict__ vic_in,
    const int* __restrict__ pc_in, const int* __restrict__ bud_in,
    const int* __restrict__ nxt_in, const int* __restrict__ prev_in,
    int* __restrict__ tails_out, int* __restrict__ vic_out,
    int* __restrict__ pc_out, int* __restrict__ bud_out,
    int* __restrict__ nxt_out, int* __restrict__ prev_out, int n_tab,
    int T, long long steps, int b_local, int b_remote) {
  extern __shared__ int smem[];
  const int per = blockDim.x;
  const int lane = threadIdx.x;
  const long long tab = (long long)blockIdx.x * per + lane;
  if (tab >= n_tab) return;  // the block never synchronises

  const int field = T * per;
  Table tb;
  tb.pc = smem + lane;
  tb.bud = tb.pc + field;
  tb.nxt = tb.bud + field;
  tb.prev = tb.nxt + field;
  int* coh = tb.prev + field;
  tb.coh = coh;
  tb.per = per;
  tb.T = T;
  tb.b_local = b_local;
  tb.b_remote = b_remote;

  const size_t row = (size_t)tab * T;
  for (int t = 0; t < T; ++t) {
    tb.pc[t * per] = pc_in[row + t];
    tb.bud[t * per] = bud_in[row + t];
    tb.nxt[t * per] = nxt_in[row + t];
    tb.prev[t * per] = prev_in[row + t];
    coh[t * per] = cohorts[row + t];
  }
  tb.t0 = tails_in[2 * tab];
  tb.t1 = tails_in[2 * tab + 1];
  tb.v = vic_in[tab];

  const int* s = sched + (size_t)tab * (size_t)steps;
  long long i = 0;
  if ((reinterpret_cast<uintptr_t>(s) & 15) == 0 && steps >= 4) {
    // four steps per 16-byte load, the next load in flight while they run
    int4 q = __ldg(reinterpret_cast<const int4*>(s));
    for (; i + 8 <= steps; i += 4) {
      const int4 nq = __ldg(reinterpret_cast<const int4*>(s + i + 4));
      tb.step(q.x);
      tb.step(q.y);
      tb.step(q.z);
      tb.step(q.w);
      q = nq;
    }
    tb.step(q.x);
    tb.step(q.y);
    tb.step(q.z);
    tb.step(q.w);
    i += 4;
  }
  for (; i < steps; ++i) tb.step(__ldg(s + i));

  for (int t = 0; t < T; ++t) {
    pc_out[row + t] = tb.pc[t * per];
    bud_out[row + t] = tb.bud[t * per];
    nxt_out[row + t] = tb.nxt[t * per];
    prev_out[row + t] = tb.prev[t * per];
  }
  tails_out[2 * tab] = tb.t0;
  tails_out[2 * tab + 1] = tb.t1;
  vic_out[tab] = tb.v;
}

}  // namespace

// Shared memory of one block of `per` tables at T threads.
extern "C" int alock_tick_smem_bytes(int T, int per) {
  return FIELDS * T * per * (int)sizeof(int);
}

// All tensors int32 and contiguous: sched (n_tab, steps), cohorts, pc,
// budget, next, prev (n_tab, T), tails (n_tab, 2), victim (n_tab, 1); the
// outputs have the inputs' shapes. `per` tables per block. Returns the
// launch's cudaGetLastError() (0 = launched).
extern "C" int alock_tick_launch(
    const void* sched, const void* cohorts, const void* tails,
    const void* victim, const void* pc, const void* budget, const void* nxt,
    const void* prev, void* tails_out, void* victim_out, void* pc_out,
    void* budget_out, void* nxt_out, void* prev_out, int n_tab, int T,
    long long steps, int b_local, int b_remote, int per, void* stream) {
  const int smem = alock_tick_smem_bytes(T, per);
  cudaError_t err = cudaFuncSetAttribute(
      alock_tick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_tab + per - 1) / per;
  alock_tick_kernel<<<blocks, per, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sched), static_cast<const int*>(cohorts),
      static_cast<const int*>(tails), static_cast<const int*>(victim),
      static_cast<const int*>(pc), static_cast<const int*>(budget),
      static_cast<const int*>(nxt), static_cast<const int*>(prev),
      static_cast<int*>(tails_out), static_cast<int*>(victim_out),
      static_cast<int*>(pc_out), static_cast<int*>(budget_out),
      static_cast<int*>(nxt_out), static_cast<int*>(prev_out), n_tab, T,
      steps, b_local, b_remote);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
