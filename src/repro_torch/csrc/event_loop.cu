// Next-event loop of the lock-table simulator, hand-written for Hopper
// (sm_90a). Plain C interface at the bottom; loaded with ctypes by
// repro_torch/kernels/event_loop/kernel.py.
//
// Replaces the TPU kernel src/repro/kernels/event_loop/kernel.py::
// event_loop_kernel (launched by the pl.pallas_call in
// src/repro/kernels/event_loop/ops.py::_pallas_events), closed loop only.
// Its plain PyTorch version is repro_torch/kernels/event_loop/ref.py::
// run_events_plain; the two are held equal bit for bit on the card.
//
// What it computes: for each of B independent replicas, n_events steps of
//   resolve phase -> (phase boundary: rejoin bump) -> tid = argmin(ready)
//   -> one lock-machine transition of thread tid (14 PCs, 18 for alock-rw)
//   -> cost opcode -> RNIC busy-clock serialisation -> new ready time
//   -> completion accounting (per-thread counts, latency ring).
//
// What bounds it on this card: latency, not bytes and not operations. One
// replica is a chain of n_events dependent steps (each step's argmin needs
// the previous step's clock), and a sweep bucket holds on the order of a
// hundred replicas, so the card runs ~100 warps of serial integer code.
// The bytes that must move (12-16 B of draws per event, the 256 KiB
// latency ring and a few KB of operands per replica) would take
// microseconds at the HBM rate; the step chain takes milliseconds.
//
// What the design does about it: one warp per replica, one block per
// warp. All per-replica machine state (cohort tails / lock word, victim,
// reader counts, per-thread pc/budget/next/prev/target/cohort, the ready /
// op_start / busy clocks, per-thread op counts) lives in dynamic shared
// memory for the whole run, so a step touches no device memory except its
// draws and, on a completion, one ring slot. The warp shares the argmin
// over `ready` ((clock, tid) pairs, lowest tid wins ties) with a shuffle
// butterfly; lane 0 runs the transition as a real switch on the PC with
// direct indexed writes. The draw streams are read 32 events at a time,
// one coalesced load per lane, and handed to the step by a shuffle.
// Clocks are native 64-bit integers. T, N, K, P, n_events and lat_samples
// are run-time arguments; only the algorithm is a template parameter, so
// one build serves every shape bucket.
//
// Numerics: costs scale as rintf(__fmul_rn(float(cost), mult)) (round half
// to even, no FMA contraction: build without --use_fast_math); the two
// probability compares are f32 against f32.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

enum Alg { ALG_ALOCK = 0, ALG_MCS = 1, ALG_SPINLOCK = 2, ALG_HLOCK = 3,
           ALG_ALOCK_RW = 4, ALG_COUNT = 5 };

// program counters (repro_torch/core/machine.py)
enum Pc { NCS = 0, SWAP = 1, WRITE_NEXT = 2, SPIN_BUDGET = 3, SET_VICTIM = 4,
          PET_WAIT = 5, SET_VICTIM_R = 6, PET_WAIT_R = 7, CS = 8,
          REL_CAS = 9, SPIN_NEXT = 10, PASS = 11, SL_CAS = 12, SL_REL = 13,
          RD_TRY = 14, RD_CS = 15, RD_REL = 16, WR_DRAIN = 17 };

// cost opcodes (repro_torch/kernels/event_loop/ref.py)
enum Op { OP_LOCAL = 0, OP_POLL = 1, OP_CS = 2, OP_THINK = 3, OP_RDMA = 4,
          OP_LOOP = 5 };

constexpr int N_COST_ROWS = 8;
constexpr long long NEVER = LLONG_MAX;   // parked threads lose every argmin
constexpr unsigned FULL = 0xffffffffu;

struct Args {
    // draw streams, (B, n_events)
    const float* u1; const int* r2; const int* r3; const float* u4;
    // per-phase operands
    const int* edges;        // (B, P)
    const int* think;        // (B, P)
    const float* locality;   // (B, P, T)
    const float* read_frac;  // (B, P, T)   alock-rw only
    const int* active;       // (B, P, T)
    const int* b_init;       // (B, P, 2)
    const int* cost_rows;    // (B, P, 8)
    const float* node_mult;  // (B, P, N)
    const int* thread_node;  // (T,)
    const int* lock_node;    // (K,)
    const int* rack;         // (B, N)      hlock only
    // outputs
    int* done;               // (B, T)
    long long* lat;          // (B, lat_samples), pre-filled with -1
    int* lat_n;              // (B,)
    long long* t_end;        // (B,)
    int* nreacq;             // (B,)
    int* npass;              // (B,)
    int T, N, K, P, n_events, lat_samples;
};

__host__ __device__ constexpr bool alock_family(int alg) {
    return alg == ALG_ALOCK || alg == ALG_HLOCK || alg == ALG_ALOCK_RW;
}

// number of K-sized int32 rows: tail0|word, [tail1, victim], [reader count]
__host__ __device__ constexpr int k_rows(int alg) {
    return (alock_family(alg) ? 3 : 1) + (alg == ALG_ALOCK_RW ? 1 : 0);
}

constexpr int T_ROWS_I32 = 7;   // pc budget nxt prev target cohort done

__host__ __device__ inline size_t smem_bytes(int alg, int T, int N, int K,
                                             int P) {
    return sizeof(long long) * (2 * (size_t)T + N)
         + sizeof(int) * ((size_t)k_rows(alg) * K + (size_t)T_ROWS_I32 * T
                          + P);
}

__device__ __forceinline__ int scale_cost(int c, float m) {
    return (int)rintf(__fmul_rn((float)c, m));
}

template <int ALG>
__global__ void __launch_bounds__(32)
event_loop_kernel(const Args a) {
    constexpr bool FAM = alock_family(ALG);
    constexpr bool HL = ALG == ALG_HLOCK;
    constexpr bool RW = ALG == ALG_ALOCK_RW;
    constexpr bool SPIN = ALG == ALG_SPINLOCK;
    constexpr int ENTER_CS = RW ? WR_DRAIN : CS;

    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    const int T = a.T, N = a.N, K = a.K, P = a.P;
    const int kpn = K / N;
    const bool multi = P > 1;

    extern __shared__ __align__(8) unsigned char smem_raw[];
    long long* ready = reinterpret_cast<long long*>(smem_raw);
    long long* opst = ready + T;
    long long* busy = opst + T;
    int* t0 = reinterpret_cast<int*>(busy + N);   // tail 0, or the lock word
    int* t1 = FAM ? t0 + K : t0;
    int* vic = FAM ? t1 + K : t0;
    int* wrd = RW ? vic + K : t0;                 // reader counts
    int* pc = t0 + (size_t)k_rows(ALG) * K;
    int* bud = pc + T;
    int* nxt = bud + T;
    int* prv = nxt + T;
    int* tgt = prv + T;
    int* coh = tgt + T;
    int* done = coh + T;
    int* edges = done + T;

    for (int k = lane; k < k_rows(ALG) * K; k += 32) t0[k] = 0;
    for (int t = lane; t < T; t += 32) {
        ready[t] = 0; opst[t] = 0;
        pc[t] = NCS; bud[t] = -1;
        nxt[t] = 0; prv[t] = 0; tgt[t] = 0; coh[t] = 0; done[t] = 0;
    }
    for (int n = lane; n < N; n += 32) busy[n] = 0;
    for (int p = lane; p < P; p += 32) edges[p] = a.edges[(size_t)b * P + p];
    __syncwarp();

    const size_t ev0 = (size_t)b * a.n_events;
    const float* u1 = a.u1 + ev0;
    const int* r2 = a.r2 + ev0;
    const int* r3 = a.r3 + ev0;
    const float* u4 = RW ? a.u4 + ev0 : nullptr;
    const int* tn = a.thread_node;
    const int* ln = a.lock_node;
    const int* rack = HL ? a.rack + (size_t)b * N : nullptr;
    long long* lat = a.lat + (size_t)b * a.lat_samples;

    int lat_n = 0, nreacq = 0, npass = 0;      // live in lane 0
    float u1v = 0.f, u4v = 0.f;                // this lane's slice of the
    int r2v = 0, r3v = 0;                      // current 32-event window

    for (int i = 0; i < a.n_events; ++i) {
        if ((i & 31) == 0) {
            const int j = i + lane;
            if (j < a.n_events) {
                u1v = u1[j]; r2v = r2[j]; r3v = r3[j];
                if (RW) u4v = u4[j];
            }
        }
        const float u1e = __shfl_sync(FULL, u1v, i & 31);
        const int r2e = __shfl_sync(FULL, r2v, i & 31);
        const int r3e = __shfl_sync(FULL, r3v, i & 31);
        const float u4e = RW ? __shfl_sync(FULL, u4v, i & 31) : 0.f;

        // -- phase resolve + the boundary rejoin bump ----------------------
        int ph = 0;
        const int* act = nullptr;
        if (multi) {
            int cnt = 0;
            bool boundary = false;
            for (int p = 0; p < P; ++p) {
                cnt += (i >= edges[p]);
                boundary |= (i == edges[p]);
            }
            ph = cnt - 1;
            act = a.active + ((size_t)b * P + ph) * T;
            if (boundary) {
                // a thread whose node rejoins resumes from the cluster's
                // current clock: the earliest clock of the continuously
                // active threads, else of the active ones
                const int php = ph > 0 ? ph - 1 : 0;
                const int* was = a.active + ((size_t)b * P + php) * T;
                long long cont_min = NEVER, act_min = NEVER;
                for (int t = lane; t < T; t += 32) {
                    if (act[t] != 0) {
                        const long long r = ready[t];
                        act_min = r < act_min ? r : act_min;
                        if (was[t] != 0) cont_min = r < cont_min ? r
                                                                 : cont_min;
                    }
                }
                for (int off = 16; off > 0; off >>= 1) {
                    const long long c = __shfl_xor_sync(FULL, cont_min, off);
                    const long long m = __shfl_xor_sync(FULL, act_min, off);
                    cont_min = c < cont_min ? c : cont_min;
                    act_min = m < act_min ? m : act_min;
                }
                const long long now_min = cont_min == NEVER ? act_min
                                                            : cont_min;
                for (int t = lane; t < T; t += 32) {
                    if (act[t] != 0 && was[t] == 0 && ready[t] < now_min)
                        ready[t] = now_min;
                }
                __syncwarp();
            }
        }

        // -- tid = argmin over schedulable ready clocks, lowest tid on ties
        long long best = NEVER;
        int tid = INT_MAX;
        for (int t = lane; t < T; t += 32) {
            const long long r = (multi && act[t] == 0) ? NEVER : ready[t];
            if (r < best || (r == best && t < tid)) { best = r; tid = t; }
        }
        for (int off = 16; off > 0; off >>= 1) {
            const long long ob = __shfl_xor_sync(FULL, best, off);
            const int ot = __shfl_xor_sync(FULL, tid, off);
            if (ob < best || (ob == best && ot < tid)) { best = ob; tid = ot; }
        }

        if (lane == 0) {
            const size_t bp = (size_t)b * P + ph;
            const int* cst = a.cost_rows + bp * N_COST_ROWS;
            const int* binit = a.b_init + bp * 2;
            const float* nm = a.node_mult + bp * N;
            const long long now = ready[tid];
            const int p = pc[tid];
            const int me = tid + 1;
            const int mynode = tn[tid];
            int code = OP_LOCAL, tnode = 0, newpc = p;

            // cost of an op on the lock word of lock k by a thread of
            // cohort c, and of a write to a peer thread's descriptor
            auto tiered = [&](int node) {
                return node == mynode ? OP_LOCAL
                     : (rack[node] == rack[mynode] ? OP_LOOP : OP_RDMA);
            };
            auto lock_cost = [&](int k, int c) {
                const int node = ln[k];
                if (HL) code = tiered(node);
                else if (FAM) code = c == 0 ? OP_LOCAL : OP_RDMA;
                else code = node == mynode ? OP_LOOP : OP_RDMA;
                tnode = node;
            };
            auto peer_cost = [&](int peer) {
                const int node = tn[peer];
                if (HL) code = tiered(node);
                else if (FAM) code = node == mynode ? OP_LOCAL : OP_RDMA;
                else code = node == mynode ? OP_LOOP : OP_RDMA;
                tnode = node;
            };

            switch (p) {
            case NCS: {
                // workload draw: own node with probability locality, else
                // a uniform remote node; a Zipf-ranked lock within it
                const bool go_local = u1e < a.locality[bp * T + tid];
                const int other = (mynode + 1 + r2e) % N;
                const int node = go_local ? mynode : other;
                int first;
                if (RW) {
                    const bool rd = u4e < a.read_frac[bp * T + tid];
                    first = rd ? RD_TRY : SWAP;
                } else {
                    first = SPIN ? SL_CAS : SWAP;
                }
                bud[tid] = -1;
                nxt[tid] = 0;
                tgt[tid] = node * kpn + r3e;
                coh[tid] = HL ? (rack[node] != rack[mynode])
                              : (node != mynode);
                newpc = first;
                code = OP_THINK;
                break;
            }
            case SWAP: {
                const int k = tgt[tid];
                const int c = coh[tid];
                int* tail = FAM ? (c == 0 ? t0 : t1) : t0;
                const int prev = tail[k];
                tail[k] = me;
                prv[tid] = prev;
                if (FAM) {
                    if (prev == 0) bud[tid] = binit[c];
                    newpc = prev == 0 ? SET_VICTIM : WRITE_NEXT;
                } else {
                    newpc = prev == 0 ? CS : WRITE_NEXT;
                }
                lock_cost(k, c);
                break;
            }
            case WRITE_NEXT: {
                const int pred = prv[tid] - 1;
                nxt[pred] = me;
                newpc = SPIN_BUDGET;
                peer_cost(pred);
                break;
            }
            case SPIN_BUDGET: {
                const int bd = bud[tid];
                if (FAM)
                    newpc = bd == -1 ? SPIN_BUDGET
                          : (bd == 0 ? SET_VICTIM_R : ENTER_CS);
                else
                    newpc = bd == -1 ? SPIN_BUDGET : CS;
                code = bd == -1 ? OP_POLL : OP_LOCAL;
                break;
            }
            case SET_VICTIM:
            case SET_VICTIM_R: {
                const int k = tgt[tid];
                const int c = coh[tid];
                vic[k] = c;
                newpc = p == SET_VICTIM ? PET_WAIT : PET_WAIT_R;
                lock_cost(k, c);
                break;
            }
            case PET_WAIT:
            case PET_WAIT_R: {
                const int k = tgt[tid];
                const int c = coh[tid];
                const int other_tail = c == 0 ? t1[k] : t0[k];
                const bool can = other_tail == 0 || vic[k] != c;
                if (p == PET_WAIT_R && can) bud[tid] = binit[c];
                newpc = can ? ENTER_CS : p;
                lock_cost(k, c);
                break;
            }
            case CS:
                newpc = SPIN ? SL_REL : REL_CAS;
                code = OP_CS;
                break;
            case REL_CAS: {
                const int k = tgt[tid];
                const int c = coh[tid];
                int* tail = FAM ? (c == 0 ? t0 : t1) : t0;
                const bool solo = tail[k] == me;
                if (solo) tail[k] = 0;
                newpc = solo ? NCS : SPIN_NEXT;
                lock_cost(k, c);
                break;
            }
            case SPIN_NEXT: {
                const bool has = nxt[tid] != 0;
                newpc = has ? PASS : SPIN_NEXT;
                code = has ? OP_LOCAL : OP_POLL;
                break;
            }
            case PASS: {
                const int succ = nxt[tid] - 1;
                bud[succ] = FAM ? bud[tid] - 1 : 1;
                newpc = NCS;
                peer_cost(succ);
                break;
            }
            case SL_CAS: {
                const int k = tgt[tid];
                const bool free_ = t0[k] == 0;
                if (free_) t0[k] = me;
                newpc = free_ ? CS : SL_CAS;
                lock_cost(k, coh[tid]);
                break;
            }
            case SL_REL: {
                const int k = tgt[tid];
                t0[k] = 0;
                newpc = NCS;
                lock_cost(k, coh[tid]);
                break;
            }
            // reader-writer ALock only; the reader count lives in `wrd`
            case RD_TRY: {
                const int k = tgt[tid];
                const bool can = t0[k] == 0 && t1[k] == 0;
                if (can) wrd[k] += 1;
                newpc = can ? RD_CS : RD_TRY;
                lock_cost(k, coh[tid]);
                break;
            }
            case RD_CS:
                newpc = RD_REL;
                code = OP_CS;
                break;
            case RD_REL: {
                const int k = tgt[tid];
                wrd[k] -= 1;
                newpc = NCS;
                lock_cost(k, coh[tid]);
                break;
            }
            case WR_DRAIN: {
                const int k = tgt[tid];
                const bool can = wrd[k] == 0;
                newpc = can ? CS : WR_DRAIN;
                lock_cost(k, coh[tid]);
                break;
            }
            default:
                break;
            }
            pc[tid] = newpc;

            // -- cost application: svc/wire scale by the target card's
            // node, plain CPU-side ops by the calling thread's node --------
            long long new_ready;
            if (code == OP_RDMA || code == OP_LOOP) {
                const bool loop = code == OP_LOOP;
                const float m = nm[tnode];
                const int svc = scale_cost(loop ? cst[5] : cst[4], m);
                const int wire = scale_cost(loop ? cst[7] : cst[6], m);
                const long long bz = busy[tnode];
                const long long fin = (now > bz ? now : bz) + svc;
                busy[tnode] = fin;
                new_ready = fin + wire;
            } else {
                const int base = code == OP_POLL ? cst[1]
                               : code == OP_CS ? cst[2]
                               : code == OP_THINK
                                   ? a.think[bp] : cst[0];
                new_ready = now + scale_cost(base, nm[mynode]);
            }

            // -- completion accounting: the latency reads op_start before
            // this event re-stamps it -------------------------------------
            const bool rel = p == REL_CAS || p == PASS || p == SL_REL
                          || (RW && p == RD_REL);
            if (rel && newpc == NCS) {
                lat[lat_n % a.lat_samples] = now - opst[tid];
                lat_n += 1;
                done[tid] += 1;
            }
            ready[tid] = new_ready;
            if (p == NCS) opst[tid] = new_ready;
            nreacq += (p == SPIN_BUDGET && newpc == SET_VICTIM_R);
            npass += (p == PASS);
        }
        __syncwarp();
    }

    long long tmax = LLONG_MIN;
    for (int t = lane; t < T; t += 32) {
        tmax = ready[t] > tmax ? ready[t] : tmax;
        a.done[(size_t)b * T + t] = done[t];
    }
    for (int off = 16; off > 0; off >>= 1) {
        const long long o = __shfl_xor_sync(FULL, tmax, off);
        tmax = o > tmax ? o : tmax;
    }
    if (lane == 0) {
        a.lat_n[b] = lat_n;
        a.t_end[b] = tmax;
        a.nreacq[b] = nreacq;
        a.npass[b] = npass;
    }
}

template <int ALG>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
    const size_t smem = smem_bytes(ALG, a.T, a.N, a.K, a.P);
    cudaError_t err = cudaFuncSetAttribute(
        event_loop_kernel<ALG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    event_loop_kernel<ALG><<<B, 32, smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one replica needs, in bytes (the wrapper prices
// the same table in Python before it launches).
int event_loop_smem_bytes(int alg, int T, int N, int K, int P) {
    if (alg < 0 || alg >= ALG_COUNT) return -1;
    return (int)smem_bytes(alg, T, N, K, P);
}

const char* event_loop_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Enqueue the event loop for B replicas on `stream`; does not synchronise
// and allocates nothing. Returns the cudaError_t of the launch (0 = ok).
int event_loop_launch(
    int alg,
    const void* u1, const void* r2, const void* r3, const void* u4,
    const void* edges, const void* think, const void* locality,
    const void* read_frac, const void* active, const void* b_init,
    const void* cost_rows, const void* node_mult, const void* thread_node,
    const void* lock_node, const void* rack,
    void* done, void* lat, void* lat_n, void* t_end, void* nreacq,
    void* npass,
    int B, int T, int N, int K, int P, int n_events, int lat_samples,
    void* stream) {
    Args a;
    a.u1 = (const float*)u1; a.r2 = (const int*)r2; a.r3 = (const int*)r3;
    a.u4 = (const float*)u4;
    a.edges = (const int*)edges; a.think = (const int*)think;
    a.locality = (const float*)locality;
    a.read_frac = (const float*)read_frac;
    a.active = (const int*)active; a.b_init = (const int*)b_init;
    a.cost_rows = (const int*)cost_rows;
    a.node_mult = (const float*)node_mult;
    a.thread_node = (const int*)thread_node;
    a.lock_node = (const int*)lock_node;
    a.rack = (const int*)rack;
    a.done = (int*)done; a.lat = (long long*)lat; a.lat_n = (int*)lat_n;
    a.t_end = (long long*)t_end; a.nreacq = (int*)nreacq;
    a.npass = (int*)npass;
    a.T = T; a.N = N; a.K = K; a.P = P; a.n_events = n_events;
    a.lat_samples = lat_samples;
    cudaStream_t s = (cudaStream_t)stream;
    switch (alg) {
    case ALG_ALOCK: return (int)launch<ALG_ALOCK>(a, B, s);
    case ALG_MCS: return (int)launch<ALG_MCS>(a, B, s);
    case ALG_SPINLOCK: return (int)launch<ALG_SPINLOCK>(a, B, s);
    case ALG_HLOCK: return (int)launch<ALG_HLOCK>(a, B, s);
    case ALG_ALOCK_RW: return (int)launch<ALG_ALOCK_RW>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
