// Next-event loop of the lock-table simulator, hand-written for Hopper
// (sm_90a). Plain C interface at the bottom; loaded with ctypes by
// repro_torch/kernels/event_loop/kernel.py.
//
// Replaces the TPU kernel src/repro/kernels/event_loop/kernel.py::
// event_loop_kernel (launched by the pl.pallas_call in
// src/repro/kernels/event_loop/ops.py::_pallas_events), closed loop and
// open loop (R > 0 request slots).
// Its plain PyTorch version is repro_torch/kernels/event_loop/ref.py::
// run_events_plain; the two are held equal bit for bit on the card.
//
// What it computes: for each of B independent replicas, n_events steps of
//   resolve phase -> (phase boundary: rejoin bump) -> tid = argmin(ready)
//   -> one lock-machine transition of thread tid (14 PCs, 18 for alock-rw)
//   -> cost opcode -> RNIC busy-clock serialisation -> new ready time
//   -> completion accounting (per-thread counts, latency ring).
// The open loop (template flag OPEN) adds per event: idle threads wake at
// the earliest available arrival, the requests that have arrived by `now`
// are ingested (token rejects and the tail beyond the queue bound drop),
// an idle selected thread takes the FIFO head, an idle thread with nothing
// to take makes no step (step_ok false), and the finishing release of a
// bound request stamps its sojourn.
//
// What bounds it on this card: latency, not bytes and not operations. One
// replica is a chain of n_events dependent steps (each step's argmin needs
// the previous step's clock). The bytes that must move (12-16 B of draws
// per event, the 256 KiB latency ring and a few KB of operands per
// replica) would take microseconds at the HBM rate; the step chain takes
// milliseconds. chip_smoke.py::k1_bound prices that chain (shared-memory
// and integer latencies measured by scripts/torch_sm_latency.py).
//
// What the design does about it:
// - One warp per replica, W replicas (warps) per block; the wrapper's
//   planner (kernels/event_loop/smem_plan.py) picks W so that W regions of
//   the per-replica table below fit the 227 KB a block may use; the tail
//   block's idle warps return at once. Replicas never synchronise with one
//   another, so there is no block-wide barrier.
// - Everything an event reads lives in the replica's shared-memory region
//   for the whole run: the machine state (lock tails / words and victims
//   as 16-bit rows, per-thread pc/budget/next/prev/target/cohort/done, the
//   ready / op_start / busy clocks) and the operands, staged at each phase
//   boundary: the cost table already scaled by each node's multiplier
//   (8 ints a node), the locality (and read_frac) row, the active row,
//   thread_node, lock_node, the rack row. An event's chain touches no
//   device memory: the draws are read 32 events ahead, one coalesced load
//   a lane, into a 32-event window in the region; a completion writes one
//   ring slot.
// - The lock op's cost code and node are fixed from the NCS draw to the
//   release, so the NCS step stores them in a per-thread word (lock_op) and
//   every lock op reads them beside the pc instead of after the target;
//   the stepping lane loads everything the step may read at once, before
//   the switch.
// - The argmin is one redux.sync over 32-bit keys that pack (clock, tid),
//   tid in the low bits so the lowest tid wins ties. Closed loop: each
//   thread's key ((clock - epoch + 1) << tb | tid) is kept and rewritten
//   with its clock. Open loop (idle threads wake with the next arrival):
//   keys relative to the last event's clock are packed each event. A key
//   that cannot hold its clock sends the event to the exact 64-bit shuffle
//   butterfly (out of line), and the closed loop then rekeys from the
//   earliest clock.
// - Closed loop, T <= 256 (the owner-lane body): thread t belongs to lane
//   t & 31, slot t >> 5. Each lane keeps its slots' keys and their least
//   in registers, so the argmin is that least into the redux.sync, with
//   no shared-memory round trip; the selected thread's step runs on its
//   owner lane, which writes the new key into its slot and refreshes its
//   least. Counts live in the lanes' registers and are summed at the end;
//   the latency ring's position is one shared word (the key row's first),
//   so the ring keeps its slot order. Otherwise (the open loop; the closed
//   loop at T > 256) lane 0 steps every thread and the keys live in the
//   region.
// - The events run phase by phase, so a boundary's bump and staging sit
//   outside the per-event loop; the transition is a real switch on the PC.
// - Open loop: arrival times are non-decreasing (a prefix sum of
//   non-negative gaps), so the arrived count, the FIFO head (lowest
//   pending slot) and the next admitted arrival (lowest pending admitted
//   slot) are warp-uniform pointers that move forward (the arrived count
//   also back, exactly, should `now` ever fall); ingestion visits only the
//   newly arrived slots. Each replica checks that its arrival row is
//   non-decreasing at the start and otherwise runs the exact R-wide scans.
//   Once every thread is idle and no admitted request is pending, no later
//   event can change anything but the phase boundaries' rejoin bumps: the
//   loop applies those and stops.
//
// Numerics: costs scale as rintf(__fmul_rn(float(cost), mult)) (round half
// to even, no FMA contraction: build without --use_fast_math); the two
// probability compares are f32 against f32. Clocks are 64-bit integers.

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

// the staged cost table: 8 ints per node, the RNIC pairs first (svc, wire)
// scaled by the target node, then the CPU-side ops indexed by opcode
// (OP_LOCAL..OP_THINK) scaled by the calling thread's node
constexpr int CT_PER_NODE = 8;
constexpr int CT_CPU = 4;

constexpr int N_COST_ROWS = 8;
constexpr long long NEVER = LLONG_MAX;   // parked threads lose every argmin
constexpr unsigned FULL = 0xffffffffu;
// packed argmin keys ((clock - epoch + 1) << tb | tid, closed loop): no
// schedulable thread, a clock beyond the key's reach, a clock below the
// epoch (0; a valid key is at least 1 << tb)
constexpr unsigned KEY_NONE = 0xffffffffu;
constexpr unsigned KEY_OVF = 0xfffffffeu;
constexpr unsigned KEY_BELOW = 0u;
constexpr size_t SMEM_LIMIT = 227 * 1024;
constexpr int MAX_WARPS = 8;            // replicas per block, at most
// threads one lane owns in the closed loop's owner-lane body (t = lane +
// 32 * slot): that body serves T <= 32 * LANE_SLOTS
constexpr int LANE_SLOTS = 8;
constexpr size_t REGION_ALIGN = 16;

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
    // open loop (R > 0)
    const long long* arr;    // (B, R) arrival times
    const int* tok;          // (B, R) 1 = token-bucket admitted
    const int* tokcum;       // (B, R) exclusive prefix count of tok
    const int* qcap;         // (B, R) wait-queue bound
    long long* wq;           // (B, R) queue waits, pre-filled with -1
    long long* soj;          // (B, R) sojourns, pre-filled with -1
    int* rstat;              // (B, R) final request status
    // optional (may be null): per replica the events the loop ran before
    // it stopped, 1 where the open-loop pointer path ran, the lock
    // operations begun (NCS steps), how many of them began shared
    // (alock-rw's RD_TRY; 0 for every other algorithm) and how many on
    // the loopback tier (hlock's same-rack locks; 0 for the others)
    int* diag;               // (B, 5)
    int B, W, T, N, K, P, R, n_events, lat_samples;
    size_t stride;           // bytes of one replica's region
};

__host__ __device__ constexpr bool alock_family(int alg) {
    return alg == ALG_ALOCK || alg == ALG_HLOCK || alg == ALG_ALOCK_RW;
}

// 16-bit K-sized rows: tail0|word, [tail1, victim], [reader count], and
// the staged lock_node
__host__ __device__ constexpr int k_rows(int alg) {
    return (alock_family(alg) ? 3 : 1) + (alg == ALG_ALOCK_RW ? 1 : 0) + 1;
}

// i32 T-sized rows: pc budget nxt prev target cohort done lock_op
// thread_node locality active argmin_key, [read_frac]
__host__ __device__ constexpr int t_rows_i32(int alg) {
    return 12 + (alg == ALG_ALOCK_RW ? 1 : 0);
}

// the draws of the current 32-event window: u1 r2 r3 [u4]
__host__ __device__ constexpr int draw_rows(int alg) {
    return alg == ALG_ALOCK_RW ? 4 : 3;
}

constexpr int R_ROWS_I32 = 4;   // rstat tok tokcum qcap

// request-slot status codes (repro_torch/traffic/metrics.py)
enum Rstat { PENDING = 0, IN_SERVICE = 1, DROPPED = 2, COMPLETED = 3 };

// one replica's region (kernels/event_loop/smem_plan.py::smem_table
// prices the same rows): the 8-byte clocks, then the 4-byte rows, then
// the 16-bit rows
__host__ __device__ inline size_t smem_bytes(int alg, int T, int N, int K,
                                             int P, int R) {
    const size_t open_i32 = R > 0 ? (size_t)R_ROWS_I32 * R + T : 0;
    return sizeof(long long) * (2 * (size_t)T + N + R)
         + sizeof(int) * ((size_t)CT_PER_NODE * N
                          + (size_t)t_rows_i32(alg) * T
                          + (alg == ALG_HLOCK ? N : 0) + P
                          + 32 * draw_rows(alg) + open_i32)
         + sizeof(unsigned short) * (size_t)k_rows(alg) * K;
}

__host__ __device__ inline size_t region_stride(size_t bytes) {
    return (bytes + REGION_ALIGN - 1) / REGION_ALIGN * REGION_ALIGN;
}

__device__ __forceinline__ int warp_sum(int v) {
    return __reduce_add_sync(FULL, v);
}

__device__ __forceinline__ int warp_min(int v) {
    return __reduce_min_sync(FULL, v);
}

__device__ __forceinline__ long long warp_min(long long v) {
    for (int off = 16; off > 0; off >>= 1) {
        const long long o = __shfl_xor_sync(FULL, v, off);
        v = o < v ? o : v;
    }
    return v;
}

__device__ __forceinline__ int scale_cost(int c, float m) {
    return (int)rintf(__fmul_rn((float)c, m));
}

// The exact argmin over (clock, tid), lowest tid on ties, by a 64-bit
// shuffle butterfly: the rare event whose clocks spread wider than the
// packed 32-bit key. Out of line, so the per-event loop stays compact.
struct Pick { long long clock; int tid; };

template <bool OPEN>
__device__ __noinline__ Pick argmin_exact(
        const long long* ready, const int* act, const int* pc,
        const int* curreq, long long next_arr, int T, int lane) {
    long long best = NEVER;
    int tid = INT_MAX;
    for (int t = lane; t < T; t += 32) {
        long long r = ready[t];
        if (OPEN && pc[t] == NCS && curreq[t] < 0 && next_arr > r)
            r = next_arr;
        if (act[t] == 0) r = NEVER;
        if (r < best || (r == best && t < tid)) { best = r; tid = t; }
    }
    for (int off = 16; off > 0; off >>= 1) {
        const long long ob = __shfl_xor_sync(FULL, best, off);
        const int ot = __shfl_xor_sync(FULL, tid, off);
        if (ob < best || (ob == best && ot < tid)) { best = ob; tid = ot; }
    }
    return {best, tid};
}

__device__ __forceinline__ unsigned lesser(unsigned x, unsigned y) {
    return x < y ? x : y;
}

// the least of a lane's slot keys, as a tree (three dependent minima)
__device__ __forceinline__ unsigned slot_min(const unsigned (&k)[LANE_SLOTS]) {
    return lesser(lesser(lesser(k[0], k[1]), lesser(k[2], k[3])),
                  lesser(lesser(k[4], k[5]), lesser(k[6], k[7])));
}

// One replica, on one warp. LANE: the closed loop's owner-lane body (T <=
// 32 * LANE_SLOTS), else the lane-0 body (the open loop, and the closed
// loop at T > 32 * LANE_SLOTS).
template <int ALG, bool OPEN, bool LANE>
__device__ __forceinline__ void replica(const Args& a, int warp, int b) {
    static_assert(!(OPEN && LANE), "the owner-lane body is closed-loop only");
    constexpr bool FAM = alock_family(ALG);
    constexpr bool HL = ALG == ALG_HLOCK;
    constexpr bool RW = ALG == ALG_ALOCK_RW;
    constexpr bool SPIN = ALG == ALG_SPINLOCK;
    constexpr int ENTER_CS = RW ? WR_DRAIN : CS;

    const int lane = threadIdx.x & 31;
    const int T = a.T, N = a.N, K = a.K, P = a.P;
    const int R = OPEN ? a.R : 0;
    const int kpn = K / N;
    const bool multi = P > 1;

    // -- this replica's region ----------------------------------------------
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* region = smem_raw + (size_t)warp * a.stride;
    long long* ready = reinterpret_cast<long long*>(region);
    long long* opst = ready + T;
    long long* busy = opst + T;
    long long* arr = busy + N;                    // open loop: arrival times
    int* ct = reinterpret_cast<int*>(arr + R);    // staged cost table
    int* pc = ct + CT_PER_NODE * N;
    int* bud = pc + T;
    int* nxt = bud + T;
    int* prv = nxt + T;
    int* tgt = prv + T;
    int* coh = tgt + T;
    int* done = coh + T;
    int* lkop = done + T;                 // lock op: code | (node << 3)
    int* tn = lkop + T;                   // staged thread_node
    float* loc = reinterpret_cast<float*>(tn + T);   // staged locality row
    int* act = reinterpret_cast<int*>(loc + T);   // staged active row
    // closed loop: the lane-0 body's keys; the owner-lane body keeps its
    // keys in registers and this row's first word holds the ring position
    unsigned* akey = reinterpret_cast<unsigned*>(act + T);
    int* ringpos = reinterpret_cast<int*>(akey);
    float* rfr = reinterpret_cast<float*>(akey + T);  // read_frac (alock-rw)
    int* rack = reinterpret_cast<int*>(rfr + (RW ? T : 0));  // hlock
    int* edges = rack + (HL ? N : 0);
    float* dw_u1 = reinterpret_cast<float*>(edges + P);  // draw window
    int* dw_r2 = reinterpret_cast<int*>(dw_u1 + 32);
    int* dw_r3 = dw_r2 + 32;
    float* dw_u4 = reinterpret_cast<float*>(dw_r3 + 32);  // alock-rw
    int* rstat = reinterpret_cast<int*>(dw_u4 + (RW ? 32 : 0));  // open
    int* tok = rstat + R;
    int* tokcum = tok + R;
    int* qcap = tokcum + R;
    int* curreq = qcap + R;               // (T,) bound request, -1
    unsigned short* t0 = reinterpret_cast<unsigned short*>(
        curreq + (OPEN ? T : 0));         // tail 0, or the lock word
    unsigned short* t1 = FAM ? t0 + K : t0;
    unsigned short* vic = FAM ? t1 + K : t0;
    unsigned short* wrd = RW ? vic + K : t0;      // reader counts
    unsigned short* ln = t0 + (size_t)(k_rows(ALG) - 1) * K;   // staged

    // -- initial state ------------------------------------------------------
    for (int k = lane; k < K; k += 32) {
        t0[k] = 0;
        if (FAM) { t1[k] = 0; vic[k] = 0; }
        if (RW) wrd[k] = 0;
        ln[k] = (unsigned short)a.lock_node[k];
    }
    for (int t = lane; t < T; t += 32) {
        ready[t] = 0; opst[t] = 0;
        pc[t] = NCS; bud[t] = -1;
        nxt[t] = 0; prv[t] = 0; tgt[t] = 0; coh[t] = 0; done[t] = 0;
        lkop[t] = 0;
        tn[t] = a.thread_node[t];
    }
    for (int n = lane; n < N; n += 32) {
        busy[n] = 0;
        if (HL) rack[n] = a.rack[(size_t)b * N + n];
    }
    for (int p = lane; p < P; p += 32) edges[p] = a.edges[(size_t)b * P + p];

    // open loop: the queue length and the pointers are warp-uniform
    int arrptr = 0, qlen = 0;
    int lowp = 0;       // lowest PENDING slot: the FIFO head when < arrptr
    int lowa = 0;       // lowest PENDING token-admitted slot
    bool mono = false;  // arrival row non-decreasing: the pointer path
    if constexpr (OPEN) {
        const size_t r0 = (size_t)b * R;
        bool ok = true;
        for (int k = lane; k < R; k += 32) {
            arr[k] = a.arr[r0 + k];
            tok[k] = a.tok[r0 + k];
            tokcum[k] = a.tokcum[r0 + k];
            qcap[k] = a.qcap[r0 + k];
            rstat[k] = PENDING;
            if (k > 0 && a.arr[r0 + k - 1] > a.arr[r0 + k]) ok = false;
        }
        mono = __all_sync(FULL, ok);
        for (int t = lane; t < T; t += 32) curreq[t] = -1;
    }
    if (LANE && lane == 0) *ringpos = 0;
    __syncwarp();

    // the packed argmin key: ((clock - base) << tb) | tid (open loop),
    // ((clock - epoch + 1) << tb) | tid kept per thread (closed loop)
    const int tb = T > 1 ? 32 - __clz(T - 1) : 0;
    const unsigned tmask = (1u << tb) - 1u;
    const unsigned long long dmax = (1ull << (32 - tb)) - 2ull;
    const unsigned long long kmax = (1ull << (32 - tb)) - 4ull;
    long long epoch = 0;                  // the closed loop's key origin
    // owner-lane body: the keys of this lane's threads (slot j holds
    // thread lane + 32 j; KEY_NONE past T) and their least
    unsigned kr[LANE ? LANE_SLOTS : 1];
    unsigned lmin = KEY_NONE;
    auto pack = [&](int t, long long r) -> unsigned {
        if (r < epoch) return KEY_BELOW;
        const unsigned long long d = (unsigned long long)(r - epoch);
        return d > kmax ? KEY_OVF : ((unsigned)(d + 1) << tb) | (unsigned)t;
    };
    // every thread's key anew, from the earliest schedulable clock
    auto rekey = [&]() {
        long long m = NEVER;
        for (int t = lane; t < T; t += 32)
            if (act[t] != 0 && ready[t] < m) m = ready[t];
        m = warp_min(m);
        if (m != NEVER) epoch = m;
        if constexpr (LANE) {
#pragma unroll
            for (int j = 0; j < LANE_SLOTS; ++j) {
                const int t = lane + 32 * j;
                kr[j] = t < T && act[t] != 0 ? pack(t, ready[t]) : KEY_NONE;
            }
            lmin = slot_min(kr);
        } else {
            for (int t = lane; t < T; t += 32)
                akey[t] = act[t] != 0 ? pack(t, ready[t]) : KEY_NONE;
            __syncwarp();
        }
    };

    // -- phase boundaries: rejoin bump, then the phase's rows staged -------
    int binit0 = 0, binit1 = 0;
    int next_edge = 0;                 // the next event that starts a phase
    auto boundary = [&](int i) {
        int cnt = 0, nb = INT_MAX;
        bool at_edge = false;
        for (int p = 0; p < P; ++p) {
            const int e = edges[p];
            cnt += i >= e;
            at_edge |= i == e;
            nb = (e > i && e < nb) ? e : nb;
        }
        next_edge = nb;
        const int ph = cnt - 1;
        const size_t bp = (size_t)b * P + ph;
        if (multi && at_edge) {
            // a thread whose node rejoins resumes from the cluster's
            // current clock: the earliest clock of the continuously active
            // threads, else of the active ones
            const int* now_act = a.active + bp * T;
            const int* was = a.active + ((size_t)b * P + (ph > 0 ? ph - 1 : 0))
                             * T;
            long long cont_min = NEVER, act_min = NEVER;
            for (int t = lane; t < T; t += 32) {
                if (now_act[t] != 0) {
                    const long long r = ready[t];
                    act_min = r < act_min ? r : act_min;
                    if (was[t] != 0) cont_min = r < cont_min ? r : cont_min;
                }
            }
            cont_min = warp_min(cont_min);
            act_min = warp_min(act_min);
            const long long now_min = cont_min == NEVER ? act_min : cont_min;
            for (int t = lane; t < T; t += 32) {
                if (now_act[t] != 0 && was[t] == 0 && ready[t] < now_min)
                    ready[t] = now_min;
            }
        }
        const int* cst = a.cost_rows + bp * N_COST_ROWS;
        const int think = a.think[bp];
        for (int n = lane; n < N; n += 32) {
            const float m = a.node_mult[bp * N + n];
            int* row = ct + CT_PER_NODE * n;
            row[0] = scale_cost(cst[4], m);           // RDMA svc, wire
            row[1] = scale_cost(cst[6], m);
            row[2] = scale_cost(cst[5], m);           // loopback svc, wire
            row[3] = scale_cost(cst[7], m);
            row[CT_CPU + OP_LOCAL] = scale_cost(cst[0], m);
            row[CT_CPU + OP_POLL] = scale_cost(cst[1], m);
            row[CT_CPU + OP_CS] = scale_cost(cst[2], m);
            row[CT_CPU + OP_THINK] = scale_cost(think, m);
        }
        for (int t = lane; t < T; t += 32) {
            loc[t] = a.locality[bp * T + t];
            if (RW) rfr[t] = a.read_frac[bp * T + t];
            // one phase: every thread schedulable, whatever `active` says
            act[t] = multi ? a.active[bp * T + t] : 1;
        }
        binit0 = a.b_init[bp * 2];
        binit1 = a.b_init[bp * 2 + 1];
        __syncwarp();
        if constexpr (!OPEN) rekey();
    };

    const size_t ev0 = (size_t)b * a.n_events;
    const float* u1 = a.u1 + ev0;
    const int* r2 = a.r2 + ev0;
    const int* r3 = a.r3 + ev0;
    const float* u4 = RW ? a.u4 + ev0 : nullptr;
    long long* lat = a.lat + (size_t)b * a.lat_samples;

    // per-replica counts, kept by the lanes that step (lane 0, or each
    // owner lane) and summed over the warp at the end; lat_pos is lane 0's
    // ring position (the owner-lane body keeps it in *ringpos)
    int lat_n = 0, lat_pos = 0, nreacq = 0, npass = 0;
    // lock operations begun, begun shared, begun on the loopback tier
    int nops = 0, nreads = 0, nloop = 0;
    // this lane's slice of the next 32-event draw window, loaded a window
    // ahead and stored to the region's window when it becomes current
    float u1n = 0.f, u4n = 0.f;
    int r2n = 0, r3n = 0;
    if (lane < a.n_events) {
        u1n = u1[lane]; r2n = r2[lane]; r3n = r3[lane];
        if (RW) u4n = u4[lane];
    }
    long long base = 0;                // open loop: the last event's clock
    int ev_run = a.n_events;

    // the events run phase by phase: each phase's boundary work (rejoin
    // bump, staging) stays outside the per-event loop
    bool idle_for_good = false;
    for (int i = 0; i < a.n_events && !idle_for_good;) {
      if (i == next_edge) boundary(i);
      const int seg_end = next_edge < a.n_events ? next_edge : a.n_events;
      for (; i < seg_end; ++i) {
        if ((i & 31) == 0) {
            dw_u1[lane] = u1n; dw_r2[lane] = r2n; dw_r3[lane] = r3n;
            if (RW) dw_u4[lane] = u4n;
            const int j = i + 32 + lane;
            if (j < a.n_events) {
                u1n = u1[j]; r2n = r2[j]; r3n = r3[j];
                if (RW) u4n = u4[j];
            }
            __syncwarp();
        }
        // owner-lane body: this event's draws, read before the argmin
        // resolves (they do not depend on the thread it selects)
        float wu1 = 0.f, wu4 = 0.f;
        int wr2 = 0, wr3 = 0;
        if constexpr (LANE) {
            const int e = i & 31;
            wu1 = dw_u1[e]; wr2 = dw_r2[e]; wr3 = dw_r3[e];
            if (RW) wu4 = dw_u4[e];
        }

        // -- open loop: idle threads (NCS, no request bound) wake at the
        // earliest arrival still available (pending, token-admitted)
        long long next_arr = NEVER;
        if constexpr (OPEN) {
            if (mono) {
                while (lowa < R && (rstat[lowa] != PENDING || tok[lowa] != 1))
                    ++lowa;
                next_arr = lowa < R ? arr[lowa] : NEVER;
            } else {
                for (int k = lane; k < R; k += 32) {
                    if (rstat[k] == PENDING && tok[k] == 1
                        && arr[k] < next_arr)
                        next_arr = arr[k];
                }
                next_arr = warp_min(next_arr);
            }
        }
        auto wake = [&](int t) {
            const long long r = ready[t];
            if constexpr (OPEN) {
                const bool idle = pc[t] == NCS && curreq[t] < 0;
                return idle && next_arr > r ? next_arr : r;
            }
            return r;
        };

        // -- tid = argmin over schedulable ready clocks, lowest tid on ties
        long long best;
        int tid;
        if constexpr (!OPEN) {
            // the per-thread keys: a min over this lane's, one redux.sync.
            // The owner-lane body holds that min in a register; the lane-0
            // body reads its keys from the region
            unsigned key = lmin;
            if constexpr (!LANE) {
                for (int t = lane; t < T; t += 32) {
                    const unsigned k = akey[t];
                    key = k < key ? k : key;
                }
            }
            const unsigned kmin = __reduce_min_sync(FULL, key);
            if (kmin != KEY_BELOW && kmin < KEY_OVF) {
                tid = (int)(kmin & tmask);
                best = epoch + (long long)(kmin >> tb) - 1;
            } else if (kmin == KEY_NONE) {
                best = NEVER;              // nothing schedulable: thread 0
                tid = 0;
            } else {
                // a clock beyond the keys' reach, or below their origin:
                // the exact path, then keys from the new earliest clock
                const Pick pk = argmin_exact<OPEN>(ready, act, pc, curreq,
                                                   next_arr, T, lane);
                best = pk.clock;
                tid = pk.tid;
                rekey();
            }
        } else {
            // wake times move with next_arr: one 32-bit key per lane from
            // the clocks (no branch: the loads issue together), one
            // redux.sync
            unsigned key = KEY_NONE;
            bool ovf = false;
#pragma unroll 4
            for (int t = lane; t < T; t += 32) {
                const long long w = wake(t);
                const bool elig = act[t] != 0 && w != NEVER;
                const unsigned long long d =
                    (unsigned long long)w - (unsigned long long)base;
                const bool fits = d <= dmax;
                ovf |= elig && !fits;
                const unsigned k = ((unsigned)d << tb) | (unsigned)t;
                key = elig && fits && k < key ? k : key;
            }
            if (__any_sync(FULL, ovf)) {
                const Pick pk = argmin_exact<OPEN>(ready, act, pc, curreq,
                                                   next_arr, T, lane);
                best = pk.clock;
                tid = pk.tid;
            } else {
                const unsigned kmin = __reduce_min_sync(FULL, key);
                if (kmin == KEY_NONE) {
                    best = NEVER;          // nothing schedulable: thread 0
                    tid = 0;
                } else {
                    tid = (int)(kmin & tmask);
                    best = base + (long long)(kmin >> tb);
                }
            }
        }
        // the selected thread's clock (with nothing schedulable, thread 0's)
        const long long now = best != NEVER ? best : wake(tid);
        if (best != NEVER) base = best;

        // -- open loop: arrival ingestion and dispatch (every lane computes
        // the same uniform values)
        bool step_ok = true;
        if constexpr (OPEN) {
            const bool live = now != NEVER;
            const bool pend_tid = pc[tid] == NCS && curreq[tid] < 0;
            if (!live) {
                // every thread idle and no admitted request pending: no
                // later event can step
                bool idle = true;
                for (int t = lane; t < T; t += 32)
                    idle &= pc[t] == NCS && curreq[t] < 0;
                if (__all_sync(FULL, idle) && next_arr == NEVER) {
                    ev_run = i + 1;
                    idle_for_good = true;
                    break;
                }
                continue;
            }
            // every request with arr <= now joins the wait queue or drops
            // (token reject, or beyond the queue bound: `rank` orders the
            // admitted newcomers so the tail drop is exact)
            int cnt = arrptr;
            if (mono) {
                while (cnt < R && arr[cnt] <= now) ++cnt;
                while (cnt > 0 && arr[cnt - 1] > now) --cnt;
            } else {
                int c = 0;
                for (int k = lane; k < R; k += 32) c += arr[k] <= now;
                cnt = warp_sum(c);
            }
            if (cnt > arrptr) {
                const int tok_base = tokcum[arrptr < R ? arrptr : R - 1];
                int joined = 0;
                for (int k0 = arrptr; k0 < cnt; k0 += 32) {
                    const int k = k0 + lane;
                    if (k < cnt) {
                        const int rank = tokcum[k] - tok_base;
                        if (tok[k] == 1 && rank < qcap[k] - qlen) ++joined;
                        else rstat[k] = DROPPED;
                    }
                }
                qlen += warp_sum(joined);
                __syncwarp();
            }
            arrptr = cnt;
            // the FIFO head: lowest queued slot
            int head = INT_MAX;
            if (mono) {
                while (lowp < R && rstat[lowp] != PENDING) ++lowp;
                head = lowp < arrptr ? lowp : INT_MAX;
            } else {
                for (int k = lane; k < arrptr; k += 32) {
                    if (rstat[k] == PENDING) { head = k; break; }
                }
                head = warp_min(head);
            }
            const bool do_disp = pend_tid && head != INT_MAX;
            __syncwarp();           // every lane has read curreq[tid], rstat
            if (do_disp && lane == 0) {
                rstat[head] = IN_SERVICE;
                curreq[tid] = head;
                a.wq[(size_t)b * R + head] = now - arr[head];
            }
            qlen -= do_disp;
            // an idle thread with nothing to take makes no machine step
            step_ok = !pend_tid || do_disp;
        }

        // the step of thread tid: on its owner lane (owner-lane body), else
        // on lane 0
        if ((LANE ? lane == (tid & 31) : lane == 0) && step_ok) {
            // everything the step may read about thread tid, loaded at once
            const int p = pc[tid];
            const int me = tid + 1;
            const int mynode = tn[tid];
            const int k = tgt[tid];
            const int c = coh[tid];
            const int lk = lkop[tid];
            const long long ost = opst[tid];
            const bool tid_act = act[tid] != 0;
            // owner-lane body: what the NCS arm and the completion
            // accounting read, with the rest (the lane-0 body reads it
            // where it is used)
            float loc_t = 0.f, rfr_t = 0.f;
            int done_t = 0, pos = lat_pos;
            if constexpr (LANE) {
                loc_t = loc[tid];
                if (RW) rfr_t = rfr[tid];
                done_t = done[tid];
                pos = *ringpos;
            }
            // the lock op's cost, fixed at the NCS draw (lock_op): its RNIC
            // pair and busy clock, and this thread's CPU-side costs
            const int2* ct2 = reinterpret_cast<const int2*>(ct);
            const int lnode = lk >> 3;
            const int2 lk_sw = ct2[lnode * (CT_PER_NODE / 2)
                                   + ((lk & 7) == OP_LOOP ? 1 : 0)];
            const long long lk_bz = busy[lnode];
            const int2 cpu01 = ct2[mynode * (CT_PER_NODE / 2) + CT_CPU / 2];
            const int2 cpu23 = ct2[mynode * (CT_PER_NODE / 2) + CT_CPU / 2
                                   + 1];
            int code = OP_LOCAL, tnode = 0, newpc = p;
            bool peer = false;

            // a write to a peer thread's descriptor: by the peer's node
            auto lock_cost = [&]() { code = lk & 7; tnode = lnode; };
            auto tiered = [&](int node) {
                return node == mynode ? OP_LOCAL
                     : (rack[node] == rack[mynode] ? OP_LOOP : OP_RDMA);
            };
            auto peer_cost = [&](int who) {
                const int node = tn[who];
                if (HL) code = tiered(node);
                else if (FAM) code = node == mynode ? OP_LOCAL : OP_RDMA;
                else code = node == mynode ? OP_LOOP : OP_RDMA;
                tnode = node;
                peer = true;
            };
            unsigned short* tail = FAM ? (c == 0 ? t0 : t1) : t0;

            switch (p) {
            case NCS: {
                // workload draw: own node with probability locality, else
                // a uniform remote node; a Zipf-ranked lock within it
                const int e = i & 31;
                const bool go_local = (LANE ? wu1 : dw_u1[e])
                                    < (LANE ? loc_t : loc[tid]);
                // the remote offset is drawn in [0, N - 1), so one
                // subtraction is the modulo
                const int x = mynode + 1 + (LANE ? wr2 : dw_r2[e]);
                const int other = (unsigned)x < 2u * (unsigned)N
                                ? (x >= N ? x - N : x) : x % N;
                const int node = go_local ? mynode : other;
                int first;
                if (RW) first = (LANE ? wu4 : dw_u4[e])
                              < (LANE ? rfr_t : rfr[tid]) ? RD_TRY : SWAP;
                else first = SPIN ? SL_CAS : SWAP;
                nops += 1;
                if (RW) nreads += first == RD_TRY;
                bud[tid] = -1;
                nxt[tid] = 0;
                const int nk = node * kpn + (LANE ? wr3 : dw_r3[e]);
                tgt[tid] = nk;
                const int nc = HL ? (rack[node] != rack[mynode])
                                  : (node != mynode);
                coh[tid] = nc;
                const int nnode = ln[nk];
                int lcode;
                if (HL) lcode = tiered(nnode);
                else if (FAM) lcode = nc == 0 ? OP_LOCAL : OP_RDMA;
                else lcode = nnode == mynode ? OP_LOOP : OP_RDMA;
                lkop[tid] = lcode | (nnode << 3);
                if (HL) nloop += lcode == OP_LOOP;
                newpc = first;
                code = OP_THINK;
                break;
            }
            case SWAP: {
                const int prev = tail[k];
                tail[k] = (unsigned short)me;
                prv[tid] = prev;
                if (FAM) {
                    if (prev == 0) bud[tid] = c == 0 ? binit0 : binit1;
                    newpc = prev == 0 ? SET_VICTIM : WRITE_NEXT;
                } else {
                    newpc = prev == 0 ? CS : WRITE_NEXT;
                }
                lock_cost();
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
                vic[k] = (unsigned short)c;
                newpc = p == SET_VICTIM ? PET_WAIT : PET_WAIT_R;
                lock_cost();
                break;
            }
            case PET_WAIT:
            case PET_WAIT_R: {
                const int other_tail = c == 0 ? t1[k] : t0[k];
                const bool can = other_tail == 0 || vic[k] != c;
                if (p == PET_WAIT_R && can)
                    bud[tid] = c == 0 ? binit0 : binit1;
                newpc = can ? ENTER_CS : p;
                lock_cost();
                break;
            }
            case CS:
                newpc = SPIN ? SL_REL : REL_CAS;
                code = OP_CS;
                break;
            case REL_CAS: {
                const bool solo = tail[k] == me;
                if (solo) tail[k] = 0;
                newpc = solo ? NCS : SPIN_NEXT;
                lock_cost();
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
                const bool free_ = t0[k] == 0;
                if (free_) t0[k] = (unsigned short)me;
                newpc = free_ ? CS : SL_CAS;
                lock_cost();
                break;
            }
            case SL_REL: {
                t0[k] = 0;
                newpc = NCS;
                lock_cost();
                break;
            }
            // reader-writer ALock only; the reader count lives in `wrd`
            case RD_TRY: {
                const bool can = t0[k] == 0 && t1[k] == 0;
                if (can) wrd[k] += 1;
                newpc = can ? RD_CS : RD_TRY;
                lock_cost();
                break;
            }
            case RD_CS:
                newpc = RD_REL;
                code = OP_CS;
                break;
            case RD_REL: {
                wrd[k] -= 1;
                newpc = NCS;
                lock_cost();
                break;
            }
            case WR_DRAIN: {
                const bool can = wrd[k] == 0;
                newpc = can ? CS : WR_DRAIN;
                lock_cost();
                break;
            }
            default:
                break;
            }
            pc[tid] = newpc;

            // -- cost application: svc/wire scale by the target card's
            // node, plain CPU-side ops by the calling thread's node (both
            // staged, already scaled) -----------------------------------
            long long new_ready;
            if (code == OP_RDMA || code == OP_LOOP) {
                const int2 sw = peer ? ct2[tnode * (CT_PER_NODE / 2)
                                           + (code == OP_LOOP ? 1 : 0)]
                                     : lk_sw;
                const long long bz = peer ? busy[tnode] : lk_bz;
                const long long fin = (now > bz ? now : bz) + sw.x;
                busy[tnode] = fin;
                new_ready = fin + sw.y;
            } else {
                const int dt = code == OP_LOCAL ? cpu01.x
                             : code == OP_POLL ? cpu01.y
                             : code == OP_CS ? cpu23.x : cpu23.y;
                new_ready = now + dt;
            }
            // what the next event's argmin reads, first
            ready[tid] = new_ready;
            if constexpr (LANE) {
                // the new key into its slot, and this lane's least key
                const unsigned nk = tid_act ? pack(tid, new_ready) : KEY_NONE;
                const int s = tid >> 5;
#pragma unroll
                for (int j = 0; j < LANE_SLOTS; ++j)
                    kr[j] = j == s ? nk : kr[j];
                lmin = slot_min(kr);
            } else if constexpr (!OPEN) {
                akey[tid] = tid_act ? pack(tid, new_ready) : KEY_NONE;
            }

            // -- completion accounting: the latency reads op_start before
            // this event re-stamps it -------------------------------------
            const bool rel = p == REL_CAS || p == PASS || p == SL_REL
                          || (RW && p == RD_REL);
            if (rel && newpc == NCS) {
                lat[pos] = now - ost;
                pos = pos + 1 == a.lat_samples ? 0 : pos + 1;
                if constexpr (LANE) *ringpos = pos; else lat_pos = pos;
                lat_n += 1;
                done[tid] = (LANE ? done_t : done[tid]) + 1;
                if constexpr (OPEN) {
                    // departure: the finishing release frees the thread
                    // and stamps the request's sojourn at the step's
                    // completion time
                    const int rq = curreq[tid];
                    if (rq >= 0) {
                        a.soj[(size_t)b * R + rq] = new_ready - arr[rq];
                        rstat[rq] = COMPLETED;
                        curreq[tid] = -1;
                    }
                }
            }
            if (p == NCS) opst[tid] = new_ready;
            nreacq += (p == SPIN_BUDGET && newpc == SET_VICTIM_R);
            npass += (p == PASS);
        }
        __syncwarp();
      }
    }
    // a replica that fell idle for good: only the remaining phase
    // boundaries' rejoin bumps can still move a clock
    while (next_edge < a.n_events) boundary(next_edge);

    long long tmax = LLONG_MIN;
    for (int t = lane; t < T; t += 32) {
        tmax = ready[t] > tmax ? ready[t] : tmax;
        a.done[(size_t)b * T + t] = done[t];
    }
    for (int off = 16; off > 0; off >>= 1) {
        const long long o = __shfl_xor_sync(FULL, tmax, off);
        tmax = o > tmax ? o : tmax;
    }
    lat_n = warp_sum(lat_n);
    nreacq = warp_sum(nreacq);
    npass = warp_sum(npass);
    nops = warp_sum(nops);
    nreads = warp_sum(nreads);
    nloop = warp_sum(nloop);
    if (lane == 0) {
        a.lat_n[b] = lat_n;
        a.t_end[b] = tmax;
        a.nreacq[b] = nreacq;
        a.npass[b] = npass;
        if (a.diag) {
            int* d = a.diag + 5 * (size_t)b;
            d[0] = ev_run;
            d[1] = OPEN && mono;
            d[2] = nops;
            d[3] = nreads;
            d[4] = nloop;
        }
    }
    if constexpr (OPEN) {
        for (int k = lane; k < R; k += 32)
            a.rstat[(size_t)b * R + k] = rstat[k];
    }
}

// (at least one block an SM: ptxas may then give a thread more than 64
// registers, and the per-event loop keeps its pointers, tid and, in the
// owner-lane body, its slot keys in them)
template <int ALG, bool OPEN>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
event_loop_kernel(const Args a) {
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.x * a.W + warp;
    if (b >= a.B) return;                 // the tail block's idle warps
    if constexpr (!OPEN) {
        if (a.T <= 32 * LANE_SLOTS) {
            replica<ALG, false, true>(a, warp, b);
            return;
        }
    }
    replica<ALG, OPEN, false>(a, warp, b);
}

template <int ALG, bool OPEN>
cudaError_t launch(Args a, cudaStream_t stream) {
    a.stride = region_stride(
        smem_bytes(ALG, a.T, a.N, a.K, a.P, OPEN ? a.R : 0));
    const size_t smem = a.stride * (size_t)a.W;
    if (a.W < 1 || a.W > MAX_WARPS || smem > SMEM_LIMIT)
        return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        event_loop_kernel<ALG, OPEN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int grid = (a.B + a.W - 1) / a.W;
    event_loop_kernel<ALG, OPEN><<<grid, 32 * a.W, smem, stream>>>(a);
    return cudaGetLastError();
}

template <bool OPEN>
cudaError_t launch_alg(int alg, const Args& a, cudaStream_t s) {
    switch (alg) {
    case ALG_ALOCK: return launch<ALG_ALOCK, OPEN>(a, s);
    case ALG_MCS: return launch<ALG_MCS, OPEN>(a, s);
    case ALG_SPINLOCK: return launch<ALG_SPINLOCK, OPEN>(a, s);
    case ALG_HLOCK: return launch<ALG_HLOCK, OPEN>(a, s);
    case ALG_ALOCK_RW: return launch<ALG_ALOCK_RW, OPEN>(a, s);
    default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Dynamic shared memory one replica's region needs, in bytes (the wrapper
// prices the same table in Python before it launches).
int event_loop_smem_bytes(int alg, int T, int N, int K, int P, int R) {
    if (alg < 0 || alg >= ALG_COUNT || R < 0) return -1;
    return (int)smem_bytes(alg, T, N, K, P, R);
}

// Dynamic shared memory of one block of W replicas (regions rounded up to
// 16 bytes), in bytes.
int event_loop_block_bytes(int alg, int T, int N, int K, int P, int R,
                           int W) {
    if (alg < 0 || alg >= ALG_COUNT || R < 0 || W < 1) return -1;
    return (int)(region_stride(smem_bytes(alg, T, N, K, P, R)) * W);
}

const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Enqueue the event loop for B replicas, W to a block, on `stream`; does
// not synchronise and allocates nothing. `diag` may be null. Returns the
// cudaError_t of the launch (0 = ok).
int event_loop_launch(
    int alg,
    const void* u1, const void* r2, const void* r3, const void* u4,
    const void* edges, const void* think, const void* locality,
    const void* read_frac, const void* active, const void* b_init,
    const void* cost_rows, const void* node_mult, const void* thread_node,
    const void* lock_node, const void* rack,
    void* done, void* lat, void* lat_n, void* t_end, void* nreacq,
    void* npass,
    const void* arr, const void* tok, const void* tokcum, const void* qcap,
    void* wq, void* soj, void* rstat, void* diag,
    int B, int W, int T, int N, int K, int P, int R, int n_events,
    int lat_samples, void* stream) {
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
    a.arr = (const long long*)arr; a.tok = (const int*)tok;
    a.tokcum = (const int*)tokcum; a.qcap = (const int*)qcap;
    a.wq = (long long*)wq; a.soj = (long long*)soj; a.rstat = (int*)rstat;
    a.diag = (int*)diag;
    a.B = B; a.W = W; a.T = T; a.N = N; a.K = K; a.P = P; a.R = R;
    a.n_events = n_events; a.lat_samples = lat_samples;
    a.stride = 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (R < 0 || B < 1) return (int)cudaErrorInvalidValue;
    return (int)(R > 0 ? launch_alg<true>(alg, a, s)
                       : launch_alg<false>(alg, a, s));
}

}  // extern "C"
