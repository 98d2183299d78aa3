// Dependent-chain latencies of one SM, in cycles: the constants behind the
// latency term of chip_smoke.py::k1_bound. Built and run by
// scripts/torch_sm_latency.py (nvcc, sm_90a); prints one JSON object.
//
// Each probe runs one warp on one SM and times, with clock64(), a chain of
// CHAIN operations in which every operation needs the previous one's
// result, then divides by CHAIN:
//   lds_indexed  x = s[x] in shared memory (the load and its address add)
//   ldg_l1       x = g[x] in device memory, a 4 KB ring already in L1
//   alu          x = (x ^ a) + b, two dependent 32-bit integer operations
//   redux        x = __reduce_min_sync(all, x + lane), the 32-bit warp min
//   shfl         x = __shfl_xor_sync(all, x + lane, 1), shuffle and add
//   sts_lds      s[i] = x; x = s[i], a store the next load must see
//   bfly32       a five-level shuffle butterfly of 32-bit minima (per
//                butterfly, not per operation)
//   bfly64       a five-level butterfly of (64-bit clock, index) pairs,
//                lowest index on ties, three shuffles a level (per
//                butterfly)
// The SM clock is clock64() cycles over the CUDA-event time of one long
// chain.
#include <cstdio>
#include <cuda_runtime.h>

constexpr int CHAIN = 4096;
constexpr int RING = 1024;
constexpr int BFLY = 256;
constexpr unsigned FULL = 0xffffffffu;

__global__ void probe(const int* g, int* out, long long* cyc, int a, int b) {
    __shared__ int s[RING];
    const int lane = threadIdx.x;
    for (int i = lane; i < RING; i += 32) s[i] = (i + 1) % RING;
    __syncwarp();
    int x = 0;
    // warm the L1 ring
    for (int i = 0; i < RING; ++i) x = g[x];
    long long t0, t1;

    t0 = clock64();
#pragma unroll 64
    for (int i = 0; i < CHAIN; ++i) x = s[x];
    t1 = clock64();
    cyc[0] = t1 - t0;

    t0 = clock64();
#pragma unroll 64
    for (int i = 0; i < CHAIN; ++i) x = g[x];
    t1 = clock64();
    cyc[1] = t1 - t0;

    t0 = clock64();
#pragma unroll 64
    for (int i = 0; i < CHAIN / 2; ++i) x = (x ^ a) + b;
    t1 = clock64();
    cyc[2] = t1 - t0;

    t0 = clock64();
#pragma unroll 64
    for (int i = 0; i < CHAIN; ++i)
        x = (int)__reduce_min_sync(FULL, (unsigned)(x + lane));
    t1 = clock64();
    cyc[3] = t1 - t0;

    t0 = clock64();
#pragma unroll 64
    for (int i = 0; i < CHAIN; ++i) x = __shfl_xor_sync(FULL, x + lane, 1);
    t1 = clock64();
    cyc[4] = t1 - t0;

    volatile int* vs = s;
    t0 = clock64();
#pragma unroll 64
    for (int i = 0; i < CHAIN; ++i) {
        vs[lane] = x + 1;
        x = vs[lane] & (RING - 1);
    }
    t1 = clock64();
    cyc[5] = t1 - t0;

    t0 = clock64();
    for (int i = 0; i < BFLY; ++i) {
        int v = x + lane;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const int o = __shfl_xor_sync(FULL, v, off);
            v = o < v ? o : v;
        }
        x = v;
    }
    t1 = clock64();
    cyc[6] = t1 - t0;

    long long best = (long long)x << 20;
    int tid = lane;
    t0 = clock64();
    for (int i = 0; i < BFLY; ++i) {
        best += lane;
        tid ^= lane;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const long long ob = __shfl_xor_sync(FULL, best, off);
            const int ot = __shfl_xor_sync(FULL, tid, off);
            if (ob < best || (ob == best && ot < tid)) { best = ob; tid = ot; }
        }
    }
    t1 = clock64();
    cyc[7] = t1 - t0;
    out[lane] = x + (int)best + tid;
}

__global__ void clocked(const int* g, int* out, long long* cyc, int n) {
    __shared__ int s[RING];
    for (int i = threadIdx.x; i < RING; i += 32) s[i] = (i + 1) % RING;
    __syncwarp();
    int x = 0;
    const long long t0 = clock64();
    for (int i = 0; i < n; ++i) x = s[x];
    cyc[0] = clock64() - t0;
    out[threadIdx.x] = x;
}

int main() {
    int *g, *out;
    long long* cyc;
    cudaMalloc(&g, RING * sizeof(int));
    cudaMalloc(&out, 32 * sizeof(int));
    cudaMalloc(&cyc, 8 * sizeof(long long));
    int h[RING];
    for (int i = 0; i < RING; ++i) h[i] = (i + 1) % RING;
    cudaMemcpy(g, h, sizeof(h), cudaMemcpyHostToDevice);
    long long c[8];
    double best[8] = {1e30, 1e30, 1e30, 1e30, 1e30, 1e30, 1e30, 1e30};
    for (int rep = 0; rep < 5; ++rep) {
        probe<<<1, 32>>>(g, out, cyc, 0x5bd1e995, 7);
        cudaMemcpy(c, cyc, 8 * sizeof(long long), cudaMemcpyDeviceToHost);
        const double per[8] = {c[0] / (double)CHAIN, c[1] / (double)CHAIN,
                               c[2] / (double)CHAIN, c[3] / (double)CHAIN,
                               c[4] / (double)CHAIN, c[5] / (double)CHAIN,
                               c[6] / (double)BFLY, c[7] / (double)BFLY};
        for (int k = 0; k < 8; ++k) best[k] = per[k] < best[k] ? per[k]
                                                                 : best[k];
    }
    // the SM clock under a long chain: cycles over event time
    const int n = 1 << 24;
    clocked<<<1, 32>>>(g, out, cyc, 1024);        // warm-up
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    cudaEventRecord(e0);
    clocked<<<1, 32>>>(g, out, cyc, n);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, e0, e1);
    cudaMemcpy(c, cyc, sizeof(long long), cudaMemcpyDeviceToHost);
    const cudaError_t err = cudaGetLastError();
    printf("{\"cuda_error\": \"%s\", \"chain\": %d, \"cycles_per_op\": "
           "{\"lds_indexed\": %.3f, \"ldg_l1\": %.3f, \"alu\": %.3f, "
           "\"redux\": %.3f, \"shfl\": %.3f, \"sts_lds\": %.3f}, "
           "\"cycles_per_butterfly\": {\"bfly32\": %.3f, \"bfly64\": %.3f}, "
           "\"clock_chain_cycles\": %lld, \"clock_chain_ms\": %.6f, "
           "\"sm_clock_mhz\": %.3f}\n",
           cudaGetErrorString(err), CHAIN, best[0], best[1], best[2],
           best[3], best[4], best[5], best[6], best[7], c[0], ms,
           c[0] / (ms * 1e3));
    return err == cudaSuccess ? 0 : 1;
}
