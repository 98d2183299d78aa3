#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA GPU (written for an H100, sm_90a), ``nvcc`` and the
repository's ``src/`` beside this file; needs no network and no JAX.
Without a CUDA device it exits non-zero and prints no result — it never
runs on the CPU.

It builds every kernel library the wrappers declare (``_build.declared()``:
the seven sources of ``src/repro_torch/csrc``; one ``nvcc`` per source, all
started together), then prints one JSON object per phase:

  device      card name and power limit (``nvidia-smi``), torch/CUDA versions,
              and that TF32 is off for the plain versions' f32 matmuls
  build       seconds, and ``nvcc`` seconds per library
  prng        the draw stream on the card equals the one made on the CPU,
              and so does the lock-property path's shaped schedule stream
              (``alock_tick.ops.schedule``) at three shapes x seeds {0, 1,
              7, 2**31-1}, whole and drawn in slabs of rows
  draw_stream  the draw-stream kernel (``csrc/draw_stream.cu``) equals its
              plain version on the card (``torch.equal``; tolerance zero)
              for rw x P {1, 3} x N {1, 2, 20} x kpn {1, 50, 200} at seeds
              {0, 1, 7, 2**31-1} and 2,047 events, one replica, and the
              widest Fig. 5 bucket (B = 96, 150,000 events) by digest, one
              launch each; its time there against ``draw_bound`` and the
              plain route's
  traffic_plan  the open loop's arrival plan (gaps, token-admit mask, its
              prefix count, queue bounds, arrival times) made on the card
              equals the one made on the CPU, and the arrival-plan kernel
              (``csrc/arrival_plan.cu``, one launch a case) equals both:
              seeds {0, 1, 7, 2**31-1} x the ramp rates, a token policy and
              burst-storm's phased rates; then at ``open-ramp``'s alock
              bucket (B = 192, R = 256) the kernel's time against
              ``plan_bound`` and the plain route's
  kernel_check  the CUDA kernel equals its plain PyTorch version on the card
              (``torch.equal`` on all six outputs; tolerance zero) for every
              algorithm, single-phase and phased (churn + fail-slow
              multipliers), at T = 16, 4 seeds a workload, launched as the
              planner chooses and with 1 and 3 replicas per block (a tail
              block of 1 or 2), the C and Python shared-memory tables
              compared; then every algorithm at the closed loop's other
              shapes (``LANE_CASES``), with the ``diag``, at 1 and 3
              replicas per block: T = 240 (all eight slots of the
              owner-lane body), T = 40 (slots partly filled), T = 288 (the
              lane-0 body past 256 threads) and T = 240 with a think time
              beyond the packed keys' 24-bit reach (the exact argmin and
              the rekey); then at the main path's widest bucket shape (T =
              160, N = 20, K = 1000, B = 96) with the event count cut for
              the plain version's sake, where both are timed (and 1 and 5
              replicas per block checked)
  kernel_check_open  the same for the open loop (all ten outputs): every
              algorithm x {open-loop-ramp at 8 req/us with queue bound 32,
              burst-storm's token policy} at the registry's topology (4 x 4
              threads, 16 locks, R = 256), 1,500 events, which path each
              replica took (``diag``); a negative control of the pointer
              path (one replica's arrival times fall once: it must take the
              exact scans and still agree); replicas that fall idle for
              good before a node rejoins (the loop stops, the rejoin bump
              still applies); then the alock open-loop-ramp bucket (B =
              192), timed, events cut for the plain version
  k1_path_shapes  K1 at both path shapes at full depth: time (closed: alock,
              and mcs and spinlock at the same bucket), shared-memory
              plan, the C and Python tables, the bytes, operations and
              latency bounds and which binds, the events the open loop's
              data needs (``diag``); and each K1 instantiation's registers
              and spill bytes (the library's ptxas report; fails on a
              spill)
  rw_ycsb     the widest bucket of the benchmark's reader-writer lock table
              (``simbench/configs/ycsb-rw-1000.json``: alock-rw, T = 160,
              N = 20, K = 1,000, Zipf 0.99, YCSB A, B and C x 32 seeds, B =
              96), packed as ``sweep`` packs it: at 3,000 events the
              kernels (the draw kernel, then K1 with a five-column
              ``diag``) against the plain route (plain draws, plain engine),
              ``torch.equal`` on the four draw streams, the six outputs and
              the counts of lock operations begun and begun shared; then
              K1 alone at 150,000 events over 3 launches after a warm-up,
              with its bound, the RW draw kernel's time, and each mix's
              share of operations begun shared
  rack_churn  the bucket of the benchmark's hierarchical rack lock under
              node churn (``simbench/configs/rack-churn-20n.json``: hlock,
              T = 160, N = 20, K = 1,000, two rack layouts, steady and with
              node 3 parked for the middle 40 % of the events, x 32 seeds,
              B = 384, padded to three phases), packed as ``sweep`` packs
              it: at 3,000 events the draw kernel and K1 with its
              five-column ``diag`` against the plain route; then K1 alone
              at 150,000 events on the two-rack churn workloads (B = 96)
              and on the whole bucket, with bounds, each workload's share
              of lock operations begun on the loopback tier, and alock's K1
              at the widest Fig. 5 bucket in the same process; callable
              alone as ``chip_smoke.rack_churn_phase(torch, dev)``
  golden      the kernel's outputs for six full-width replicas equal the
              digests the JAX reference wrote to
              ``tests/golden/torch_fig5_full.json``
  golden_open the kernel's open-loop outputs at full depth (150,000 events)
              equal ``tests/golden/torch_open_loop_full.json``
  golden_algs the registry's read-heavy (alock-rw), rack-locality (hlock),
              limping-node (node_mult) and node-churn (phases) workloads,
              seeds 0 and 1, 150,000 events, one launch per algorithm,
              equal ``tests/golden/torch_algs_full.json``
  main_path   the paper's Fig. 5 grid (89 labelled workloads, 32 seeds,
              150,000 events each) through ``Experiment.run()`` with the
              default device and backend (every bucket issued before any
              is forced); launch counters are set to 0 just before and read
              just after (one K1 and one draw-kernel launch a bucket, no
              arrival-plan launch);
              then the same grid one bucket at a time
              (``batch.IN_FLIGHT_SHARE = 0``), every replica's outputs
              compared by digest
  main_path_open  ``run_scenario("open-loop-ramp")`` and ``("burst-storm")``
              at 32 seeds x 150,000 events with the default device and
              backend, counters set to 0 just before each and read just
              after: launches (one K1, draw-kernel and arrival-plan launch
              a bucket), seconds by stage, events/s, knee rows
  sharded     the Fig. 5 grid again through the sharded layouts:
              ``Experiment.run()`` with ``ExecOptions(devices=1, chunk=32)``
              and ``chunk=40`` (a trimmed trailing superchunk in every
              bucket), and ``sweep(devices=[cuda:0, cuda:0])`` (two shards
              a bucket on the one card); counters set to 0 just before each
              and read just after: every replica's outputs equal
              main_path's (by digest), dispatches equal the sum over the 33
              buckets of popcount(units), one K1 and one draw-kernel
              launch a shard; wall, seconds
              by stage and peak device memory of each
  pairs       ``run_events_pairs`` (the hi/lo int32 output contract) by the
              kernel at the widest Fig. 5 bucket (events cut to 3,000) and
              at the alock open-loop-ramp bucket (1,500 events), one launch
              each: ``i32pair.pack`` of its pairs equals ``run_events``
              (``torch.equal``), and its pairs equal the plain version's
  coord_stress  ``run_scenario("coord-stress", n_seeds=2, n_events=30000)``
              with the default options (host threads only) twice: rows,
              seconds, and the fields the seed fixes equal in both runs
  kernel_check_attention  K3 (forward), K4 (dq) and K5 (dk, dv) against
              their plain versions on the card, f32 and bf16, every mask
              case (causal or not, with or without a window), at the test
              shapes (K3: B=2, H=2, S=256, hd=128; K4/K5: B=2, H=2, S=64,
              hd=16) and the path shape (B=2, H=16, S=2048, hd=128), plus
              ragged tiles, an hd whose rows are not 16-byte aligned and
              (K3) an S that is a multiple of neither its q tile nor a kv
              stage, both dtypes; tolerances in ``ATT_TOL``
  tensor_cores  each K3, K4, K5 and K6 instantiation (K3-K5: kernel x
              dtype x padded hd, 18; K6: the path shape's unguarded one and
              the guarded one, 2; 20 in all): its route (wgmma for bf16,
              3xTF32 mma.sync for f32), registers and spill bytes from this
              build's ``-Xptxas -v``, and its HGMMA / HMMA count in
              ``cuobjdump --dump-sass``; fails on a spill or a missing
              tensor-core instruction
  kernel_check_ssd  K6 against its plain version, and ``ssd_forward``
              against the exact recurrence ``ssd_sequential``, at the
              reference tests' shapes, the path shape (B=2, S=2048, H=16,
              P=64, N=128, chunk 128), H = 6 (no multiple of the path's
              head tile; also at tiles of 2, 3 and 6 heads, bit for bit the
              plan's), chunk 64 and rows that are not 16-byte aligned,
              2e-4; the C and Python shared-memory sizes of each plan; a
              negative control (one element of b changed)
  float_timings  K3-K6, their plain versions and
              ``scaled_dot_product_attention`` forward and backward (the
              yardstick; nothing in the port calls it), CUDA events over 3
              calls after a warm-up (K6 and its plain version over
              ``SSD_REPS``), with each kernel's bound, at the test and path
              shapes (attention also in bf16), K4 + K5 as one
              ``flash_attention_bwd`` call against the SDPA backward, and
              ``ssd_forward`` whole at the path shape (its glue: the whole
              less K6)
  exemplar_path  ``mha_vjp`` forward and ``.backward()`` and ``ssd_forward``
              at the path shape with the default device and backend, launch
              counters set to 0 just before and read just after (K3, K4,
              K5 and K6 once each), outputs held against a plain run
  kernel_check_tick  K2 against its plain version on the card,
              ``torch.equal`` on all six outputs. Schedule given (mode a,
              ``alock_tick``): the reference tests' shapes (one padded),
              per-table cohorts under four budget pairs, mid-run state,
              out-of-range schedule entries, T = 100, and a negative control
              (one schedule entry changed). Schedule drawn in the kernel
              (mode b, ``tick_drawn``) against ``ops.schedule`` + the plain
              version: seeds {0, 1, 7, 2**31-1} x T in {3, 5, 16, 100},
              mid-run state, rows of a (30000, 150000) draw whose counters
              pass 2**32, and a negative control (one key word flipped).
              The path shape with the steps cut, both modes timed; the C and
              Python shared-memory tables of the plans
  schedule_gen  the schedule K2 draws, written out by a draw-only launch,
              equals ``ops.schedule`` bit for bit at the prng phase's three
              shapes x four seeds, and ``prng.randint(rows=)`` past 2**32
  golden_tick the path shape (4,096 tables x 16 threads x 150,000 steps)
              at full depth: the schedule's SHA-256, and K2's six outputs'
              SHA-256, ``in_cs_frac`` and the pc histogram in both modes,
              equal ``tests/golden/torch_tick_full.json`` (the JAX
              reference's)
  schedule_check  ``run_schedule`` for all five algorithms on the card equals
              the same call on the CPU, trace and final state
  main_path_tick  ``monte_carlo_cs_entries`` at the path shape with the
              default device and backend, K2's counter set to 0 just before
              and read just after: one launch, drawing its schedule (no
              (tables, steps) schedule allocated: peak device memory below
              its size), seconds by stage, table-steps per second, the two
              statistics equal to the golden's
  analysis    ``repro_torch.analysis.__main__.main`` in process: ``--strict
              --device cuda`` (every rule, with the card legs: S001's C and
              Python shared-memory bytes at every registry bucket and K2-K6
              launch shape and the card's opt-in limit, R004's key of the
              live ``nvcc`` in every loaded library's name, X001 through
              K1), ``--selftest`` and ``--imports``; each exit code, the
              findings, the legs, the per-shape bytes and the ``nvcc``
              version. The kernel_check phases' C vs Python tables go
              through the same S001 function
  kernels     the per-kernel record (K1 closed and open, K2, K3-K6): launches
              on each main path, largest deviation from the plain version,
              times, the roofline bound and the library call's time (K1 and
              K2: also the latency bound and which of the three binds; K2
              in both modes)

and, last, the card's ``nvidia-smi`` line and ``{"ok": true, "device":
{...}}``. Any phase that fails raises, and the run exits non-zero.
"""
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

from simbench.peaks import (HBM_BYTES_PER_S, INT32_OPS_PER_S, N_SM,
                            RANDINT_OPS, SM_CLOCK_HZ, STEP_OPS,
                            THREEFRY_CALLS, THREEFRY_OPS, UNIFORM_OPS)

HERE = os.path.dirname(os.path.abspath(__file__))

# the paper-scale Fig. 5 grid
GRID_NODES = (5, 10, 20)
LOCKS = (20, 100, 1000)
LOCALITY = (0.85, 0.95, 1.0)
TPN = 8
FIG5_ALGS = ("alock", "spinlock", "mcs")
SCALING_TPN = (2, 4, 8, 12)
N_EVENTS = 150_000
N_SEEDS = 32
#: the closed loop's shapes besides T = 16 that kernel_check holds every
#: algorithm to the plain version at: name -> (nodes, threads a node,
#: locks, think multiplier). T = 240 is the thread-scaling strip's widest
#: (20 x 12); a think of 100,000 x 300 ns = 30 ms passes the packed keys'
#: reach at T = 240 (2**24 ns), so the exact argmin and the rekey run
LANE_CASES = {"T240_all_slots": (20, 12, 20, "default"),
              "T40_slots_partly_filled": (5, 8, 20, "default"),
              "T288_lane0_body": (24, 12, 48, "default"),
              "T240_key_overflow": (20, 12, 20, 100_000.0)}
# the scenario registry's open-loop cells
OPEN_SCENARIOS = ("open-loop-ramp", "burst-storm")
OPEN_EV_CHECK = 1500
PLAN_SEEDS = (0, 1, 7, 2**31 - 1)

# the float kernels' shapes. Test shape: the largest the reference's own
# tests give each kernel (tests/test_sim_and_kernels.py); path shape: the
# width the kernels' sources were written for (flash_attention/kernel.py:
# 5-7, hd = 128 with 256-wide tiles; ssd_scan/kernel.py:9-10, L = 128,
# P = 64, N = 128). `window` is the shape's sliding-window mask case.
ATT_FWD_TEST = dict(B=2, H=2, S=256, hd=128, window=32)    # K3
ATT_BWD_TEST = dict(B=2, H=2, S=64, hd=16, window=16)      # K4, K5
ATT_PATH = dict(B=2, H=16, S=2048, hd=128, window=256)
SSD_TEST = dict(B=2, S=128, H=2, P=32, N=16, L=32)
SSD_PATH = dict(B=2, S=2048, H=16, P=64, N=128, L=128)
#: tolerance of kernel vs plain version on the card. f32 at the test
#: shapes is the reference tests' 2e-5; at the path shape each output sums
#: over up to 2,048 keys (and dk, dv over 2,048 queries) in another order
#: than the plain version's matmuls, so 1e-4; bf16 outputs 2e-2; SSD 2e-4.
ATT_TOL = {"test": 2e-5, "path": 1e-4, "bf16": 2e-2}
SSD_TOL = 2e-4
#: calls K6, its plain version and ssd_forward are timed over
SSD_REPS = 20

# the lock-property path: monte_carlo_cs_entries at Fig. 5's 8 threads per
# node (8 local + 8 remote), 4,096 single-lock tables, the simulator's
# per-replica depth of 150,000 steps, the paper's budgets (5, 20), seed 0
TICK_PATH = dict(tables=4096, T=16, steps=150_000)
TICK_COHORTS = (0,) * 8 + (1,) * 8
TICK_B_INIT = (5, 20)
#: steps of the path shape at which the plain version is timed
TICK_STEPS_CUT = 2000
#: scalar operations one ALock step needs: read the scheduled thread and
#: range-check it, read its cohort and pc, pick the cohort's tail, decide
#: the class, the class's read-compare-write, write the pc and the tail back
TICK_STEP_OPS = 10
#: integer instructions of one remainder by the launch's span through its
#: magic: multiply-high, subtract, shift, add, shift, multiply-subtract
MOD_OPS = 6
#: the draw kernel's cases against its plain version: seeds, events (not a
#: multiple of its 1,024-event block), and the grid of rw x P x N x kpn
DRAW_SEEDS = (0, 1, 7, 2**31 - 1)
DRAW_EVENTS = 2047
DRAW_GRID = dict(rw=(False, True), P=(1, 3), N=(1, 2, 20), kpn=(1, 50, 200))
#: launches the draw kernel is timed over at the widest Fig. 5 bucket
DRAW_REPS = 10
#: the arrival plan's f32 operations a request besides its two hashes
#: (fold_in, then the uniform's bits): XLA's log1p, both branches (~32 for
#: the log, ~22 for the rational one), the scaling, rounding and the add
#: (4), the phase resolve and the token step (~8)
PLAN_F32_OPS = 66
#: dependent operations of one step of the token bucket's credit chain:
#: the refill FMA, the min with the burst, the compare, the debit's select
PLAN_STEP_OPS = 4
#: launches the arrival-plan kernel is timed over at the open-ramp bucket
PLAN_REPS = 50
#: the benchmark's reader-writer lock table under YCSB A, B and C: its
#: widest bucket, the job seed its workloads take, and the event count at
#: which the kernels are held against the plain route
RW_CONFIG = os.path.join(HERE, "simbench", "configs", "ycsb-rw-1000.json")
RW_SEED = 26
RW_EV_CUT = 3000
#: the benchmark's hierarchical rack lock under node churn
RACK_CONFIG = os.path.join(HERE, "simbench", "configs", "rack-churn-20n.json")
RACK_SEED = 30

# published peaks of one H100 SXM (dense, full power limit); HBM's, the
# integer rate's and the SM clock, with the draws' and the event step's
# work, are the benchmark's own (simbench/peaks.py)
ALU32_OPS_PER_S = 67e12        # f32 rate outside the tensor cores (an FMA
                               # counts two): K6's elementwise work
BF16_OPS_PER_S = 989e12        # bf16 products on the tensor cores
#: f32 products on the tensor cores as 3xTF32 (three TF32 products at
#: 495e12 each), the least time the card can take for f32 attention work
#: and K6's products
TF32X3_OPS_PER_S = 495e12 / 3
#: scalar operations the open loop needs per event besides the argmin and
#: the transition. Arrival times are sorted and dispatch is FIFO in slot
#: order, so the next arrival, the arrival count and the queue head are
#: each a pointer that only moves forward: a test and an advance each (6),
#: plus the live / idle / step_ok decision (4).
OPEN_EVENT_OPS = 10
#: scalar operations per request, once per run: ingestion (token and
#: queue-bound test, status) 5, dispatch (status, bind, wait stamp) 4,
#: departure (sojourn stamp, status) 3
REQ_OPS = 12
# K1's latency term: the dependent chain of one event, priced with one
# SM's latencies as scripts/torch_sm_latency.py measured them on an NVIDIA
# H100 80GB HBM3 at 700.00 W (the lower of two runs; PERF.md, PR 17), at
# simbench/peaks.py's SM_CLOCK_HZ: the card's maximum (nvidia-smi
# clocks.max.sm, 1980 MHz; 1982-1995 MHz measured under the chain)
#: cycles from an indexed shared-memory load to its use (x = s[x])
SMEM_LOAD_CYCLES = 28.645
#: cycles of one dependent 32-bit integer operation
INT_OP_CYCLES = 4.716
#: the minimal chain of one event: the argmin reads the ready clocks (a
#: load) and takes their minimum (at least one operation), the selected
#: thread's state is read (a load), then the lock or peer word it names (a
#: load), the new clock is computed (an operation) and written where the
#: next event's argmin reads it (that read is the next event's first load)
EVENT_CHAIN_CYCLES = 3 * SMEM_LOAD_CYCLES + 2 * INT_OP_CYCLES
#: the minimal chain of one K2 step: the step reads what the last one left
#: in registers (the cohort tail, or the record of the same thread), tests
#: it (an empty queue at SWAP, the thread's own id at REL_CAS, the budget
#: at SPIN_BUDGET) and selects the new value from the test (two
#: operations); the next thread's record can be loaded ahead
TICK_CHAIN_CYCLES = 2 * INT_OP_CYCLES
#: what the card holds at once: N_SM (132) SMs of 228 KB shared memory and
#: 64 resident warps each (one warp per replica)
SM_SMEM_BYTES = 228 * 1024
SM_WARPS = 64


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def k1_bound(alg, wl, streams, T, N, K, n_events, events=None,
             lat_samples=1 << 15):
    """Three least times of one K1 launch over the operands ``wl``
    (tensors on the card) and draw ``streams``, in ms, as a dict.

    ``events`` (per replica; default ``n_events`` each) is the events the
    data needs: an open-loop replica whose threads have all fallen idle
    with no admitted request left needs no further event (the kernel's
    ``diag`` reports where that happens). ``bytes``: every input read once
    (the draw streams for those events) and every output written once,
    over the HBM rate. ``operations``: per event 2 operations per thread
    for the masked argmin, STEP_OPS for the transition and, open loop,
    OPEN_EVENT_OPS, plus REQ_OPS per request slot, over the INT32 rate.
    ``latency``: per replica its events x EVENT_CHAIN_CYCLES at
    SM_CLOCK_HZ; replicas run side by side up to what the card holds at
    once (shared memory and resident warps) and in waves beyond it, so the
    longest replica's chain, or the replica-chains over that capacity when
    that is longer."""
    import torch
    from repro_torch.kernels.event_loop.smem_plan import (region_bytes,
                                                          smem_bytes)
    B, R, P = (int(wl.seed.shape[0]), int(wl.arr_fix.shape[-1]),
               int(wl.edges.shape[1]))
    ev = (torch.full((B,), n_events, dtype=torch.float64) if events is None
          else torch.as_tensor(events).double().cpu())
    total_ev = float(ev.sum())
    draw_bytes = sum(s.element_size() for s in streams) * total_ev
    in_bytes = draw_bytes + sum(
        t.numel() * t.element_size() for t in (
            wl.edges, wl.think_ns, wl.locality, wl.active, wl.b_init,
            wl.cost_rows, wl.node_mult)) + 4 * (T + K)
    out_bytes = B * (4 * T + 8 * lat_samples + 4 + 8 + 4 + 4)
    if R:
        in_bytes += B * R * (8 + 3 * 4)      # arr, tok, tokcum, qcap
        out_bytes += B * R * (8 + 8 + 4)     # wq, soj, rstat
    ops = (total_ev * (2 * T + STEP_OPS + (OPEN_EVENT_OPS if R else 0))
           + B * R * REQ_OPS)
    capacity = N_SM * min(SM_WARPS, SM_SMEM_BYTES // region_bytes(
        smem_bytes(alg, T, N, K, P, R)))
    chain_events = max(float(ev.max()), total_ev / capacity)
    return {"bytes_ms": (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
            "operations_ms": ops / INT32_OPS_PER_S * 1e3,
            "latency_ms": chain_events * EVENT_CHAIN_CYCLES / SM_CLOCK_HZ
            * 1e3,
            "events": total_ev, "resident_replicas": capacity}


def k1_row(b):
    """A kernels-phase row's bound fields from ``k1_bound``'s dict:
    ``bound_ms`` / ``bound_by`` the larger of bytes and operations, and
    beside them the latency term and which of the three binds."""
    terms = {"bytes": b["bytes_ms"], "operations": b["operations_ms"],
             "latency": b["latency_ms"]}
    two = max(("bytes", "operations"), key=terms.get)
    return {"bound_ms": terms[two], "bound_by": two,
            "bound_bytes_ms": b["bytes_ms"],
            "bound_operations_ms": b["operations_ms"],
            "bound_latency_ms": b["latency_ms"],
            "bound_with_latency_ms": max(terms.values()),
            "binds": max(terms, key=terms.get),
            "bound_events": b["events"],
            "resident_replicas": b["resident_replicas"]}


def bound_row(nbytes, nops, ops_per_s):
    """Least time for the work: bytes (each input read once, each output
    written once) over the HBM rate, operations over ``ops_per_s``."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = nops / ops_per_s * 1e3
    return {"bytes": nbytes, "operations": nops, "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bound_bytes_ms": b_ms, "bound_operations_ms": o_ms}


def draw_bound(B, n_events, kz, rw):
    """The draw stream of ``B`` replicas x ``n_events`` as a kernels-phase
    row. ``operations``: THREEFRY_CALLS threefry2x32 hashes of THREEFRY_OPS
    each, the uniforms' and randint's conversions and one compare a zcdf
    entry, per event, over the INT32 rate. ``bytes``: the outputs written
    once (the operands are a few hundred bytes a replica)."""
    per_event = (THREEFRY_CALLS[rw] * THREEFRY_OPS
                 + (3 if rw else 2) * UNIFORM_OPS + RANDINT_OPS + kz)
    return bound_row(4 * (4 if rw else 3) * B * n_events,
                     B * n_events * per_event, INT32_OPS_PER_S)


def plan_bound(B, R):
    """The arrival plan of ``B`` replicas x ``R`` requests as a
    kernels-phase row, with its latency term. ``operations``: two
    threefry2x32 hashes and ``PLAN_F32_OPS`` a request over the INT32 rate.
    ``bytes``: ``arr_fix`` read and the four ``(B, R)`` outputs written
    once. ``latency``: one replica's credit chain, ``R`` steps of
    ``PLAN_STEP_OPS`` dependent operations at ``INT_OP_CYCLES`` each (every
    replica's block is resident at once up to 8 blocks an SM)."""
    row = bound_row(4 * 5 * B * R, B * R * (2 * THREEFRY_OPS + PLAN_F32_OPS),
                    INT32_OPS_PER_S)
    lat_ms = (R * PLAN_STEP_OPS * INT_OP_CYCLES / SM_CLOCK_HZ * 1e3
              * math.ceil(B / (8 * N_SM)))
    terms = {"bytes": row["bound_bytes_ms"],
             "operations": row["bound_operations_ms"], "latency": lat_ms}
    return {**row, "bound_latency_ms": lat_ms,
            "bound_with_latency_ms": max(terms.values()),
            "binds": max(terms, key=terms.get)}


def visible_pairs(S, causal, window):
    """(query, key) pairs the mask keeps: the products the data needs."""
    import numpy as np
    q, k = np.arange(S)[:, None], np.arange(S)[None, :]
    ok = np.ones((S, S), bool)
    if causal:
        ok &= k <= q
    if window is not None:
        ok &= k > q - window
    return int(ok.sum())


def attention_bound(kernel, B, H, S, hd, causal=True, window=None, elem=4):
    """K3 (q, k, v in; o, lse out; q k^T and p v), K4 (q, k, v, do, lse,
    drow in; dq out; s, dp, ds k) or K5 (the same in; dk, dv out; s, dp,
    p^T do, ds^T q): a multiply-add is 2 operations, counted over the
    visible pairs only. ``elem`` is the inputs' bytes per element; bf16
    products are bounded at the tensor cores' bf16 rate, f32 at their
    3xTF32 rate."""
    n, rows = B * H * S * hd, B * H * S
    pairs = B * H * visible_pairs(S, causal, window)
    nbytes, per_pair = {
        "K3": (4 * n * elem + 4 * rows, 4 * hd),
        "K4": (5 * n * elem + 8 * rows, 6 * hd),
        "K5": (6 * n * elem + 8 * rows, 8 * hd)}[kernel]
    rate = BF16_OPS_PER_S if elem == 2 else TF32X3_OPS_PER_S
    row = bound_row(nbytes, pairs * per_pair, rate)
    row["shape"] = dict(B=B, H=H, S=S, hd=hd, causal=causal, window=window,
                        dtype="bfloat16" if elem == 2 else "float32")
    return row


def ssd_bound(B, S, H, P, N, L):
    """K6, f32: xd, dA, b, c in; y_diag, states, chunk_decay out. The
    three products at the tensor cores' 3xTF32 rate: per (batch, chunk)
    c b^T over the lower triangle (shared by the heads), per head W xd over
    the triangle and the state product. The elementwise work at the f32
    rate outside the tensor cores: per head the masked decay (an exp and a
    product per kept pair) and the state weights (a product per element of
    xd). The two units work side by side, so the operations term is the
    larger of the two times."""
    nc, tri = S // L, L * (L + 1) // 2
    nbytes = 4 * (2 * B * S * H * P + B * S * H + 2 * B * S * N
                  + B * nc * H * P * N + B * nc * H)
    products = B * nc * (2 * tri * N + H * (2 * tri * P + 2 * L * P * N))
    elementwise = B * nc * H * (2 * tri + L * P)
    prod_ms = products / TF32X3_OPS_PER_S * 1e3
    elem_ms = elementwise / ALU32_OPS_PER_S * 1e3
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = max(prod_ms, elem_ms)
    return {"bytes": nbytes, "operations": products + elementwise,
            "operations_tensor_cores": products,
            "operations_alu": elementwise, "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bound_bytes_ms": b_ms, "bound_operations_ms": o_ms,
            "bound_products_ms": prod_ms, "bound_elementwise_ms": elem_ms,
            "shape": dict(B=B, S=S, H=H, P=P, N=N, chunk=L)}


def draw_ops(T):
    """Integer instructions one element of the drawn schedule needs
    (``core/prng.py::randint``): the 64-bit counter (2), the lower bits'
    hash and its xor; where the span is a power of two a mask, else the
    higher bits' hash and xor, three remainders and the multiply-add."""
    span = max(T, 1)
    if span & (span - 1) == 0:
        return 2 + THREEFRY_OPS + 1 + 1
    return 2 + 2 * (THREEFRY_OPS + 1) + 3 * MOD_OPS + 1


def k2_bound(tables, T, steps, drawn):
    """K2 alock_tick on ``tables`` tables of ``T`` threads over ``steps``
    steps, all int32, as a kernels-phase row. ``bytes``: the cohorts and
    the state (tails, victim, pc/budget/next/prev) read once, the state
    written once, and the schedule read once unless it is ``drawn`` in the
    kernel. ``operations``: TICK_STEP_OPS per (table, step), plus
    ``draw_ops(T)`` when drawn, over the INT32 rate. ``latency``: steps x
    TICK_CHAIN_CYCLES at SM_CLOCK_HZ, the tables side by side (in waves
    beyond one per lane of every resident warp). ``bound_ms`` / ``bound_by``
    are the larger of bytes and operations; ``binds`` names the largest of
    the three."""
    state = 2 + 1 + 4 * T
    nbytes = 4 * (tables * T + 2 * tables * state
                  + (0 if drawn else tables * steps))
    nops = tables * steps * (TICK_STEP_OPS + (draw_ops(T) if drawn else 0))
    row = bound_row(nbytes, nops, INT32_OPS_PER_S)
    waves = max(1.0, tables / (N_SM * SM_WARPS * 32))
    lat = steps * waves * TICK_CHAIN_CYCLES / SM_CLOCK_HZ * 1e3
    terms = {"bytes": row["bound_bytes_ms"],
             "operations": row["bound_operations_ms"], "latency": lat}
    row.update(bound_latency_ms=lat, bound_with_latency_ms=max(
        terms.values()), binds=max(terms, key=terms.get),
        shape=dict(tables=tables, T=T, steps=steps, drawn=drawn))
    return row


def cuda_ms(torch, fn, reps=3):
    """CUDA-event time of ``fn`` per call: one warm-up call, then ``reps``
    calls between two events, synchronised."""
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sdpa_fwd_ms(torch, q, k, v):
    """``scaled_dot_product_attention`` forward, causal, on the same inputs:
    a yardstick only — nothing in the port calls it."""
    F = torch.nn.functional
    return cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))


def sdpa_bwd_ms(torch, q, k, v, do):
    """Its backward: dq, dk and dv in one ``torch.autograd.grad`` call."""
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg,
                                                         is_causal=True)
    return cuda_ms(torch, lambda: torch.autograd.grad(
        o, (qg, kg, vg), do, retain_graph=True))


def attention_inputs(torch, dev, B, H, S, hd, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((B, H, S, hd), device=dev, generator=g).to(dtype)
            for _ in range(4)]


def ssd_at_tile(torch, sk, _build, ops, hb):
    """K6 at head tile ``hb`` through its C entry (``ssd_kernel`` always
    takes the plan's tile), to check that the tile changes no bit; counts
    no launch."""
    xd, b = ops[0], ops[2]
    B, nc, L, H, P = xd.shape
    N = b.shape[-1]
    y = torch.empty_like(xd)
    st = torch.empty((B, nc, H, P, N), device=xd.device)
    dec = torch.empty((B, nc, H), device=xd.device)
    lib = sk.LIB.load()
    err = lib.ssd_launch(*(t.data_ptr() for t in (*ops, y, st, dec)),
                         B, nc, L, H, P, N, hb, _build.stream_of(xd))
    _build.check_launch(lib, err, f"SSD intra-chunk kernel at hb={hb}")
    return y, st, dec


def ssd_inputs(torch, dev, B, S, H, P, N, seed):
    """xh, dt, a, b, c as the reference tests make them (softplus dt,
    negative a), from a seeded generator on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, device=dev, generator=g)
    xh = rn(B, S, H, P)
    dt = torch.nn.functional.softplus(rn(B, S, H))
    a = -torch.exp(rn(H) * 0.3)
    return xh, dt, a, rn(B, S, N) * 0.5, rn(B, S, N) * 0.5


def deviation(torch, got, want, tol):
    """(largest |got - want| in f32, whether every element is within
    ``tol`` absolute plus ``tol`` relative)."""
    err, ok = 0.0, True
    for a, b in zip(got, want):
        a, b = a.detach().float(), b.detach().float()
        err = max(err, float((a - b).abs().max()))
        ok = ok and bool(torch.isfinite(a).all()) and bool(
            torch.allclose(a, b, atol=tol, rtol=tol))
    return err, ok


def smem_check(ep, dev):
    """S001 of ``repro_torch.analysis`` at one launch shape: the C
    library's and the Python wrapper's shared-memory bytes, and whether
    the rule is clean there (C == Python, within the limit, the limit the
    card's opt-in)."""
    from repro_torch.analysis import check_smem_consistency, smem_sizes
    sizes = smem_sizes(ep, dev)
    return {"entrypoint": ep.name, "c": list(sizes["c"]),
            "python": list(sizes["python"]),
            "agrees": not check_smem_consistency(ep, dev)}


def ptxas_report(log):
    """function -> registers and spill bytes, from ``nvcc -Xptxas -v``."""
    rows, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            rows[cur] = {}
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                rows[cur].update(spill_stores=int(m.group(1)),
                                 spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rows[cur]["registers"] = int(m.group(1))
    return rows


def k1_ptxas_report(_build, algs):
    """K1's instantiations (algorithm x closed or open loop) in the
    event-loop library's ptxas report (its build's ``-Xptxas -v``):
    registers and spill bytes. ``ok`` when all of them are there and none
    spills."""
    rows = []
    for fn, regs in ptxas_report(_build.BUILD_LOG.get("event_loop",
                                                      "")).items():
        m = re.search(r"event_loop_kernelILi(\d+)ELb([01])E", fn)
        if m:
            rows.append({"alg": algs[int(m.group(1))],
                         "open": m.group(2) == "1", **regs})
    rows.sort(key=lambda r: (r["open"], algs.index(r["alg"])))
    ok = len(rows) == 2 * len(algs) and all(
        r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0
        for r in rows)
    return {"ok": ok, "instances": rows}


def sass_counts(library):
    """function -> its HGMMA (wgmma) and HMMA (mma.sync) instructions in
    ``cuobjdump --dump-sass`` of ``library``; None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "--dump-sass", str(library)], check=True,
                         capture_output=True, text=True).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = counts.setdefault(m.group(1), {"HGMMA": 0, "HMMA": 0})
        elif cur is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    cur[op] += 1
    return counts


#: the float kernels' route per input dtype (K6 takes f32 only)
ATT_ROUTES = {"bfloat16": "wgmma m64nNk16 (bf16 in, f32 accumulators)",
              "float32": "mma.sync m16n8k8 3xTF32 (f32 accumulators)"}
#: kernel function -> its name in the ``kernels`` line, per library
TC_FUNCTIONS = {"flash_attention": {"flash_fwd_kernel": "K3"},
                "flash_attention_bwd": {"dq_kernel": "K4",
                                        "dkv_kernel": "K5"},
                "ssd_scan": {"ssd_kernel": "K6"}}
#: instantiations the tensor_cores phase expects: K3, K4, K5 x 2 dtypes x
#: 3 padded hd, and K6's two (FULL, the path shape's, without column
#: guards, and the guarded one for every other shape)
TC_INSTANCES = 20


def tensor_core_report(_build):
    """The instantiations of K3, K4, K5 (kernel x dtype x padded hd) and
    K6 (FULL or not, f32) in the libraries of ``TC_FUNCTIONS``: route,
    registers and spill bytes (the ptxas report of
    each library's build) and their tensor-core instructions in its SASS.
    ``ok`` when all ``TC_INSTANCES`` are there, none spills and, where
    ``cuobjdump`` exists, each has its route's instructions (HGMMA for
    bf16, HMMA for f32)."""
    rows, logs, sass_found = [], True, True
    for stem, names in TC_FUNCTIONS.items():
        lib = _build.LIBRARIES[stem].build()
        log = _build.BUILD_LOG.get(stem)
        logs = logs and bool(log)
        regs = ptxas_report(log) if log else {}
        sass = sass_counts(lib) or {}
        sass_found = sass_found and bool(sass)
        for fn in sorted(set(regs) | set(sass)):
            # a mangled name: its length, the name, then "I" (a template)
            # or "E" (the end of the nested name)
            kern = [k for n, k in names.items()
                    if re.search(rf"{len(n)}{n}[IE]", fn)]
            hd = re.search(r"Li(\d+)E", fn)
            if not kern or (kern[0] != "K6" and not hd):
                continue
            dtype = "bfloat16" if "bfloat16" in fn else "float32"
            row = {"kernel": kern[0], "dtype": dtype,
                   "hd_pad": int(hd.group(1)) if hd else None,
                   "route": ATT_ROUTES[dtype], **regs.get(fn, {}),
                   **sass.get(fn, {})}
            if kern[0] == "K6":
                row["full"] = "ILb1E" in fn
            rows.append(row)
    op = {"bfloat16": "HGMMA", "float32": "HMMA"}
    ok = len(rows) == TC_INSTANCES and all(
        r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0
        and (not sass_found or r.get(op[r["dtype"]], 0) > 0) for r in rows)
    return {"ptxas_report": logs, "sass": sass_found, "ok": ok,
            "instances": rows}


def float_kernel_phases(torch, dev):
    """kernel_check_attention, tensor_cores, kernel_check_ssd,
    float_timings and exemplar_path; returns the K3-K6 records of the
    ``kernels`` line.
    Raises on any disagreement."""
    from repro_torch.analysis.entrypoints import (Entrypoint,
                                                  kernel_entrypoints)
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import kernel_bwd as fkb
    from repro_torch.kernels.flash_attention.ops import mha_vjp
    from repro_torch.kernels.flash_attention.ref import (flash_bwd_plain,
                                                         flash_fwd_plain)
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ops import ssd_forward
    from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_ref,
                                                  ssd_sequential)
    f32, bf16 = torch.float32, torch.bfloat16

    # -- kernel_check_attention: K3, K4, K5 vs their plain versions --------
    smem_rows = [smem_check(ep, dev) for ep in kernel_entrypoints()
                 if ep.kind in ("k3", "k4", "k5")]
    cases, errs = [], {"K3": 0.0, "K4": 0.0, "K5": 0.0}

    def fwd_case(name, shp, dtype, tol, causal, window, seed):
        q, k, v, _ = attention_inputs(torch, dev, shp["B"], shp["H"],
                                      shp["S"], shp["hd"], dtype, seed)
        got = fk.flash_fwd_kernel(q, k, v, causal=causal, window=window)
        want = flash_fwd_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err, ok = deviation(torch, got, want, tol)
        ok = ok and got[0].dtype == dtype and got[1].dtype == f32
        errs["K3"] = max(errs["K3"], err)
        cases.append({"kernel": "K3", "case": name, "dtype": str(dtype),
                      "causal": causal, "window": window, "tolerance": tol,
                      "max_abs_err": err, "ok": ok})

    def bwd_case(name, shp, dtype, tol, causal, window, seed):
        q, k, v, do = attention_inputs(torch, dev, shp["B"], shp["H"],
                                       shp["S"], shp["hd"], dtype, seed)
        o, lse = flash_fwd_plain(q, k, v, causal=causal, window=window)
        drow = (do.float() * o.float()).sum(-1)
        dq = fkb.flash_dq_kernel(q, k, v, do, lse, drow, causal=causal,
                                 window=window)
        dk, dv = fkb.flash_dkv_kernel(q, k, v, do, lse, drow, causal=causal,
                                      window=window)
        want = flash_bwd_plain(q, k, v, do, lse, drow, causal=causal,
                               window=window)
        torch.cuda.synchronize()
        for kern, got, w in (("K4", (dq,), want[:1]),
                             ("K5", (dk, dv), want[1:])):
            err, ok = deviation(torch, got, w, tol)
            errs[kern] = max(errs[kern], err)
            cases.append({"kernel": kern, "case": name, "dtype": str(dtype),
                          "causal": causal, "window": window,
                          "tolerance": tol, "max_abs_err": err, "ok": ok})

    seed = 100
    for name, shp, tol in (("test", ATT_FWD_TEST, ATT_TOL["test"]),
                           ("path", ATT_PATH, ATT_TOL["path"])):
        for causal, window in ((True, None), (False, None),
                               (True, shp["window"]), (False, shp["window"])):
            for dtype, t in ((f32, tol), (bf16, ATT_TOL["bf16"])):
                seed += 1
                fwd_case(name, shp, dtype, t, causal, window, seed)
    for name, shp, tol in (("test", ATT_BWD_TEST, ATT_TOL["test"]),
                           ("path", ATT_PATH, ATT_TOL["path"])):
        for causal, window in ((True, None), (False, None),
                               (True, shp["window"]), (False, shp["window"])):
            for dtype, t in ((f32, tol), (bf16, ATT_TOL["bf16"])):
                seed += 1
                bwd_case(name, shp, dtype, t, causal, window, seed)
    # ragged tiles (S not a multiple of 64, hd not of 16), hd > 128 (the
    # forward's 32-row tiles; the backward's warpgroups split the columns)
    # and an hd whose rows are not 16-byte aligned (the backward loads
    # element by element), in both dtypes
    for shp in (dict(B=1, H=2, S=96, hd=80), dict(B=1, H=2, S=128, hd=256),
                dict(B=1, H=2, S=72, hd=18)):
        for causal, window in ((True, None), (False, 40)):
            for dtype, t in ((f32, ATT_TOL["test"]), (bf16, ATT_TOL["bf16"])):
                seed += 1
                fwd_case("edge", shp, dtype, t, causal, window, seed)
                bwd_case("edge", shp, dtype, t, causal, window, seed)
    # K3 at an S that is a multiple of neither its 128-row q tile nor a kv
    # stage (128 rows bf16, 64 f32): a part-filled last stage and a q tile
    # whose second warpgroup holds 8 rows
    for shp in (dict(B=1, H=2, S=200, hd=64), dict(B=1, H=2, S=200, hd=128)):
        for causal, window in ((True, None), (False, 40)):
            for dtype, t in ((f32, ATT_TOL["test"]), (bf16, ATT_TOL["bf16"])):
                seed += 1
                fwd_case("edge", shp, dtype, t, causal, window, seed)
    # control: K4 and K5 sum in another order than their plain versions
    # (3xTF32 products on the tensor cores), so they differ by a few f32
    # ulps; the comparison must also see a change of one element of k by
    # 1e-3
    q, k, v, do = attention_inputs(torch, dev, 1, 1, 64, 16, f32, 99)
    o, lse = flash_fwd_plain(q, k, v)
    drow = (do.float() * o.float()).sum(-1)
    k2 = k.clone()
    k2[0, 0, 3, 5] += 1e-3
    control = deviation(
        torch, (fkb.flash_dq_kernel(q, k, v, do, lse, drow),
                *fkb.flash_dkv_kernel(q, k, v, do, lse, drow)),
        flash_bwd_plain(q, k2, v, do, lse, drow), 0.0)[0]
    att_ok = (all(c["ok"] for c in cases) and control > 0
              and all(r["agrees"] for r in smem_rows))
    emit({"phase": "kernel_check_attention", "tolerance": ATT_TOL,
          "all_ok": att_ok, "max_abs_err": errs,
          "control_max_abs_err": control, "smem": smem_rows,
          "cases": cases})
    if not att_ok:
        raise SystemExit("kernel_check_attention: a CUDA kernel and its "
                         "plain version disagree")
    tc = tensor_core_report(_build)
    emit({"phase": "tensor_cores", **tc})
    if not tc["ok"]:
        raise SystemExit("tensor_cores: a K3/K4/K5/K6 instantiation is "
                         "missing, spills or lacks its route's tensor-core "
                         "instructions")

    # -- kernel_check_ssd: K6 vs its plain version, ssd_forward vs the
    # exact recurrence ------------------------------------------------------
    def chunked(xh, dt, a, b, c, L):
        B, S, H, P = xh.shape
        N, nc = b.shape[-1], S // L
        return ((xh * dt[..., None]).reshape(B, nc, L, H, P),
                (dt * a).reshape(B, nc, L, H), b.reshape(B, nc, L, N),
                c.reshape(B, nc, L, N))

    ssd_cases, err6 = [], 0.0
    # the reference tests' shapes, the path shape, an H that is no multiple
    # of the path's head tile (also at tiles of 2, 3 and 6 heads: an odd
    # count of double-buffered heads), L = 64, rows that are not 16-byte
    # aligned (P, N not multiples of 4: element copies; L, P, N not
    # multiples of the mma tiles), and H = 32 (Mamba-2 370m's: a tile of
    # all 32 heads passes shared memory; the plan takes 8, also run at 16)
    ssd_shapes = (("test", SSD_TEST, ()), ("path", SSD_PATH, ()),
                  ("test", dict(B=2, S=64, H=4, P=16, N=8, L=16), ()),
                  ("test", dict(B=2, S=32, H=8, P=8, N=4, L=8), ()),
                  ("heads6", dict(B=2, S=256, H=6, P=64, N=128, L=128),
                   (2, 3, 6)),
                  ("chunk64", dict(B=2, S=512, H=4, P=64, N=128, L=64), ()),
                  ("ragged", dict(B=1, S=200, H=2, P=18, N=10, L=40), (2,)),
                  ("heads32", dict(B=2, S=2048, H=32, P=64, N=128, L=128),
                   (16,)))
    for i, (name, shp, tiles) in enumerate(ssd_shapes):
        B, S, H, P, N, L = (shp[x] for x in "BSHPNL")
        xs = ssd_inputs(torch, dev, B, S, H, P, N, 200 + i)
        ops = chunked(*xs, L)
        want = ssd_chunk_ref(*ops)
        got = sk.ssd_kernel(*ops)
        plan = sk.last_plan()
        err, ok = deviation(torch, got, want, SSD_TOL)
        for hb in tiles:                 # other head tiles, the same bits
            other = ssd_at_tile(torch, sk, _build, ops, hb)
            ok = ok and all(torch.equal(a, b) for a, b in zip(got, other))
        err6 = max(err6, err)
        y, h = ssd_forward(*xs, chunk=L)
        err_f, ok_f = deviation(torch, (y, h), ssd_sequential(*xs), SSD_TOL)
        smem = smem_check(Entrypoint(
            f"k6:{name}", "k6", {"L": L, "P": P, "N": N, "hb": plan["hb"]}),
            dev)
        ssd_cases.append({"case": name, "shape": shp, "plan": plan,
                          "head_tiles_equal": list(tiles),
                          "max_abs_err": err, "ok": ok,
                          "forward_vs_sequential_max_abs_err": err_f,
                          "forward_ok": ok_f, "smem": smem,
                          "smem_agrees": smem["agrees"] and smem["python"]
                          == [plan["smem_bytes"]]})
    # control, as for K4 and K5: one element of b changed by 1e-3
    ops = chunked(*ssd_inputs(torch, dev, 1, 32, 2, 8, 4, 299), 8)
    b2 = ops[2].clone()
    b2[0, 0, 3, 1] += 1e-3
    control = deviation(torch, sk.ssd_kernel(*ops),
                      ssd_chunk_ref(ops[0], ops[1], b2, ops[3]), 0.0)[0]
    ssd_ok = control > 0 and all(c["ok"] and c["forward_ok"]
                                 and c["smem_agrees"] for c in ssd_cases)
    emit({"phase": "kernel_check_ssd", "tolerance": SSD_TOL, "all_ok": ssd_ok,
          "control_max_abs_err": control, "cases": ssd_cases})
    if not ssd_ok:
        raise SystemExit("kernel_check_ssd: K6 and its plain version, or "
                         "ssd_forward and ssd_sequential, disagree")

    # -- float_timings: kernel, plain version and library call per shape --
    timings = {}
    att_shapes = (("test", ATT_FWD_TEST, f32), ("path", ATT_PATH, f32),
                  ("path_bf16", ATT_PATH, bf16))
    for name, shp, dtype in att_shapes:
        B, H, S, hd = (shp[x] for x in ("B", "H", "S", "hd"))
        q, k, v, do = attention_inputs(torch, dev, B, H, S, hd, dtype, 300)
        elem = 2 if dtype == bf16 else 4
        timings[("K3", name)] = dict(
            ms=cuda_ms(torch, lambda: fk.flash_fwd_kernel(q, k, v)),
            plain_ms=cuda_ms(torch, lambda: flash_fwd_plain(q, k, v)),
            library_ms=sdpa_fwd_ms(torch, q, k, v),
            **attention_bound("K3", B, H, S, hd, elem=elem))
    for name, shp, dtype in (("test", ATT_BWD_TEST, f32),
                             ("path", ATT_PATH, f32),
                             ("path_bf16", ATT_PATH, bf16)):
        B, H, S, hd = (shp[x] for x in ("B", "H", "S", "hd"))
        q, k, v, do = attention_inputs(torch, dev, B, H, S, hd, dtype, 301)
        o, lse = flash_fwd_plain(q, k, v)
        drow = (do.float() * o.float()).sum(-1)
        elem = 2 if dtype == bf16 else 4
        bwd_ms = sdpa_bwd_ms(torch, q, k, v, do)
        plain_ms = cuda_ms(torch, lambda: flash_bwd_plain(q, k, v, do, lse,
                                                          drow))
        timings[("K4", name)] = dict(
            ms=cuda_ms(torch, lambda: fkb.flash_dq_kernel(q, k, v, do, lse,
                                                          drow)),
            plain_ms=plain_ms, library_ms=bwd_ms,
            **attention_bound("K4", B, H, S, hd, elem=elem))
        timings[("K5", name)] = dict(
            ms=cuda_ms(torch, lambda: fkb.flash_dkv_kernel(q, k, v, do, lse,
                                                           drow)),
            plain_ms=plain_ms, library_ms=bwd_ms,
            **attention_bound("K5", B, H, S, hd, elem=elem))
        # the pair against the one library call that computes all three
        both = cuda_ms(torch, lambda: fkb.flash_attention_bwd(
            q, k, v, do, lse, drow))
        timings[("K4+K5", name)] = dict(
            ms=both, library_ms=bwd_ms, factor_vs_library=both / bwd_ms,
            bound_ms=timings[("K4", name)]["bound_ms"]
            + timings[("K5", name)]["bound_ms"],
            shape=timings[("K4", name)]["shape"])
    for name, shp in (("test", SSD_TEST), ("path", SSD_PATH)):
        B, S, H, P, N, L = (shp[x] for x in "BSHPNL")
        xs = ssd_inputs(torch, dev, B, S, H, P, N, 302)
        ops = chunked(*xs, L)
        timings[("K6", name)] = dict(
            ms=cuda_ms(torch, lambda: sk.ssd_kernel(*ops), SSD_REPS),
            plain_ms=cuda_ms(torch, lambda: ssd_chunk_ref(*ops), SSD_REPS),
            library_ms=None, plan=sk.last_plan(), reps=SSD_REPS,
            **ssd_bound(B, S, H, P, N, L))
    # ssd_forward whole: K6 plus the glue (operands, the inter-chunk loop
    # and the final einsum, plain torch as in the reference)
    fwd_ms = cuda_ms(torch, lambda: ssd_forward(*xs, chunk=L), SSD_REPS)
    timings[("ssd_forward", "path")] = dict(
        ms=fwd_ms, glue_ms=fwd_ms - timings[("K6", "path")]["ms"],
        reps=SSD_REPS, shape=timings[("K6", "path")]["shape"])
    emit({"phase": "float_timings", "reps": 3, "ssd_reps": SSD_REPS,
          "note": "CUDA events over 3 calls after a warm-up; causal, no "
                  "window; library_ms: scaled_dot_product_attention "
                  "forward (K3) and its backward, dq, dk and dv in one "
                  "call (K4, K5); plain_ms of K4 and K5: one "
                  "flash_bwd_plain call (dq, dk and dv); K4+K5: one "
                  "flash_attention_bwd call (K4 then K5), bound the sum "
                  "of theirs; K6, its plain version and ssd_forward over "
                  "reps calls (a K6 launch is shorter than the wrapper's "
                  "host time, and the first call's start, idle on the "
                  "card, is shared by more calls); ssd_forward: the whole "
                  "call at the path shape, glue_ms = its ms - K6's",
          "rows": [dict(kernel=kern, at=name, **row)
                   for (kern, name), row in timings.items()]})

    # -- exemplar_path: the slice's entry points at the path shape --------
    B, H, S, hd = (ATT_PATH[x] for x in ("B", "H", "S", "hd"))
    q, k, v, do = attention_inputs(torch, dev, B, H, S, hd, f32, 400)
    xs = ssd_inputs(torch, dev, *(SSD_PATH[x] for x in "BSHPN"), 401)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    torch.cuda.synchronize()
    for mod in (fk, fkb, sk):                # every launch count to 0
        mod.LIB.reset_launches()
    t0 = time.perf_counter()
    o = mha_vjp(qg, kg, vg, causal=True)
    o.backward(do)
    y, h = ssd_forward(*xs, chunk=SSD_PATH["L"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    path_launches = {"K3": fk.LIB.launches(),
                     "K4": fkb.LIB.launches()["dq"],
                     "K5": fkb.LIB.launches()["dkv"],
                     "K6": sk.LIB.launches()}
    # the same inputs through the plain versions
    qp, kp, vp = (t.clone().requires_grad_() for t in (q, k, v))
    op = mha_vjp(qp, kp, vp, causal=True, backend="plain")
    op.backward(do)
    yp, hp = ssd_forward(*xs, chunk=SSD_PATH["L"], backend="plain")
    err_att, ok_att = deviation(
        torch, (o, qg.grad, kg.grad, vg.grad),
        (op, qp.grad, kp.grad, vp.grad), ATT_TOL["path"])
    err_ssd, ok_ssd = deviation(torch, (y, h), (yp, hp), SSD_TOL)
    problems = [f"{n} launched {c} times, not once"
                for n, c in path_launches.items() if c != 1]
    if not ok_att:
        problems.append(f"mha_vjp differs from its plain run ({err_att})")
    if not ok_ssd:
        problems.append(f"ssd_forward differs from its plain run "
                        f"({err_ssd})")
    if tuple(y.shape) != (SSD_PATH["B"], SSD_PATH["S"], SSD_PATH["H"],
                          SSD_PATH["P"]) or tuple(o.shape) != (B, H, S, hd):
        problems.append("wrong output shapes")
    emit({"phase": "exemplar_path", "attention": ATT_PATH, "ssd": SSD_PATH,
          "launches": path_launches, "wall_seconds": wall,
          "mha_vjp_vs_plain_max_abs_err": err_att,
          "ssd_forward_vs_plain_max_abs_err": err_ssd,
          "problems": problems})
    if problems:
        raise SystemExit("exemplar_path: " + "; ".join(problems))

    sources = {
        "K3": ("flash_attention", "flash_attention.cu",
               "src/repro/kernels/flash_attention/kernel.py:25"),
        "K4": ("flash_attention_dq", "flash_attention_bwd.cu",
               "src/repro/kernels/flash_attention/kernel_bwd.py:35"),
        "K5": ("flash_attention_dkv", "flash_attention_bwd.cu",
               "src/repro/kernels/flash_attention/kernel_bwd.py:62"),
        "K6": ("ssd_intra_chunk", "ssd_scan.cu",
               "src/repro/kernels/ssd_scan/kernel.py:21")}
    errs["K6"] = err6
    records = []
    for kern, (name, src, replaces) in sources.items():
        path = timings[(kern, "path")]
        rec = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/csrc/{src}", "replaces": replaces,
               "launches": path_launches[kern], "max_abs_err": errs[kern],
               "ms": path["ms"], "plain_ms": path["plain_ms"],
               "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
               "library_ms": path["library_ms"], "shape": path["shape"],
               "at_other_shapes": {n: r for (k2, n), r in timings.items()
                                   if k2 == kern and n != "path"}}
        rec["tensor_cores"] = {
            "routes": ATT_ROUTES if kern != "K6" else
            {"float32": ATT_ROUTES["float32"]},
            "instances": [r for r in tc["instances"] if r["kernel"] == kern]}
        records.append(rec)
    return records


def tick_phases(torch, dev, np):
    """kernel_check_tick, schedule_gen, golden_tick, schedule_check and
    main_path_tick; returns K2's record of the ``kernels`` line. Raises on
    any disagreement."""
    from repro_torch.core import machine as mc
    from repro_torch.core import prng
    from repro_torch.core.sim import run_schedule
    from repro_torch.analysis.entrypoints import kernel_entrypoints
    from repro_torch.kernels.alock_tick import kernel as tk
    from repro_torch.kernels.alock_tick import ops as tops
    from repro_torch.kernels.alock_tick.ref import alock_tick_plain
    i32 = dict(dtype=torch.int32, device=dev)

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    def run(state, sched, coh, b_init, tile, plain=False):
        fn = alock_tick_plain if plain else tk.tick_kernel
        return fn(*state, sched, coh, b_init=b_init, tile=tile)

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def abs_err(a, b):
        return max(int((x.long() - y.long()).abs().max()) for x, y in
                   zip(a, b))

    # -- kernel_check_tick: K2 vs its plain version, on the card ------------
    # every case with the schedule given (mode a); then the schedule drawn
    # in the kernel (mode b) against ops.schedule + the plain version
    smem_rows = [dict(smem_check(ep, dev), **ep.plan.as_dict())
                 for ep in kernel_entrypoints() if ep.kind == "k2"]
    cases = []

    def record(name, got, want, **kw):
        ok = equal(got, want)
        cases.append({"case": name, **kw, "equal": ok,
                      "max_abs_err": abs_err(got, want),
                      "in_cs": int((got[2] == mc.CS).sum())})
        return ok

    def case(name, Tab, T, steps, tile, b_init, seed, per_table=False,
             state=None, lo=0, hi=None):
        rng = np.random.default_rng(seed)
        sched = torch.from_numpy(rng.integers(
            lo, T if hi is None else hi, (Tab, steps)).astype(np.int32)).to(
            dev)
        coh = rng.integers(0, 2, (Tab, T) if per_table else T)
        coh = torch.from_numpy(np.broadcast_to(coh, (Tab, T)).astype(
            np.int32).copy()).to(dev)
        if state is None:
            state = tops.fresh_tables(Tab, T, dev)
        got = run(state, sched, coh, b_init, tile)
        want = run(state, sched, coh, b_init, tile, plain=True)
        ok = record(name, got, want, mode="given", tables=Tab, T=T,
                    steps=steps, tile=tile, plan=tk.last_plan(),
                    b_init=list(b_init))
        return got, sched, coh, ok

    case("reference test shape", 8, 4, 300, 4, (2, 3), 5)
    case("reference test shape, padded", 6, 3, 150, 4, (2, 3), 11)
    for b in ((5, 20), (1, 1), (3, 1), (2, 7)):
        mid, _, _, _ = case("per-table cohorts", 300, 16, 500, 128, b,
                            sum(b), per_table=True)
        case("per-table cohorts, mid-run state in", 300, 16, 500, 128, b,
             sum(b) + 1, per_table=True, state=mid)
    case("threads out of range", 64, 5, 400, 32, (2, 3), 3, lo=-2, hi=7)
    case("T = 100, records of 32 tables in 64 KB", 200, 100, 300, 128,
         (5, 20), 4, per_table=True)
    # negative control: one schedule entry changed (the last step of
    # table 0 moves another thread); the outputs must differ
    state = tops.fresh_tables(8, 4, dev)
    base, sched0, coh0, _ = case("control base", 8, 4, 300, 4, (2, 3), 6)
    caught = False
    for t in range(4):
        bad = sched0.clone()
        if int(bad[0, -1]) == t:
            continue
        bad[0, -1] = t
        got_bad = run(state, bad, coh0, (2, 3), 4)
        if not equal(got_bad, base):
            caught = equal(got_bad, run(state, bad, coh0, (2, 3), 4,
                                        plain=True))
            break

    # mode b: seeds x spans (3, 5 and 100 are not powers of two), per-table
    # cohorts, 100 tables (a ragged last block)
    def drawn_case(name, Tab, T, steps, seed, state=None, r0=0, pitch=None):
        rng = np.random.default_rng(seed % 1000 + T)
        coh = torch.from_numpy(rng.integers(0, 2, (Tab, T)).astype(
            np.int32)).to(dev)
        if state is None:
            state = tops.fresh_tables(Tab, T, dev)
        if r0 == 0 and pitch is None:
            sched = tops.schedule(Tab, steps, T, seed, dev)
        else:
            k = prng.key(torch.tensor(seed, dtype=torch.int32, device=dev))
            sched = prng.randint(k, (r0 + Tab, pitch), 0, T,
                                 rows=(r0, r0 + Tab))[:, :steps].contiguous()
        got = tk.tick_drawn(*state, coh, seed=seed, steps=steps,
                            b_init=TICK_B_INIT, r0=r0, pitch=pitch)
        want = run(state, sched, coh, TICK_B_INIT, 128, plain=True)
        record(name, got, want, mode="drawn", tables=Tab, T=T, steps=steps,
               seed=seed, r0=r0, pitch=pitch or steps, plan=tk.last_plan())
        return got, coh

    for seed in PLAN_SEEDS:
        for T in (3, 5, 16, 100):
            got, _ = drawn_case("drawn", 100, T, 200, seed)
    mid, _ = drawn_case("drawn, before mid-run state", 100, 16, 200, 1)
    drawn_case("drawn, mid-run state in", 100, 16, 200, 1, state=mid)
    for T in (5, 16):       # rows 29,000+ of a (30000, 150000) draw
        drawn_case("drawn, counters past 2**32", 64, T, 300, 7, r0=29000,
                   pitch=150_000)
    # negative control: one key word flipped; the outputs must differ
    st5 = tops.fresh_tables(100, 5, dev)
    coh5 = torch.zeros((100, 5), dtype=torch.int32, device=dev)
    good5 = tk.tick_drawn(*st5, coh5, seed=0, steps=200)
    w5 = tk.draw_words(0, 5, 0, 200)
    key_caught = not equal(good5, tk.tick_drawn(
        *st5, coh5, seed=0, steps=200, words=w5._replace(hi0=w5.hi0 ^ 1)))

    # the path shape with the steps cut for the plain version; both modes
    # timed
    Tab, T = TICK_PATH["tables"], TICK_PATH["T"]
    coh_path = torch.tensor(TICK_COHORTS, **i32).expand(Tab, T).contiguous()
    sched_cut = tops.schedule(Tab, TICK_STEPS_CUT, T, 0, dev)
    st_cut = tops.fresh_tables(Tab, T, dev)

    def drawn_cut(words=None):
        return tk.tick_drawn(*st_cut, coh_path, seed=0, steps=TICK_STEPS_CUT,
                             b_init=TICK_B_INIT, words=words)

    got = run(st_cut, sched_cut, coh_path, TICK_B_INIT, 128)
    got_b = drawn_cut()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = run(st_cut, sched_cut, coh_path, TICK_B_INIT, 128, plain=True)
    torch.cuda.synchronize()
    plain_ms_cut = (time.perf_counter() - t0) * 1e3
    ms_cut = cuda_ms(torch, lambda: run(st_cut, sched_cut, coh_path,
                                        TICK_B_INIT, 128))
    ms_cut_b = cuda_ms(torch, drawn_cut)
    record("path shape, steps cut", got, want, mode="given", tables=Tab,
           T=T, steps=TICK_STEPS_CUT, ms=ms_cut, plain_ms=plain_ms_cut)
    record("path shape, steps cut", got_b, want, mode="drawn", tables=Tab,
           T=T, steps=TICK_STEPS_CUT, ms=ms_cut_b, plain_ms=plain_ms_cut)
    w16 = tk.draw_words(0, T, 0, TICK_STEPS_CUT)
    key_caught = key_caught and not equal(
        got_b, drawn_cut(w16._replace(lo0=w16.lo0 ^ 1)))
    max_err = max(c["max_abs_err"] for c in cases)
    del sched_cut, st_cut, got, got_b, want
    all_equal = all(c["equal"] for c in cases) and all(
        r["agrees"] for r in smem_rows)
    emit({"phase": "kernel_check_tick", "tolerance": 0, "outputs": 6,
          "all_equal": all_equal, "negative_control_caught": caught,
          "key_control_caught": key_caught, "smem_tables": smem_rows,
          "cases": cases})
    if not (all_equal and caught and key_caught):
        raise SystemExit("kernel_check_tick: the CUDA kernel and its plain "
                         "version disagree, or a control was not caught")

    # -- schedule_gen: the schedule K2 draws, written out -------------------
    gen_rows = []
    for seed in PLAN_SEEDS:
        for n, steps, T_ in ((64, 1000, 16), (37, 333, 3), (5, 7, 1)):
            a = tk.draw_schedule(n, steps, T_, seed, device=dev)
            gen_rows.append({"seed": seed, "shape": [n, steps], "T": T_,
                             "equal": torch.equal(a, tops.schedule(
                                 n, steps, T_, seed, dev))})
    for T_ in (5, 16):
        k = prng.key(torch.tensor(7, dtype=torch.int32, device=dev))
        want_s = prng.randint(k, (30000, 150_000), 0, T_,
                              rows=(29000, 29064))
        a = tk.draw_schedule(64, 150_000, T_, 7, r0=29000, device=dev)
        gen_rows.append({"seed": 7, "shape": [64, 150_000], "T": T_,
                         "rows_of": [30000, 150_000], "r0": 29000,
                         "equal": torch.equal(a, want_s)})
    del want_s, a
    gen_equal = all(r["equal"] for r in gen_rows)
    emit({"phase": "schedule_gen", "equal": gen_equal, "cases": gen_rows})
    if not gen_equal:
        raise SystemExit("schedule_gen: the schedule drawn in K2 differs "
                         "from ops.schedule")

    # -- golden_tick: the path shape at full depth against the reference,
    # schedule given (mode a) and drawn (mode b) ----------------------------
    with open(os.path.join(HERE, "tests", "golden",
                           "torch_tick_full.json")) as f:
        golden = json.load(f)
    shape = (golden["n_tables"], golden["n_threads"], golden["steps"])
    if shape != (Tab, T, TICK_PATH["steps"]):
        raise SystemExit(f"golden_tick: the golden file is for {shape}")
    t0 = time.perf_counter()
    sched = tops.schedule(Tab, golden["steps"], T, golden["seed"], dev)
    torch.cuda.synchronize()
    sched_s = time.perf_counter() - t0
    h = hashlib.sha256()
    for r0 in range(0, Tab, 256):
        h.update(sched[r0:r0 + 256].cpu().numpy().tobytes())
    coh_g = torch.tensor(golden["cohorts"], **i32).expand(Tab, T).contiguous()
    st = tops.fresh_tables(Tab, T, dev)
    b_g = tuple(golden["b_init"])
    names = ("tails", "victim", "pc", "budget", "nxt", "prev")

    def held(out):
        got_d = {n: digest(o.cpu().numpy()) for n, o in zip(names, out)}
        frac = tops.in_cs_fraction(out[2])
        hist = torch.bincount(out[2].reshape(-1), minlength=14)[:14].tolist()
        return {"equal": (got_d == golden["final_sha256"]
                          and frac == golden["in_cs_frac"]
                          and hist == golden["final_pc_histogram"]),
                "final_equal": {n: got_d[n] == golden["final_sha256"][n]
                                for n in names},
                "in_cs_frac": frac, "final_pc_histogram": hist}

    given_rec = held(run(st, sched, coh_g, b_g, 128))
    ms_full = cuda_ms(torch, lambda: run(st, sched, coh_g, b_g, 128))
    del sched

    def drawn_full():
        return tk.tick_drawn(*st, coh_g, seed=golden["seed"],
                             steps=golden["steps"], b_init=b_g)

    drawn_rec = held(drawn_full())
    ms_full_b = cuda_ms(torch, drawn_full)
    sched_ok = h.hexdigest() == golden["sched_sha256"]
    g_ok = sched_ok and given_rec["equal"] and drawn_rec["equal"]
    bound = k2_bound(Tab, T, golden["steps"], drawn=True)
    bound_given = k2_bound(Tab, T, golden["steps"], drawn=False)
    emit({"phase": "golden_tick", "equal": g_ok, "schedule_equal": sched_ok,
          "given": given_rec, "drawn": drawn_rec,
          "schedule_seconds": sched_s, "kernel_ms_given": ms_full,
          "kernel_ms_drawn": ms_full_b, "bound_drawn": bound,
          "bound_given": bound_given, "reference": golden["source"],
          "reference_jax": golden["jax"]})
    del st
    if not g_ok:
        raise SystemExit("golden_tick: K2 or the schedule differs from the "
                         "reference's digests")

    # -- schedule_check: run_schedule on the card equals the CPU's ---------
    rows = []
    rng = np.random.default_rng(0)
    sch = rng.integers(0, 4, 300)
    for alg in ("alock", "mcs", "spinlock", "hlock", "alock-rw"):
        s_gpu, t_gpu = run_schedule(alg, (0, 0, 1, 1), (2, 3), sch,
                                    device=dev)
        s_cpu, t_cpu = run_schedule(alg, (0, 0, 1, 1), (2, 3), sch,
                                    device="cpu")
        ok = all(torch.equal(a.cpu(), b) for a, b in
                 zip(list(s_gpu) + list(t_gpu), list(s_cpu) + list(t_cpu)))
        rows.append({"alg": alg, "steps": len(sch), "equal": ok,
                     "cs_steps": int((t_gpu[0] == mc.CS).any(1).sum())})
    emit({"phase": "schedule_check", "equal": all(r["equal"] for r in rows),
          "algorithms": rows})
    if not all(r["equal"] for r in rows):
        raise SystemExit("schedule_check: run_schedule differs between cuda "
                         "and cpu")

    # -- main_path_tick: monte_carlo_cs_entries at the path shape ----------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tops.reset_exec_stats()                  # every launch count to 0
    t0 = time.perf_counter()
    res = tops.monte_carlo_cs_entries(Tab, T, TICK_PATH["steps"],
                                      TICK_COHORTS, b_init=TICK_B_INIT,
                                      seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = tops.exec_stats()                # read just after
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    hist = res["final_pc_histogram"].tolist()
    sched_mib = Tab * TICK_PATH["steps"] * 4 / 2**20
    problems = []
    if stats["launches"] != 1:
        problems.append(f"K2 launched {stats['launches']} times, not once")
    if (stats["plan"] or {}).get("launch_mode") != "drawn":
        problems.append(f"K2 did not draw the schedule: {stats['plan']}")
    if peak_mib >= sched_mib:
        problems.append(f"peak device memory {peak_mib:.1f} MiB holds a "
                        f"({Tab}, {TICK_PATH['steps']}) schedule "
                        f"({sched_mib:.1f} MiB)")
    if sum(hist) != Tab * T or not 0.0 <= res["in_cs_frac"] <= 1.0:
        problems.append(f"bad statistics {res}")
    if res["in_cs_frac"] != golden["in_cs_frac"] \
            or hist != golden["final_pc_histogram"]:
        problems.append("statistics differ from the reference's")
    emit({"phase": "main_path_tick", **TICK_PATH,
          "cohorts": list(TICK_COHORTS), "b_init": list(TICK_B_INIT),
          "seed": 0, "kernel_launches": stats["launches"],
          "wall_seconds": wall, "seconds": stats["seconds"],
          "table_steps_per_second": Tab * TICK_PATH["steps"] / wall,
          "peak_device_memory_mib": peak_mib,
          "schedule_mib_not_allocated": sched_mib, "plan": stats["plan"],
          "in_cs_frac": res["in_cs_frac"], "final_pc_histogram": hist,
          "problems": problems})
    if problems:
        raise SystemExit("main_path_tick: " + "; ".join(problems))
    return {
        "name": "alock_tick", "route": "cuda",
        "source": "src/repro_torch/csrc/alock_tick.cu",
        "replaces": "src/repro/kernels/alock_tick/kernel.py:26",
        "launches": stats["launches"], "max_abs_err": max_err,
        "tolerance": 0,
        # the main path's launch draws the schedule (mode b); ms_given is
        # the same tables with the schedule given (mode a), the TPU
        # kernel's contract
        "shape": dict(TICK_PATH), "mode": "drawn", "ms": ms_full_b,
        "ms_given": ms_full, "plan": stats["plan"],
        # the plain version at the path's tables and threads with the steps
        # cut to plain_steps; ms_at_plain_steps is the kernel at that cut
        "plain_ms": plain_ms_cut, "plain_steps": TICK_STEPS_CUT,
        "ms_at_plain_steps": ms_cut_b, "ms_given_at_plain_steps": ms_cut,
        **{k: bound[k] for k in (
            "bound_ms", "bound_by", "bytes", "operations", "bound_bytes_ms",
            "bound_operations_ms", "bound_latency_ms",
            "bound_with_latency_ms", "binds")},
        "bound_given": {k: bound_given[k] for k in (
            "bound_ms", "bound_by", "bound_bytes_ms", "bound_operations_ms",
            "bound_latency_ms", "binds")},
        "library_ms": None,
    }


def bucket_rows(workloads, n_seeds):
    """Rows of each shape bucket a sweep of ``workloads`` makes."""
    from repro_torch.core import batch
    rows = {}
    for w in dict.fromkeys(workloads):
        key = batch.shape_key(w, N_EVENTS)
        rows[key] = rows.get(key, 0) + n_seeds
    return list(rows.values())


def result_digests(np, pairs):
    """SHA-256 of every array of each ``(name, BatchResult)``."""
    return {name: hashlib.sha256(b"".join(
        np.ascontiguousarray(a).tobytes() for a in (
            br.seeds, br.ops, br.sim_ns, br.throughput_mops, br.lat_ns,
            br.per_thread_ops, br.reacquires, br.passes))).hexdigest()
        for name, br in pairs}


def sharded_phases(torch, np, batch, exp, res, dev):
    """The Fig. 5 grid ``exp`` through the sharded layouts, each against
    main_path's results ``res``: dispatches follow the superchunk formula,
    one K1 launch a shard, every replica's arrays the same bits."""
    from repro_torch.experiments import ExecOptions, Experiment
    from repro_torch.parallel import sharding
    card = torch.device("cuda", torch.cuda.current_device())
    want = result_digests(np, [(w, res[w]) for w in exp.workloads])
    rows = bucket_rows(exp.workloads, exp.n_seeds)
    layouts = [("ExecOptions(devices=1, chunk=32)", 1, 32),
               ("ExecOptions(devices=1, chunk=40)", 1, 40),
               ("sweep(devices=[cuda:0, cuda:0])", 2, None)]
    for name, D, chunk in layouts:
        dispatches = sum(len(sharding.superchunks(B, D, chunk))
                         for B in rows)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        batch.reset_exec_stats()             # every launch count to 0
        t0 = time.perf_counter()
        if D == 1:
            run = Experiment("fig5", n_seeds=exp.n_seeds,
                             n_events=exp.n_events,
                             options=ExecOptions(devices=1, chunk=chunk))
            for lbl, w, _ in res:
                run.add(w, label=lbl)
            got = [(w, br) for _, w, br in run.run()]
        else:
            ws = list(dict.fromkeys(exp.workloads))
            got = list(zip(ws, batch.sweep(
                ws, n_seeds=exp.n_seeds, n_events=exp.n_events,
                devices=[card, card])))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = batch.exec_stats()           # read just after
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        have = result_digests(np, got)
        problems = []
        if any(have[w] != want[w] for w in have) or len(have) != len(set(
                exp.workloads)):
            problems.append("outputs differ from main_path's")
        if stats["dispatches"] != dispatches:
            problems.append(f"dispatches {stats['dispatches']} != "
                            f"{dispatches}")
        if stats["launches"] != dispatches * D or stats["launches"] <= 0:
            problems.append(f"launches {stats['launches']} != "
                            f"{dispatches * D}")
        if stats["draw_launches"] != stats["launches"]:
            problems.append(f"draw-kernel launches "
                            f"{stats['draw_launches']} != shards "
                            f"{stats['launches']}")
        emit({"phase": "sharded", "layout": name, "devices": D,
              "chunk": chunk, "buckets": len(rows),
              "bucket_rows": sorted(set(rows)), "equal": not problems,
              "dispatches": stats["dispatches"],
              "dispatches_formula": dispatches,
              "kernel_launches": stats["launches"],
              "draw_launches": stats["draw_launches"], "wall_seconds": wall,
              "seconds": stats["seconds"],
              "peak_device_memory_mib": peak_mib,
              "smem_plan_last": stats["smem_plan"], "problems": problems})
        if problems:
            raise SystemExit(f"sharded {name}: " + "; ".join(problems))


def pairs_phase(torch, cases):
    """``run_events_pairs`` by K1 against ``run_events`` and against the
    plain version's pairs, for each ``(name, alg, T, N, K, n_events,
    operands on the card)`` of ``cases``."""
    from repro_torch.core.sim import topology
    from repro_torch.kernels.event_loop import i32pair
    from repro_torch.kernels.event_loop import kernel as el_kernel
    from repro_torch.kernels.event_loop.ops import (precompute_draws,
                                                    precompute_plan,
                                                    run_events,
                                                    run_events_pairs)
    rows = []
    for name, alg, T, N, K, n_events, wl in cases:
        dev = wl.seed.device
        tn, ln, _ = topology(alg, N, T // N, K)
        streams = precompute_draws(wl.seed, wl.edges, wl.zcdf, n_events, N,
                                   K // N, device=dev)
        plan = (precompute_plan(wl, n_events, device=dev)
                if wl.arr_fix.shape[-1] else None)
        kw = dict(device=dev, streams=streams, plan=plan)
        el_kernel.LIB.reset_launches()           # K1's count to 0
        got = run_events_pairs(alg, T, N, K, n_events, wl, tn, ln,
                               backend="kernel", **kw)
        torch.cuda.synchronize()
        launches = el_kernel.LIB.launches()      # read just after
        ints = run_events(alg, T, N, K, n_events, wl, tn, ln,
                          backend="kernel", **kw)
        plain = run_events_pairs(alg, T, N, K, n_events, wl, tn, ln,
                                 backend="plain", **kw)

        def flat(out):
            return [a for o in out
                    for a in (o if isinstance(o, tuple) else (o,))]
        packed = [i32pair.pack(o) if isinstance(o, tuple) else o
                  for o in got]
        equal_ints = len(packed) == len(ints) and all(
            torch.equal(a, b) for a, b in zip(packed, ints))
        equal_plain = len(flat(got)) == len(flat(plain)) and all(
            torch.equal(a, b) for a, b in zip(flat(got), flat(plain)))
        pair_dtypes = sorted({str(a.dtype) for a in flat(got)})
        rows.append({"case": name, "alg": alg, "T": T, "N": N, "K": K,
                     "B": int(wl.seed.shape[0]), "n_events": n_events,
                     "outputs": len(got), "launches": launches,
                     "pack_equals_run_events": equal_ints,
                     "equals_plain_pairs": equal_plain,
                     "dtypes": pair_dtypes,
                     "t_end_max": int(ints[3].max()),
                     "ops": int(ints[0].sum())})
    ok = all(r["pack_equals_run_events"] and r["equals_plain_pairs"]
             and r["launches"] == 1 and r["dtypes"] == ["torch.int32"]
             and r["ops"] > 0 for r in rows)
    emit({"phase": "pairs", "tolerance": 0, "equal": ok, "cases": rows})
    if not ok:
        raise SystemExit(f"pairs: the hi/lo outputs disagree: {rows}")


def draw_stream_phase(torch, dev, wide):
    """The draw-stream kernel (``precompute_draws(backend="kernel")``, one
    launch) against its plain version on the card, ``torch.equal`` on
    every output: every case of ``DRAW_GRID`` at the four ``DRAW_SEEDS``
    (P = 3 with its last phase padded, replicas whose first phase starts
    after event 0), one replica, and ``wide`` — ``(seed, edges, zcdf, N,
    kpn)`` of the widest Fig. 5 bucket — at ``N_EVENTS`` by digest, timed
    against ``draw_bound`` and the plain route."""
    import hashlib
    import itertools
    from repro_torch.kernels.event_loop import draws
    from repro_torch.kernels.event_loop.ops import precompute_draws

    def both(seed, edges, zcdf, n_events, N, kpn, rw):
        before = draws.LIB.launches()
        k = precompute_draws(seed, edges, zcdf, n_events, N, kpn, rw=rw,
                             device=dev, backend="kernel")
        launched = draws.LIB.launches() - before
        p = precompute_draws(seed, edges, zcdf, n_events, N, kpn, rw=rw,
                             device=dev, backend="plain")
        return k, p, launched

    gen = torch.Generator().manual_seed(25)
    rows = []
    cases = [dict(zip(DRAW_GRID, v))
             for v in itertools.product(*DRAW_GRID.values())]
    cases.append(dict(rw=True, P=3, N=20, kpn=200, B=1))
    for c in cases:
        B, P, kpn = c.get("B", len(DRAW_SEEDS)), c["P"], c["kpn"]
        seed = torch.tensor(DRAW_SEEDS[-B:], dtype=torch.int32)
        edges = torch.zeros((B, P), dtype=torch.int32)
        if P > 1:
            edges[:, 0] = 3 * torch.arange(B, dtype=torch.int32)
            edges[:, 1] = 700 + torch.arange(B, dtype=torch.int32)
            edges[:, 2:] = 2**31 - 1          # pad_phases' padded phase
        w = torch.rand((B, P, kpn), generator=gen, dtype=torch.float64) ** 3
        zcdf = torch.cumsum((w + 1e-3) / (w + 1e-3).sum(-1, keepdim=True),
                            -1).float()
        k, p, launched = both(seed.to(dev), edges.to(dev), zcdf.to(dev),
                              DRAW_EVENTS, c["N"], kpn, c["rw"])
        rows.append({**c, "B": B, "n_events": DRAW_EVENTS,
                     "launches": launched, "outputs": len(k),
                     "equal": len(k) == len(p) and all(
                         torch.equal(a, b) for a, b in zip(k, p))})
    seed, edges, zcdf, N, kpn = wide
    B = int(seed.shape[0])
    k, p, launched = both(seed, edges, zcdf, N_EVENTS, N, kpn, False)

    def digest(out):
        h = hashlib.sha256()
        for a in out:
            h.update(a.cpu().numpy().tobytes())
        return h.hexdigest()
    dk, dp = digest(k), digest(p)
    del k, p
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(DRAW_REPS):
        precompute_draws(seed, edges, zcdf, N_EVENTS, N, kpn, device=dev,
                         backend="kernel")
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / DRAW_REPS
    start.record()
    precompute_draws(seed, edges, zcdf, N_EVENTS, N, kpn, device=dev,
                     backend="plain")
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    bound = draw_bound(B, N_EVENTS, int(zcdf.shape[-1]), False)
    rows.append({"case": "widest Fig. 5 bucket", "B": B,
                 "n_events": N_EVENTS, "N": N, "kpn": kpn,
                 "launches": launched, "digest": dk, "plain_digest": dp,
                 "equal": dk == dp})
    ok = all(r["equal"] and r["launches"] == 1 for r in rows)
    emit({"phase": "draw_stream", "tolerance": 0, "equal": ok,
          "cases": rows, "ms": ms, "reps": DRAW_REPS, "plain_ms": plain_ms,
          "bound": bound, "x_bound": ms / bound["bound_ms"],
          "plain_over_kernel": plain_ms / ms})
    if not ok:
        raise SystemExit("draw_stream: the draw kernel and its plain "
                         "version disagree")


def traffic_plan_phase(torch, dev, cases, ramp):
    """The open loop's arrival plan, every field and the arrival times:
    for each ``name -> operands`` (numpy leaves) of ``cases`` the plain
    route on the CPU against the plain route on the card (``differing``)
    and the kernel (``precompute_plan(backend="kernel")``, one launch)
    against both; then at ``ramp`` (``open-ramp``'s bucket, on the card)
    the kernel against the plain route, its time over ``PLAN_REPS``
    launches enqueued while the card sleeps (device time, not the
    host's enqueue), the host's enqueue per call, and the plain route's
    time, beside ``plan_bound``."""
    from repro_torch.kernels.event_loop import arrivals
    from repro_torch.kernels.event_loop.ops import precompute_plan
    from repro_torch.traffic.stream import arrival_times_i64
    from repro_torch.workloads import to_device
    fields = ("gaps", "tok", "tokcum", "qcap", "arr")

    def differing(a, b):
        pairs = list(zip(a, b)) + [(arrival_times_i64(a.gaps),
                                    arrival_times_i64(b.gaps))]
        return dict(zip(fields, (int((x.cpu() != y.cpu()).sum())
                                 for x, y in pairs)))

    def kernel(wl):
        before = arrivals.LIB.launches()
        got = precompute_plan(wl, N_EVENTS, device=dev, backend="kernel")
        return got, arrivals.LIB.launches() - before

    rows = []
    for name, st in cases.items():
        wl = to_device(st, dev)
        p_cpu = precompute_plan(st, N_EVENTS, device="cpu")
        p_plain = precompute_plan(wl, N_EVENTS, device=dev, backend="plain")
        p_kern, launched = kernel(wl)
        rows.append({"case": name, "replicas": int(wl.seed.shape[0]),
                     "R": int(wl.arr_fix.shape[-1]),
                     "differing": differing(p_cpu, p_plain),
                     "kernel_differing": differing(p_plain, p_kern),
                     "kernel_cpu_differing": differing(p_cpu, p_kern),
                     "plan_launches": launched,
                     "admitted": int(p_kern.tok.sum())})
    B, R = int(ramp.seed.shape[0]), int(ramp.arr_fix.shape[-1])
    p_kern, launched = kernel(ramp)
    p_plain = precompute_plan(ramp, N_EVENTS, device=dev, backend="plain")
    rows.append({"case": "open-ramp bucket", "replicas": B, "R": R,
                 "kernel_differing": differing(p_plain, p_kern),
                 "plan_launches": launched,
                 "admitted": int(p_kern.tok.sum())})
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(int(0.05 * SM_CLOCK_HZ))
    t0 = time.perf_counter()
    start.record()
    for _ in range(PLAN_REPS):
        precompute_plan(ramp, N_EVENTS, device=dev, backend="kernel")
    end.record()
    enqueue_ms = (time.perf_counter() - t0) / PLAN_REPS * 1e3
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / PLAN_REPS
    start.record()
    precompute_plan(ramp, N_EVENTS, device=dev, backend="plain")
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    bound = plan_bound(B, R)
    ok = all(sum(r.get("differing", {}).values()) == 0
             and sum(r["kernel_differing"].values()) == 0
             and sum(r.get("kernel_cpu_differing", {}).values()) == 0
             and r["plan_launches"] == 1 for r in rows)
    emit({"phase": "traffic_plan", "equal": ok, "cases": rows,
          "ms": ms, "reps": PLAN_REPS, "enqueue_ms": enqueue_ms,
          "plain_ms": plain_ms, "bound": bound,
          "x_bound": ms / bound["bound_with_latency_ms"],
          "plain_over_kernel": plain_ms / ms})
    if not ok:
        raise SystemExit("traffic_plan: the arrival plan differs between "
                         "the kernel, the plain route on the card and the "
                         "CPU")
    return {"name": "arrival_plan", "route": "cuda",
            "source": "src/repro_torch/csrc/arrival_plan.cu",
            "replaces": "src/repro/traffic/stream.py (XLA, no TPU kernel)",
            "tolerance": 0, "shape": {"B": B, "R": R}, "ms": ms,
            "plain_ms": plain_ms, **bound, "library_ms": None}


def packed_bucket(torch, dev, ws, S, n_events):
    """The workloads ``ws`` (one shape bucket) x ``S`` seeds, lowered and
    packed as ``sweep`` packs a bucket (phases padded to the bucket's
    most): ``(thread_node, lock_node, operands)`` on ``dev``."""
    from repro_torch.core import batch
    from repro_torch.core.cost_model import CostModel
    from repro_torch.workloads import lower, to_device
    lows = [lower(w, n_events) for w in ws]
    tn, ln, _, wl = batch._pack(lows[0].shape_key,
                                [lw.operands for lw in lows], S, 1,
                                CostModel())
    return (torch.from_numpy(tn).to(dev), torch.from_numpy(ln).to(dev),
            to_device(wl, dev))


def engine_with_diag(torch, dev, alg, T, N, K, n_events, wl, tn, ln,
                     streams, backend):
    """``run_events`` on the given draw streams with a ``diag`` (filled
    with -7 first, so a column the engine leaves shows): its outputs and
    the diag."""
    from repro_torch.kernels.event_loop.ops import run_events
    from repro_torch.kernels.event_loop.ref import DIAG_COLS
    diag = torch.full((int(wl.seed.shape[0]), DIAG_COLS), -7,
                      dtype=torch.int32, device=dev)
    out = run_events(alg, T, N, K, n_events, wl, tn, ln, backend=backend,
                     device=dev, streams=streams, diag=diag)
    return out, diag


def cut_check(torch, dev, alg, T, N, K, wl, tn, ln, n_events):
    """At ``n_events`` events, the draw kernel and K1 against the plain
    draws and the plain engine on the card: ``torch.equal`` on every draw
    stream, every output and the ``diag``. Returns the kernel's outputs
    and diag and the comparison's fields."""
    from repro_torch.kernels.event_loop.ops import precompute_draws

    def draws(backend):
        return precompute_draws(wl.seed, wl.edges, wl.zcdf, n_events, N,
                                K // N, rw=alg == "alock-rw", device=dev,
                                backend=backend)

    sk, sp = draws("kernel"), draws("plain")
    draws_equal = len(sk) == len(sp) and all(
        torch.equal(a, b) for a, b in zip(sk, sp))
    out_k, diag_k = engine_with_diag(torch, dev, alg, T, N, K, n_events, wl,
                                     tn, ln, sk, "kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p, diag_p = engine_with_diag(torch, dev, alg, T, N, K, n_events, wl,
                                     tn, ln, sp, "plain")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    outs_equal = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
    diag_equal = torch.equal(diag_k, diag_p)
    return out_k, diag_k, {
        "n_events": n_events, "draws_equal": draws_equal,
        "outputs_equal": outs_equal, "diag_equal": diag_equal,
        "plain_ms": plain_ms}


def rw_ycsb_phase(torch, dev):
    """``ycsb-rw-1000``'s widest bucket (its 20-node workloads, YCSB A, B
    and C, x ``n_seeds``), lowered and packed as ``sweep`` does: at
    ``RW_EV_CUT`` events the draw kernel and K1 against the plain draws
    and the plain engine on the card, ``torch.equal`` on every draw
    stream, every output and the five-column ``diag`` (events run, path,
    lock operations begun, begun shared, begun on the loopback tier); then
    at ``N_EVENTS`` the RW draw kernel's time and K1's alone (3 launches
    after a warm-up, CUDA events), K1's bound and each mix's share of
    operations begun shared."""
    from repro_torch.kernels.event_loop import smem_plan
    from repro_torch.kernels.event_loop.ops import (precompute_draws,
                                                    run_events)
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    from simbench.inputs import grid
    from simbench.program import to_workload

    with open(RW_CONFIG) as f:
        cfg = json.load(f)
    S, ds = cfg["n_seeds"], grid(cfg)
    widest = max(d["n_nodes"] for d in ds)
    ws = [to_workload(dict(d, seed=RW_SEED)) for d in ds
          if d["n_nodes"] == widest]
    T, N, K = (ws[0].n_nodes * ws[0].threads_per_node, ws[0].n_nodes,
               ws[0].n_locks)
    alg = ws[0].alg

    def draws(wl, n_events, backend):
        return precompute_draws(wl.seed, wl.edges, wl.zcdf, n_events, N,
                                K // N, rw=True, device=dev, backend=backend)

    def elapsed_ms(fn, reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    tn, ln, wl = packed_bucket(torch, dev, ws, S, RW_EV_CUT)
    B = int(wl.seed.shape[0])
    out_k, diag_k, cut = cut_check(torch, dev, alg, T, N, K, wl, tn, ln,
                                   RW_EV_CUT)
    ops_cut, reads_cut = (int(diag_k[:, j].sum()) for j in (2, 3))
    sane = (bool((diag_k[:, 0] == RW_EV_CUT).all())
            and 0 < reads_cut < ops_cut < B * RW_EV_CUT
            and int(diag_k[:, 4].abs().sum()) == 0
            and int(out_k[0].sum()) > 0)
    del out_k, wl

    tn, ln, wl = packed_bucket(torch, dev, ws, S, N_EVENTS)
    draw_ms = elapsed_ms(lambda: draws(wl, N_EVENTS, "kernel"), 3)
    streams = draws(wl, N_EVENTS, "kernel")
    _, diag = engine_with_diag(torch, dev, alg, T, N, K, N_EVENTS, wl, tn,
                               ln, streams, "kernel")          # warm-up
    ms = elapsed_ms(lambda: run_events(
        alg, T, N, K, N_EVENTS, wl, tn, ln, backend="kernel", device=dev,
        streams=streams), 3)
    plan = smem_plan.last_plan().as_dict()
    bound = k1_bound(alg, wl, streams, T, N, K, N_EVENTS)
    d = diag.cpu()
    mixes = []
    for c, w in enumerate(ws):
        ops = int(d[c * S:(c + 1) * S, 2].sum())
        reads = int(d[c * S:(c + 1) * S, 3].sum())
        mixes.append({"read_frac": w.read_frac, "ops": ops, "reads": reads,
                      "reads_over_ops": reads / ops,
                      "ops_over_events": ops / (S * N_EVENTS)})
    del streams, wl
    ok = (cut["draws_equal"] and cut["outputs_equal"] and cut["diag_equal"]
          and sane)
    emit({"phase": "rw_ycsb", "tolerance": 0, "equal": ok,
          "shape": dict(alg=alg, T=T, N=N, K=K, B=B, zipf_s=ws[0].zipf_s,
                        read_frac=[w.read_frac for w in ws]),
          "cut": dict(cut, ops=ops_cut, reads=reads_cut),
          "n_events": N_EVENTS, "k1_ms": ms, "reps": 3,
          "draw_kernel_ms": draw_ms, "smem_plan": plan, **k1_row(bound),
          "mixes": mixes})
    if not ok:
        raise SystemExit("rw_ycsb: the kernels and the plain route disagree "
                         "on the reader-writer lock table")


def rack_churn_phase(torch, dev):
    """``rack-churn-20n``'s bucket, the benchmark's hierarchical rack lock
    under node churn (hlock, T = 160, N = 20, K = 1,000; its 12 workloads
    padded to three phases, x ``n_seeds``: B = 384), lowered and packed as
    ``sweep`` does: at ``RW_EV_CUT`` events (phase edges at 30 % and 70 %
    of them) the draw kernel and K1 against the plain draws and the plain
    engine on the card, ``torch.equal`` on every draw stream, every output
    and the five-column ``diag``. Then at ``N_EVENTS``, CUDA events over 3
    launches after a warm-up: K1 on the three churn workloads of the
    two-rack layout (B = 96, three phases) and on the whole bucket, with
    their bounds, each workload's share of lock operations begun on the
    loopback tier, and, in the same process, alock's K1 at the widest Fig.
    5 bucket (``k1_path_shapes``' shape) as the yardstick."""
    from repro_torch.kernels.event_loop import smem_plan
    from repro_torch.kernels.event_loop.ops import (precompute_draws,
                                                    run_events)
    from repro_torch.workloads import Workload
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    from simbench.inputs import grid
    from simbench.program import to_workload

    with open(RACK_CONFIG) as f:
        cfg = json.load(f)
    S, ds = cfg["n_seeds"], grid(cfg)
    ws = [to_workload(dict(d, seed=RACK_SEED)) for d in ds]
    T, N, K = (ws[0].n_nodes * ws[0].threads_per_node, ws[0].n_nodes,
               ws[0].n_locks)
    alg = ws[0].alg

    tn, ln, wl = packed_bucket(torch, dev, ws, S, RW_EV_CUT)
    B, P = int(wl.seed.shape[0]), int(wl.edges.shape[1])
    out_k, diag_k, cut = cut_check(torch, dev, alg, T, N, K, wl, tn, ln,
                                   RW_EV_CUT)
    ops_cut, loop_cut = (int(diag_k[:, j].sum()) for j in (2, 4))
    sane = (bool((diag_k[:, 0] == RW_EV_CUT).all())
            and 0 < loop_cut < ops_cut < B * RW_EV_CUT
            and int(diag_k[:, 3].abs().sum()) == 0
            and int(out_k[0].sum()) > 0)
    del out_k, wl

    def timed(sub_ws, a):
        """K1 alone at ``N_EVENTS`` on ``sub_ws`` x ``S``: time, plan,
        bound and the per-workload diag sums."""
        tn, ln, wl = packed_bucket(torch, dev, sub_ws, S, N_EVENTS)
        Tw, Nw, Kw = (sub_ws[0].n_nodes * sub_ws[0].threads_per_node,
                      sub_ws[0].n_nodes, sub_ws[0].n_locks)
        streams = precompute_draws(wl.seed, wl.edges, wl.zcdf, N_EVENTS, Nw,
                                   Kw // Nw, device=dev)
        _, diag = engine_with_diag(torch, dev, a, Tw, Nw, Kw, N_EVENTS, wl,
                                   tn, ln, streams, "kernel")
        ms = cuda_ms(torch, lambda: run_events(
            a, Tw, Nw, Kw, N_EVENTS, wl, tn, ln, backend="kernel",
            device=dev, streams=streams))
        row = {"shape": dict(alg=a, T=Tw, N=Nw, K=Kw,
                             B=int(wl.seed.shape[0]),
                             P=int(wl.edges.shape[1])),
               "k1_ms": ms, "reps": 3,
               "smem_plan": smem_plan.last_plan().as_dict(),
               **k1_row(k1_bound(a, wl, streams, Tw, Nw, Kw, N_EVENTS))}
        d = diag.cpu().long()
        sums = [d[c * S:(c + 1) * S].sum(0).tolist()
                for c in range(len(sub_ws))]
        del streams, wl
        return row, sums

    two_racks = [w for w, d in zip(ws, ds)
                 if d["phases"] and max(d["topology"]) == 1]
    churn_row, _ = timed(two_racks, alg)
    bucket_row, sums = timed(ws, alg)
    workloads = [{"locality": d["locality"],
                  "racks": max(d["topology"]) + 1,
                  "churn": bool(d["phases"]), "ops": s[2], "loop": s[4],
                  "loop_over_ops": s[4] / s[2]}
                 for d, s in zip(ds, sums)]
    fig5_row, _ = timed([Workload("alock", 20, TPN, 1000, locality=l)
                         for l in LOCALITY], "alock")
    ok = (cut["draws_equal"] and cut["outputs_equal"] and cut["diag_equal"]
          and sane and all(w["loop"] > 0 for w in workloads))
    emit({"phase": "rack_churn", "tolerance": 0, "equal": ok,
          "shape": dict(alg=alg, T=T, N=N, K=K, B=B, P=P),
          "cut": dict(cut, ops=ops_cut, loop=loop_cut),
          "n_events": N_EVENTS, "churn_two_racks": churn_row,
          "bucket": bucket_row, "workloads": workloads,
          "fig5_widest_alock": fig5_row})
    if not ok:
        raise SystemExit("rack_churn: the kernels and the plain route "
                         "disagree on the rack lock under node churn")


def analysis_phase(torch, dev):
    """``python -m repro_torch.analysis`` in process, once every library
    is built: the lint with its card legs (``--strict --device cuda``:
    S001's C == Python at every sweep bucket and K2-K6 launch shape,
    R004's live ``nvcc`` key, X001 through K1), the fixture corpus
    (``--selftest``) and the imports gate (``--imports``). Raises on any
    non-zero exit code or finding."""
    from repro_torch.analysis import legs
    from repro_torch.analysis.__main__ import main as lint
    from repro_torch.analysis.entrypoints import collect_entrypoints
    from repro_torch.analysis.rules import kernel_builds
    from repro_torch.kernels import _build
    out = str(_build.build_dir() / "analysis_findings.json")
    t0 = time.perf_counter()
    codes = {"strict": lint(["--strict", "--device", "cuda", "--json", out]),
             "selftest": lint(["--selftest"]),
             "imports": lint(["--imports"])}
    seconds = time.perf_counter() - t0
    with open(out) as f:
        findings = json.load(f)
    smem = [smem_check(ep, dev) for ep in collect_entrypoints()]
    ok = (not any(codes.values()) and not findings
          and all(r["agrees"] for r in smem))
    emit({"phase": "analysis", "seconds": seconds, "exit_codes": codes,
          "findings": findings, "legs": legs(device=dev),
          "smem_all_agree": all(r["agrees"] for r in smem), "smem": smem,
          "nvcc_version": _build.nvcc_version().strip().splitlines()[-2:],
          "libraries": {stem: _build.loaded_path(stem).name
                        for stem, *_ in kernel_builds()}})
    if not ok:
        raise SystemExit(f"analysis: exit codes {codes}, findings "
                         f"{findings}")


COORD_FIXED = ("name", "ops", "lease_grants", "lease_steals",
               "phase_members")


def coord_stress_phase(run_scenario):
    """The registry's coord-stress scenario twice with the default options
    (host threads; no device work): the seed-fixed fields must agree."""
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        rows = run_scenario("coord-stress", n_seeds=2, n_events=30_000)
        runs.append((time.perf_counter() - t0, rows))
    fixed = [[{k: r[k] for k in COORD_FIXED} for r in rows]
             for _, rows in runs]
    ok = (fixed[0] == fixed[1] and len(fixed[0]) == 2
          and all(r["ops"] > 0 and r["lease_grants"] > 0
                  for r in runs[0][1]))
    emit({"phase": "coord_stress", "n_seeds": 2, "n_events": 30_000,
          "agree": ok, "seconds": [t for t, _ in runs],
          "rows": runs[0][1], "second_run_rows": runs[1][1]})
    if not ok:
        raise SystemExit(f"coord_stress: two runs disagree: {fixed}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this run needs one "
              "GPU and does not run on the CPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np
    from repro_torch.analysis.entrypoints import k1_entrypoint
    from repro_torch.core import batch
    from repro_torch.core.sim import topology
    from repro_torch.experiments import (Experiment, run_scenario,
                                         scenario_workloads)
    from repro_torch.kernels.event_loop import kernel as el_kernel
    from repro_torch.kernels.event_loop import smem_plan
    from repro_torch.kernels.event_loop.ops import (precompute_draws,
                                                    precompute_plan,
                                                    run_events)
    from repro_torch.kernels.event_loop.ref import DIAG_COLS
    from repro_torch.traffic.stream import arrival_times_i64
    from repro_torch.workloads import (Arrivals, Phase, Workload,
                                       WorkloadOperands, lower, pad_phases,
                                       racks_of, to_device)

    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    # the plain versions' f32 matmuls in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "float32_matmul_precision": torch.get_float32_matmul_precision()})

    # -- build: every declared library at once, one nvcc per source ---------
    t0 = time.perf_counter()
    libs = _build.build_all((lib.source, lib.stem, lib.flags)
                            for lib in _build.declared().values())
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.BUILD_SECONDS.get("event_loop"),
          "library": os.path.relpath(str(libs["event_loop"]), HERE),
          "libraries": {stem: {"nvcc_seconds":
                               _build.BUILD_SECONDS.get(stem),
                               "library": os.path.relpath(str(p), HERE)}
                        for stem, p in libs.items()}})

    def stacked(ws, n_events, n_seeds=1):
        """Lower workloads of one bucket, pad phases, stack (and repeat
        each for ``n_seeds`` consecutive seeds) on a leading axis; numpy
        leaves."""
        lws = [lower(w, n_events) for w in ws]
        pmax = max(lw.operands.n_phases for lw in lws)
        ops = [pad_phases(lw.operands, pmax) for lw in lws]
        wl = WorkloadOperands(*(
            np.repeat(np.stack([np.asarray(getattr(o, f)) for o in ops]),
                      n_seeds, axis=0) for f in WorkloadOperands._fields))
        seeds = (np.repeat(np.asarray([o.seed for o in ops], np.int32),
                           n_seeds)
                 + np.tile(np.arange(n_seeds, dtype=np.int32), len(ops)))
        return wl._replace(seed=seeds)

    def batched(ws, n_events, n_seeds=1):
        return to_device(stacked(ws, n_events, n_seeds), dev)

    # -- prng: the stream made on the card equals the one made on the CPU ---
    seeds = torch.tensor([0, 1, 7, 2**31 - 1], dtype=torch.int32)
    edges = torch.tensor([[0, 700, 1500]] * 4, dtype=torch.int32)
    w = torch.rand((4, 3, 50), generator=torch.Generator().manual_seed(0),
                   dtype=torch.float64) ** 3 + 1e-3
    zcdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1).float()
    on_cpu = precompute_draws(seeds, edges, zcdf, 2048, 20, 50, rw=True,
                              device="cpu")
    on_gpu = precompute_draws(seeds, edges, zcdf, 2048, 20, 50, rw=True,
                              device=dev)
    prng_equal = all(torch.equal(a, b.cpu()) for a, b in zip(on_cpu, on_gpu))
    # the shaped schedule stream of the lock-property path, whole and in
    # slabs of rows
    from repro_torch.kernels.alock_tick import ops as tick_ops
    sched_rows = []
    for seed in (0, 1, 7, 2**31 - 1):
        for n, steps, T in ((64, 1000, 16), (37, 333, 3), (5, 7, 1)):
            a = tick_ops.schedule(n, steps, T, seed, "cpu")
            b = tick_ops.schedule(n, steps, T, seed, dev)
            sched_rows.append({"seed": seed, "shape": [n, steps], "T": T,
                               "differing": int((a != b.cpu()).sum())})
    chunk, tick_ops.SCHED_CHUNK_ELEMS = tick_ops.SCHED_CHUNK_ELEMS, 3000
    slabbed = tick_ops.schedule(64, 1000, 16, 7, dev)
    tick_ops.SCHED_CHUNK_ELEMS = chunk
    slab_equal = torch.equal(slabbed, tick_ops.schedule(64, 1000, 16, 7,
                                                        dev))
    prng_equal = (prng_equal and slab_equal
                  and not any(r["differing"] for r in sched_rows))
    emit({"phase": "prng", "equal": prng_equal, "streams": len(on_gpu),
          "shape": list(on_gpu[0].shape), "schedule": sched_rows,
          "schedule_slabs_equal": slab_equal})
    if not prng_equal:
        raise SystemExit("prng: the draw stream differs between cpu and cuda")
    # the draw kernel against its plain version, on the card
    wide = batched([Workload("alock", 20, TPN, 1000, locality=l)
                    for l in LOCALITY], N_EVENTS, N_SEEDS)
    draw_stream_phase(torch, dev, (wide.seed, wide.edges, wide.zcdf, 20,
                                   50))
    del wide

    # the registry's open-loop workloads: ramp rates x algorithms, and
    # burst-storm's admission policies x algorithms
    RAMP_WS, BURST_WS = (scenario_workloads(n) for n in OPEN_SCENARIOS)
    RAMP_ALOCK = [w for w in RAMP_WS if w.alg == "alock"]
    RAMP8 = next(w for w in RAMP_ALOCK if w.arrivals.rate_per_us == 8.0)
    BURST_TOKEN = next(w for w in BURST_WS if w.alg == "alock"
                       and w.arrivals.token_rate_per_us > 0.0)

    # -- traffic_plan: the arrival plan, kernel, card and CPU alike --------
    plan_cases = {
        "ramp_rates": RAMP_ALOCK,
        "token": [RAMP8.replace(arrivals=Arrivals(
            rate_per_us=4.0, max_requests=RAMP8.arrivals.max_requests,
            token_rate_per_us=2.0, token_burst=16.0))],
        "burst_storm_phased": [w for w in BURST_WS if w.alg == "alock"],
    }
    plan_record = traffic_plan_phase(torch, dev, {
        name: stacked([w.replace(seed=s) for s in PLAN_SEEDS for w in ws],
                      N_EVENTS) for name, ws in plan_cases.items()},
        batched(RAMP_ALOCK, N_EVENTS, N_SEEDS))

    # -- kernel_check: CUDA kernel vs its plain version, on the card --------
    def direct(alg, T, N, K, n_events, wl, streams, plan, warps=None):
        """The kernel through its wrapper with an explicit replicas-per-block
        request; returns its outputs and its ``diag``."""
        tn, ln, _ = topology(alg, N, T // N, K)
        B = int(wl.seed.shape[0])
        diag = torch.zeros((B, DIAG_COLS), dtype=torch.int32, device=dev)
        out = el_kernel.run_events_kernel(
            alg, T, N, K, n_events, wl, torch.from_numpy(tn).to(dev),
            torch.from_numpy(ln).to(dev), streams, lat_samples=1 << 15,
            plan=plan, arr=arrival_times_i64(plan.gaps) if plan else None,
            warps=warps, diag=diag)
        return out, diag

    def compare(alg, T, N, K, n_events, wl, time_it=False, warps=(),
                plan_edit=None):
        """Kernel (the planned launch, then each of ``warps`` replicas per
        block) against the plain version on the same draws and plan;
        ``plan_edit`` rewrites the arrival plan first. Each of ``warps``
        also holds the kernel's ``diag`` (events run, path, lock operations
        begun, begun shared) to the plain version's."""
        tn, ln, _ = topology(alg, N, T // N, K)
        streams = precompute_draws(wl.seed, wl.edges, wl.zcdf, n_events, N,
                                   K // N, rw=alg == "alock-rw", device=dev)
        plan = (precompute_plan(wl, n_events, device=dev)
                if wl.arr_fix.shape[-1] else None)
        if plan_edit is not None:
            plan = plan_edit(plan)
        kw = dict(device=dev, streams=streams, plan=plan)
        out_k = run_events(alg, T, N, K, n_events, wl, tn, ln,
                           backend="kernel", **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diag_p = torch.zeros((int(wl.seed.shape[0]), DIAG_COLS),
                             dtype=torch.int32, device=dev)
        out_p = run_events(alg, T, N, K, n_events, wl, tn, ln,
                           backend="plain", diag=diag_p, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        equal = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(out_k, out_p))
        by_warps, diag = {}, None
        for w in warps:
            out_w, diag = direct(alg, T, N, K, n_events, wl, streams, plan, w)
            by_warps[w] = {"equal": all(torch.equal(a, b) for a, b in
                                        zip(out_w, out_p))
                           and torch.equal(diag, diag_p),
                           "diag_equal": torch.equal(diag, diag_p),
                           **smem_plan.last_plan().as_dict()}
            equal = equal and by_warps[w]["equal"]
        ms = None
        if time_it:
            ms = time_kernel(alg, T, N, K, n_events, wl, tn, ln, streams,
                             plan)
        return {"equal": equal, "err": err, "ms": ms, "plain_ms": plain_ms,
                "ops": int(out_k[0].sum()), "warps": by_warps,
                "diag": diag}

    def time_kernel(alg, T, N, K, n_events, wl, tn, ln, streams, plan=None,
                    reps=3):
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for _ in range(reps):
            run_events(alg, T, N, K, n_events, wl, tn, ln, backend="kernel",
                       device=dev, streams=streams, plan=plan)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def tables(alg, T, N, K, P, R, warps):
        """The C library's and the planner's shared-memory tables: one
        replica's region and one block of ``warps`` regions (S001)."""
        row = smem_check(k1_entrypoint(alg, warps, T, N, K, P, R,
                                       warps=warps), dev)
        return {"smem_bytes": row["c"][0], "block_bytes": row["c"][1],
                "smem_table_agrees": row["agrees"]}

    checks = []
    max_err = 0.0
    # 4 seeds a workload: 4 or 8 replicas, so 3 replicas per block leave a
    # tail block of 1 or 2
    N_S, TPN_S, K_S, EV_S, SEEDS_S, W_S = 4, 4, 16, 2000, 4, (1, 3)
    for alg in el_kernel.ALGS:
        extra = {}
        if alg == "hlock":
            extra["topology"] = racks_of(N_S, 2)
        if alg == "alock-rw":
            extra["read_frac"] = 0.6
        base = Workload(alg, N_S, TPN_S, K_S, locality=0.8, b_init=(2, 3),
                        seed=5, **extra)
        cases = {
            "single_phase": [base, base.replace(locality=1.0, zipf_s=1.3)],
            "phased_churn_node_mult": [base.replace(
                node_mult={0: 4.0}, phases=(
                    Phase(frac=0.3),
                    Phase(frac=0.4, down_nodes=(1,), zipf_s=3.0,
                          node_mult={2: 1.25}),
                    Phase(frac=0.3, b_init=(1, 1),
                          cost="congested-nic")))],
        }
        for name, ws in cases.items():
            wl = batched(ws, EV_S, SEEDS_S)
            P = wl.edges.shape[1]
            c = compare(alg, N_S * TPN_S, N_S, K_S, EV_S, wl, warps=W_S)
            max_err = max(max_err, c["err"])
            checks.append({"alg": alg, "case": name, "equal": c["equal"],
                           "B": int(wl.seed.shape[0]), "ops": c["ops"],
                           "plain_ms": c["plain_ms"],
                           "warps": {w: {k: v[k] for k in (
                               "equal", "diag_equal", "warps", "blocks",
                               "tail_replicas")}
                               for w, v in c["warps"].items()},
                           **tables(alg, N_S * TPN_S, N_S, K_S, P, 0, 3)})
    # the closed loop's other shapes: both bodies, every slot, the exact
    # argmin on key overflow
    for alg in el_kernel.ALGS:
        for name, (n, tpn, k, think) in LANE_CASES.items():
            extra = {}
            if alg == "hlock":
                extra["topology"] = racks_of(n, 2)
            if alg == "alock-rw":
                extra["read_frac"] = 0.6
            ws = [Workload(alg, n, tpn, k, locality=0.95, think=think,
                           seed=7, **extra)]
            wl = batched(ws, EV_S, SEEDS_S)
            c = compare(alg, n * tpn, n, k, EV_S, wl, warps=W_S)
            max_err = max(max_err, c["err"])
            checks.append({"alg": alg, "case": name, "T": n * tpn,
                           "equal": c["equal"], "B": int(wl.seed.shape[0]),
                           "ops": c["ops"], "plain_ms": c["plain_ms"],
                           "warps": {w: {k: v[k] for k in (
                               "equal", "diag_equal", "warps", "blocks",
                               "tail_replicas")}
                               for w, v in c["warps"].items()}})
    # the main path's widest bucket: alock, 20 nodes x 8 threads, 1000
    # locks, 3 localities x 32 seeds; event count cut for the plain version
    WIDE = dict(alg="alock", T=160, N=20, K=1000)
    EV_CUT = 3000
    wide_ws = [Workload("alock", 20, TPN, 1000, locality=l)
               for l in LOCALITY]
    wl_cut = batched(wide_ws, EV_CUT, N_SEEDS)
    c = compare("alock", 160, 20, 1000, EV_CUT, wl_cut, time_it=True,
                warps=(1, 5))
    ms_cut, plain_ms_cut = c["ms"], c["plain_ms"]
    max_err = max(max_err, c["err"])
    if c["ops"] <= 0:
        raise SystemExit("kernel_check: the cut run completed no operation")
    checks.append({"alg": "alock", "case": "main_path_width_cut_events",
                   "equal": c["equal"], "ops": c["ops"],
                   "B": int(wl_cut.seed.shape[0]), "n_events": EV_CUT,
                   "ms": ms_cut, "plain_ms": plain_ms_cut,
                   "warps": {w: {k: v[k] for k in (
                       "equal", "diag_equal", "warps", "blocks",
                       "tail_replicas")}
                       for w, v in c["warps"].items()}})
    emit({"phase": "kernel_check", "tolerance": 0,
          "all_equal": all(c["equal"] for c in checks), "cases": checks})
    if not all(c["equal"] and c.get("smem_table_agrees", True)
               for c in checks):
        raise SystemExit("kernel_check: the CUDA kernel and its plain "
                         "version disagree")

    # the same bucket at full depth: the kernel's time on the main path
    wl_full = batched(wide_ws, N_EVENTS, N_SEEDS)
    tn, ln, _ = topology("alock", 20, TPN, 1000)
    streams = precompute_draws(wl_full.seed, wl_full.edges, wl_full.zcdf,
                               N_EVENTS, 20, 50, device=dev)
    run_events("alock", 160, 20, 1000, N_EVENTS, wl_full, tn, ln,
               backend="kernel", device=dev, streams=streams)   # warm-up
    ms_full = time_kernel("alock", 160, 20, 1000, N_EVENTS, wl_full, tn, ln,
                          streams)
    # mcs and spinlock at the same bucket (their own lowering and draws)
    ms_by_alg = {"alock": ms_full}
    for alg in ("mcs", "spinlock"):
        wl_a = batched([w.replace(alg=alg) for w in wide_ws], N_EVENTS,
                       N_SEEDS)
        tn_a, ln_a, _ = topology(alg, 20, TPN, 1000)
        st_a = precompute_draws(wl_a.seed, wl_a.edges, wl_a.zcdf, N_EVENTS,
                                20, 50, device=dev)
        run_events(alg, 160, 20, 1000, N_EVENTS, wl_a, tn_a, ln_a,
                   backend="kernel", device=dev, streams=st_a)  # warm-up
        ms_by_alg[alg] = time_kernel(alg, 160, 20, 1000, N_EVENTS, wl_a,
                                     tn_a, ln_a, st_a)
        del wl_a, st_a
    B_full = int(wl_full.seed.shape[0])
    wide_plan = smem_plan.last_plan().as_dict()
    wide_tables = tables("alock", 160, 20, 1000, 1, 0, wide_plan["warps"])
    bound_full = k1_bound("alock", wl_full, streams, 160, 20, 1000,
                          N_EVENTS)
    del streams, wl_full, wl_cut

    # -- kernel_check_open: the open loop, kernel vs plain version ----------
    open_checks = []
    max_err_open = 0.0
    OT, ON, OK = (RAMP8.n_nodes * RAMP8.threads_per_node, RAMP8.n_nodes,
                  RAMP8.n_locks)
    for alg in el_kernel.ALGS:
        extra = {}
        if alg == "hlock":
            extra["topology"] = racks_of(ON, 2)
        if alg == "alock-rw":
            extra["read_frac"] = 0.6
        ws = [RAMP8.replace(alg=alg, **extra),
              BURST_TOKEN.replace(alg=alg, **extra)]
        wl = batched(ws, OPEN_EV_CHECK, SEEDS_S)
        P, R = wl.edges.shape[1], wl.arr_fix.shape[-1]
        c = compare(alg, OT, ON, OK, OPEN_EV_CHECK, wl, warps=W_S)
        max_err_open = max(max_err_open, c["err"])
        open_checks.append({"alg": alg,
                            "case": "open-loop-ramp rate 8 qcap 32 + "
                                    "burst-storm token (P = 3)",
                            "equal": c["equal"], "ops": c["ops"], "R": R,
                            "B": int(wl.seed.shape[0]),
                            "n_events": OPEN_EV_CHECK,
                            "plain_ms": c["plain_ms"],
                            "pointer_path": c["diag"][:, 1].tolist(),
                            "events_run": c["diag"][:, 0].tolist(),
                            "warps": {w: {k: v[k] for k in (
                                "equal", "diag_equal", "warps", "blocks",
                                "tail_replicas")}
                                for w, v in c["warps"].items()},
                            **tables(alg, OT, ON, OK, P, R, 3)})
        # negative control of the pointer path: replica 1's arrival times
        # fall once (a negative gap), so it must take the exact scans and
        # still equal the plain version
        if alg in ("alock", "mcs"):
            def fall(plan):
                gaps = plan.gaps.clone()
                gaps[1, 10] = -3000
                return plan._replace(gaps=gaps)
            c = compare(alg, OT, ON, OK, OPEN_EV_CHECK, wl, warps=(3,),
                        plan_edit=fall)
            paths = c["diag"][:, 1].tolist()
            ok = paths[1] == 0 and all(p == 1 for i, p in enumerate(paths)
                                       if i != 1)
            open_checks.append({"alg": alg,
                                "case": "non-monotone arrivals in replica 1 "
                                        "(negative control of the pointer "
                                        "path)",
                                "equal": c["equal"] and ok, "ops": c["ops"],
                                "pointer_path": paths,
                                "plain_ms": c["plain_ms"]})
    # the loop's stop once idle for good: 32 requests are served long
    # before node 1 rejoins at event 1,050, whose rejoin bump must still
    # move the clocks after the stop
    for alg in ("alock", "mcs"):
        ws = [RAMP8.replace(alg=alg, arrivals=Arrivals(
            rate_per_us=4.0, max_requests=32, queue_cap=8), phases=(
                Phase(frac=0.3), Phase(frac=0.4, down_nodes=(1,)),
                Phase(frac=0.3)))]
        wl = batched(ws, OPEN_EV_CHECK, SEEDS_S)
        c = compare(alg, OT, ON, OK, OPEN_EV_CHECK, wl, warps=(1,))
        ran = c["diag"][:, 0].tolist()
        open_checks.append({"alg": alg,
                            "case": "idle for good before a rejoin (P = 3, "
                                    "node 1 down for events 450-1049)",
                            "equal": c["equal"] and max(ran) < 1050,
                            "ops": c["ops"], "events_run": ran,
                            "plain_ms": c["plain_ms"]})
    # the open-loop-ramp bucket of alock (6 rates x 32 seeds), timed, with
    # the event count cut for the plain version
    OPEN_WS = RAMP_ALOCK
    wl_ocut = batched(OPEN_WS, OPEN_EV_CHECK, N_SEEDS)
    c = compare("alock", OT, ON, OK, OPEN_EV_CHECK, wl_ocut, time_it=True)
    ms_ocut, plain_ms_ocut = c["ms"], c["plain_ms"]
    max_err_open = max(max_err_open, c["err"])
    open_checks.append({"alg": "alock", "case": "open_bucket_cut_events",
                        "equal": c["equal"], "ops": c["ops"],
                        "B": int(wl_ocut.seed.shape[0]),
                        "n_events": OPEN_EV_CHECK, "ms": ms_ocut,
                        "plain_ms": plain_ms_ocut})
    emit({"phase": "kernel_check_open", "tolerance": 0, "outputs": 10,
          "all_equal": all(c["equal"] for c in open_checks),
          "cases": open_checks})
    if not all(c["equal"] and c.get("smem_table_agrees", True)
               for c in open_checks):
        raise SystemExit("kernel_check_open: the CUDA kernel and its plain "
                         "version disagree on the open loop")
    # the same bucket at full depth
    wl_ofull = batched(OPEN_WS, N_EVENTS, N_SEEDS)
    otn, oln, _ = topology("alock", ON, OT // ON, OK)
    ostreams = precompute_draws(wl_ofull.seed, wl_ofull.edges, wl_ofull.zcdf,
                                N_EVENTS, ON, OK // ON, device=dev)
    oplan = precompute_plan(wl_ofull, N_EVENTS, device=dev)
    run_events("alock", OT, ON, OK, N_EVENTS, wl_ofull, otn, oln,
               backend="kernel", device=dev, streams=ostreams,
               plan=oplan)                                       # warm-up
    ms_ofull = time_kernel("alock", OT, ON, OK, N_EVENTS, wl_ofull, otn, oln,
                           ostreams, oplan)
    B_ofull = int(wl_ofull.seed.shape[0])
    # the events each replica's data needs, from the kernel's diag
    _, odiag = direct("alock", OT, ON, OK, N_EVENTS, wl_ofull, ostreams,
                      oplan)
    open_plan = smem_plan.last_plan().as_dict()
    open_tables = tables("alock", OT, ON, OK, int(wl_ofull.edges.shape[1]),
                         int(wl_ofull.arr_fix.shape[-1]),
                         open_plan["warps"])
    bound_open = k1_bound("alock", wl_ofull, ostreams, OT, ON, OK, N_EVENTS,
                          events=odiag[:, 0])
    open_events = odiag[:, 0].double()
    del ostreams, oplan, wl_ofull, wl_ocut
    if not (wide_tables["smem_table_agrees"]
            and open_tables["smem_table_agrees"]):
        raise SystemExit(f"kernel_check: the C and Python shared-memory "
                         f"tables differ: {wide_tables} {open_tables}")
    k1_regs = k1_ptxas_report(_build, list(el_kernel.ALGS))
    emit({"phase": "k1_path_shapes", "ptxas": k1_regs, "closed": {
              "shape": dict(WIDE, B=B_full, n_events=N_EVENTS),
              "ms": ms_full, "ms_by_alg": ms_by_alg, "smem_plan": wide_plan,
              **wide_tables, **k1_row(bound_full)},
          "open": {"shape": dict(alg="alock", T=OT, N=ON, K=OK,
                                 R=RAMP8.arrivals.max_requests, B=B_ofull,
                                 n_events=N_EVENTS),
                   "ms": ms_ofull, "smem_plan": open_plan, **open_tables,
                   "events_run_min": float(open_events.min()),
                   "events_run_mean": float(open_events.mean()),
                   "events_run_max": float(open_events.max()),
                   **k1_row(bound_open)}})
    if not k1_regs["ok"]:
        raise SystemExit(f"k1_path_shapes: a K1 instantiation spills or is "
                         f"missing from the ptxas report: {k1_regs}")

    # -- rw_ycsb: the benchmark's reader-writer lock table at full width ---
    rw_ycsb_phase(torch, dev)

    # -- rack_churn: the benchmark's rack lock under node churn ------------
    rack_churn_phase(torch, dev)

    # -- golden: full-width replicas against the JAX reference's digests ----
    with open(os.path.join(HERE, "tests", "golden",
                           "torch_fig5_full.json")) as f:
        golden = json.load(f)

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    def golden_row(alg, seed, done, lat, lat_n, t_end, nreacq, npass):
        return {"alg": alg, "seed": int(seed), "ops": int(done.sum()),
                "sim_ns": max(int(t_end), 1), "reacquires": int(nreacq),
                "passes": int(npass), "lat_n": int(lat_n),
                "done_sha256": digest(done.astype(np.int32)),
                "lat_sha256": digest(lat.astype(np.int64))}

    g_shape = (golden["n_nodes"], golden["threads_per_node"],
               golden["n_locks"])
    got_rows = []
    for alg in dict.fromkeys(r["alg"] for r in golden["replicas"]):
        g_seeds = [r["seed"] for r in golden["replicas"] if r["alg"] == alg]
        ws = [Workload(alg, *g_shape, locality=golden["locality"], seed=s)
              for s in g_seeds]
        wl = batched(ws, golden["n_events"])
        gN, gtpn, gK = g_shape
        tn, ln, _ = topology(alg, gN, gtpn, gK)
        out = [o.cpu().numpy() for o in run_events(
            alg, gN * gtpn, gN, gK, golden["n_events"], wl, tn, ln,
            backend="kernel", device=dev)]
        for i, s in enumerate(g_seeds):
            got_rows.append(golden_row(alg, s, *(o[i] for o in out)))
    golden_equal = got_rows == golden["replicas"]
    emit({"phase": "golden", "equal": golden_equal,
          "replicas": len(got_rows), "n_events": golden["n_events"],
          "reference": golden["source"]})
    if not golden_equal:
        bad = [(g["alg"], g["seed"]) for g, r in
               zip(got_rows, golden["replicas"]) if g != r]
        raise SystemExit(f"golden: kernel output differs from the "
                         f"reference for {bad}")

    # -- golden_open: the open loop at full depth against the reference ----
    with open(os.path.join(HERE, "tests", "golden",
                           "torch_open_loop_full.json")) as f:
        golden_open = json.load(f)
    specs = {f"open-loop-ramp.{w.alg}.rate8": w for w in RAMP_WS
             if w.arrivals.rate_per_us == 8.0}
    specs.update({f"burst-storm.{w.alg}.token": w for w in BURST_WS
                  if w.arrivals.token_rate_per_us > 0.0})
    got_open = []
    for case in dict.fromkeys(r["case"] for r in golden_open["replicas"]):
        w = specs[case]
        g_seeds = [r["seed"] for r in golden_open["replicas"]
                   if r["case"] == case]
        wl = batched([w.replace(seed=s) for s in g_seeds],
                     golden_open["n_events"])
        tn, ln, _ = topology(w.alg, w.n_nodes, w.threads_per_node,
                             w.n_locks)
        out = dict(zip(
            ("done", "lat", "lat_n", "t_end", "nreacq", "npass", "arr",
             "wq", "soj", "rstat"),
            (o.cpu().numpy() for o in run_events(
                w.alg, w.n_nodes * w.threads_per_node, w.n_nodes,
                w.n_locks, golden_open["n_events"], wl, tn, ln,
                backend="kernel", device=dev))))
        for i, s in enumerate(g_seeds):
            row = {"case": case, "alg": w.alg, "seed": s,
                   "ops": int(out["done"][i].sum()),
                   "sim_ns": max(int(out["t_end"][i]), 1),
                   "reacquires": int(out["nreacq"][i]),
                   "passes": int(out["npass"][i]),
                   "lat_n": int(out["lat_n"][i]),
                   "completed": int((out["rstat"][i] == 3).sum()),
                   "dropped": int((out["rstat"][i] == 2).sum())}
            for name in ("done", "lat", "arr", "wq", "soj", "rstat"):
                row[f"{name}_sha256"] = digest(out[name][i])
            got_open.append(row)
    golden_open_equal = got_open == golden_open["replicas"]
    emit({"phase": "golden_open", "equal": golden_open_equal,
          "replicas": len(got_open), "n_events": golden_open["n_events"],
          "completed": [r["completed"] for r in got_open],
          "reference": golden_open["source"]})
    if not golden_open_equal:
        bad = [(g["case"], g["seed"]) for g, r in
               zip(got_open, golden_open["replicas"]) if g != r]
        raise SystemExit(f"golden_open: kernel output differs from the "
                         f"reference for {bad}")

    # -- golden_algs: hlock, alock-rw, node_mult and churn at full depth ---
    with open(os.path.join(HERE, "tests", "golden",
                           "torch_algs_full.json")) as f:
        golden_algs = json.load(f)
    alg_cases = {f"{name}.{i}": w for name in golden_algs["scenarios"]
                 for i, w in enumerate(scenario_workloads(name))}
    groups = {}
    for case in dict.fromkeys(r["case"] for r in golden_algs["replicas"]):
        w = alg_cases[case]
        groups.setdefault((w.alg, w.n_nodes, w.threads_per_node, w.n_locks),
                          []).append(case)
    got_algs = {}
    for (alg, gN, gtpn, gK), cases_g in groups.items():
        # one bucket per algorithm, phases padded as a sweep pads them
        ws = [alg_cases[c].replace(seed=s) for c in cases_g
              for s in golden_algs["seeds"]]
        wl = batched(ws, golden_algs["n_events"])
        tn, ln, _ = topology(alg, gN, gtpn, gK)
        out = [o.cpu().numpy() for o in run_events(
            alg, gN * gtpn, gN, gK, golden_algs["n_events"], wl, tn, ln,
            backend="kernel", device=dev)]
        j = 0
        for c in cases_g:
            for sd in golden_algs["seeds"]:
                got_algs[(c, sd)] = {"case": c, **golden_row(
                    alg, sd, *(o[j] for o in out))}
                j += 1
    got_algs = [got_algs[(r["case"], r["seed"])]
                for r in golden_algs["replicas"]]
    golden_algs_equal = got_algs == golden_algs["replicas"]
    bad = [(g["case"], g["seed"]) for g, r in
           zip(got_algs, golden_algs["replicas"]) if g != r]
    emit({"phase": "golden_algs", "equal": golden_algs_equal,
          "replicas": len(got_algs), "buckets": len(groups),
          "n_events": golden_algs["n_events"], "differ": bad,
          "reference": golden_algs["source"]})
    if not golden_algs_equal:
        raise SystemExit(f"golden_algs: kernel output differs from the "
                         f"reference for {bad}")

    # -- main_path: the Fig. 5 grid through Experiment.run() ----------------
    exp = Experiment("fig5", n_seeds=N_SEEDS, n_events=N_EVENTS)
    for n in GRID_NODES:
        for k in LOCKS:
            for loc in LOCALITY:
                for alg in FIG5_ALGS:
                    exp.add(Workload(alg, n, TPN, k, locality=loc),
                            label=f"{alg}.n{n}.k{k}.loc{int(loc * 100)}")
    for tpn in SCALING_TPN:
        for alg in ("alock", "spinlock"):
            exp.add(Workload(alg, 20, tpn, 20, locality=0.95),
                    label=f"{alg}.scale.t{tpn}")
    distinct = list(dict.fromkeys(exp.workloads))
    n_buckets = len({batch.shape_key(w, N_EVENTS) for w in distinct})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch.reset_exec_stats()                 # every launch count to 0
    t0 = time.perf_counter()
    res = exp.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = batch.exec_stats()               # read just after
    launches = stats["launches"]
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    problems = []
    if launches != n_buckets or launches <= 0:
        problems.append(f"kernel launches {launches} != buckets {n_buckets}")
    if stats["draw_launches"] != launches:
        problems.append(f"draw-kernel launches {stats['draw_launches']} != "
                        f"shards {launches}")
    if stats["plan_launches"] != 0:
        problems.append(f"arrival-plan launches {stats['plan_launches']} "
                        f"in a closed grid")
    if stats["dispatches"] != n_buckets:
        problems.append(f"dispatches {stats['dispatches']} != {n_buckets}")
    if len(res) != len(exp):
        problems.append("missing results")
    for lbl, w, br in res:
        T = w.n_nodes * w.threads_per_node
        ok = (br.ops.shape == (N_SEEDS,) and br.lat_ns.shape ==
              (N_SEEDS, 1 << 15) and br.per_thread_ops.shape == (N_SEEDS, T)
              and bool((br.ops > 0).all()) and bool((br.sim_ns > 0).all())
              and bool(np.isfinite(br.throughput_mops).all())
              and math.isfinite(br.p99_lat_ns) and br.mean_mops > 0
              and bool((np.minimum(br.ops, 1 << 15)
                        == (br.lat_ns >= 0).sum(axis=1)).all()))
        if not ok:
            problems.append(f"bad result for {lbl}")
    # the grid holds the golden replicas (seeds 0 and 1 of the n20.k1000.
    # loc95 cells): the main path's own outputs must carry those digests
    for g in golden["replicas"]:
        br = res[f"{g['alg']}.n20.k1000.loc95"]
        i = g["seed"]
        row = {"alg": g["alg"], "seed": i, "ops": int(br.ops[i]),
               "sim_ns": int(br.sim_ns[i]),
               "reacquires": int(br.reacquires[i]),
               "passes": int(br.passes[i]), "lat_n": g["lat_n"],
               "done_sha256": digest(br.per_thread_ops[i]),
               "lat_sha256": digest(br.lat_ns[i])}
        if row != g:
            problems.append(f"main path differs from the reference for "
                            f"{g['alg']} seed {i}")
    # the same grid one bucket at a time (no bucket issued before the one
    # before it is forced): every replica's outputs must be the same bits
    def grid_digests(result):
        return {lbl: digest(np.concatenate([
            np.ascontiguousarray(a).view(np.uint8).ravel() for a in (
                br.seeds, br.ops, br.sim_ns, br.lat_ns, br.per_thread_ops,
                br.reacquires, br.passes)])) for lbl, _, br in result}
    share, batch.IN_FLIGHT_SHARE = batch.IN_FLIGHT_SHARE, 0.0
    batch.reset_exec_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = exp.run()
    torch.cuda.synchronize()
    serial_wall = time.perf_counter() - t0
    serial_stats = batch.exec_stats()
    batch.IN_FLIGHT_SHARE = share
    serial_equal = grid_digests(res) == grid_digests(serial)
    if not serial_equal:
        problems.append("the concurrent grid differs from the one "
                        "bucket at a time run")
    sanity = {alg: res[f"{alg}.n20.k20.loc100"].mean_mops
              for alg in FIG5_ALGS}
    if not (sanity["alock"] > sanity["spinlock"]
            and sanity["alock"] > sanity["mcs"]):
        problems.append(f"paper trend broken at n20.k20.loc100: {sanity}")
    sim_events = len(distinct) * N_SEEDS * N_EVENTS
    emit({"phase": "main_path", "labelled_workloads": len(exp),
          "distinct_workloads": len(distinct), "seeds": N_SEEDS,
          "n_events": N_EVENTS, "replicas": len(distinct) * N_SEEDS,
          "buckets": n_buckets, "kernel_launches": launches,
          "draw_launches": stats["draw_launches"],
          "plan_launches": stats["plan_launches"],
          "dispatches": stats["dispatches"], "wall_seconds": wall,
          "seconds": stats["seconds"],
          "simulated_events_per_second": sim_events / wall,
          "peak_device_memory_mib": peak_mib,
          "mops_n20_k20_loc100": sanity,
          "golden_replicas_checked": len(golden["replicas"]),
          "smem_plan_last": stats["smem_plan"],
          "one_bucket_at_a_time": {"equal": serial_equal,
                                   "wall_seconds": serial_wall,
                                   "seconds": serial_stats["seconds"],
                                   "kernel_launches":
                                       serial_stats["launches"]},
          "problems": problems})
    if problems:
        raise SystemExit("main_path: " + "; ".join(problems))

    # -- sharded: the same grid through the sharded and chunked layouts ----
    sharded_phases(torch, np, batch, exp, res, dev)

    # -- pairs: the hi/lo int32 output contract through K1 ------------------
    pair_cases = (("closed", "alock", 160, 20, 1000, EV_CUT,
                   batched(wide_ws, EV_CUT, N_SEEDS)),
                  ("open", "alock", OT, ON, OK, OPEN_EV_CHECK,
                   batched(OPEN_WS, OPEN_EV_CHECK, N_SEEDS)))
    pairs_phase(torch, pair_cases)

    # -- coord_stress: the threaded coordination plane (host only) ---------
    coord_stress_phase(run_scenario)

    # -- main_path_open: the registry's open-loop scenarios -----------------
    open_launches = 0
    for name in OPEN_SCENARIOS:
        distinct = list(dict.fromkeys(scenario_workloads(name)))
        n_buckets = len({batch.shape_key(w, N_EVENTS) for w in distinct})
        torch.cuda.synchronize()
        batch.reset_exec_stats()             # every launch count to 0
        t0 = time.perf_counter()
        rows = run_scenario(name, n_seeds=N_SEEDS, n_events=N_EVENTS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = batch.exec_stats()           # read just after
        launches_o = stats["launches"]
        open_launches += launches_o
        problems = []
        if launches_o != n_buckets or launches_o <= 0:
            problems.append(f"kernel launches {launches_o} != buckets "
                            f"{n_buckets}")
        if stats["dispatches"] != n_buckets:
            problems.append(f"dispatches {stats['dispatches']} != "
                            f"{n_buckets}")
        if stats["plan_launches"] != n_buckets:
            problems.append(f"arrival-plan launches "
                            f"{stats['plan_launches']} != shards "
                            f"{n_buckets}")
        serving = [r for r in rows if r["name"].endswith(".serving")]
        if len(serving) != len(distinct):
            problems.append(f"{len(serving)} serving rows for "
                            f"{len(distinct)} workloads")
        for r in serving:
            if not (r["completed"] > 0 and r["offered_per_us"] > 0
                    and 0.0 <= r["drop_rate"] <= 1.0
                    and math.isfinite(r["goodput_per_us"])
                    and math.isfinite(r["p99_sojourn_ns"])):
                problems.append(f"bad serving row {r['name']}")
        for r in rows:
            if "mean_mops" in r and not r["mean_mops"] > 0:
                problems.append(f"no throughput in {r['name']}")
        knees = [r for r in rows if r["name"].endswith(".knee")]
        if name == "open-loop-ramp" and (
                len(knees) != 3
                or all(k["knee_rate_per_us"] is None for k in knees)):
            problems.append(f"knee rows {knees}")
        sim_events = len(distinct) * N_SEEDS * N_EVENTS
        emit({"phase": "main_path_open", "scenario": name,
              "distinct_workloads": len(distinct), "seeds": N_SEEDS,
              "n_events": N_EVENTS, "replicas": len(distinct) * N_SEEDS,
              "buckets": n_buckets, "kernel_launches": launches_o,
              "plan_launches": stats["plan_launches"],
              "dispatches": stats["dispatches"], "wall_seconds": wall,
              "seconds": stats["seconds"],
              "simulated_events_per_second": sim_events / wall,
              "knees": [{k: r[k] for k in ("name", "knee_rate_per_us",
                                          "knee_goodput_per_us")}
                        for r in knees],
              "serving": [{k: r[k] for k in (
                  "name", "offered_per_us", "goodput_per_us", "drop_rate",
                  "p99_sojourn_ns")} for r in serving],
              "problems": problems})
        if problems:
            raise SystemExit(f"main_path_open {name}: " + "; ".join(problems))

    # -- the attention and SSD entry points (K3-K6) ------------------------
    float_records = float_kernel_phases(torch, dev)

    # -- the lock-property path (K2) ----------------------------------------
    tick_record = tick_phases(torch, dev, np)

    # -- analysis: the port's lint on the card ------------------------------
    analysis_phase(torch, dev)

    # -- the per-kernel record ----------------------------------------------
    emit({"kernels": [{
        "name": "event_loop", "route": "cuda",
        "source": "src/repro_torch/csrc/event_loop.cu",
        "replaces": "src/repro/kernels/event_loop/kernel.py:217",
        "launches": launches, "max_abs_err": max_err, "tolerance": 0,
        "shape": dict(WIDE, B=B_full, n_events=N_EVENTS),
        "ms": ms_full,
        # the plain version at the same widths and replica count, with the
        # event count cut to plain_n_events; ms_at_plain_n_events is the
        # kernel at that same cut
        "plain_ms": plain_ms_cut, "plain_n_events": EV_CUT,
        "ms_at_plain_n_events": ms_cut, **k1_row(bound_full),
        "smem_plan": wide_plan, "library_ms": None,
    }, {
        "name": "event_loop[open]", "route": "cuda",
        "source": "src/repro_torch/csrc/event_loop.cu",
        "replaces": "src/repro/kernels/event_loop/kernel.py:217",
        "launches": open_launches, "max_abs_err": max_err_open,
        "tolerance": 0,
        "shape": dict(alg="alock", T=OT, N=ON, K=OK,
                      R=RAMP8.arrivals.max_requests,
                      B=B_ofull, n_events=N_EVENTS),
        "ms": ms_ofull,
        "plain_ms": plain_ms_ocut, "plain_n_events": OPEN_EV_CHECK,
        "ms_at_plain_n_events": ms_ocut, **k1_row(bound_open),
        "smem_plan": open_plan, "library_ms": None,
    }, plan_record, tick_record] + float_records})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
