#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA GPU (written for an H100, sm_90a), ``nvcc`` and the
repository's ``src/`` beside this file; needs no network and no JAX.
Without a CUDA device it exits non-zero and prints no result — it never
runs on the CPU.

It builds the event-loop kernel from ``src/repro_torch/csrc``, then prints
one JSON object per phase:

  device      card name and power limit (``nvidia-smi``), torch/CUDA versions
  build       seconds ``nvcc`` took
  prng        the draw stream on the card equals the one made on the CPU
  traffic_plan  the open loop's arrival plan (gaps, token-admit mask, its
              prefix count, queue bounds, arrival times) made on the card
              equals the one made on the CPU: seeds {0, 1, 7, 2**31-1} x the
              ramp rates, a token policy and burst-storm's phased rates
  kernel_check  the CUDA kernel equals its plain PyTorch version on the card
              (``torch.equal`` on all six outputs; tolerance zero) for every
              algorithm, single-phase and phased (churn + fail-slow
              multipliers), at T = 16; then at the main path's widest bucket
              shape (T = 160, N = 20, K = 1000, B = 96) with the event count
              cut for the plain version's sake, where both are timed
  kernel_check_open  the same for the open loop (all ten outputs): every
              algorithm x {open-loop-ramp at 8 req/us with queue bound 32,
              burst-storm's token policy} at the registry's topology (4 x 4
              threads, 16 locks, R = 256), 1,500 events; then the alock
              open-loop-ramp bucket (B = 192), timed, events cut for the
              plain version
  golden      the kernel's outputs for six full-width replicas equal the
              digests the JAX reference wrote to
              ``tests/golden/torch_fig5_full.json``
  golden_open the kernel's open-loop outputs at full depth (150,000 events)
              equal ``tests/golden/torch_open_loop_full.json``
  main_path   the paper's Fig. 5 grid (89 labelled workloads, 32 seeds,
              150,000 events each) through ``Experiment.run()`` with the
              default device and backend; launch counters are set to 0 just
              before and read just after
  main_path_open  ``run_scenario("open-loop-ramp")`` and ``("burst-storm")``
              at 32 seeds x 150,000 events with the default device and
              backend, counters set to 0 just before each and read just
              after: launches, seconds by stage, events/s, knee rows
  library_baselines  one PyTorch call per off-path TPU kernel that has one
              (``scaled_dot_product_attention`` forward and backward at the
              reference tests' attention shapes), timed as a yardstick, and
              the bound of every off-path kernel at its test shape
  kernels     the per-kernel record: launches on each main path, largest
              deviation from the plain version, times and the roofline bound

and, last, the card's ``nvidia-smi`` line and ``{"ok": true, "device":
{...}}``. Any phase that fails raises, and the run exits non-zero.
"""
import hashlib
import json
import math
import os
import subprocess
import sys
import time

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
# the scenario registry's open-loop cells
OPEN_SCENARIOS = ("open-loop-ramp", "burst-storm")
OPEN_EV_CHECK = 1500
PLAN_SEEDS = (0, 1, 7, 2**31 - 1)

# published peaks of one H100 SXM (dense, full power limit)
HBM_BYTES_PER_S = 3.35e12
ALU32_OPS_PER_S = 67e12        # 32-bit rate outside the tensor cores
#: scalar 32/64-bit operations of one event step besides the argmin,
#: counted from the kernel source: phase resolve and draw hand-off ~14,
#: the longest switch arm ~20, cost application ~20, accounting ~10
STEP_OPS = 64
#: scalar operations the open loop needs per event besides the argmin and
#: the transition. Arrival times are sorted and dispatch is FIFO in slot
#: order, so the next arrival, the arrival count and the queue head are
#: each a pointer that only moves forward: a test and an advance each (6),
#: plus the live / idle / step_ok decision (4). The kernel's scans of all
#: R slots on every event are its own choice, not work the inputs need.
OPEN_EVENT_OPS = 10
#: scalar operations per request, once per run: ingestion (token and
#: queue-bound test, status) 5, dispatch (status, bind, wait stamp) 4,
#: departure (sojourn stamp, status) 3
REQ_OPS = 12


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def k1_bound(wl, streams, T, K, n_events, lat_samples=1 << 15):
    """(bytes bound ms, operations bound ms) of one K1 launch over the
    operands ``wl`` (tensors on the card) and draw ``streams``: every input
    read once and every output written once over the HBM rate; per event
    and replica 2 operations per thread for the masked argmin, STEP_OPS for
    the transition and, open loop, OPEN_EVENT_OPS, plus REQ_OPS per request
    slot once per replica, over the 32-bit rate. The transition is charged
    on every event, also on the open loop's no-op events, which skip it."""
    B, R = int(wl.seed.shape[0]), int(wl.arr_fix.shape[-1])
    in_bytes = sum(s.numel() * s.element_size() for s in streams) + sum(
        t.numel() * t.element_size() for t in (
            wl.edges, wl.think_ns, wl.locality, wl.active, wl.b_init,
            wl.cost_rows, wl.node_mult)) + 4 * (T + K)
    out_bytes = B * (4 * T + 8 * lat_samples + 4 + 8 + 4 + 4)
    if R:
        in_bytes += B * R * (8 + 3 * 4)      # arr, tok, tokcum, qcap
        out_bytes += B * R * (8 + 8 + 4)     # wq, soj, rstat
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops = (B * n_events * (2 * T + STEP_OPS + (OPEN_EVENT_OPS if R else 0))
           + B * R * REQ_OPS)
    ops_ms = ops / ALU32_OPS_PER_S * 1e3
    return bytes_ms, ops_ms


def offpath_bounds():
    """Bound (ms) of each off-path TPU kernel at the largest shape the
    reference's own tests give it (``tests/test_sim_and_kernels.py``):
    bytes = every input read once and every output written once, over the
    HBM rate; operations over the card's rate for their type (i32 and f32
    both 67 T/s outside the tensor cores; the f32 products run there at
    PyTorch's default full-f32 precision)."""
    def row(nbytes, nops, shape):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = nops / ALU32_OPS_PER_S * 1e3
        return {"shape": shape, "bytes": nbytes, "operations": nops,
                "bound_ms": max(b_ms, o_ms),
                "bound_by": "bytes" if b_ms >= o_ms else "operations"}
    # K2 alock_tick: Tab tables, T threads, `steps` scheduled steps, all
    # i32; ~40 scalar operations per (table, step) counted from
    # _tick_kernel's gathers, compares and selects
    Tab, T, steps = 8, 4, 300
    state = 2 + 1 + 4 * T                     # tails, victim, pc/bud/nxt/prev
    k2 = row(4 * (Tab * steps + Tab * T + 2 * Tab * state),
             Tab * steps * 40, dict(tables=Tab, T=T, steps=steps))
    # K3 flash forward, causal: q, k, v in, o and lse out; QK^T and PV over
    # the causal half
    B, H, S, hd = 2, 2, 256, 128
    k3 = row(4 * (4 * B * H * S * hd + B * H * S),
             2 * B * H * S * S * hd, dict(B=B, H=H, S=S, hd=hd, f32=True,
                                          causal=True))
    # K4 dq / K5 dk,dv, causal: q, k, v, do, lse, delta in; 3 (dq) or 4
    # (dk, dv) products over the causal half
    B, H, S, hd = 2, 2, 64, 16
    bwd_in = 4 * (4 * B * H * S * hd + 2 * B * H * S)
    shp = dict(B=B, H=H, S=S, hd=hd, f32=True, causal=True)
    k4 = row(bwd_in + 4 * B * H * S * hd, 3 * B * H * S * S * hd, shp)
    k5 = row(bwd_in + 8 * B * H * S * hd, 4 * B * H * S * S * hd, shp)
    # K6 ssd intra-chunk: xd, dA, b, c in; y_diag, states, chunk_decay out;
    # C B^T, the masked decay, W X and the chunk state per (batch, chunk)
    B, S, H, P, N, L = 2, 128, 2, 32, 16, 32
    nc = S // L
    k6 = row(4 * (B * nc * L * H * P + B * nc * L * H + 2 * B * nc * L * N
                  + B * nc * L * H * P + B * nc * H * P * N + B * nc * H),
             B * nc * (2 * L * L * N + H * (3 * L * L + 2 * L * L * P
                                            + 2 * L * P * N + L * P)),
             dict(B=B, S=S, H=H, P=P, N=N, chunk=L))
    return {"K2": k2, "K3": k3, "K4": k4, "K5": k5, "K6": k6}


def library_baselines(torch, dev, reps=20):
    """``scaled_dot_product_attention`` forward at K3's test shape and its
    backward (dq, dk and dv in one call) at K4/K5's, timed with CUDA events
    over ``reps`` calls after a warm-up; a yardstick only — nothing in the
    port calls it. K2 and K6 have no PyTorch call of the same function."""
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(0)

    def timed(fn):
        for _ in range(3):
            fn()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    q, k, v = (torch.randn((2, 2, 256, 128), device=dev, generator=g)
               for _ in range(3))
    fwd_ms = timed(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    q, k, v = (torch.randn((2, 2, 64, 16), device=dev, generator=g,
                           requires_grad=True) for _ in range(3))
    o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    do = torch.randn_like(o)
    bwd_ms = timed(lambda: torch.autograd.grad(o, (q, k, v), do,
                                               retain_graph=True))
    bounds = offpath_bounds()
    lib_ms = {"K2": None, "K3": fwd_ms, "K4": bwd_ms, "K5": bwd_ms,
              "K6": None}
    return {"phase": "library_baselines",
            "library_call": {
                "K3": "F.scaled_dot_product_attention(q, k, v, "
                      "is_causal=True), f32",
                "K4/K5": "torch.autograd.grad of it (dq, dk, dv in one "
                         "call), f32"},
            "kernels": {n: dict(b, library_ms=lib_ms[n])
                        for n, b in bounds.items()}}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this run needs one "
              "GPU and does not run on the CPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np
    from repro_torch.core import batch
    from repro_torch.core.sim import topology
    from repro_torch.experiments import (Experiment, run_scenario,
                                         scenario_workloads)
    from repro_torch.kernels.event_loop import kernel as el_kernel
    from repro_torch.kernels.event_loop.ops import (precompute_draws,
                                                    precompute_plan,
                                                    run_events)
    from repro_torch.traffic.stream import arrival_plan, arrival_times_i64
    from repro_torch.workloads import (Arrivals, Phase, Workload,
                                       WorkloadOperands, lower, pad_phases,
                                       racks_of, to_device)

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib = el_kernel.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": el_kernel.build_seconds(),
          "library": os.path.relpath(str(el_kernel.build()), HERE)})

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
    emit({"phase": "prng", "equal": prng_equal, "streams": len(on_gpu),
          "shape": list(on_gpu[0].shape)})
    if not prng_equal:
        raise SystemExit("prng: the draw stream differs between cpu and cuda")

    # the registry's open-loop workloads: ramp rates x algorithms, and
    # burst-storm's admission policies x algorithms
    RAMP_WS, BURST_WS = (scenario_workloads(n) for n in OPEN_SCENARIOS)
    RAMP_ALOCK = [w for w in RAMP_WS if w.alg == "alock"]
    RAMP8 = next(w for w in RAMP_ALOCK if w.arrivals.rate_per_us == 8.0)
    BURST_TOKEN = next(w for w in BURST_WS if w.alg == "alock"
                       and w.arrivals.token_rate_per_us > 0.0)

    # -- traffic_plan: the arrival plan made on the card equals the CPU's --
    plan_cases = {
        "ramp_rates": RAMP_ALOCK,
        "token": [RAMP8.replace(arrivals=Arrivals(
            rate_per_us=4.0, max_requests=RAMP8.arrivals.max_requests,
            token_rate_per_us=2.0, token_burst=16.0))],
        "burst_storm_phased": [w for w in BURST_WS if w.alg == "alock"],
    }
    plan_rows = []
    for name, ws in plan_cases.items():
        st = stacked([w.replace(seed=s) for s in PLAN_SEEDS for w in ws],
                     N_EVENTS)
        p_cpu = arrival_plan(to_device(st, "cpu"), N_EVENTS)
        p_gpu = arrival_plan(to_device(st, dev), N_EVENTS)
        arrs = (list(zip(p_cpu, p_gpu))
                + [(arrival_times_i64(p_cpu.gaps),
                    arrival_times_i64(p_gpu.gaps))])
        differ = [int((a != b.cpu()).sum()) for a, b in arrs]
        plan_rows.append({"case": name, "replicas": int(st.seed.shape[0]),
                          "R": int(st.arr_fix.shape[-1]),
                          "differing": dict(zip(
                              ("gaps", "tok", "tokcum", "qcap", "arr"),
                              differ)),
                          "admitted": int(p_gpu.tok.sum())})
    plan_equal = all(sum(r["differing"].values()) == 0 for r in plan_rows)
    emit({"phase": "traffic_plan", "equal": plan_equal, "cases": plan_rows})
    if not plan_equal:
        raise SystemExit("traffic_plan: the arrival plan differs between "
                         "cpu and cuda")

    # -- kernel_check: CUDA kernel vs its plain version, on the card --------
    def compare(alg, T, N, K, n_events, wl, time_it=False):
        tn, ln, _ = topology(alg, N, T // N, K)
        streams = precompute_draws(wl.seed, wl.edges, wl.zcdf, n_events, N,
                                   K // N, rw=alg == "alock-rw", device=dev)
        plan = (precompute_plan(wl, n_events, device=dev)
                if wl.arr_fix.shape[-1] else None)
        kw = dict(device=dev, streams=streams, plan=plan)
        out_k = run_events(alg, T, N, K, n_events, wl, tn, ln,
                           backend="kernel", **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = run_events(alg, T, N, K, n_events, wl, tn, ln,
                           backend="plain", **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        equal = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(out_k, out_p))
        ms = None
        if time_it:
            ms = time_kernel(alg, T, N, K, n_events, wl, tn, ln, streams,
                             plan)
        return equal, err, ms, plain_ms, int(out_k[0].sum())

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

    checks = []
    max_err = 0.0
    N_S, TPN_S, K_S, EV_S = 4, 4, 16, 2000
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
            wl = batched(ws, EV_S)
            P = wl.edges.shape[1]
            smem_c = lib.event_loop_smem_bytes(
                el_kernel.ALGS.index(alg), N_S * TPN_S, N_S, K_S, P, 0)
            smem_py = el_kernel.smem_bytes(alg, N_S * TPN_S, N_S, K_S, P)
            equal, err, _, plain_ms, ops = compare(
                alg, N_S * TPN_S, N_S, K_S, EV_S, wl)
            max_err = max(max_err, err)
            checks.append({"alg": alg, "case": name, "equal": equal,
                           "ops": ops, "plain_ms": plain_ms,
                           "smem_bytes": smem_c,
                           "smem_table_agrees": smem_c == smem_py})
    # the main path's widest bucket: alock, 20 nodes x 8 threads, 1000
    # locks, 3 localities x 32 seeds; event count cut for the plain version
    WIDE = dict(alg="alock", T=160, N=20, K=1000)
    EV_CUT = 3000
    wide_ws = [Workload("alock", 20, TPN, 1000, locality=l)
               for l in LOCALITY]
    wl_cut = batched(wide_ws, EV_CUT, N_SEEDS)
    equal, err, ms_cut, plain_ms_cut, ops = compare(
        "alock", 160, 20, 1000, EV_CUT, wl_cut, time_it=True)
    max_err = max(max_err, err)
    if ops <= 0:
        raise SystemExit("kernel_check: the cut run completed no operation")
    checks.append({"alg": "alock", "case": "main_path_width_cut_events",
                   "equal": equal, "ops": ops, "B": int(wl_cut.seed.shape[0]),
                   "n_events": EV_CUT, "ms": ms_cut,
                   "plain_ms": plain_ms_cut})
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
    B_full = int(wl_full.seed.shape[0])
    bytes_ms, ops_ms = k1_bound(wl_full, streams, 160, 1000, N_EVENTS)
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
        wl = batched(ws, OPEN_EV_CHECK)
        P, R = wl.edges.shape[1], wl.arr_fix.shape[-1]
        smem_c = lib.event_loop_smem_bytes(el_kernel.ALGS.index(alg), OT, ON,
                                           OK, P, R)
        smem_py = el_kernel.smem_bytes(alg, OT, ON, OK, P, R)
        equal, err, _, plain_ms, ops = compare(alg, OT, ON, OK,
                                               OPEN_EV_CHECK, wl)
        max_err_open = max(max_err_open, err)
        open_checks.append({"alg": alg,
                            "case": "open-loop-ramp rate 8 qcap 32 + "
                                    "burst-storm token (P = 3)",
                            "equal": equal, "ops": ops, "R": R,
                            "n_events": OPEN_EV_CHECK, "plain_ms": plain_ms,
                            "smem_bytes": smem_c,
                            "smem_table_agrees": smem_c == smem_py})
    # the open-loop-ramp bucket of alock (6 rates x 32 seeds), timed, with
    # the event count cut for the plain version
    OPEN_WS = RAMP_ALOCK
    wl_ocut = batched(OPEN_WS, OPEN_EV_CHECK, N_SEEDS)
    equal, err, ms_ocut, plain_ms_ocut, ops = compare(
        "alock", OT, ON, OK, OPEN_EV_CHECK, wl_ocut, time_it=True)
    max_err_open = max(max_err_open, err)
    open_checks.append({"alg": "alock", "case": "open_bucket_cut_events",
                        "equal": equal, "ops": ops,
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
    obytes_ms, oops_ms = k1_bound(wl_ofull, ostreams, OT, OK, N_EVENTS)
    del ostreams, oplan, wl_ofull, wl_ocut

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
          "dispatches": stats["dispatches"], "wall_seconds": wall,
          "seconds": stats["seconds"],
          "simulated_events_per_second": sim_events / wall,
          "peak_device_memory_mib": peak_mib,
          "mops_n20_k20_loc100": sanity,
          "golden_replicas_checked": len(golden["replicas"]),
          "problems": problems})
    if problems:
        raise SystemExit("main_path: " + "; ".join(problems))

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

    # -- library_baselines: yardsticks and bounds of the off-path kernels --
    emit(library_baselines(torch, dev))

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
        "ms_at_plain_n_events": ms_cut,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bound_bytes_ms": bytes_ms, "bound_operations_ms": ops_ms,
        "library_ms": None,
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
        "ms_at_plain_n_events": ms_ocut,
        "bound_ms": max(obytes_ms, oops_ms),
        "bound_by": "bytes" if obytes_ms >= oops_ms else "operations",
        "bound_bytes_ms": obytes_ms, "bound_operations_ms": oops_ms,
        "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
