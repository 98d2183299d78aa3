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
  kernel_check  the CUDA kernel equals its plain PyTorch version on the card
              (``torch.equal`` on all six outputs; tolerance zero) for every
              algorithm, single-phase and phased (churn + fail-slow
              multipliers), at T = 16; then at the main path's widest bucket
              shape (T = 160, N = 20, K = 1000, B = 96) with the event count
              cut for the plain version's sake, where both are timed
  golden      the kernel's outputs for six full-width replicas equal the
              digests the JAX reference wrote to
              ``tests/golden/torch_fig5_full.json``
  main_path   the paper's Fig. 5 grid (89 labelled workloads, 32 seeds,
              150,000 events each) through ``Experiment.run()`` with the
              default device and backend; launch counters are set to 0 just
              before and read just after
  kernels     the per-kernel record: launches on the main path, largest
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

# published peaks of one H100 SXM (dense, full power limit)
HBM_BYTES_PER_S = 3.35e12
ALU32_OPS_PER_S = 67e12        # 32-bit rate outside the tensor cores
#: scalar 32/64-bit operations of one event step besides the argmin,
#: counted from the kernel source: phase resolve and draw hand-off ~14,
#: the longest switch arm ~20, cost application ~20, accounting ~10
STEP_OPS = 64


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


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
    from repro_torch.experiments import Experiment
    from repro_torch.kernels.event_loop import kernel as el_kernel
    from repro_torch.kernels.event_loop.ops import (precompute_draws,
                                                    run_events)
    from repro_torch.workloads import (Phase, Workload, WorkloadOperands,
                                       lower, pad_phases, racks_of,
                                       to_device)

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

    def batched(ws, n_events, n_seeds=1):
        """Lower workloads of one bucket, pad phases, stack (and repeat
        each for ``n_seeds`` consecutive seeds) on a leading axis."""
        lws = [lower(w, n_events) for w in ws]
        pmax = max(lw.operands.n_phases for lw in lws)
        ops = [pad_phases(lw.operands, pmax) for lw in lws]
        wl = WorkloadOperands(*(
            np.repeat(np.stack([np.asarray(getattr(o, f)) for o in ops]),
                      n_seeds, axis=0) for f in WorkloadOperands._fields))
        seeds = (np.repeat(np.asarray([o.seed for o in ops], np.int32),
                           n_seeds)
                 + np.tile(np.arange(n_seeds, dtype=np.int32), len(ops)))
        return to_device(wl._replace(seed=seeds), dev)

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

    # -- kernel_check: CUDA kernel vs its plain version, on the card --------
    def compare(alg, T, N, K, n_events, wl, time_it=False):
        tn, ln, _ = topology(alg, N, T // N, K)
        streams = precompute_draws(wl.seed, wl.edges, wl.zcdf, n_events, N,
                                   K // N, rw=alg == "alock-rw", device=dev)
        kw = dict(device=dev, streams=streams)
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
            ms = time_kernel(alg, T, N, K, n_events, wl, tn, ln, streams)
        return equal, err, ms, plain_ms, int(out_k[0].sum())

    def time_kernel(alg, T, N, K, n_events, wl, tn, ln, streams, reps=3):
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for _ in range(reps):
            run_events(alg, T, N, K, n_events, wl, tn, ln, backend="kernel",
                       device=dev, streams=streams)
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
                el_kernel.ALGS.index(alg), N_S * TPN_S, N_S, K_S, P)
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
    in_bytes = sum(s.numel() * s.element_size() for s in streams) + sum(
        t.numel() * t.element_size() for t in (
            wl_full.edges, wl_full.think_ns, wl_full.locality,
            wl_full.active, wl_full.b_init, wl_full.cost_rows,
            wl_full.node_mult)) + 4 * (160 + 1000)
    out_bytes = B_full * (4 * 160 + 8 * (1 << 15) + 4 + 8 + 4 + 4)
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = (B_full * N_EVENTS * (2 * 160 + STEP_OPS)
              / ALU32_OPS_PER_S * 1e3)
    del streams, wl_full, wl_cut

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
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
