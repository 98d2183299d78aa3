#!/usr/bin/env python3
"""Time K1 (``csrc/event_loop.cu``) against variants of its own design.

``python3 scripts/torch_k1_variants.py [--against OTHER.cu]`` on a machine
with an NVIDIA H100 and ``nvcc``. At the widest Fig. 5 bucket (20 nodes x
8 threads, 1000 locks, 3 localities x 32 seeds = 96 replicas, 150,000
events) it times, with CUDA events over 3 launches after a warm-up:

- the kernel as committed, then again at 2, 4 and 8 replicas per block;
- build-local copies of the source, each with one design choice undone
  (``VARIANTS``): the launch bound without its one-block minimum, the
  closed loop's lane-0 body (keys in the region, every step on lane 0) at
  T <= 256 in place of the owner-lane body;
- with ``--against``, another version of ``csrc/event_loop.cu`` (say, a
  parent commit's) built beside it: alock, mcs and spinlock timed on both
  in one process, other | committed | committed | other, outputs equal;
- a copy with ``clock64()`` stamps (``PROFILE_STAMPS``): the cycles one
  event spends in each part of the loop (20,000 events; the stepping
  lane's parts summed over the warp), and by the PC of the step;

each copy checked equal to the committed kernel's outputs; then the Fig. 5
grid through ``Experiment.run()`` at 1, 2, 4, 8 and 16 CUDA streams in the
sweep's pool. Prints one JSON object per line, the last the card's
``nvidia-smi`` name and power limit. Builds go to ``build/``.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SRC = ROOT / "src" / "repro_torch" / "csrc" / "event_loop.cu"

#: name -> [(text in the committed source, its replacement)]
VARIANTS = {
    "launch_bound_without_min_blocks": [
        ("__launch_bounds__(32 * MAX_WARPS, 1)",
         "__launch_bounds__(32 * MAX_WARPS)")],
    "lane0_body": [
        ("        if (a.T <= 32 * LANE_SLOTS) {",
         "        if (false) {")],
}

#: clock64() stamps: loop head, argmin, tid decode and the open loop's
#: queue (lane 0's), then the step: the stepping lane's transition
#: (prologue loads, switch and arm, cost application, the rest) and the
#: tail to the warp's reconvergence; the stepping lanes' parts are summed
#: over the warp at the end
PROFILE_STAMPS = [
    ("    bool idle_for_good = false;\n",
     "    bool idle_for_good = false;\n"
     "    long long prof[6] = {0, 0, 0, 0, 0, 0}, fine[3] = {0, 0, 0};\n"
     "    long long pcyc[18] = {0}; int pcnt[18] = {0}; int lastp = -1;\n"
     "    long long c3 = 0, c4 = 0;\n"),
    ("      for (; i < seg_end; ++i) {\n",
     "      for (; i < seg_end; ++i) {\n"
     "        const long long c0 = clock64();\n"),
    ("        // -- tid = argmin",
     "        const long long c1 = clock64();\n        // -- tid = argmin"),
    ("        // the selected thread's clock",
     "        const long long c2 = clock64();\n"
     "        // the selected thread's clock"),
    ("        if ((LANE ? lane == (tid & 31) : lane == 0) && step_ok) {",
     "        c3 = clock64();\n"
     "        if ((LANE ? lane == (tid & 31) : lane == 0) && step_ok) {"),
    ("            switch (p) {\n            case NCS: {",
     "            const long long f0 = clock64();\n"
     "            switch (p) {\n            case NCS: {"),
    ("            pc[tid] = newpc;\n",
     "            pc[tid] = newpc;\n            lastp = p;\n"
     "            const long long f1 = clock64();\n"),
    ("            // what the next event's argmin reads, first\n",
     "            const long long f2 = clock64();\n"
     "            fine[0] += f0 - c3; fine[1] += f1 - f0; fine[2] += f2 - f1;\n"
     "            // what the next event's argmin reads, first\n"),
    ("            npass += (p == PASS);\n        }\n        __syncwarp();\n"
     "      }",
     "            npass += (p == PASS);\n        }\n"
     "        c4 = clock64();\n        __syncwarp();\n"
     "        const long long c5 = clock64();\n"
     "        prof[0] += c1 - c0; prof[1] += c2 - c1; prof[2] += c3 - c2;\n"
     "        prof[3] += c4 - c3; prof[4] += c5 - c4; prof[5] += 1;\n"
     "        if (lastp >= 0) {\n"
     "            pcyc[lastp] += c4 - c3; pcnt[lastp] += 1; lastp = -1;\n"
     "        }\n"
     "      }"),
    # the stepping lanes' parts summed over the warp
    ("    if (lane == 0) {\n        a.lat_n[b] = lat_n;",
     "    for (int q = 0; q < 21; ++q) {\n"
     "        long long v = q < 3 ? fine[q] : pcyc[q - 3];\n"
     "        for (int off = 16; off > 0; off >>= 1)\n"
     "            v += __shfl_xor_sync(FULL, v, off);\n"
     "        if (q < 3) fine[q] = v; else pcyc[q - 3] = v;\n"
     "    }\n"
     "    for (int q = 0; q < 18; ++q) pcnt[q] = warp_sum(pcnt[q]);\n"
     "    if (lane == 0) {\n        a.lat_n[b] = lat_n;"),
    # the stamps leave through the latency ring's first 45 slots
    ("        a.npass[b] = npass;\n",
     "        a.npass[b] = npass;\n"
     "        long long* o = a.lat + (size_t)b * a.lat_samples;\n"
     "        for (int q = 0; q < 6; ++q) o[q] = prof[q];\n"
     "        for (int q = 0; q < 3; ++q) o[6 + q] = fine[q];\n"
     "        for (int q = 0; q < 18; ++q) {\n"
     "            o[9 + q] = pcyc[q]; o[27 + q] = pcnt[q];\n        }\n"),
]


def emit(obj):
    print(json.dumps(obj), flush=True)


def edited(name, edits):
    text = SRC.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new, 1)
    path = ROOT / "build" / f"k1_variant_{name}.cu"
    path.parent.mkdir(exist_ok=True)
    path.write_text(text)
    return path


def main(argv=None):
    import argparse

    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another event_loop.cu to time beside the "
                         "committed one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k1_variants: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import batch
    from repro_torch.core.sim import topology
    from repro_torch.experiments import Experiment
    from repro_torch.kernels import _build
    from repro_torch.kernels.event_loop import kernel as K
    from repro_torch.kernels.event_loop.ops import precompute_draws
    from repro_torch.workloads import (Workload, WorkloadOperands, lower,
                                       to_device)
    dev = torch.device("cuda")
    committed = K.LIB.load
    specs = [(edited(n, e), f"k1_variant_{n}", K.LIB.flags)
             for n, e in VARIANTS.items()]
    specs.append((edited("profile", PROFILE_STAMPS), "k1_variant_profile",
                  K.LIB.flags))
    if args.against is not None:
        other = ROOT / "build" / "k1_variant_against.cu"
        other.parent.mkdir(exist_ok=True)
        other.write_text(args.against.read_text())
        specs.append((other, "k1_variant_against", K.LIB.flags))
    _build.build_all(specs)

    def use(stem):
        K.LIB.load = committed if stem is None else (
            lambda: _build.load(
                ROOT / "build" / f"{stem}.cu", stem,
                lambda lib: _build.bind(lib, K.LIB.signatures), K.LIB.flags))

    def widest(n_events, alg="alock"):
        lws = [lower(Workload(alg, 20, 8, 1000, locality=l), n_events)
               for l in (0.85, 0.95, 1.0)]
        wl = WorkloadOperands(*(
            np.repeat(np.stack([np.asarray(getattr(lw.operands, f))
                                for lw in lws]), 32, axis=0)
            for f in WorkloadOperands._fields))
        seeds = (np.repeat(np.asarray([lw.operands.seed for lw in lws],
                                      np.int32), 32)
                 + np.tile(np.arange(32, dtype=np.int32), 3))
        wl = to_device(wl._replace(seed=seeds), dev)
        streams = precompute_draws(wl.seed, wl.edges, wl.zcdf, n_events, 20,
                                   50, device=dev)
        return wl, streams

    def launch(wl, streams, n_events, warps=None, alg="alock"):
        tn, ln, _ = topology(alg, 20, 8, 1000)
        return K.run_events_kernel(
            alg, 160, 20, 1000, n_events, wl, torch.from_numpy(tn).to(dev),
            torch.from_numpy(ln).to(dev), streams, lat_samples=1 << 15,
            warps=warps)

    def timed(wl, streams, n_events, warps=None, alg="alock"):
        launch(wl, streams, n_events, warps, alg)
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for _ in range(3):
            launch(wl, streams, n_events, warps, alg)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / 3

    n_events = 150_000
    wl, streams = widest(n_events)
    use(None)
    ref = launch(wl, streams, n_events)
    for warps in (None, 2, 4, 8):
        emit({"variant": "committed", "warps": warps,
              "ms": timed(wl, streams, n_events, warps)})
    for name in VARIANTS:
        use(f"k1_variant_{name}")
        out = launch(wl, streams, n_events)
        emit({"variant": name, "ms": timed(wl, streams, n_events),
              "equal_to_committed": all(torch.equal(x, y)
                                        for x, y in zip(out, ref))})
    use(None)
    emit({"variant": "committed", "ms": timed(wl, streams, n_events)})
    del wl, streams, ref

    # another version of the source beside the committed one, per
    # algorithm: other | committed | committed | other
    if args.against is not None:
        for alg in ("alock", "mcs", "spinlock"):
            wl, streams = widest(n_events, alg)
            use(None)
            ref = launch(wl, streams, n_events, alg=alg)
            use("k1_variant_against")
            out = launch(wl, streams, n_events, alg=alg)
            ms = {"against": [], "committed": []}
            for stem in ("k1_variant_against", None, None,
                         "k1_variant_against"):
                use(stem)
                ms["committed" if stem is None else "against"].append(
                    timed(wl, streams, n_events, alg=alg))
            use(None)
            emit({"against": str(args.against), "alg": alg, "ms": ms,
                  "equal_to_committed": all(torch.equal(x, y)
                                            for x, y in zip(out, ref))})
            del wl, streams, ref, out

    # where an event's cycles go
    wl, streams = widest(20_000)
    use("k1_variant_profile")
    lat = launch(wl, streams, 20_000)[1][:, :45].double().cpu().numpy()
    use(None)
    per = lat[:, :5] / lat[:, 5:6]
    fine = lat[:, 6:9] / lat[:, 5:6]
    pcyc, pcnt = lat[:, 9:27].sum(0), lat[:, 27:45].sum(0)
    emit({"profile": "cycles per event, widest bucket, 20,000 events",
          "loop_head": per[:, 0].mean(), "argmin": per[:, 1].mean(),
          "tid_and_queue": per[:, 2].mean(),
          "step_to_reconvergence": (per[:, 3] + per[:, 4]).mean(),
          "event": per.sum(1).mean(),
          "transition": (pcyc.sum() / pcnt.sum()),
          "transition_prologue": fine[:, 0].mean(),
          "transition_switch_and_arm": fine[:, 1].mean(),
          "transition_cost": fine[:, 2].mean(),
          "by_pc": {int(q): {"share": pcnt[q] / pcnt.sum(),
                             "transition_cycles": pcyc[q] / pcnt[q]}
                    for q in range(18) if pcnt[q]}})
    del wl, streams

    # the Fig. 5 grid at several stream-pool sizes
    exp = Experiment("fig5", n_seeds=32, n_events=150_000)
    for n in (5, 10, 20):
        for k in (20, 100, 1000):
            for loc in (0.85, 0.95, 1.0):
                for alg in ("alock", "spinlock", "mcs"):
                    exp.add(Workload(alg, n, 8, k, locality=loc),
                            label=f"{alg}.n{n}.k{k}.loc{int(loc * 100)}")
    for tpn in (2, 4, 8, 12):
        for alg in ("alock", "spinlock"):
            exp.add(Workload(alg, 20, tpn, 20, locality=0.95),
                    label=f"{alg}.scale.t{tpn}")
    exp.run()                                            # warm-up
    pool = batch.N_STREAMS
    for n_streams in (8, 1, 2, 4, 16, 8):
        batch.N_STREAMS = n_streams
        batch._STREAMS.clear()
        torch.cuda.synchronize()
        batch.reset_exec_stats()
        t0 = time.perf_counter()
        exp.run()
        torch.cuda.synchronize()
        emit({"fig5_streams": n_streams,
              "wall_seconds": time.perf_counter() - t0,
              "seconds": batch.exec_stats()["seconds"]})
    batch.N_STREAMS = pool
    batch._STREAMS.clear()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
