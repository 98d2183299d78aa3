#!/usr/bin/env python3
"""Measure the dependent-chain latencies behind ``chip_smoke.py::k1_bound``.

``python3 scripts/torch_sm_latency.py`` on a machine with an NVIDIA H100
and ``nvcc``: builds ``scripts/torch_sm_latency.cu`` for ``sm_90a`` into
``build/`` and prints, as JSON, the cycles one dependent operation takes
(indexed shared-memory load, L1-resident device load, 32-bit integer
operation, ``redux.sync`` min, shuffle, store then load), the SM clock
under that chain, and the card's ``nvidia-smi`` name, power limit and
maximum SM clock. Exits non-zero without a CUDA device or ``nvcc``.
"""
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        print("torch_sm_latency: nvcc not found", file=sys.stderr)
        return 1
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    exe = os.path.join(out_dir, "torch_sm_latency")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-o", exe,
                    os.path.join(HERE, "torch_sm_latency.cu")], check=True)
    run = subprocess.run([exe], capture_output=True, text=True)
    if run.returncode != 0:
        print(run.stdout, run.stderr, file=sys.stderr)
        return run.returncode
    rec = json.loads(run.stdout)
    rec["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm,clocks.sm",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
