"""Run cells several times and report each metric's spread.

    python simbench/spread.py --out runs.jsonl --seconds 30 \\
        --runs fig5-grid:11,12,13 open-ramp:21,22 [--trace 0|1]

Each ``cell:seeds`` runs ``simbench/run.py`` once per seed, one process
after another, in the order given; every result line is appended to
``--out`` with its cell, seed and exit code, and each process's standard
error goes beside it (``<out>.<cell>.<seed>.err``). At the end, per cell
and metric: the median and the spread, the distance between the first
and third quartile (``statistics.quantiles(values, n=4)``) as a share of
the median; the bound rule takes about five times the widest spread.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values) -> float:
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--runs", nargs="+", required=True)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = {}
    for item in args.runs:
        cell, _, seeds = item.partition(":")
        for seed in seeds.split(","):
            err = out.with_name(f"{out.name}.{cell}.{seed}.err")
            with open(err, "w") as ef:
                p = subprocess.run(
                    [sys.executable, str(ROOT / "simbench" / "run.py"),
                     "--workload", cell, "--seed", seed, "--seconds",
                     str(args.seconds), "--trace", str(args.trace)],
                    cwd=ROOT, stdout=subprocess.PIPE, stderr=ef, text=True)
            last = (p.stdout.strip().splitlines() or [""])[-1]
            try:
                res = json.loads(last)
            except json.JSONDecodeError:
                res = None
            rec = {"cell": cell, "seed": int(seed), "rc": p.returncode,
                   "trace": args.trace, "result": res}
            with open(out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            lines.setdefault(cell, []).append(rec)
            print(json.dumps({"cell": cell, "seed": int(seed),
                              "rc": p.returncode,
                              "correct": res and res["correct"],
                              "metrics": res and {
                                  k: v["value"] for k, v in
                                  res["metrics"].items()}}), flush=True)
    for cell, recs in lines.items():
        ok = [r["result"] for r in recs if r["result"]]
        names = sorted({k for r in ok for k in r["metrics"]})
        summary = {}
        for n in names:
            v = [r["metrics"][n]["value"] for r in ok if n in r["metrics"]]
            summary[n] = {"median": statistics.median(v),
                          "spread": spread(v), "n": len(v)}
        print(json.dumps({"cell": cell, "correct": sum(
            bool(r["correct"]) for r in ok), "runs": len(recs),
            "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
