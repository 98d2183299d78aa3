"""The control of the check: the plain reference in bfloat16 put in the
program's place, judged as a run judges the program.

    python simbench/control.py --workload <cell> --seeds 1,2,3 \\
        --jobs <n> [--workers 8]

For each seed it takes the sample a run of ``<n>`` jobs would take (the
sample's keys depend on the seed and the job index only), makes the
"program's" outputs of it with the reference computed one precision
below the configuration's: every f32 value the simulation reads (the
uniform draws, the locality and read shares, the Zipf table, the
fail-slow multipliers, the Poisson jitter) rounded to bfloat16; then
``check.judge`` compares them with the reference in f32, and
``check.verdict``, the rule a run's ``correct`` follows, judges the
numbers; one JSON line a seed gives both. A sound check prints
``"correct": false`` on every seed.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from simbench import check, harness, inputs  # noqa: E402


class LowPrecision:
    """The program's part in ``harness.Sampler``, played by the reference
    in bfloat16; replicas are computed only when the sample asks."""

    def __init__(self, config: dict, workers: int):
        self.config, self.workers = config, workers
        self.cache: dict = {}

    def run_job(self, workloads) -> list[dict]:
        groups = {}
        if self.config.get("knee"):
            groups = inputs.ramp_groups(workloads, self.config["knee"])
        out = [{"workload": d, "job": workloads, "group": None}
               for d in workloads]
        for idx in groups.values():
            for i in idx:
                out[i]["group"] = idx
        return out

    def replicas(self, keys):
        todo = [k for k in dict.fromkeys(keys) if k not in self.cache]
        n = self.config["n_events"]
        reps = check.reference_replicas(
            [(json.loads(d), s, n) for d, s in todo], self.workers,
            low=True)
        self.cache.update(zip(todo, reps))
        return [self.cache[k] for k in keys]

    def _keys(self, d):
        dj = json.dumps(d, sort_keys=True)
        return [(dj, d["seed"] + s) for s in range(self.config["n_seeds"])]

    # The sample is drawn before anything is computed: each read is a
    # thunk, and ``resolve`` computes the sample's replicas at once.

    def arrays(self, item, s):
        return lambda: check.as_arrays(
            self.replicas(self._keys(item["workload"]))[s])

    def full_rows(self, item):
        return lambda: check.rows_of(
            self.replicas(self._keys(item["workload"])))

    def knee_of(self, item):
        if item["group"] is None:
            return None
        ws = [item["job"][i] for i in item["group"]]

        def row():
            keys = [k for d in ws for k in self._keys(d)]
            reps = self.replicas(keys)
            S = self.config["n_seeds"]
            rows = [check.rows_of(reps[i * S:(i + 1) * S])["serving"]
                    for i in range(len(ws))]
            return ("group", check.knee_row(rows, self.config["knee"]))
        return row

    def resolve(self, sample: check.Sample) -> check.Sample:
        keys = [k for w in sample.whole for k in self._keys(w.workload)]
        keys += [(json.dumps(x.workload, sort_keys=True),
                  x.workload["seed"] + x.s) for x in sample.singles]
        self.replicas(keys)
        whole = [check.Whole(w.workload, [a() for a in w.arrays], w.rows(),
                             w.knee() if w.knee else None)
                 for w in sample.whole]
        singles = [check.Single(x.workload, x.s, x.arrays())
                   for x in sample.singles]
        return check.Sample(whole, singles)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--jobs", type=int, required=True)
    ap.add_argument("--workers", type=int, default=min(8, os.cpu_count()))
    args = ap.parse_args(argv)
    cell = inputs.cell(ROOT, args.workload)
    config = cell["config"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        low = LowPrecision(config, args.workers)
        sampler = harness.Sampler(seed, config, low)
        for j, ws in itertools.islice(
                inputs.jobs(config, cell["traffic"], seed), args.jobs):
            sampler.offer(j, low.run_job(ws))
        judged = check.judge(low.resolve(sampler.sample()), config,
                             args.workers)
        n_checked = judged.pop("replicas_checked")[0]
        print(json.dumps({"cell": args.workload, "seed": seed,
                          "control": "bfloat16",
                          "correct": check.verdict(judged, 0, args.jobs),
                          "replicas_checked": n_checked,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in judged.items()},
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
