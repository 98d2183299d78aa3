"""The comparison that decides ``correct``.

After the window the run holds a sample of what its jobs produced, drawn
from ``--seed`` (``Sample``): one whole workload of one job, every seed of
it with its rows (throughput, latency percentiles and, open loop, the
serving summary) and, where that job made a knee row, the whole ramp
group it belongs to; and a few more single replicas from any job. The
plain reference (``reference/``) recomputes each of them from the
workload as the configuration states it and the replica's seed, and two
numbers are compared, each against its limit:

* ``replica_values_differing``: values of the replicas' arrays (per
  thread operations, the latency ring, simulated time, re-acquires,
  passes; open loop: arrival, wait and sojourn times and request states)
  that differ from the reference's. The simulator is exact: limit 0.
* ``aggregate_values_differing``: rows that differ from what the
  reference makes of its own replicas. Limit 0.
"""
from __future__ import annotations

import math
import multiprocessing
from typing import NamedTuple

import numpy as np

from simbench.reference import aggregate, engine, spec

LIMITS = {"replica_values_differing": 0, "aggregate_values_differing": 0}
ARRAY_FIELDS = ("done", "lat", "sim_ns", "reacquires", "passes", "arr",
                "wait", "sojourn", "rstat")


class Whole(NamedTuple):
    """One workload of a job, every seed: ``arrays[s]`` as
    ``Program.arrays`` gives them, ``rows`` as ``Program.full_rows``."""
    workload: dict
    arrays: list
    rows: dict
    knee: tuple | None = None       # (group key, row) where the job made one


class Single(NamedTuple):
    workload: dict
    s: int
    arrays: dict


class Sample(NamedTuple):
    whole: list        # [Whole]: the drawn workload, or its ramp group
    singles: list      # [Single]


def _replica(task):
    d, seed, n_events, low = task
    return engine.run(spec.lower(d, n_events), seed, n_events, low)


def reference_replicas(tasks, workers: int, low: bool = False) -> list:
    """The reference's replica of each ``(workload, seed, n_events)``, run
    on ``workers`` processes (in this one for 1); ``low`` is the control
    in bfloat16."""
    todo = [(d, s, n, low) for d, s, n in tasks]
    if workers <= 1 or len(todo) <= 1:
        return [_replica(t) for t in todo]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(workers, len(todo))) as pool:
        out = pool.map(_replica, todo, chunksize=1)
        pool.close()
        pool.join()
    return out


def as_arrays(r) -> dict:
    """A reference replica in the program's terms."""
    a = {"done": r.done, "lat": r.lat, "sim_ns": max(int(r.t_end), 1),
         "reacquires": r.reacquires, "passes": r.passes}
    if r.arr is not None:
        a.update(arr=r.arr, wait=r.wait, sojourn=r.sojourn, rstat=r.rstat)
    return a


def differing(got: dict, want: dict) -> int:
    """Values of ``got`` that differ from ``want``; a missing or misshapen
    array counts as wholly different."""
    n = 0
    for k in ARRAY_FIELDS:
        if k not in want:
            continue
        a, b = np.asarray(got.get(k)), np.asarray(want[k])
        n += int((a != b).sum()) if a.shape == b.shape else max(b.size, 1)
    return n


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is b
    a, b = float(a), float(b)
    return a == b or (math.isnan(a) and math.isnan(b))


def rows_of(reps) -> dict:
    """The rows the reference makes of one workload's replicas."""
    rows = aggregate.throughput(reps)
    if reps[0].arr is not None:
        rows["serving"] = aggregate.serving_mean(reps)
    return rows


def rows_differing(got: dict, want: dict) -> int:
    n = sum(not _same(got.get(k), v) for k, v in want.items()
            if k != "serving")
    if "serving" in want:
        sv = got.get("serving") or {}
        n += sum(not _same(sv.get(k), v) for k, v in want["serving"].items())
    return n


def judge(sample: Sample, config: dict, workers: int = 1) -> dict:
    """The compared numbers of a run: name -> (value, limit)."""
    S, n_events = config["n_seeds"], config["n_events"]
    tasks = [(w.workload, w.workload["seed"] + s, n_events)
             for w in sample.whole for s in range(S)]
    tasks += [(x.workload, x.workload["seed"] + x.s, n_events)
              for x in sample.singles]
    reps = reference_replicas(tasks, workers)
    rep_diff = agg_diff = 0
    whole_reps = [reps[i * S:(i + 1) * S] for i in range(len(sample.whole))]
    for w, rs in zip(sample.whole, whole_reps):
        for s, r in enumerate(rs):
            rep_diff += differing(w.arrays[s] if s < len(w.arrays) else {},
                                  as_arrays(r))
        agg_diff += rows_differing(w.rows, rows_of(rs))
    knee = config.get("knee")
    if knee and any(w.knee for w in sample.whole):
        # the sample holds the group in the ramp's order
        want = knee_row([rows_of(rs)["serving"] for rs in whole_reps], knee)
        for w in sample.whole:
            got = w.knee[1] if w.knee else {}
            agg_diff += sum(not _same(got.get(k), v) for k, v in want.items())
    for x, r in zip(sample.singles, reps[len(sample.whole) * S:]):
        rep_diff += differing(x.arrays, as_arrays(r))
    return {"replica_values_differing": (rep_diff,
                                         LIMITS["replica_values_differing"]),
            "aggregate_values_differing": (
                agg_diff, LIMITS["aggregate_values_differing"]),
            "replicas_checked": (len(tasks), None)}


def verdict(judged: dict, failed: int, completed: int) -> bool:
    """``correct``: no job failed, one or more completed, and every
    compared number of ``judged`` (name -> (value, limit)) is within its
    limit."""
    return failed == 0 and completed > 0 and all(
        v <= lim for v, lim in judged.values())


def knee_row(serving_rows, knee: dict) -> dict:
    k = aggregate.knee([s["offered_per_us"] for s in serving_rows],
                       [s["goodput_per_us"] for s in serving_rows],
                       knee.get("efficiency", 0.9))
    return {"knee_index": k,
            "knee_goodput_per_us": (None if k is None else
                                    serving_rows[k]["goodput_per_us"])}
