"""What the figures and the serving rows make of a workload's replicas.

Throughput of a replica is its completed operations over its simulated
nanoseconds, in Mops; a workload reports the mean over its seeds, the
half-width of its normal 95 % interval, and the mean, median and 99th
percentile of its pooled latencies (the ring's valid samples). An
open-loop replica reduces to counts of arrived, completed, dropped,
in-service and queued requests, offered load and goodput per simulated
microsecond, sojourn percentiles, mean wait and mean concurrency; a
workload reports their mean over the seeds that have a finite value. On
an offered-load ramp the knee is the first rate whose goodput falls
below 0.9 of what was offered.
"""
from __future__ import annotations

import numpy as np

COMPLETED, IN_SERVICE, DROPPED = 3, 1, 2


def throughput(reps) -> dict:
    """Aggregates of the replicas ``reps`` (one per seed, in seed order):
    each has ``done``, ``lat`` and ``t_end``."""
    ops = np.asarray([int(r.done.sum()) for r in reps], np.int64)
    sim = np.maximum(np.asarray([r.t_end for r in reps], np.int64), 1)
    mops = ops / sim * 1e3
    pool = np.concatenate([r.lat for r in reps])
    pool = pool[pool >= 0]
    n = len(mops)
    return {
        "mean_mops": float(mops.mean()),
        "ci95_mops": (0.0 if n < 2 else
                      float(1.96 * mops.std(ddof=1) / np.sqrt(n))),
        "mean_lat_us": (float(pool.mean()) / 1e3 if len(pool)
                        else float("nan")),
        "p50_lat_ns": (float(np.percentile(pool, 50)) if len(pool)
                       else float("nan")),
        "p99_lat_ns": (float(np.percentile(pool, 99)) if len(pool)
                       else float("nan")),
    }


def serving(r) -> dict:
    """One open-loop replica's serving numbers."""
    t_end = max(int(r.t_end), 1)
    inside = r.arr <= t_end
    arrived = int(inside.sum())
    completed = int((r.rstat == COMPLETED).sum())
    dropped = int(((r.rstat == DROPPED) & inside).sum())
    in_service = int((r.rstat == IN_SERVICE).sum())
    soj = r.sojourn[r.rstat == COMPLETED]
    wq = r.wait[r.rstat == COMPLETED]
    t_us = t_end / 1e3
    return {
        "arrived": arrived, "completed": completed, "dropped": dropped,
        "in_service": in_service,
        "queued": arrived - completed - dropped - in_service,
        "drop_rate": dropped / arrived if arrived else 0.0,
        "offered_per_us": arrived / t_us,
        "goodput_per_us": completed / t_us,
        "p50_sojourn_ns": (float(np.percentile(soj, 50)) if soj.size
                           else float("nan")),
        "p99_sojourn_ns": (float(np.percentile(soj, 99)) if soj.size
                           else float("nan")),
        "mean_sojourn_ns": float(soj.mean()) if soj.size else float("nan"),
        "mean_wait_ns": float(wq.mean()) if wq.size else float("nan"),
        "mean_concurrency": float(soj.sum()) / t_end,
    }


def serving_mean(reps) -> dict:
    """The seed mean of each serving number, over its finite values."""
    rows = [serving(r) for r in reps]
    out = {}
    for k in rows[0]:
        v = np.asarray([row[k] for row in rows], np.float64)
        v = v[np.isfinite(v)]
        out[k] = float(v.mean()) if len(v) else float("nan")
    return out


def knee(offered, goodput, efficiency: float = 0.9):
    """Index of the first point of a ramp whose goodput is below
    ``efficiency`` times its offered load; None when there is none."""
    sat = (np.asarray(goodput, np.float64)
           < efficiency * np.asarray(offered, np.float64))
    return int(np.argmax(sat)) if sat.any() else None
