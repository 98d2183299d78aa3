"""Host-side serving metrics: goodput, sojourn percentiles, knee detection.

The engines return four per-request arrays per replica (see
``docs/serving.md``):

  * ``arr``   — arrival time of each request slot (ns);
  * ``wq``    — queue wait (dispatch - arrival), ``-1`` if never dispatched;
  * ``soj``   — sojourn (departure - arrival), ``-1`` if never completed;
  * ``rstat`` — final slot status: 0 pending/queued, 1 in service,
    2 dropped (admission), 3 completed.

This module reduces them to the serving numbers the benchmarks emit and
checks rely on: ``serving_summary`` one replica at a time,
``serving_table`` every replica of an ``(S, R)`` stack in one pass, with
the same bits. Everything here is plain numpy over already-materialized
outputs — no tracing, no x64 dependence.

>>> import numpy as np
>>> s = serving_summary(np.int64([10, 20, 30, 40]),
...                     np.int64([0, 5, -1, -1]),
...                     np.int64([100, 105, -1, -1]),
...                     np.int32([COMPLETED, COMPLETED, DROPPED, PENDING]),
...                     t_end=1000)
>>> s["completed"], s["dropped"], s["drop_rate"]
(2, 1, 0.25)
>>> round(s["goodput_per_us"], 3)
2.0
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "COMPLETED", "DROPPED", "IN_SERVICE", "PENDING", "detect_knee",
    "serving_summary", "serving_table",
]

# request-slot status codes (mirrored by the plain engine and the kernel)
PENDING, IN_SERVICE, DROPPED, COMPLETED = 0, 1, 2, 3


def serving_summary(arr, wq, soj, rstat, t_end: int) -> dict:
    """Reduce one replica's request arrays to serving aggregates.

    ``arrived`` counts slots whose arrival time falls inside the simulated
    window (the run is event-bounded, so late slots never materialize);
    conservation over that window — ``arrived == completed + dropped +
    in_service + queued`` — holds by construction (``queued`` is the
    remainder).
    ``goodput_per_us`` counts *completed* requests per simulated
    microsecond; ``offered_per_us`` counts arrivals the same way, so the
    two diverge exactly when the service saturates or drops.
    """
    arr = np.asarray(arr, np.int64)
    wq = np.asarray(wq, np.int64)
    soj = np.asarray(soj, np.int64)
    rstat = np.asarray(rstat)
    t_end = max(int(t_end), 1)
    inside = arr <= t_end
    arrived = int(inside.sum())
    completed = int((rstat == COMPLETED).sum())
    dropped = int(((rstat == DROPPED) & inside).sum())
    in_service = int((rstat == IN_SERVICE).sum())
    queued = arrived - completed - dropped - in_service
    csoj = soj[rstat == COMPLETED]
    cwq = wq[rstat == COMPLETED]
    t_us = t_end / 1e3
    return {
        "arrived": arrived,
        "completed": completed,
        "dropped": dropped,
        "in_service": in_service,
        "queued": queued,
        "drop_rate": dropped / arrived if arrived else 0.0,
        "offered_per_us": arrived / t_us,
        "goodput_per_us": completed / t_us,
        "p50_sojourn_ns": float(np.percentile(csoj, 50)) if csoj.size
        else float("nan"),
        "p99_sojourn_ns": float(np.percentile(csoj, 99)) if csoj.size
        else float("nan"),
        "mean_sojourn_ns": float(csoj.mean()) if csoj.size else float("nan"),
        "mean_wait_ns": float(cwq.mean()) if cwq.size else float("nan"),
        # time-average number in system over the window (Little's L):
        # each completed request contributes its full sojourn interval
        "mean_concurrency": float(csoj.sum()) / t_end,
    }


#: a row's completed sojourns and waits take integer means below this
#: bound (``serving_table``); float64 holds every integer below it
_EXACT = 2**53
#: the two sojourn percentiles, as ``np.percentile`` scales them
_QUANTILES = np.true_divide(np.array([50, 99]), 100)


def _percentiles(srt, n):
    """``np.percentile(row[:n], [50, 99])`` of each row of ``srt`` (sorted
    rows whose first ``n`` entries are the sample), ``(S, 2)``, bit for
    bit: NumPy's linear method as ``numpy.lib._function_base_impl`` takes
    it, virtual index ``(n - 1) * q``, its floor and gamma, then
    ``_lerp``'s two-sided form. Past the last sample NumPy takes the last
    one twice (and another gamma): ``b - a`` is then 0 and the result the
    last sample, whatever gamma is. NaN where ``n`` is 0."""
    n = n[:, None]
    vi = (n - 1) * _QUANTILES
    prev = np.floor(vi)
    gamma = vi - prev
    last = n - 1
    lo = np.minimum(prev.astype(np.intp), last)
    hi = np.minimum(lo + 1, last)
    rows = np.arange(len(srt))[:, None]
    a, b = srt[rows, lo], srt[rows, hi]
    d = b - a
    out = np.where(gamma >= 0.5, b - d * (1 - gamma), a + d * gamma)
    return np.where(n > 0, out, np.nan)


def serving_table(arr, wq, soj, rstat, t_end):
    """``serving_summary`` of every row of ``(S, R)`` request arrays at
    once, ``t_end`` ``(S,)``: returns ``(table, fallback)``. ``table``
    has ``serving_summary``'s keys, in its order, each an ``(S,)`` array
    whose row ``i`` equals ``serving_summary(arr[i], wq[i], soj[i],
    rstat[i], t_end[i])[key]`` bit for bit; counts are int64, the rest
    float64.

    Counts are row sums; the rates take ``serving_summary``'s float64
    operations in its order. The completed sojourns and waits are summed
    as int64, and a mean is that sum over the count: NumPy's mean of the
    row, in any order of summation, while every partial sum is an integer
    below 2**53. ``fallback`` (bool ``(S,)``) marks the rows where a
    completed value times the count reaches 2**53; those rows are
    ``serving_summary``'s own. The percentiles are taken from each row
    sorted once, the other slots keyed to the int64 maximum so they sort
    last (``_percentiles``).
    """
    arr = np.asarray(arr, np.int64)
    wq = np.asarray(wq, np.int64)
    soj = np.asarray(soj, np.int64)
    rstat = np.asarray(rstat)
    t_end = np.maximum(np.asarray(t_end, np.int64), 1)
    inside = arr <= t_end[:, None]
    done = rstat == COMPLETED
    masks = np.stack([inside, done, (rstat == DROPPED) & inside,
                      rstat == IN_SERVICE])
    arrived, completed, dropped, in_service = masks.view(np.uint8).sum(
        axis=2, dtype=np.int32).astype(np.int64)
    srt = np.where(done, soj, np.iinfo(np.int64).max)
    srt.sort(axis=1)
    cwq = wq * done
    soj_sum = (soj * done).sum(axis=1)
    wq_sum = cwq.sum(axis=1)
    # |every completed value| <= (2**53 - 1) // n keeps n of them exact;
    # the sorted row's first and n-th entries are its completed extremes
    some = completed > 0
    n1 = np.maximum(completed, 1)
    lim = (_EXACT - 1) // n1
    rows = np.arange(len(srt))
    fallback = some & ((srt[rows, n1 - 1] > lim) | (srt[:, 0] < -lim)
                       | (cwq.max(axis=1) > lim) | (cwq.min(axis=1) < -lim))
    pct = _percentiles(srt, completed)
    t_us = t_end / 1e3
    table = {
        "arrived": arrived,
        "completed": completed,
        "dropped": dropped,
        "in_service": in_service,
        "queued": arrived - completed - dropped - in_service,
        "drop_rate": np.where(arrived > 0,
                              dropped / np.maximum(arrived, 1), 0.0),
        "offered_per_us": arrived / t_us,
        "goodput_per_us": completed / t_us,
        "p50_sojourn_ns": pct[:, 0],
        "p99_sojourn_ns": pct[:, 1],
        "mean_sojourn_ns": np.where(some, soj_sum / n1, np.nan),
        "mean_wait_ns": np.where(some, wq_sum / n1, np.nan),
        "mean_concurrency": soj_sum.astype(np.float64) / t_end,
    }
    for i in np.flatnonzero(fallback):
        row = serving_summary(arr[i], wq[i], soj[i], rstat[i], t_end[i])
        for k, v in row.items():
            table[k][i] = v
    return table, fallback


def detect_knee(offered, goodput, efficiency: float = 0.9):
    """Index of the saturation knee on an offered-load ramp.

    The knee is the first point whose achieved goodput falls below
    ``efficiency`` x offered — below it the service tracks the offered
    rate, above it queueing (or dropping) absorbs the difference.
    Returns ``None`` when the ramp never saturates.

    >>> detect_knee([1.0, 2.0, 4.0, 8.0], [1.0, 2.0, 3.9, 4.1])
    3
    >>> detect_knee([1.0, 2.0], [1.0, 2.0]) is None
    True
    """
    offered = np.asarray(offered, np.float64)
    goodput = np.asarray(goodput, np.float64)
    if offered.shape != goodput.shape or offered.ndim != 1:
        raise ValueError("offered/goodput must be matching 1-D sequences")
    sat = goodput < efficiency * offered
    return int(np.argmax(sat)) if sat.any() else None
