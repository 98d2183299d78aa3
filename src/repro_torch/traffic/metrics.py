"""Host-side serving metrics: goodput, sojourn percentiles, knee detection.

The engines return four per-request arrays per replica (see
``docs/serving.md``):

  * ``arr``   — arrival time of each request slot (ns);
  * ``wq``    — queue wait (dispatch - arrival), ``-1`` if never dispatched;
  * ``soj``   — sojourn (departure - arrival), ``-1`` if never completed;
  * ``rstat`` — final slot status: 0 pending/queued, 1 in service,
    2 dropped (admission), 3 completed.

This module reduces them to the serving numbers the benchmarks emit and
checks rely on. Everything here is plain numpy over already-materialized
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
    "serving_summary",
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
