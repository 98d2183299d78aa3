"""95th percentile of the host time of every job of the window, from the
call to its results on the host (linear between order statistics)."""
import numpy as np


def read(ctx):
    t = ctx["job_seconds"]
    return float(np.percentile(t, 95)) * 1e3 if t else None
