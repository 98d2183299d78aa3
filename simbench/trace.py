"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a
few jobs run after the measured window closed (the profiler's own start
and stop take seconds, which would read as idle time inside the window),
reduced in memory to what the result line carries.

* ``busy_s``: the union of the device's operation intervals (kernels,
  copies, fills) in the stretch;
* ``window_s``: the stretch's length on the host clock;
* ``device_ops``: the ten device operations with the most time, by name;
* ``idle_gaps``: the ten longest gaps between device operations, each
  named by the innermost host span open in its middle (the benchmark's
  own ``simbench.job`` spans, the program's host operations), or
  ``host: between jobs`` where no span is open.

Only the summary is kept; no trace file is written.
"""
from __future__ import annotations

import time

TOP = 10
#: the benchmark's own host spans (``record_function``) start with it
SPAN_PREFIX = "simbench."


class Tracer:
    def __init__(self):
        import torch
        self.torch = torch
        self.prof = None
        self.t0 = self.t1 = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        from torch.autograd import DeviceType
        events = self.prof.profiler.kineto_results.events()
        dev, host = [], []
        for e in events:
            span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            if e.device_type() == DeviceType.CUDA:
                # the device copy of a host span is no device operation
                if not (e.is_user_annotation()
                        or e.name().startswith(SPAN_PREFIX)):
                    dev.append(span)
            elif e.duration_ns() > 0:
                host.append(span)
        return summarize(dev, host, self.t1 - self.t0)


def summarize(dev, host, window_s: float) -> dict:
    """``dev`` and ``host``: ``(start_ns, end_ns, name)`` spans."""
    by_name: dict = {}
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0) + (b - a)
    merged = []
    for a, b, _ in sorted(dev):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:TOP]
    host = sorted(host)
    named = []
    for g, a, b in gaps:
        mid = (a + b) // 2
        inner = None
        for s, e, n in host:
            if s > mid:
                break
            if e >= mid and (inner is None or e - s < inner[1] - inner[0]):
                inner = (s, e, n)
        named.append([inner[2] if inner else "host: between jobs",
                      g / 1e9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy / 1e9, "window_s": window_s,
            "breakdown": {"device_ops": [[n, t / 1e9] for n, t in ops],
                          "idle_gaps": named}}
