"""One run of one cell: set-up, the measured window, the check, the line.

Set-up builds or loads the kernels, then runs every bucket of the cell's
configuration once at ``WARM_EVENTS`` events. The window submits jobs
one after another (closed loop) until ``seconds`` have passed, and ends
when the last job's results are on the host. Through the window the
process's objects from set-up are kept out of the garbage collector's
scans (``gc.freeze``) and the submitting thread stays on one core. After
it, a ``--trace 1`` run traces the next jobs of the same stream until
``TRACE_SECONDS`` of them have run: the device's busy time, its idle
share and the roofline share come from that stretch, the stage shares
and the memory peak from the untraced window.
The sample that ``check.judge`` reads was drawn while the window's jobs
ran, from keys that ``--seed`` fixes (the smallest keys win), so it is a
sample of the whole window.

Every metric is read by its own file ``metrics/<name>.py``, whose
``read(ctx)`` returns a number or None (the metric is then left out). A
name ``<base>.<group>`` without a file of its own is the quantity of
``metrics/<base>.py`` in the cells of another group, split from it
because those cells report another end-to-end metric.
``ctx`` holds: ``window_s``, ``setup_s``, ``job_seconds`` (one per job),
``events`` (simulated events the window's jobs completed), ``jobs`` (each
job's workloads), ``config``, ``stats`` (the program's ``exec_stats()``
over the window), ``peak_window_bytes`` and ``trace`` (``trace.py``'s
summary with the traced stretch's ``jobs``, or None).
"""
from __future__ import annotations

import gc
import importlib.util
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np

from simbench import check, inputs

#: events of each replica in the warm-up
WARM_EVENTS = 2000
#: host seconds of jobs a --trace 1 run traces (at least one job)
TRACE_SECONDS = 1.0
#: single replicas the check recomputes besides the whole workload
SINGLES = 8
#: modules that may not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def read_metric(root: Path, name: str, ctx: dict):
    path = root / "simbench" / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = path.with_name(name.partition(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "simbench_metric_" + "".join(c if c.isalnum() else "_" for c in name),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics the line of ``cell`` carries: its end-to-end metrics,
    or with ``trace`` its per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


class Sampler:
    """Keeps the sample ``check.judge`` reads, as the jobs finish: the
    workload whose key is smallest over the window (whole, with its ramp
    group where the job made a knee row) and the ``SINGLES`` replicas
    with the smallest keys. Keys are drawn from ``--seed`` and the job's
    index, so the sample is fixed by the seed and the jobs that ran. The
    whole workload's arrays and rows are read only by ``sample()``, after
    the window."""

    def __init__(self, seed: int, config: dict, program):
        self.seed, self.config, self.program = seed, config, program
        self.best = None                   # (key, [check.Whole])
        self.singles: list = []      # [(key, check.Single, None, None)]

    def offer(self, j: int, out: list):
        S = self.config["n_seeds"]
        g = inputs.rng(self.seed, j, 3)
        wkeys = g.random(len(out))
        rkeys = g.random((len(out), S))
        i = int(wkeys.argmin())
        if self.best is None or wkeys[i] < self.best[0]:
            group = [i]
            knee = self.config.get("knee")
            if knee and self.program.knee_of(out[i]):
                ws = [o["workload"] for o in out]
                group = next(idx for idx in inputs.ramp_groups(
                    ws, knee).values() if i in idx)
            # kept as the job made it; read out after the window
            self.best = (wkeys[i], [out[k] for k in group])
        cand = sorted(((rkeys[a, s], a, s) for a in range(len(out))
                       for s in range(S)))[:SINGLES]
        kept = sorted(self.singles + [(k, None, a, s) for k, a, s in cand],
                      key=lambda x: x[0])[:SINGLES]
        self.singles = []
        for k, single, a, s in kept:
            if single is None:         # new in the sample: read it now
                single = check.Single(out[a]["workload"], s,
                                      self.program.arrays(out[a], s))
            self.singles.append((k, single, None, None))

    def _whole(self, item) -> check.Whole:
        S = self.config["n_seeds"]
        return check.Whole(item["workload"],
                           [self.program.arrays(item, s) for s in range(S)],
                           self.program.full_rows(item),
                           self.program.knee_of(item))

    def sample(self) -> check.Sample:
        return check.Sample([self._whole(x) for x in self.best[1]]
                            if self.best else [],
                            [x for _, x, _, _ in self.singles])


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, workers: int = 1,
             err=sys.stderr) -> dict:
    """One run of cell ``name``; returns the result line as a dict.
    ``t_start`` is the host clock when the process began."""
    from simbench.program import Program
    bench = inputs.benchmark(root)
    cell = inputs.cell(root, name)
    config = cell["config"]
    t_import = time.perf_counter()
    program = Program(device)
    t_warm = time.perf_counter()
    program.warm_up(inputs.grid(config), config["n_seeds"], WARM_EVENTS)
    setup_s = time.perf_counter() - t_start
    print(f"setup s: start to harness {t_import - t_start:.2f}, program "
          f"import {t_warm - t_import:.2f}, warm-up (library load or build "
          f"included) {t_start + setup_s - t_warm:.2f}", file=err)

    sampler = Sampler(seed, config, program)
    job_seconds, jobs_run = [], []
    attempted = failed = events = 0
    per_replica = config["n_seeds"] * config["n_events"]
    peak_setup = program.peak_bytes()
    program.reset_stats()
    stream = inputs.jobs(config, cell["traffic"], seed)
    gc.collect()
    gc.freeze()
    cpus = _pin()
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        j, workloads = next(stream)
        attempted += 1
        t0 = time.perf_counter()
        try:
            out = program.run_job(workloads, config)
        except Exception:              # a failed job is counted, not fatal
            traceback.print_exc(file=err)
            failed += 1
            continue
        job_seconds.append(time.perf_counter() - t0)
        jobs_run.append(workloads)
        events += len(workloads) * per_replica
        sampler.offer(j, out)
        out = None
    window_s = time.perf_counter() - w0
    _unpin(cpus)
    gc.unfreeze()
    stats = program.stats()
    peak_window = program.peak_bytes()
    trace_sum = None
    if trace and device != "cpu":
        trace_sum = traced_stretch(program, stream, config)

    t_check = time.perf_counter()
    judged = check.judge(sampler.sample(), config, workers)
    n_checked = judged.pop("replicas_checked")[0]
    correct = check.verdict(judged, failed, len(job_seconds))

    ctx = {"window_s": window_s, "setup_s": setup_s,
           "job_seconds": job_seconds, "events": events, "jobs": jobs_run,
           "config": config, "stats": stats,
           "peak_window_bytes": peak_window, "trace": trace_sum}
    metrics = {}
    for m in cell_metrics(bench, name, trace):
        v = read_metric(root, m["name"], ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": device_info(device, max(peak_setup, peak_window))}
    if trace_sum is not None:
        result["device"].update(busy_s=trace_sum["busy_s"],
                                window_s=trace_sum["window_s"])
        result["breakdown"] = trace_sum["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in judged.items()}
    if job_seconds:
        q = np.percentile(job_seconds, [0, 5, 50, 95, 100]) * 1e3
        print("job ms min p5 p50 p95 max " + " ".join(f"{v:.1f}" for v in q),
              file=err)
    print(f"checked {n_checked} replicas of {len(job_seconds)} jobs in "
          f"{time.perf_counter() - t_check:.1f} s", file=err)
    for k, (v, lim) in judged.items():
        print(f"check {k} {v} limit {lim}", file=err)
    return result


def _pin():
    """Keeps this thread on the core it runs on; returns the cores it
    was allowed before (None where the system has no affinity)."""
    if not hasattr(os, "sched_setaffinity"):
        return None
    cpus = os.sched_getaffinity(0)
    with open("/proc/thread-self/stat") as f:
        cpu = int(f.read().rpartition(")")[2].split()[36])
    os.sched_setaffinity(0, {cpu} if cpu in cpus else {min(cpus)})
    return cpus


def _unpin(cpus):
    if cpus is not None:
        os.sched_setaffinity(0, cpus)


def traced_stretch(program, stream, config) -> dict:
    """``trace.py``'s summary of the next jobs of ``stream``, run under
    the profiler until ``TRACE_SECONDS`` have passed (at least one), with
    the jobs it ran under ``jobs``. A trace with no device operation in
    it is an error: its busy time and shares would read as nought."""
    from torch.profiler import record_function

    from simbench.trace import Tracer
    tracer = Tracer()
    jobs = []
    tracer.start()
    try:
        t0 = time.perf_counter()
        while True:
            _, workloads = next(stream)
            with record_function("simbench.job"):
                program.run_job(workloads, config)
            jobs.append(workloads)
            if time.perf_counter() - t0 >= TRACE_SECONDS:
                break
    finally:
        tracer.stop()
    summary = tracer.summary()
    if summary["busy_s"] <= 0:
        raise RuntimeError("the profiler's trace holds no device operation")
    return dict(summary, jobs=jobs)


def device_info(device: str, peak: int) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
            "count": 1, "memory_peak_bytes": peak}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
