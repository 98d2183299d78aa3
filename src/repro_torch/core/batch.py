"""Batched simulation: one engine call per (workload x seed) shape bucket.

The paper's headline figures (Fig. 5/6) are grids of simulator runs.
``sweep`` accepts ``repro_torch.workloads.Workload`` specs (legacy
``SimConfig`` rides the bitwise-faithful adapter), lowers each to its
``WorkloadOperands``, and buckets by the static shape key ``(alg, T, N, K,
n_events, R)`` — everything workload-shaped (per-thread locality, Zipf
CDFs, phase programs, think times, active masks, per-phase ALock budgets,
per-phase cost rows, seeds) rides along as batched operands. Replicas with
fewer phases than their bucket's maximum are padded with unreachable
phases (``pad_phases``), so a sweep mixing scenarios still runs one engine
call — on the kernel backend, one kernel launch — per bucket.

``BatchResult`` keeps the per-seed samples bitwise-identical to individual
``simulate()`` calls and derives mean/ci95/p50/p99 aggregates from them.

Open-loop workloads (``Workload.arrivals``, ``R > 0`` request slots, part
of the shape key) carry the per-request arrays ``arr_ns / wait_ns /
sojourn_ns / rstat`` and the serving aggregates ``serving(i)`` /
``serving_mean()``.

On a CUDA device every bucket is issued — operands uploaded, draws, plan
and engine launched on a stream of a small pool — before any result is
forced, as the reference issues every bucket before it forces one
(``repro/core/batch.py:353-406``, on one device here): the buckets' kernels
run side by side and beside later buckets' draws. The device memory the
issued but unforced buckets hold is bounded (``IN_FLIGHT_SHARE`` of the
memory free when the sweep starts): past it, the oldest is forced before
the next is issued. On the CPU each bucket is forced before the next is
lowered, one after another as before.

``sweep(..., devices=, chunk=)`` turns on the sharded layout of the
reference (``repro/core/batch.py:353-406``): a bucket's rows are measured in
units of ``chunk`` rows per device, the unit count is split greedily into
power-of-two superchunks (``repro_torch.parallel.sharding``), and each
superchunk is one dispatch of ``D`` equal shards, one per listed device,
each its own upload, draws (and plan) and kernel launch on that device's
stream pool. Rows are padded only to a multiple of ``D`` (the last row
repeated, cut off after) and the last superchunk is trimmed. Every
superchunk of every bucket is issued before any is forced, within each
device's in-flight bound; they are forced in dispatch order and their rows
joined in row order before a bucket's results are made. Draws are keyed
per row by the seed, so every layout gives the same bits.

``exec_stats()`` counts engine dispatches (one per bucket unsharded, one
per superchunk sharded) and the event-loop and draw-stream kernels'
launches (one each per shard), times the stages, counts the events drawn
against the events the loop ran, and shows
the event-loop kernel's last shared-memory plan. Each host stage is one
``stage(name, counter)``: its host-clock time goes to ``exec_stats()
["seconds"][counter]`` and, while ``torch.profiler`` records, it is a host
span ``name`` on the profiler's timeline, so the device's idle gaps can be
named by the stage the host was in. The spans nest as ``experiment.run >
sweep > sweep.lower | sweep.pack | sweep.issue (> sweep.upload,
sweep.draws, sweep.plan, sweep.launch) | sweep.wait | sweep.copy_back |
sweep.aggregate``; ``result.latency`` and ``result.serving`` are the
``BatchResult`` reductions. ``serving_mean`` reduces all of a result's
seeds in one vectorised pass (``traffic.metrics.serving_table``), counted
in ``exec_stats()["serving"]``.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.cost_model import CostModel, N_COST_ROWS
from repro_torch.core.sim import (LAT_SAMPLES, SimConfig, SimResult,
                                  topology)
from repro_torch.device import resolve_backend, resolve_device
from repro_torch.kernels.event_loop import arrivals as _arrivals
from repro_torch.kernels.event_loop import draws as _draws
from repro_torch.kernels.event_loop import kernel as _kernel
from repro_torch.kernels.event_loop import smem_plan as _smem_plan
from repro_torch.kernels.event_loop.ops import (precompute_draws,
                                                precompute_plan, run_events)
from repro_torch.kernels.event_loop.ref import DIAG_COLS
from repro_torch.parallel import sharding as _sharding
from repro_torch.traffic.metrics import serving_summary, serving_table
from repro_torch.workloads import (OPERAND_DTYPES, Workload,
                                   WorkloadOperands, as_workload, lower,
                                   pad_phases, to_device)

#: CUDA streams the buckets of a sweep are issued on, in turn
N_STREAMS = 8
#: share of the device memory free when a sweep starts that the issued
#: but not yet forced buckets may hold (draw streams, arrival plan,
#: outputs: ``_bucket_bytes``)
IN_FLIGHT_SHARE = 0.5

# -- execution statistics ----------------------------------------------------
# A "dispatch" is one engine call covering a whole bucket, or, sharded, one
# superchunk (its D shards together, as the reference's _note_call counts);
# "launches" is the event-loop kernel's own launch counter
# (kernels/event_loop/kernel.py), one per shard, read here so a run can show
# that its buckets went through the kernel; "draw_launches" the draw-stream
# kernel's (kernels/event_loop/draws.py), one per shard drawn by it;
# "plan_launches" the arrival-plan kernel's (kernels/event_loop/
# arrivals.py), one per open-loop shard planned by it (0 in closed sweeps).
# The reference's "compiles" has no counterpart: the kernel library is
# built once per source hash.
# "seconds" by stage. Host-clock sums of the host's own stages, disjoint:
# "lower" (lowering and bucketing the workloads, packing each bucket),
# "issue" (enqueueing each shard: operand upload, draw stream, arrival
# plan, engine launch; on the CPU the engine runs inside it), "wait" (the
# host blocked until a dispatch's device work is done) and "aggregate"
# (copy back and BatchResults, after that); "plan" is the part of "issue"
# spent making arrival plans; "results" is the host time of the
# BatchResult reductions (latency pools and percentiles, serving
# summaries), which run after sweep() returns. "draws" (operand upload,
# draw stream, arrival plan) and "engine" (the event loop) are, on a CUDA
# device, the union of the shards' intervals between CUDA events recorded
# on their streams (time during which at least one shard was in that
# stage; the two overlap one another and the host stages), on the CPU
# host-clock sums. Each device's events are timed against that device's
# own origin event; the origins are recorded one after another as the
# sweep starts, so the devices' intervals share one timeline to within
# those few microseconds; "engine_only" is the part of "engine" during
# which no shard was in its draws (what the engine adds beside the draws);
# "wall" is the host clock around each sweep() call. "events": "drawn" is
# replicas x n_events of every shard (the draw stream is made for every
# event), "run" the events the loop ran (an open-loop replica stops at the
# first event at which it is idle for good: K1's ``diag``; a closed one
# runs every event), "ops" the lock operations the loop began (its NCS
# steps, the only events at which it reads the draws), "reads" those
# begun shared (alock-rw's readers; 0 for every other algorithm) and
# "loop" those begun on the loopback tier (hlock's locks in another node
# of the taker's rack; 0 for every other algorithm), all counted by the
# engine into its ``diag``; "down" the events run in a phase in which at
# least one thread is parked (its node down), counted on the host from
# the lowered phase edges and active rows and each replica's events run;
# "lane" the events run by the shards of buckets that the kernel runs on
# its owner-lane body (``kernel.owner_lane``: the closed loop at up to 256
# threads; the plain engine's buckets count by the same rule), counted on
# the host from the bucket's shape key and each shard's events run.
# "serving": "passes" counts the ``serving_mean`` calls (one
# ``serving_table`` pass over a result's seeds each), "seeds" the seeds
# those passes summarised and "fallback" the seeds the pass's 2**53 guard
# sent to ``serving_summary`` one by one.
# "smem_plan" is the event-loop kernel's last shared-memory plan (None
# before any launch).
_STATS = {"dispatches": 0}
_SECONDS = {"lower": 0.0, "issue": 0.0, "plan": 0.0, "wait": 0.0,
            "draws": 0.0, "engine": 0.0, "engine_only": 0.0,
            "aggregate": 0.0, "results": 0.0, "wall": 0.0}
_EVENTS = {"drawn": 0, "run": 0, "ops": 0, "reads": 0, "loop": 0,
           "down": 0, "lane": 0}
_SERVING = {"passes": 0, "seeds": 0, "fallback": 0}
_STREAMS: dict = {}


@contextlib.contextmanager
def stage(name: str, counter: str | None = None):
    """A stage of the host: adds its host-clock time to ``exec_stats()
    ["seconds"][counter]`` (unless ``counter`` is None) and, while
    ``torch.profiler`` records, opens the span ``name``
    (``record_function``, a user annotation; the profiler's copy of it on
    the device's timeline is flagged as one too). Also a decorator. With
    no profiler running it costs a flag test and two clock reads."""
    with (record_function(name) if torch.autograd._profiler_enabled()
          else contextlib.nullcontext()):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if counter is not None:
                _SECONDS[counter] += time.perf_counter() - t0


def exec_stats() -> dict:
    """Snapshot of {dispatches, launches, draw_launches, plan_launches,
    seconds, events, serving, smem_plan} since the last reset.
    ``seconds``: lower, issue, plan, wait, draws, engine, engine_only,
    aggregate, results, wall (see the comment above ``_SECONDS``);
    ``events``: {drawn, run, ops, reads, loop, down, lane}; ``serving``:
    {passes, seeds, fallback}."""
    plan = _smem_plan.last_plan()
    return {"dispatches": _STATS["dispatches"],
            "launches": _kernel.LIB.launches(),
            "draw_launches": _draws.LIB.launches(),
            "plan_launches": _arrivals.LIB.launches(),
            "seconds": dict(_SECONDS),
            "events": dict(_EVENTS),
            "serving": dict(_SERVING),
            "smem_plan": None if plan is None else plan.as_dict()}


def reset_exec_stats() -> None:
    _STATS["dispatches"] = 0
    for k in _SECONDS:
        _SECONDS[k] = 0.0
    for k in _EVENTS:
        _EVENTS[k] = 0
    for k in _SERVING:
        _SERVING[k] = 0
    for mod in (_kernel, _draws, _arrivals):
        mod.LIB.reset_launches()
    _smem_plan.clear_plan()


def shape_key(cfg, n_events: int):
    """The static-argument tuple that determines a bucket: two workloads
    (or SimConfigs) with equal keys share one engine call. The final entry
    is the open-loop request-slot count R (0 = closed loop; legacy
    SimConfigs have no arrivals and are always closed)."""
    arr = getattr(cfg, "arrivals", None)
    return (cfg.alg, cfg.n_nodes * cfg.threads_per_node, cfg.n_nodes,
            cfg.n_locks, n_events, 0 if arr is None else arr.n_requests)


class BatchResult(NamedTuple):
    """Per-seed samples + aggregate statistics for one workload.

    ``config`` is the item as passed to ``sweep`` (a ``Workload`` or a
    legacy ``SimConfig``). Sample arrays (numpy) are stacked over the seed
    axis S; ``result(i)`` recovers the i-th seed as a plain ``SimResult``
    (bitwise-equal to running ``simulate`` with that seed).
    """
    config: object
    n_events: int
    seeds: np.ndarray             # (S,)
    ops: np.ndarray               # (S,)
    sim_ns: np.ndarray            # (S,)
    throughput_mops: np.ndarray   # (S,)
    lat_ns: np.ndarray            # (S, LAT_SAMPLES), -1 padded
    per_thread_ops: np.ndarray    # (S, T)
    reacquires: np.ndarray        # (S,)
    passes: np.ndarray            # (S,)
    # (S, 3) per seed: the sum, count and largest of the latency ring's
    # valid samples (``_lat_stats``, reduced on the engine's device)
    lat_stats: np.ndarray
    # open-loop (Workload.arrivals) extras — None on closed-loop runs
    arr_ns: np.ndarray | None = None      # (S, R) request arrival times
    wait_ns: np.ndarray | None = None     # (S, R) queue waits, -1 padded
    sojourn_ns: np.ndarray | None = None  # (S, R) sojourns, -1 padded
    rstat: np.ndarray | None = None       # (S, R) traffic status codes

    @property
    def n_seeds(self) -> int:
        return len(self.seeds)

    @property
    def open_loop(self) -> bool:
        return self.arr_ns is not None

    def result(self, i: int) -> SimResult:
        extras = {}
        if self.open_loop:
            extras = dict(arr_ns=self.arr_ns[i], wait_ns=self.wait_ns[i],
                          sojourn_ns=self.sojourn_ns[i],
                          rstat=self.rstat[i])
        return SimResult(int(self.ops[i]), int(self.sim_ns[i]),
                         float(self.throughput_mops[i]), self.lat_ns[i],
                         self.per_thread_ops[i], int(self.reacquires[i]),
                         int(self.passes[i]), **extras)

    # -- open-loop serving aggregates --------------------------------------

    @stage("result.serving", "results")
    def serving(self, i: int) -> dict:
        """One seed's ``traffic.metrics.serving_summary`` dict."""
        if not self.open_loop:
            raise ValueError("serving() needs an open-loop run "
                             "(Workload.arrivals)")
        return serving_summary(self.arr_ns[i], self.wait_ns[i],
                               self.sojourn_ns[i], self.rstat[i],
                               int(self.sim_ns[i]))

    @stage("result.serving", "results")
    def serving_mean(self) -> dict:
        """Seed-averaged serving summary (nan-safe over empty seeds): the
        mean of each key over its finite values, from one
        ``serving_table`` pass over the seeds, whose rows are
        ``serving(i)``'s bits."""
        if not self.open_loop:
            raise ValueError("serving_mean() needs an open-loop run "
                             "(Workload.arrivals)")
        table, fallback = serving_table(self.arr_ns, self.wait_ns,
                                        self.sojourn_ns, self.rstat,
                                        self.sim_ns)
        n_fallback = int(fallback.sum())
        _SERVING["passes"] += 1
        _SERVING["seeds"] += self.n_seeds - n_fallback
        _SERVING["fallback"] += n_fallback
        out = {}
        for k, col in table.items():
            vals = col.astype(np.float64)
            finite = vals[np.isfinite(vals)]
            out[k] = float(finite.mean()) if len(finite) else float("nan")
        return out

    # -- throughput aggregates ---------------------------------------------

    @property
    def mean_mops(self) -> float:
        return float(self.throughput_mops.mean())

    @property
    def ci95_mops(self) -> float:
        """Half-width of the normal-approx 95% CI of the mean (0 for S=1)."""
        s = self.throughput_mops
        if len(s) < 2:
            return 0.0
        return float(1.96 * s.std(ddof=1) / np.sqrt(len(s)))

    # -- latency aggregates (valid samples only; -1 is padding) ------------

    def _lat_pool(self) -> np.ndarray:
        flat = self.lat_ns.ravel()
        return flat[flat >= 0]

    @property
    @stage("result.latency", "results")
    def mean_lat_us(self) -> float:
        st = self.lat_stats
        total, n = (int(x) for x in st[:, :2].sum(axis=0))
        if not n:
            return float("nan")
        if int(st[:, 2].max()) * n < 2**53:
            # every partial sum of the pool is then an integer below 2**53,
            # which float64 holds exactly: NumPy's mean of the pool, in any
            # order of summation, is this sum over n
            return float(total) / n / 1e3
        return float(self._lat_pool().mean()) / 1e3

    @property
    @stage("result.latency", "results")
    def p50_lat_ns(self) -> float:
        pool = self._lat_pool()
        return float(np.percentile(pool, 50)) if len(pool) else float("nan")

    @property
    @stage("result.latency", "results")
    def p99_lat_ns(self) -> float:
        pool = self._lat_pool()
        return float(np.percentile(pool, 99)) if len(pool) else float("nan")

    @stage("result.latency", "results")
    def lat_pct(self, q: float) -> tuple[float, float]:
        """(mean, ci95) of the q-th latency percentile across seeds."""
        per_seed = []
        for row in self.lat_ns:
            valid = row[row >= 0]
            if len(valid):
                per_seed.append(np.percentile(valid, q))
        if not per_seed:
            return float("nan"), 0.0
        per_seed = np.asarray(per_seed, np.float64)
        mean = float(per_seed.mean())
        if len(per_seed) < 2:
            return mean, 0.0
        return mean, float(1.96 * per_seed.std(ddof=1)
                           / np.sqrt(len(per_seed)))


def _mark(dev):
    """A point on a shard's timeline: a CUDA event recorded on ``dev``'s
    current stream, or the host clock on the CPU (where every stage is
    synchronous)."""
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        return ev
    return time.perf_counter()


def _seconds(origin, mark) -> float:
    if isinstance(mark, float):
        return mark - origin
    return origin.elapsed_time(mark) / 1e3


def _merged(intervals) -> list:
    """``(start, end)`` intervals merged into disjoint ones, in order."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _union(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    return sum(b - a for a, b in _merged(intervals))


def _union_outside(intervals, cover) -> float:
    """Length of the union of ``intervals`` outside the union of
    ``cover``."""
    cover = _merged(cover)
    total = 0.0
    for a, b in _merged(intervals):
        total += b - a
        for c, d in cover:
            total -= max(0.0, min(b, d) - max(a, c))
    return total


def _stream_pool(dev):
    if dev.type != "cuda":
        return [None]
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _STREAMS:
        _STREAMS[idx] = [torch.cuda.Stream(device=idx)
                         for _ in range(N_STREAMS)]
    return _STREAMS[idx]


def _in_flight_budget(dev) -> int:
    """Bytes the issued but unforced shards may hold on ``dev``: on the
    CPU none (each dispatch is forced before the next one), on a CUDA
    device ``IN_FLIGHT_SHARE`` of its free memory."""
    if dev.type != "cuda":
        return 0
    free, _ = torch.cuda.mem_get_info(dev)
    return int(IN_FLIGHT_SHARE * free)


def _bucket_bytes(key, B: int) -> int:
    """Device bytes ``B`` replicas of a bucket hold from issue to force:
    their draw streams, arrival plan and times, and outputs."""
    alg, T, _, _, n_events, R = key
    n_draws = 4 if alg == "alock-rw" else 3
    per_replica = (4 * n_draws * n_events + 8 * LAT_SAMPLES + 4 * T + 24
                   + R * (4 * 4 + 8 + 8 + 8 + 4))
    return B * per_replica


def _upload(a, dev, dtype) -> torch.Tensor:
    """A host array as a tensor on ``dev``; to a CUDA device through
    pinned memory without blocking the host, in the current stream."""
    t = torch.from_numpy(np.array(a, dtype))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


class _Shard(NamedTuple):
    """One shard's enqueued device work."""
    dev: torch.device
    stream: object           # torch.cuda.Stream, or None on the CPU
    out: tuple               # the engine's device outputs
    marks: tuple             # (draws start, engine start, engine end)
    diag: object             # (B, 5) i32: events run, path, ops, reads, loop
    lat_stats: object        # (B, 3) i64: ``_lat_stats`` of the ring
    parked: object           # host (edges, parked) of ``_parked_phases``


def _lat_stats(lat: torch.Tensor) -> torch.Tensor:
    """Per replica the sum, count and largest of the latency ring's valid
    (non-negative) samples, ``(B, 3)`` int64, where the ring lies: what
    ``BatchResult.mean_lat_us`` needs without a pass over the ring on the
    host."""
    valid = lat >= 0
    return torch.stack((torch.where(valid, lat, 0).sum(1), valid.sum(1),
                        lat.amax(1)), 1)


class _Bucket:
    """A bucket in flight: what its results need, and the host rows of its
    superchunks forced so far, in row order."""

    def __init__(self, key, idxs, seeds, pending: int):
        self.key = key
        self.idxs = idxs
        self.seeds = seeds                    # (C, S)
        self.pending = pending                # dispatches not yet forced
        self.parts: list = []                 # forced shards' host outputs


class _Issued(NamedTuple):
    """A dispatch — a whole bucket, or one superchunk of a sharded one —
    whose shards are enqueued."""
    bucket: _Bucket
    shards: list
    need: dict               # device -> bytes its shards hold until forced


@stage("sweep.issue", "issue")
def _issue_shard(key, thread_node, lock_node, wl: WorkloadOperands,
                 backend: str, dev, stream) -> _Shard:
    """Enqueue one shard (its rows of a bucket) on ``dev``: upload its
    operands, draw its stream (and plan), launch its engine call with a
    ``(B, 5)`` ``diag`` (events run, the open loop's path, lock operations
    begun, begun shared and begun on the loopback tier). ``wl`` leaves
    (numpy) carry the shard's rows."""
    alg, T, N, K, n_events, R = key
    ctx = (contextlib.nullcontext() if stream is None
           else torch.cuda.stream(stream))
    with ctx:
        d0 = _mark(dev)
        with stage("sweep.upload"):
            wd = (to_device(wl, dev) if dev.type != "cuda" else
                  WorkloadOperands(*(
                      _upload(a, dev, OPERAND_DTYPES[name])
                      for name, a in zip(WorkloadOperands._fields, wl))))
            tn = _upload(thread_node, dev, np.int32)
            ln = _upload(lock_node, dev, np.int32)
        with stage("sweep.draws"):
            streams = precompute_draws(wd.seed, wd.edges, wd.zcdf, n_events,
                                       N, K // N, rw=alg == "alock-rw",
                                       device=dev, backend=backend)
        plan = None
        if R:
            with stage("sweep.plan", "plan"):
                plan = precompute_plan(wd, n_events, device=dev,
                                       backend=backend)
        d1 = _mark(dev)
        with stage("sweep.launch"):
            diag = torch.zeros((wd.seed.shape[0], DIAG_COLS),
                               dtype=torch.int32, device=dev)
            out = run_events(alg, T, N, K, n_events, wd, tn, ln,
                             backend=backend, device=dev, streams=streams,
                             plan=plan, diag=diag)
        e1 = _mark(dev)
        lat_stats = _lat_stats(out[1])
    return _Shard(dev, stream, out, (d0, d1, e1), diag, lat_stats,
                  _parked_phases(wl))


def _parked_phases(wl: WorkloadOperands):
    """Per row of a shard's operands (numpy), its phases' first events
    ``(B, P)`` int64 and whether each phase parks a thread ``(B, P)``
    bool; None for one phase, which parks nobody (the engine then
    schedules every thread)."""
    edges = np.asarray(wl.edges, np.int64)
    if edges.shape[1] == 1:
        return None
    return edges, (np.asarray(wl.active) == 0).any(axis=-1)


def _down_events(parked, ev_run: np.ndarray, n_events: int) -> int:
    """Events run in a phase that parks a thread, summed over the rows:
    each phase's events ``[edges[p], edges[p + 1])``, cut at the row's
    events run ``ev_run``."""
    if parked is None:
        return 0
    edges, down = parked
    ends = np.concatenate(
        [edges[:, 1:], np.full((len(edges), 1), n_events, np.int64)], 1)
    ev = ev_run.astype(np.int64)[:, None]
    span = np.minimum(ends, ev) - np.minimum(edges, ev)
    return int((span * down).sum())


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t``'s values on the host. From a CUDA device through page-locked
    memory of the caching host allocator, which the next buckets reuse
    once the results that view it are gone: no page of a fresh pageable
    buffer is faulted in for every copy (which made the copy-back of a
    job's latency rings take from 7 to 47 ms on the host of an NVIDIA H100
    machine, and a copy out of the page-locked block into NumPy's own
    memory as much). So a ``BatchResult`` made on a CUDA device holds
    page-locked host memory while it lives, its latency rings the most of
    it (256 KiB a replica). A CPU tensor as it is."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


def _joined(parts, j: int, B: int) -> np.ndarray:
    """Output ``j`` of the shards ``parts`` joined in row order, the
    padding rows cut off."""
    a = parts[0][j] if len(parts) == 1 else np.concatenate(
        [p[j] for p in parts])
    return a[:B]


def _force_bucket(issued: _Issued, configs, n_events: int, out: list):
    """Wait for one dispatch, copy its shards' outputs back, count their
    events and, once its bucket's last dispatch is in, fill the bucket's
    workloads' ``BatchResult``s into ``out``."""
    with stage("sweep.wait", "wait"):
        for sh in issued.shards:
            if sh.stream is not None:
                sh.marks[-1].synchronize()
    bucket = issued.bucket
    lane = _kernel.owner_lane(bucket.key[1], bucket.key[5])
    with stage("sweep.copy_back", "aggregate"):
        for sh in issued.shards:
            ctx = (contextlib.nullcontext() if sh.stream is None
                   else torch.cuda.stream(sh.stream))
            with ctx:
                bucket.parts.append(tuple(_to_host(o) for o in sh.out)
                                    + (_to_host(sh.lat_stats),))
                diag = _to_host(sh.diag)
                counts = diag.sum(axis=0, dtype=np.int64)
                _EVENTS["drawn"] += sh.out[0].shape[0] * n_events
                _EVENTS["run"] += int(counts[0])
                _EVENTS["ops"] += int(counts[2])
                _EVENTS["reads"] += int(counts[3])
                _EVENTS["loop"] += int(counts[4])
                _EVENTS["down"] += _down_events(sh.parked, diag[:, 0],
                                                n_events)
                if lane:
                    _EVENTS["lane"] += int(counts[0])
        bucket.pending -= 1
    if bucket.pending == 0:
        with stage("sweep.aggregate", "aggregate"):
            _aggregate(bucket, configs, n_events, out)


def _aggregate(bucket: _Bucket, configs, n_events: int, out: list):
    """A bucket's joined outputs -> its workloads' ``BatchResult``s."""
    _, T, _, _, _, R = bucket.key
    C, S = bucket.seeds.shape
    outs = tuple(_joined(bucket.parts, j, C * S)
                 for j in range(len(bucket.parts[0])))
    bucket.parts = []
    done, lat, _lat_n, t_end, nreacq, npass = outs[:6]
    lat_stats = outs[-1].reshape(C, S, 3)
    done = done.reshape(C, S, T)
    lat = lat.reshape(C, S, LAT_SAMPLES)
    t_end = t_end.reshape(C, S)
    nreacq = nreacq.reshape(C, S)
    npass = npass.reshape(C, S)
    extras = None
    if R:
        extras = tuple(o.reshape(C, S, R) for o in outs[6:-1])

    for row, i in enumerate(bucket.idxs):
        ops = done[row].sum(axis=1).astype(np.int64)
        sim_ns = np.maximum(t_end[row].astype(np.int64), 1)
        # per-element arithmetic matches simulate()'s scalar formula
        # bitwise: ops / sim_ns * 1e3 in float64 either way
        mops = ops / sim_ns * 1e3
        kw = {}
        if extras is not None:
            kw = dict(arr_ns=extras[0][row], wait_ns=extras[1][row],
                      sojourn_ns=extras[2][row], rstat=extras[3][row])
        out[i] = BatchResult(configs[i], n_events, bucket.seeds[row], ops,
                             sim_ns, mops, lat[row], done[row], nreacq[row],
                             npass[row], lat_stats[row], **kw)


def _pack(key, operands: list, S: int, D: int, cm: CostModel):
    """A bucket's lowered operands (one per workload) as the rows of its
    engine call: every workload x ``S`` seeds, flattened to ``(C * S,
    ...)`` and padded to a multiple of ``D`` rows. Returns the cluster's
    ``thread_node`` and ``lock_node``, the ``(C, S)`` seeds and the packed
    ``WorkloadOperands`` (numpy)."""
    alg, T, N, K, _, R = key
    C, kpn = len(operands), K // N
    B = C * S
    thread_node, lock_node, _ = topology(alg, N, T // N, K, cm)
    # scenarios with fewer phases pad up to the bucket max with
    # unreachable phases, so mixed phase programs share one engine call
    # (open-loop arrival rows pad identically; R is part of the key)
    Pmax = max(o.n_phases for o in operands)
    loc = np.empty((C, S, Pmax, T), np.float32)
    zc = np.empty((C, S, Pmax, kpn), np.float32)
    ed = np.empty((C, S, Pmax), np.int32)
    th = np.empty((C, S, Pmax), np.int32)
    ac = np.empty((C, S, Pmax, T), np.int32)
    bi = np.empty((C, S, Pmax, 2), np.int32)
    cr = np.empty((C, S, Pmax, N_COST_ROWS), np.int32)
    nm = np.empty((C, S, Pmax, N), np.float32)
    sd = np.empty((C, S), np.int32)
    ag = np.empty((C, S, Pmax), np.float32)
    ae = np.empty((C, S, Pmax), np.int32)
    aq = np.empty((C, S, Pmax), np.int32)
    at = np.empty((C, S, Pmax, 2), np.float32)
    af = np.empty((C, S, R), np.int32)
    rk = np.empty((C, S, N), np.int32)
    rf = np.empty((C, S, Pmax, T), np.float32)
    for row, op in enumerate(operands):
        o = pad_phases(op, Pmax)
        loc[row], zc[row], ed[row] = o.locality, o.zcdf, o.edges
        th[row], ac[row], bi[row] = o.think_ns, o.active, o.b_init
        cr[row], nm[row] = o.cost_rows, o.node_mult
        ag[row], ae[row], aq[row] = (o.arr_gap_ns, o.arr_edges,
                                     o.arr_qcap)
        at[row], af[row] = o.arr_token, o.arr_fix
        rk[row], rf[row] = o.rack, o.read_frac
        sd[row] = int(o.seed) + np.arange(S, dtype=np.int32)

    def flat(a):
        # (C, S, ...) -> (B, ...), padded to a multiple of D
        return _sharding.pad_rows(a.reshape((B,) + a.shape[2:]),
                                  _sharding.padded_rows(B, D) - B)

    wl = WorkloadOperands(flat(loc), flat(zc), flat(ed), flat(th),
                          flat(ac), flat(bi), flat(sd), flat(cr), flat(nm),
                          flat(ag), flat(ae), flat(aq), flat(at), flat(af),
                          flat(rk), flat(rf))
    return thread_node, lock_node, sd, wl


@stage("sweep", "wall")
def sweep(configs: Sequence[SimConfig | Workload], n_seeds: int = 1,
          n_events: int = 400_000, cm: CostModel = CostModel(), *,
          backend: str = "auto", device="cuda", devices=None,
          chunk: int | None = None) -> list[BatchResult]:
    """Run every workload with seeds ``w.seed + [0, n_seeds)``; one engine
    call per ``shape_key`` bucket (per superchunk shard when sharding).

    configs: ``Workload`` specs and/or legacy ``SimConfig`` (adapter).
    backend: "kernel" | "plain" | "auto" — per-replica engine (see
      ``core/sim.py``); both return bitwise-identical replicas.
    device: where the buckets run; the default ``"cuda"`` raises without a
      CUDA device.
    devices: devices, all of one type, to shard each bucket's flattened
      (workload x seed) axis over; it takes the place of ``device``. A
      device may be listed more than once (its shards then share it).
      None with ``chunk`` set means every visible device of ``device``'s
      type; None with ``chunk=None`` keeps one dispatch per bucket.
    chunk: rows per device per dispatch *unit*. A bucket's units are
      coalesced into greedy power-of-two superchunks, one dispatch each
      (``popcount(units)`` per bucket); ``chunk=None`` with ``devices``
      set gives one even chunk per device (one superchunk). Every layout
      returns the same bits.

    Returns BatchResults parallel to ``configs`` (duplicates are simulated
    twice — dedupe upstream if the grid overlaps; ``experiments.Experiment``
    does). ``cm`` is the base cost model every ``cost=None`` workload
    inherits.

    >>> from repro_torch.core.batch import sweep
    >>> from repro_torch.workloads import Workload
    >>> rs = sweep([Workload("alock", 2, 2, 8, locality=0.9, seed=1)],
    ...            n_seeds=2, n_events=300, device="cpu")
    >>> rs[0].ops.shape                  # per-seed samples
    (2,)
    >>> rs[0].mean_mops > 0 and rs[0].p99_lat_ns > 0
    True
    """
    if n_seeds < 1:
        raise ValueError(f"n_seeds must be >= 1, got {n_seeds}")
    if chunk is not None and int(chunk) < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    devs = (_sharding.resolve_devices(devices, device)
            if devices is not None or chunk is not None
            else [resolve_device(device)])
    backend = resolve_backend(backend, devs[0])
    D = len(devs)
    places = list(dict.fromkeys(devs))         # each device once
    configs = list(configs)
    with stage("sweep.lower", "lower"):
        origins = {d: _mark(d) for d in places}
        lowered = [lower(as_workload(c), n_events, cm) for c in configs]
        buckets: dict[tuple, list[int]] = {}
        for i, lw in enumerate(lowered):
            buckets.setdefault(lw.shape_key, []).append(i)

    out: list[BatchResult | None] = [None] * len(configs)
    pools = {d: _stream_pool(d) for d in places}
    budgets = {d: _in_flight_budget(d) for d in places}
    live = dict.fromkeys(places, 0)            # bytes issued, not forced
    turn = dict.fromkeys(places, 0)            # next stream of each pool
    issued: deque[_Issued] = deque()
    spans = []                                 # (device, marks) per shard

    def force_oldest():
        oldest = issued.popleft()
        for d, n in oldest.need.items():
            live[d] -= n
        spans.extend((sh.dev, sh.marks) for sh in oldest.shards)
        _force_bucket(oldest, configs, n_events, out)

    def bytes_by_device(key, cut):
        need = {}
        for d, (_, n) in zip(devs, cut):
            need[d] = need.get(d, 0) + _bucket_bytes(key, n)
        return need

    def make_room(need):
        # bound the device memory of the issued shards: force the oldest
        # dispatch until this one fits on each of its devices (on the
        # CPU: always)
        while issued and any(live[d] + n > budgets[d]
                             for d, n in need.items()):
            force_oldest()

    for key, idxs in buckets.items():
        B = len(idxs) * n_seeds
        # unsharded (one device, no chunk): one superchunk of B rows
        parts = _sharding.superchunks(B, D, chunk)
        cuts = [_sharding.shards(off, nrows, D) for off, nrows in parts]
        # room for the first dispatch before packing (on the CPU: every
        # earlier bucket forced first)
        make_room(bytes_by_device(key, cuts[0]))
        with stage("sweep.pack", "lower"):
            thread_node, lock_node, sd, wl = _pack(
                key, [lowered[i].operands for i in idxs], n_seeds, D, cm)
        bucket = _Bucket(key, idxs, sd, len(parts))
        for cut in cuts:
            need = bytes_by_device(key, cut)
            make_room(need)
            shards = []
            for d, (off, n) in zip(devs, cut):
                pool = pools[d]
                shards.append(_issue_shard(
                    key, thread_node, lock_node,
                    WorkloadOperands(*(a[off:off + n] for a in wl)),
                    backend, d, pool[turn[d] % len(pool)]))
                turn[d] += 1
            for d, n in need.items():
                live[d] += n
            _STATS["dispatches"] += 1
            issued.append(_Issued(bucket, shards, need))
    while issued:
        force_oldest()
    # the device stages' time: union of the shards' intervals, each
    # timed against its own device's origin
    marks = [tuple(_seconds(origins[d], m) for m in ms)
             for d, ms in spans]
    draws = [(d0, d1) for d0, d1, _ in marks]
    engine = [(d1, e1) for _, d1, e1 in marks]
    _SECONDS["draws"] += _union(draws)
    _SECONDS["engine"] += _union(engine)
    _SECONDS["engine_only"] += _union_outside(engine, draws)
    return out
