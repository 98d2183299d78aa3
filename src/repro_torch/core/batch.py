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

``exec_stats()`` counts engine dispatches and kernel launches. Sharded
dispatch (``devices=`` / ``chunk=``) is not ported yet and raises
``NotImplementedError``.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.cost_model import CostModel, N_COST_ROWS
from repro_torch.core.sim import (LAT_SAMPLES, SimConfig, SimResult,
                                  topology)
from repro_torch.device import resolve_backend, resolve_device
from repro_torch.kernels.event_loop import kernel as _kernel
from repro_torch.kernels.event_loop.ops import (precompute_draws,
                                                precompute_plan, run_events)
from repro_torch.traffic.metrics import serving_summary
from repro_torch.workloads import (Workload, WorkloadOperands, as_workload,
                                   lower, pad_phases, to_device)

SHARDED_MSG = (
    "sharded dispatch (sweep(devices=, chunk=)) is not ported yet — ROADMAP "
    "Queue A, item 'sweep(devices=, chunk=)'")

# -- execution statistics ----------------------------------------------------
# A "dispatch" is one engine call covering a whole bucket; "launches" is the
# event-loop kernel's own launch counter (kernels/event_loop/kernel.py),
# read here so a run can show that its buckets went through the kernel.
# "seconds" splits the wall time of sweep() calls by stage ("draws" holds
# both state-independent precomputes: the draw stream and, open loop, the
# arrival plan); device stages are closed by a synchronize when the device
# is a CUDA device.
_STATS = {"dispatches": 0}
_SECONDS = {"lower": 0.0, "draws": 0.0, "engine": 0.0, "aggregate": 0.0}


def exec_stats() -> dict:
    """Snapshot of {dispatches, launches, seconds} since the last reset."""
    return {"dispatches": _STATS["dispatches"],
            "launches": _kernel.launches(), "seconds": dict(_SECONDS)}


def reset_exec_stats() -> None:
    _STATS["dispatches"] = 0
    for k in _SECONDS:
        _SECONDS[k] = 0.0
    _kernel.reset_launches()


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

    def serving(self, i: int) -> dict:
        """One seed's ``traffic.metrics.serving_summary`` dict."""
        if not self.open_loop:
            raise ValueError("serving() needs an open-loop run "
                             "(Workload.arrivals)")
        return serving_summary(self.arr_ns[i], self.wait_ns[i],
                               self.sojourn_ns[i], self.rstat[i],
                               int(self.sim_ns[i]))

    def serving_mean(self) -> dict:
        """Seed-averaged serving summary (nan-safe over empty seeds)."""
        rows = [self.serving(i) for i in range(self.n_seeds)]
        out = {}
        for k in rows[0]:
            vals = np.asarray([r[k] for r in rows], np.float64)
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
    def mean_lat_us(self) -> float:
        pool = self._lat_pool()
        return float(pool.mean()) / 1e3 if len(pool) else float("nan")

    @property
    def p50_lat_ns(self) -> float:
        pool = self._lat_pool()
        return float(np.percentile(pool, 50)) if len(pool) else float("nan")

    @property
    def p99_lat_ns(self) -> float:
        pool = self._lat_pool()
        return float(np.percentile(pool, 99)) if len(pool) else float("nan")

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


def _clock(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _exec_bucket(key, thread_node, lock_node, wl: WorkloadOperands,
                 backend: str, dev):
    """Run one flattened bucket (B rows) in one engine call and return the
    6 output arrays (10 for an open-loop bucket) as numpy. ``wl`` leaves
    (numpy) carry the flattened (workload x seed) axis B."""
    alg, T, N, K, n_events, R = key
    t0 = _clock(dev)
    wd = to_device(wl, dev)
    streams = precompute_draws(wd.seed, wd.edges, wd.zcdf, n_events, N,
                               K // N, rw=alg == "alock-rw", device=dev)
    plan = precompute_plan(wd, n_events, device=dev) if R else None
    t1 = _clock(dev)
    out = run_events(alg, T, N, K, n_events, wd, thread_node, lock_node,
                     backend=backend, device=dev, streams=streams,
                     plan=plan)
    t2 = _clock(dev)
    out = tuple(o.cpu().numpy() for o in out)
    _SECONDS["draws"] += t1 - t0
    _SECONDS["engine"] += t2 - t1
    _SECONDS["aggregate"] += time.perf_counter() - t2
    _STATS["dispatches"] += 1
    return out


def sweep(configs: Sequence[SimConfig | Workload], n_seeds: int = 1,
          n_events: int = 400_000, cm: CostModel = CostModel(), *,
          backend: str = "auto", device="cuda", devices=None,
          chunk: int | None = None) -> list[BatchResult]:
    """Run every workload with seeds ``w.seed + [0, n_seeds)``; one engine
    call per ``shape_key`` bucket.

    configs: ``Workload`` specs and/or legacy ``SimConfig`` (adapter).
    backend: "kernel" | "plain" | "auto" — per-replica engine (see
      ``core/sim.py``); both return bitwise-identical replicas.
    device: where the buckets run; the default ``"cuda"`` raises without a
      CUDA device.
    devices, chunk: sharded dispatch — not ported yet, must stay None.

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
    if devices is not None or chunk is not None:
        raise NotImplementedError(SHARDED_MSG)
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    configs = list(configs)
    t_start = time.perf_counter()
    lowered = [lower(as_workload(c), n_events, cm) for c in configs]
    buckets: dict[tuple, list[int]] = {}
    for i, lw in enumerate(lowered):
        buckets.setdefault(lw.shape_key, []).append(i)
    _SECONDS["lower"] += time.perf_counter() - t_start

    out: list[BatchResult | None] = [None] * len(configs)
    for key, idxs in buckets.items():
        t_start = time.perf_counter()
        alg, T, N, K, _, R = key
        kpn = K // N
        thread_node, lock_node, _ = topology(alg, N, T // N, K, cm)
        C, S = len(idxs), n_seeds
        # scenarios with fewer phases pad up to the bucket max with
        # unreachable phases, so mixed phase programs share one engine call
        # (open-loop arrival rows pad identically; R is part of the key)
        Pmax = max(lowered[i].operands.n_phases for i in idxs)
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
        for row, i in enumerate(idxs):
            o = pad_phases(lowered[i].operands, Pmax)
            loc[row], zc[row], ed[row] = o.locality, o.zcdf, o.edges
            th[row], ac[row], bi[row] = o.think_ns, o.active, o.b_init
            cr[row], nm[row] = o.cost_rows, o.node_mult
            ag[row], ae[row], aq[row] = (o.arr_gap_ns, o.arr_edges,
                                         o.arr_qcap)
            at[row], af[row] = o.arr_token, o.arr_fix
            rk[row], rf[row] = o.rack, o.read_frac
            sd[row] = int(o.seed) + np.arange(S, dtype=np.int32)

        def flat(a):
            return a.reshape((C * S,) + a.shape[2:])

        wl = WorkloadOperands(flat(loc), flat(zc), flat(ed), flat(th),
                              flat(ac), flat(bi), flat(sd), flat(cr),
                              flat(nm), flat(ag), flat(ae), flat(aq),
                              flat(at), flat(af), flat(rk), flat(rf))
        _SECONDS["lower"] += time.perf_counter() - t_start
        outs = _exec_bucket(key, thread_node, lock_node, wl, backend, dev)
        t_start = time.perf_counter()
        done, lat, _lat_n, t_end, nreacq, npass = outs[:6]
        done = done.reshape(C, S, T)
        lat = lat.reshape(C, S, LAT_SAMPLES)
        t_end = t_end.reshape(C, S)
        nreacq = nreacq.reshape(C, S)
        npass = npass.reshape(C, S)
        extras = None
        if R:
            extras = tuple(o.reshape(C, S, R) for o in outs[6:])

        for row, i in enumerate(idxs):
            ops = done[row].sum(axis=1).astype(np.int64)
            sim_ns = np.maximum(t_end[row].astype(np.int64), 1)
            # per-element arithmetic matches simulate()'s scalar formula
            # bitwise: ops / sim_ns * 1e3 in float64 either way
            mops = ops / sim_ns * 1e3
            kw = {}
            if extras is not None:
                kw = dict(arr_ns=extras[0][row], wait_ns=extras[1][row],
                          sojourn_ns=extras[2][row], rstat=extras[3][row])
            out[i] = BatchResult(configs[i], n_events, sd[row], ops,
                                 sim_ns, mops, lat[row], done[row],
                                 nreacq[row], npass[row], **kw)
        _SECONDS["aggregate"] += time.perf_counter() - t_start
    return out
