"""The port's entrypoints for the rules: launch shapes, not traces.

The analyzer's raw material. Every workload a registered simulator
scenario sweeps (``repro_torch.experiments.scenario_workloads``) is
lowered and bucketed exactly as ``core/batch.py::sweep`` buckets it (shape
key + phase padding), and each bucket becomes one :class:`Entrypoint` for
the K1 instantiation it launches, with the shared-memory plan
(``smem_plan.plan_smem``) its wrapper would make on an H100. The kernels
off the simulator's path (K2-K6) get one entrypoint per launch shape their
paths and ``chip_smoke.py`` use. Nothing is put on a device and nothing is
launched: the JAX reference traces jaxprs here, the port has none.

  ========= =============================================================
  kind      what the record describes
  ========= =============================================================
  k1-closed a closed-loop sweep bucket through K1 (``csrc/event_loop.cu``)
  k1-open   an open-loop bucket (``R > 0`` request slots)
  k2        a K2 launch plan (``alock_tick.kernel.tick_plan``)
  k3 k4 k5  the attention forward, dq and dk/dv blocks at one head dim
  k6        a K6 launch plan (``ssd_scan.kernel.ssd_plan``)
  ========= =============================================================

>>> eps = collect_entrypoints(scenarios=["burst-storm"], n_events=512)
>>> sorted({ep.kind for ep in eps if ep.kind.startswith("k1")})
['k1-open']
>>> ep = next(ep for ep in eps if ep.kind == "k1-open")
>>> ep.dims["R"] > 0 and ep.plan.total_bytes <= ep.plan.limit
True
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable

import numpy as np

__all__ = ["Entrypoint", "collect_buckets", "collect_entrypoints",
           "k1_entrypoint", "kernel_entrypoints", "lowered_by_bucket",
           "DEFAULT_TRACE_EVENTS"]

#: lowered event count: shapes only (a bucket's operands do not depend on
#: it beyond the phase edges), small enough that every phase program stays
#: strictly increasing
DEFAULT_TRACE_EVENTS = 2048
#: streaming multiprocessors of an H100: the replicas-per-block request the
#: wrapper makes there (``smem_plan.default_warps``)
N_SM = 132
#: head dimensions of the attention kernels' shared-memory checks: the
#: test and path shapes (16, 128), one unaligned (80) and each padded width
HEAD_DIMS = (16, 64, 80, 128, 256)
#: K2 launch plans: (T, tile, mode, chain warps asked), the path shape
#: (16, 128, drawn) among them, a ring stepped down (300) and 4 chain warps
TICK_PLANS = ((3, 4, "given", 1), (16, 128, "given", 1),
              (16, 128, "drawn", 1), (100, 128, "drawn", 1),
              (300, 64, "given", 1), (200, 128, "given", 4),
              (16, 128, "drawn", 4))
#: K6 launches: (B, chunks, H, L, P, N), the reference tests' shape and the
#: path shape
SSD_SHAPES = ((2, 4, 2, 32, 32, 16), (2, 16, 16, 128, 64, 128))


@dataclass(frozen=True)
class Entrypoint:
    """One kernel launch shape of the port, and its rule context."""
    name: str            # e.g. "k1-closed:('alock', 16, 4, 16, 2048, 0)"
    kind: str            # k1-closed | k1-open | k2 | k3 | k4 | k5 | k6
    dims: dict           # the launch's static extents
    plan: Any = None     # K1: its SmemPlan; K2, K6: their launch plans
    meta: dict = field(default_factory=dict, compare=False)


def _lowered(scenarios: Iterable[str] | None, n_events: int):
    """``(scenario, shape key, operands)`` of every workload of the selected
    simulator scenarios (default: all registered), lowered for
    ``n_events``."""
    from repro_torch.experiments import scenario_names, scenario_workloads
    from repro_torch.workloads import lower
    names = list(scenarios) if scenarios is not None else scenario_names()
    out = []
    for scen in names:
        for w in scenario_workloads(scen) or ():
            lw = lower(w, n_events)
            out.append((scen, lw.shape_key, lw.operands))
    return out


def lowered_by_bucket(scenarios: Iterable[str] | None = None,
                      n_events: int = DEFAULT_TRACE_EVENTS) -> dict:
    """``{"scenario:shape key": [phase-padded operands, ...]}``: each
    scenario's sweep buckets, replica by replica, as ``sweep`` pads them."""
    from repro_torch.workloads import pad_phases
    per_bucket: dict = {}
    for scen, key, ops in _lowered(scenarios, n_events):
        per_bucket.setdefault(f"{scen}:{key}", []).append(ops)
    out = {}
    for bucket, ops in per_bucket.items():
        pmax = max(o.n_phases for o in ops)
        out[bucket] = [pad_phases(o, pmax) for o in ops]
    return out


def collect_buckets(scenarios: Iterable[str] | None = None,
                    n_events: int = DEFAULT_TRACE_EVENTS) -> dict:
    """Lower + bucket every scenario workload the way ``sweep`` would.

    Returns ``{shape_key: (batched WorkloadOperands, meta)}`` — one entry
    per distinct shape bucket across the selected scenarios (default: all
    registered simulator scenarios), each replica phase-padded to its
    bucket max so the batched leaves stack (numpy). ``meta`` records which
    scenarios contributed and the padded phase count.
    """
    from repro_torch.workloads import WorkloadOperands, pad_phases
    per_key: dict = {}
    sources: dict = {}
    for scen, key, ops in _lowered(scenarios, n_events):
        per_key.setdefault(key, []).append(ops)
        sources.setdefault(key, set()).add(scen)
    buckets = {}
    for key, ops in per_key.items():
        pmax = max(o.n_phases for o in ops)
        padded = [pad_phases(o, pmax) for o in ops]
        wl = WorkloadOperands(*(np.stack([np.asarray(getattr(o, f))
                                          for o in padded])
                                for f in WorkloadOperands._fields))
        buckets[key] = (wl, {"scenarios": sorted(sources[key]),
                             "n_phases": pmax})
    return buckets


def k1_entrypoint(alg: str, B: int, T: int, N: int, K: int, P: int,
                  R: int = 0, *, warps: int | None = None, name: str = "",
                  meta: dict | None = None) -> Entrypoint:
    """The K1 launch of ``B`` replicas of one shape, planned as its wrapper
    plans it on an H100 (``warps`` overrides the request)."""
    from repro_torch.kernels.event_loop.smem_plan import (default_warps,
                                                          plan_smem)
    plan = plan_smem(alg, B, T, N, K, P, R,
                     warps=default_warps(B, N_SM) if warps is None
                     else warps)
    kind = "k1-open" if R else "k1-closed"
    dims = {"alg": alg, "T": T, "N": N, "K": K, "P": P, "R": R}
    return Entrypoint(name or f"{kind}:{(alg, T, N, K, P, R)}", kind, dims,
                      plan, dict(meta or {}, B=B))


def kernel_entrypoints() -> list[Entrypoint]:
    """K2-K6 at the launch shapes of their paths and checks."""
    from repro_torch.kernels.alock_tick.kernel import tick_plan
    from repro_torch.kernels.ssd_scan.kernel import ssd_plan
    eps = []
    for T, tile, mode, cw in TICK_PLANS:
        p = tick_plan(T, tile, None, mode, chain_warps=cw)
        dims = {"T": T, "chain_warps": p.chain_warps,
                "stage_steps": p.stage_steps, "stages": p.stages}
        eps.append(Entrypoint(f"k2:{mode}:T={T}:tile={tile}:cw={cw}", "k2",
                              dims, p))
    for hd in HEAD_DIMS:
        for kind in ("k3", "k4", "k5"):
            eps.append(Entrypoint(f"{kind}:hd={hd}", kind, {"hd": hd}))
    for B, nc, H, L, P, N in SSD_SHAPES:
        p = ssd_plan(B, nc, H, L, P, N)
        eps.append(Entrypoint(f"k6:L={L}:P={P}:N={N}:hb={p.hb}", "k6",
                              {"L": L, "P": P, "N": N, "hb": p.hb}, p))
    return eps


def collect_entrypoints(scenarios: Iterable[str] | None = None,
                        n_events: int = DEFAULT_TRACE_EVENTS
                        ) -> list[Entrypoint]:
    """One K1 entrypoint per sweep bucket of the selected scenarios
    (``collect_buckets``), then ``kernel_entrypoints()``."""
    eps = []
    for key, (wl, bmeta) in collect_buckets(scenarios, n_events).items():
        alg, T, N, K, _, R = key
        eps.append(k1_entrypoint(
            alg, int(wl.seed.shape[0]), T, N, K, bmeta["n_phases"], R,
            name=f"{'k1-open' if R else 'k1-closed'}:{key}",
            meta=dict(bmeta, shape_key=key)))
    return eps + kernel_entrypoints()
