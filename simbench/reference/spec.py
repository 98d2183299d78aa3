"""A workload as the benchmark's configuration files state it, lowered to
the per-phase tables the event loop reads.

A workload is a JSON object with the fields of the simulator's workload
spec: ``alg``, ``n_nodes``, ``threads_per_node``, ``n_locks``, and
optionally ``locality`` (a probability, a list of one per thread, or
``{"local", "frac", "rest"}``), ``zipf_s``, ``think`` (a class name or a
multiplier), ``b_init``, ``cost`` (a profile name or field overrides),
``node_mult`` (a profile name or ``{node: multiplier}``), ``topology``
(a rack id per node), ``read_frac``, ``phases`` (a list of objects with
``frac`` and any of ``locality``, ``zipf_s``, ``think``, ``down_nodes``,
``cost``, ``b_init``, ``node_mult``, ``rate_per_us``, ``read_frac``) and
``arrivals`` (``rate_per_us``, ``max_requests``, ``trace_ns``,
``queue_cap``, ``token_rate_per_us``, ``token_burst``).

The cost arithmetic is the paper's testbed model (ALock, section 5): a
shared-memory op, a local spin, the critical section and think time as
constants, and the RNIC's service time inflated by QP-context thrashing
and, for designs that use loopback, by PCIe pressure past a knee.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

I32_MAX = np.iinfo(np.int32).max

COST_DEFAULT = dict(
    local_ns=100.0, spin_poll_ns=400.0, remote_wire_ns=1500.0,
    loopback_wire_ns=1800.0, rnic_svc_ns=250.0, cs_ns=250.0,
    think_ns=300.0, pcie_knee=2, pcie_beta=0.8, qp_cache=450,
    qp_alpha=1.2, thrash_cap=5.0)
COST_PROFILES = {
    "default": {},
    "idle-nic": dict(rnic_svc_ns=150.0, remote_wire_ns=1200.0,
                     loopback_wire_ns=1500.0),
    "congested-nic": dict(rnic_svc_ns=900.0, remote_wire_ns=3500.0,
                          loopback_wire_ns=5200.0, pcie_beta=1.6,
                          qp_alpha=1.8),
}
THINK_CLASSES = {"none": 0.0, "short": 0.25, "default": 1.0, "long": 4.0}
NODE_MULT_PROFILES = {"healthy": {}, "limp-node0-2x": {0: 2.0},
                      "limp-node0-4x": {0: 4.0}}


def _cost_model(cost, base: dict) -> dict:
    if cost is None:
        return base
    if isinstance(cost, str):
        return {**COST_DEFAULT, **COST_PROFILES[cost]}
    return {**base, **{k: float(v) for k, v in cost.items()}}


def cost_rows(cm: dict, alg: str, n_nodes: int, tpn: int) -> list[int]:
    """The eight integer-ns costs ``(local, poll, cs, think, svc_remote,
    svc_loopback, wire_remote, wire_loopback)``."""
    loop = alg != "alock"
    n, t = n_nodes, tpn
    qps = (n - 1) * t + t * max(n - 1, 0) + (2 * t if loop else 0)
    thrash = 1.0
    if qps > cm["qp_cache"]:
        thrash = min(1.0 + cm["qp_alpha"] * (qps / cm["qp_cache"] - 1.0),
                     cm["thrash_cap"])
    pcie = (1.0 + cm["pcie_beta"] * max(0, t - cm["pcie_knee"])
            if loop else 1.0)
    return [int(round(v)) for v in (
        cm["local_ns"], cm["spin_poll_ns"], cm["cs_ns"], cm["think_ns"],
        cm["rnic_svc_ns"] * thrash, cm["rnic_svc_ns"] * (thrash * pcie),
        cm["remote_wire_ns"], cm["loopback_wire_ns"])]


def zipf_cdf(kpn: int, s: float) -> np.ndarray:
    """Inclusive CDF of a Zipf(s) rank over ``kpn`` locks: weights
    normalised in f64, the cumulative sum cast to f32."""
    w = np.arange(1, kpn + 1, dtype=np.float64) ** (-float(s))
    return np.cumsum(w / w.sum()).astype(np.float32)


def _per_thread(v, n_nodes: int, tpn: int) -> np.ndarray:
    T = n_nodes * tpn
    if isinstance(v, dict):
        row = np.full(tpn, np.float32(v["rest"]))
        row[:int(round(v["frac"] * tpn))] = np.float32(v["local"])
        return np.tile(row, n_nodes)
    if isinstance(v, (list, tuple)):
        return np.asarray(v, np.float32)
    return np.full(T, np.float32(v))


def _node_mult(nm, n_nodes: int) -> np.ndarray:
    pairs = NODE_MULT_PROFILES[nm] if isinstance(nm, str) else (nm or {})
    row = np.ones(n_nodes, np.float32)
    for n, m in pairs.items():
        row[int(n)] = np.float32(float(m))
    return row


class Lowered(NamedTuple):
    """A workload's tables; ``P`` phases, ``T`` threads, ``R`` requests."""
    alg: str
    T: int
    N: int
    K: int
    locality: np.ndarray     # (P, T) f32
    zcdf: np.ndarray         # (P, K // N) f32
    edges: np.ndarray        # (P,) first event of each phase
    think_ns: np.ndarray     # (P,)
    active: np.ndarray       # (P, T) 0 where the thread's node is down
    b_init: np.ndarray       # (P, 2)
    cost_rows: np.ndarray    # (P, 8)
    node_mult: np.ndarray    # (P, N) f32
    arr_gap_ns: np.ndarray   # (P,) f32 mean Poisson gap, 0 = none
    arr_edges: np.ndarray    # (P,) first request of each phase
    arr_qcap: np.ndarray     # (P,) queue bound
    arr_token: np.ndarray    # (P, 2) f32 token refill per ns, burst
    arr_fix: np.ndarray      # (R,) base gaps
    rack: np.ndarray         # (N,)
    read_frac: np.ndarray    # (P, T) f32


def lower(w: dict, n_events: int) -> Lowered:
    """The tables of workload ``w`` for a run of ``n_events`` events."""
    alg, N = w["alg"], int(w["n_nodes"])
    tpn, K = int(w["threads_per_node"]), int(w["n_locks"])
    T, kpn = N * tpn, K // N
    if K % N:
        raise ValueError(f"n_locks={K} is not a multiple of n_nodes={N}")
    phases = w.get("phases") or [{"frac": 1.0}]
    P = len(phases)
    base_cm = _cost_model(w.get("cost"), dict(COST_DEFAULT))
    arr = w.get("arrivals")
    R = 0
    if arr is not None:
        R = len(arr["trace_ns"]) if arr.get("trace_ns") else int(
            arr.get("max_requests", 256))
    loc = np.empty((P, T), np.float32)
    zc = np.empty((P, kpn), np.float32)
    edges = np.empty(P, np.int64)
    think = np.empty(P, np.int64)
    active = np.ones((P, T), np.int64)
    b_init = np.empty((P, 2), np.int64)
    crow = np.empty((P, 8), np.int64)
    nmult = np.empty((P, N), np.float32)
    gap = np.zeros(P, np.float32)
    aedges = np.zeros(P, np.int64)
    qcap = np.full(P, I32_MAX, np.int64)
    token = np.zeros((P, 2), np.float32)
    rfrac = np.empty((P, T), np.float32)
    rack = np.asarray(w.get("topology") or range(N), np.int64)
    cum = 0.0
    for p, ph in enumerate(phases):
        def get(name, default=None):
            v = ph.get(name)
            return w.get(name, default) if v is None else v
        edges[p] = int(round(cum * n_events))
        if arr is not None:
            aedges[p] = int(round(cum * R))
            rate = ph.get("rate_per_us")
            rate = float(arr.get("rate_per_us", 0.0)) if rate is None \
                else float(rate)
            gap[p] = np.float32(1000.0 / rate) if rate > 0.0 else 0.0
            if arr.get("queue_cap") is not None:
                qcap[p] = int(arr["queue_cap"])
            if float(arr.get("token_rate_per_us", 0.0)) > 0.0:
                token[p] = (np.float32(arr["token_rate_per_us"] / 1000.0),
                            np.float32(arr.get("token_burst", 8.0)))
        cum += float(ph["frac"])
        loc[p] = _per_thread(get("locality", 1.0), N, tpn)
        zc[p] = zipf_cdf(kpn, get("zipf_s", 0.0))
        cm = _cost_model(ph.get("cost"), base_cm)
        crow[p] = cost_rows(cm, alg, N, tpn)
        b_init[p] = get("b_init", (5, 20))
        th = get("think", "default")
        mult = THINK_CLASSES[th] if isinstance(th, str) else float(th)
        think[p] = int(round(mult * cm["think_ns"]))
        nmult[p] = _node_mult(get("node_mult"), N)
        rfrac[p] = _per_thread(get("read_frac", 0.0), N, tpn)
        for node in ph.get("down_nodes", ()):
            active[p, node * tpn:(node + 1) * tpn] = 0
    edges[0] = 0
    aedges[0] = 0
    if arr is None:
        fix = np.zeros(0, np.int64)
    elif arr.get("trace_ns"):
        fix = np.diff(np.asarray(arr["trace_ns"], np.int64), prepend=0)
    else:
        fix = np.zeros(R, np.int64)
    if P == 1 and (active == 0).any():
        # a masked single phase runs as two identical halves
        def two(a):
            return np.repeat(a, 2, axis=0)
        loc, zc, think, active = two(loc), two(zc), two(think), two(active)
        b_init, crow, nmult, gap = two(b_init), two(crow), two(nmult), \
            two(gap)
        qcap, token, rfrac = two(qcap), two(token), two(rfrac)
        edges = np.asarray([0, n_events // 2], np.int64)
        aedges = np.asarray([0, R // 2], np.int64)
    if len(edges) > 1 and np.any(np.diff(edges) <= 0):
        raise ValueError(f"a phase has no event at n_events={n_events}")
    return Lowered(alg, T, N, K, loc, zc, edges, think, active, b_init,
                   crow, nmult, gap, aedges, qcap, token, fix, rack, rfrac)
