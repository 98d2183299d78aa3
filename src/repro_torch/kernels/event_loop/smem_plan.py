"""Shared-memory planner of the CUDA event-loop kernel (host code only).

The kernel (``csrc/event_loop.cu``) keeps every per-replica buffer in
shared memory for the whole run, one warp per replica and ``W`` replicas
(warps) per block, each in its own region. One region's bytes are a
closed-form function of ``(alg, T, N, K, P, R)`` (``smem_table``, the
carve-up of the ``.cu`` row by row); a block needs ``W`` regions, each
rounded up to 16 bytes, within the 227 KB one block may use on Hopper
(``_build.SMEM_LIMIT``).

``plan_smem`` chooses ``W``: the requested count, clamped to ``[1, B]``
and to ``MAX_WARPS``, then evened out (``ceil(B / ceil(B / W))``: the same
number of blocks, the smallest tail), then halved until ``W`` regions fit.
Deterministic: the same arguments give the same plan. When not even one
region fits, ``smem_bytes`` raises an actionable ``ValueError`` naming the
largest buffers and the knobs that shrink them. The counterpart of the
JAX reference's ``kernels/event_loop/vmem.py`` + ``ops.py::plan_for_run``;
``plan_for_run`` records the plan it makes, and
``repro_torch.core.batch.exec_stats()["smem_plan"]`` shows the last one.
``tests/test_torch_smem_plan.py`` holds the cases.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

from repro_torch.kernels._build import SMEM_LIMIT

ALGS = ("alock", "mcs", "spinlock", "hlock", "alock-rw")

#: replicas (warps) per block at most: the kernel's launch bound is 256
#: threads
MAX_WARPS = 8
#: each replica's region starts on this boundary (its 8-byte clocks and
#: the cost table's 8-byte pairs)
REGION_ALIGN = 16


def smem_table(alg: str, T: int, N: int, K: int, P: int,
               R: int = 0) -> dict:
    """name -> bytes of every buffer of one replica's region, in the
    ``.cu``'s order: the 8-byte clocks (and, ``R > 0``, arrival times),
    the 4-byte rows (the cost table staged per phase, 8 ints a node; the
    per-thread state and staged rows; the draw window; the open loop's
    request rows), then the 16-bit lock rows and the staged lock_node."""
    fam = alg in ("alock", "hlock", "alock-rw")
    table = {"ready": 8 * T, "op_start": 8 * T, "busy": 8 * N}
    if R:
        table["arrival"] = 8 * R
    table["cost_table"] = 4 * 8 * N
    for name in ("pc", "budget", "nxt", "prev", "target", "cohort", "done",
                 "lock_op", "thread_node", "locality", "active",
                 "argmin_key"):
        table[name] = 4 * T
    if alg == "alock-rw":
        table["read_frac"] = 4 * T
    if alg == "hlock":
        table["rack"] = 4 * N
    table["edges"] = 4 * P
    # the current 32-event window of the draw streams (u1 r2 r3 [u4])
    table["draw_window"] = 4 * 32 * (4 if alg == "alock-rw" else 3)
    if R:
        for name in ("rstat", "token", "token_cum", "queue_cap"):
            table[name] = 4 * R
        table["curreq"] = 4 * T
    table["tail0/word"] = 2 * K
    if fam:
        table["tail1"] = 2 * K
        table["victim"] = 2 * K
    if alg == "alock-rw":
        table["reader_count"] = 2 * K
    table["lock_node"] = 2 * K
    return table


def smem_bytes(alg: str, T: int, N: int, K: int, P: int, R: int = 0) -> int:
    """Bytes of one replica's region. Raises an actionable ``ValueError``
    naming the dominant buffers when one region alone exceeds what a block
    may hold (227 KB)."""
    if alg not in ALGS:
        raise ValueError(f"unknown algorithm {alg!r}; expected one of {ALGS}")
    if T + 1 > 0xFFFF:
        raise ValueError(f"the kernel's 16-bit lock rows hold thread ids up "
                         f"to {0xFFFF - 1}, got T={T}")
    table = smem_table(alg, T, N, K, P, R)
    total = sum(table.values())
    if total > SMEM_LIMIT:
        top = sorted(table.items(), key=lambda kv: -kv[1])[:3]
        detail = ", ".join(f"{n}={b:,}B" for n, b in top)
        raise ValueError(
            f"event-loop kernel cannot fit one replica's state into the "
            f"{SMEM_LIMIT:,}B of shared memory a block may use: "
            f"(alg={alg}, T={T}, N={N}, K={K}, P={P}, R={R}) needs "
            f"{total:,}B (largest buffers: {detail}). Lower n_locks (the "
            f"K-sized lock tables) or max_requests (the R-sized request "
            f"rows), or run this shape with backend='plain'.")
    return total


def region_bytes(replica_bytes: int) -> int:
    """One replica's region, rounded up to ``REGION_ALIGN``."""
    return -(-replica_bytes // REGION_ALIGN) * REGION_ALIGN


@dataclass(frozen=True)
class SmemPlan:
    """The planner's verdict for one launch."""
    alg: str
    replicas: int                 # B
    requested_warps: int
    warps: int                    # W, replicas per block
    blocks: int
    tail_replicas: int            # replicas in the last block
    replica_bytes: int            # one region, unpadded
    region_bytes: int             # one region, rounded up
    total_bytes: int              # one block: W regions
    limit: int
    shrunk: bool                  # halved to fit the limit
    breakdown: Mapping[str, int]  # name -> bytes for the block's W regions

    def as_dict(self) -> dict:
        """Compact form for ``exec_stats()`` and JSON records."""
        return {"alg": self.alg, "replicas": self.replicas,
                "requested_warps": self.requested_warps,
                "warps": self.warps, "blocks": self.blocks,
                "tail_replicas": self.tail_replicas,
                "replica_bytes": self.replica_bytes,
                "region_bytes": self.region_bytes,
                "total_bytes": self.total_bytes, "limit": self.limit,
                "shrunk": self.shrunk}


def plan_smem(alg: str, B: int, T: int, N: int, K: int, P: int,
              R: int = 0, *, warps: int,
              limit: int = SMEM_LIMIT) -> SmemPlan:
    """Choose the replicas per block for ``B`` replicas of one shape.

    ``warps`` is the request; the plan clamps it to ``[1, min(B,
    MAX_WARPS)]``, evens out the blocks, then halves it until ``W``
    regions fit ``limit`` bytes. Raises ``ValueError`` (``smem_bytes``'s
    message) when one region alone does not fit the hardware limit, and
    when it does not fit ``limit``.
    """
    if B < 1 or warps < 1:
        raise ValueError(f"need B >= 1 and warps >= 1, got (B={B}, "
                         f"warps={warps})")
    per = smem_bytes(alg, T, N, K, P, R)
    region = region_bytes(per)
    if region > limit:
        raise ValueError(
            f"event-loop kernel cannot fit one replica's region "
            f"({region:,}B) into the {limit:,}B limit of this plan; "
            f"(alg={alg}, T={T}, N={N}, K={K}, P={P}, R={R}). Lower "
            f"n_locks or max_requests, or raise the limit.")
    w = max(1, min(warps, B, MAX_WARPS))
    w = even = -(-B // -(-B // w))   # same block count, smallest tail
    while w > 1 and w * region > limit:
        w = max(1, w // 2)
    blocks = -(-B // w)
    table = smem_table(alg, T, N, K, P, R)
    return SmemPlan(alg=alg, replicas=B, requested_warps=warps, warps=w,
                    blocks=blocks, tail_replicas=B - (blocks - 1) * w,
                    replica_bytes=per, region_bytes=region,
                    total_bytes=w * region, limit=limit, shrunk=w < even,
                    breakdown={n: w * b for n, b in table.items()})


def default_warps(B: int, n_sm: int) -> int:
    """The request when the caller names none: enough replicas per block
    that one launch of ``B`` replicas spreads over the ``n_sm``
    multiprocessors, one block each, when it can."""
    return max(1, min(MAX_WARPS, -(-B // max(1, n_sm))))


# -- last-plan registry (read by batch.exec_stats) ---------------------------

_LAST_PLAN: SmemPlan | None = None


def plan_for_run(alg: str, B: int, T: int, N: int, K: int, P: int,
                 R: int = 0, *, n_sm: int,
                 warps: int | None = None) -> SmemPlan:
    """``plan_smem`` with ``warps`` defaulting to ``default_warps(B,
    n_sm)``; records the plan (``last_plan``). The kernel's wrapper plans
    every launch through here."""
    global _LAST_PLAN
    _LAST_PLAN = plan_smem(alg, B, T, N, K, P, R,
                           warps=default_warps(B, n_sm) if warps is None
                           else warps)
    return _LAST_PLAN


def last_plan() -> SmemPlan | None:
    return _LAST_PLAN


def clear_plan() -> None:
    global _LAST_PLAN
    _LAST_PLAN = None
