"""Host-side coordination plane built on the ALock lock table.

One `CoordService` emulates the control plane of a multi-pod training job:
named locks (hashed onto the distributed table), writer leases, membership.
On a real cluster each node talks to the table over its own transport; here
nodes are threads, and the asymmetric lock keeps local participants on
shared-memory ops — the paper's point, applied to the runtime.
"""
from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass

from repro_torch.core.lock_table import LockTable


class CoordService:
    def __init__(self, n_nodes: int, locks_per_node: int = 64,
                 local_budget: int = 5, remote_budget: int = 20, net=None):
        self.table = LockTable(n_nodes, locks_per_node, local_budget,
                               remote_budget, net=net)
        self.n_nodes = n_nodes
        self._kv: dict = {}
        self._kv_lock = threading.Lock()

    def lock_id(self, name: str) -> int:
        return zlib.crc32(name.encode()) % len(self.table.cells)

    def critical(self, node_id: int, name: str):
        return self.table.critical(node_id, self.lock_id(name))

    # a tiny strongly-consistent KV (guarded by the table's locks)
    def put(self, node_id: int, key: str, value):
        with self.critical(node_id, "kv:" + key):
            with self._kv_lock:
                self._kv[key] = value

    def get(self, key: str):
        with self._kv_lock:
            return self._kv.get(key)

    def update(self, node_id: int, key: str, fn, default=None):
        with self.critical(node_id, "kv:" + key):
            with self._kv_lock:
                cur = self._kv.get(key, default)
                new = fn(cur)
                self._kv[key] = new
                return new


@dataclass
class Lease:
    name: str
    holder: int
    deadline: float
    epoch: int


class LeaseManager:
    """Writer leases (checkpointing, log ownership) with crash expiry.

    acquire() is mutual-exclusive via the ALock; expiry lets a restarted
    node steal a dead holder's lease after ttl.

    ``clock`` is any zero-arg callable returning seconds (default
    ``time.monotonic``). Injecting a manual clock makes lease-expiry-storm
    scenarios deterministic — ``coord/stress.py`` and the tests drive
    expiry by advancing the clock instead of sleeping.
    """

    def __init__(self, svc: CoordService, ttl_s: float = 5.0,
                 clock=time.monotonic):
        self.svc = svc
        self.ttl = ttl_s
        self._clock = clock

    def acquire(self, node_id: int, name: str, *, attempts: int = 1,
                deadline_s: float | None = None,
                backoff_base_s: float = 0.05, backoff_max_s: float = 1.0,
                rng=None, sleep=None) -> Lease | None:
        """Acquire (or steal an expired) lease; ``None`` when held live.

        ``attempts > 1`` turns one shot into a bounded retry loop with
        exponential backoff: attempt ``i`` failing sleeps
        ``min(base * 2**i, max)``, jittered into ``[0.5, 1.0)`` of itself
        when an ``rng`` (anything with ``.random()``) is injected — a
        seeded rng keeps the schedule deterministic while still
        de-synchronizing contending nodes. ``deadline_s`` bounds the
        *total* time budget measured on the injected ``clock``: no sleep
        ever overshoots it, and the loop stops retrying once it is spent.
        ``sleep`` defaults to ``ManualClock.advance`` when the clock is
        manual (tests/stress advance virtual time, no real waiting) and
        ``time.sleep`` otherwise.
        """
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        if sleep is None:
            sleep = getattr(self._clock, "advance", time.sleep)
        start = self._clock()
        for i in range(attempts):
            lease = self._try_acquire(node_id, name)
            if lease is not None:
                return lease
            if i + 1 >= attempts:
                break
            d = min(backoff_base_s * (2.0 ** i), backoff_max_s)
            if rng is not None:
                d *= 0.5 + 0.5 * rng.random()
            if deadline_s is not None:
                remaining = deadline_s - (self._clock() - start)
                if remaining <= 0.0:
                    break
                d = min(d, remaining)
            sleep(d)
        return None

    def _try_acquire(self, node_id: int, name: str) -> Lease | None:
        with self.svc.critical(node_id, "lease:" + name):
            cur: Lease | None = self.svc.get("lease:" + name)
            now = self._clock()
            if cur is not None and cur.deadline > now and \
                    cur.holder != node_id:
                return None
            epoch = (cur.epoch + 1) if cur is not None else 0
            lease = Lease(name, node_id, now + self.ttl, epoch)
            with self.svc._kv_lock:
                self.svc._kv["lease:" + name] = lease
            return lease

    def renew(self, lease: Lease) -> bool:
        with self.svc.critical(lease.holder, "lease:" + lease.name):
            cur: Lease | None = self.svc.get("lease:" + lease.name)
            if cur is None or cur.epoch != lease.epoch:
                return False
            lease.deadline = self._clock() + self.ttl
            with self.svc._kv_lock:
                self.svc._kv["lease:" + lease.name] = lease
            return True

    def release(self, lease: Lease):
        with self.svc.critical(lease.holder, "lease:" + lease.name):
            cur: Lease | None = self.svc.get("lease:" + lease.name)
            if cur is not None and cur.epoch == lease.epoch:
                cur.deadline = 0.0


class Membership:
    """Elastic membership + heartbeat + straggler-aware shard ownership.

    ``clock`` mirrors :class:`LeaseManager`'s injectable clock so churn
    scenarios (node join/leave storms) run deterministically in tests.
    """

    def __init__(self, svc: CoordService, heartbeat_ttl: float = 2.0,
                 clock=time.monotonic):
        self.svc = svc
        self.ttl = heartbeat_ttl
        self._clock = clock

    def join(self, node_id: int):
        def upd(m):
            m = dict(m or {})
            m[node_id] = self._clock()
            return m
        self.svc.update(node_id, "members", upd, default={})

    def heartbeat(self, node_id: int):
        self.join(node_id)

    def alive(self) -> list[int]:
        m = self.svc.get("members") or {}
        now = self._clock()
        return sorted(n for n, t in m.items() if now - t < self.ttl)

    def leave(self, node_id: int):
        self.svc.update(node_id, "members",
                        lambda m: {k: v for k, v in (m or {}).items()
                                   if k != node_id}, default={})

    # ---- work shards (data pipeline ranges) ------------------------------
    def assign_shards(self, node_id: int, n_shards: int) -> list[int]:
        """Deterministic re-partition of shard ownership over live nodes —
        called after membership changes; lock-guarded so exactly one
        assignment wins per epoch."""
        with self.svc.critical(node_id, "shards"):
            live = self.alive()
            if not live:
                return []
            owner = {s: live[s % len(live)] for s in range(n_shards)}
            with self.svc._kv_lock:
                self.svc._kv["shards"] = owner
            return [s for s, n in owner.items() if n == node_id]

    def steal_from(self, node_id: int, dead_node: int) -> list[int]:
        """Straggler/failure mitigation: re-own a dead node's shards.

        Tolerates the "dead" node racing a late heartbeat: liveness is
        re-checked *inside* the shards critical section (the same lock
        :meth:`assign_shards` serializes on), and a target that
        heartbeated within the TTL aborts the steal — the caller keeps
        only what it already owns, and the revived node's shards stay
        put instead of being clobbered mid-recovery.
        """
        with self.svc.critical(node_id, "shards"):
            owner = dict(self.svc.get("shards") or {})
            if dead_node in self.alive():
                return [s for s, n in owner.items() if n == node_id]
            for s, n in owner.items():
                if n == dead_node:
                    owner[s] = node_id
            with self.svc._kv_lock:
                self.svc._kv["shards"] = owner
            return [s for s, n in owner.items() if n == node_id]
