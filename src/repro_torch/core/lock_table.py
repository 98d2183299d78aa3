"""Distributed lock table — the paper's evaluation application, usable as a
real (threaded) coordination substrate.

Nodes are emulated in-process; the operation-asymmetric memory contract is
preserved: lock words (tails, victim) are mutated under a per-cell "hardware"
mutex that stands in for cache-coherent CAS / RNIC-serialized rCAS, while
descriptor fields (budget, next) are plain single-writer fields, exactly as
the algorithm requires (a thread spins locally on its own descriptor; only
its predecessor writes it). An optional `net` hook injects per-operation
latency so integration tests can exercise realistic interleavings.

The framework's coordination plane (checkpoint leases, elastic membership —
repro_torch.coord) runs on this table.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable

LOCAL, REMOTE = 0, 1


class Descriptor:
    __slots__ = ("budget", "next", "_cohort", "_cell")

    def __init__(self):
        self.budget = -1
        self.next = None


class ALockCell:
    """One 64B ALock: two cohort tails + victim."""
    __slots__ = ("hw", "tail", "victim")

    def __init__(self):
        self.hw = threading.Lock()
        self.tail = [None, None]
        self.victim = 0


@dataclass
class TableStats:
    ops: int = 0
    remote_ops: int = 0
    local_ops: int = 0
    reacquires: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def bump(self, **kw):
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)


class LockTable:
    def __init__(self, n_nodes: int, locks_per_node: int,
                 local_budget: int = 5, remote_budget: int = 20,
                 net: Callable[[str, int], None] | None = None):
        self.n_nodes = n_nodes
        self.locks_per_node = locks_per_node
        self.b_init = (local_budget, remote_budget)
        self.cells = [ALockCell() for _ in range(n_nodes * locks_per_node)]
        self.net = net
        self.stats = TableStats()

    # -- helpers ----------------------------------------------------------
    def owner_node(self, lock_id: int) -> int:
        return lock_id // self.locks_per_node

    def _op(self, kind: str, cohort: int):
        if cohort == REMOTE:
            self.stats.bump(remote_ops=1)
            if self.net:
                self.net(kind, cohort)
        else:
            self.stats.bump(local_ops=1)

    @staticmethod
    def _pause():
        time.sleep(0)  # yield GIL; local spin

    # -- paper API: Lock / Unlock ------------------------------------------
    def lock(self, node_id: int, lock_id: int) -> Descriptor:
        cell = self.cells[lock_id]
        c = LOCAL if self.owner_node(lock_id) == node_id else REMOTE
        d = Descriptor()
        with cell.hw:                      # rCAS-retry swap, linearized
            prev = cell.tail[c]
            cell.tail[c] = d
        self._op("swap", c)
        if prev is None:
            d.budget = self.b_init[c]
            self._peterson(cell, c)
        else:
            prev.next = d
            self._op("write_next", c)
            while d.budget == -1:          # local spin on own descriptor
                self._pause()
            if d.budget == 0:
                self.stats.bump(reacquires=1)
                self._peterson(cell, c)
                d.budget = self.b_init[c]
        d._cohort = c  # type: ignore[attr-defined]
        d._cell = cell  # type: ignore[attr-defined]
        return d

    def _peterson(self, cell: ALockCell, c: int):
        cell.victim = c
        self._op("set_victim", c)
        while True:
            # one 64B read observes both tails + victim
            other_locked = cell.tail[1 - c] is not None
            vict = cell.victim
            self._op("pet_check", c)
            if not other_locked or vict != c:
                return
            self._pause()

    def unlock(self, d: Descriptor):
        cell, c = d._cell, d._cohort  # type: ignore[attr-defined]
        with cell.hw:
            solo = cell.tail[c] is d
            if solo:
                cell.tail[c] = None
        self._op("rel_cas", c)
        if not solo:
            while d.next is None:
                self._pause()
            d.next.budget = d.budget - 1
            self._op("pass", c)
        self.stats.bump(ops=1)

    # -- convenience -------------------------------------------------------
    def critical(self, node_id: int, lock_id: int):
        table = self

        class _Guard:
            def __enter__(self):
                self.d = table.lock(node_id, lock_id)
                return self.d

            def __exit__(self, *exc):
                table.unlock(self.d)
                return False

        return _Guard()
