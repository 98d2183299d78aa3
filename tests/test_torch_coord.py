"""The threaded lock table and coordination plane of the port.

The seven cases of the reference's ``tests/test_lock_table_and_coord.py``
run on ``repro_torch.core.lock_table`` and ``repro_torch.coord`` at the
same sizes, with the lease expiry driven by a ``ManualClock`` instead of a
wall-clock sleep. ``run_coord_stress`` and the registry's ``coord-stress``
are held against the reference on the fields the seed fixes (``ops``,
``per_node_ops``, lease grants, steals and retries, ``phase_members``);
``local_ops`` / ``remote_ops`` count Peterson spins and depend on the
threads' interleaving, in both packages.
"""
import random
import threading
import time

import pytest

import repro_torch.workloads as port_workloads
import torch_ref as R
from repro_torch.coord import (CoordService, LeaseManager, ManualClock,
                               Membership, run_coord_stress)
from repro_torch.core.lock_table import LockTable
from repro_torch.experiments import ExecOptions, run_scenario
from repro_torch.workloads import Phase, Workload

FIXED = ("ops", "per_node_ops", "lease_grants", "lease_steals",
         "lease_retries", "phase_members")
ROW_FIXED = ("name", "us_per_call", "ops", "lease_grants", "lease_steals",
             "phase_members")


def test_threaded_mutual_exclusion_counter():
    table = LockTable(n_nodes=4, locks_per_node=4)
    counter = {"v": 0}
    N_OPS, THREADS = 200, 8
    violations = []
    holders = {"n": 0}
    entries = {"n": 0}

    def worker(node):
        rng = random.Random(node)
        for _ in range(N_OPS):
            lk = rng.randrange(16)
            d = table.lock(node, lk)
            if lk == 3:
                holders["n"] += 1
                if holders["n"] != 1:
                    violations.append(1)
                v = counter["v"]
                time.sleep(0)                  # yield inside the section
                counter["v"] = v + 1
                entries["n"] += 1
                holders["n"] -= 1
            table.unlock(d)

    ths = [threading.Thread(target=worker, args=(i % 4,))
           for i in range(THREADS)]
    [t.start() for t in ths]
    [t.join() for t in ths]
    assert not violations
    assert table.stats.ops == N_OPS * THREADS
    # no increment lost: every entry into lock 3 counted once
    assert counter["v"] == entries["n"] > 0


def test_threaded_local_ops_stay_local():
    """100% locality => zero remote ops (the paper's headline property)."""
    table = LockTable(n_nodes=2, locks_per_node=4)

    def worker(node):
        for _ in range(100):
            lk = node * 4 + random.Random(node).randrange(4)
            d = table.lock(node, lk)
            table.unlock(d)

    ths = [threading.Thread(target=worker, args=(n,)) for n in range(2)]
    [t.start() for t in ths]
    [t.join() for t in ths]
    assert table.stats.remote_ops == 0
    assert table.stats.local_ops > 0


def test_lease_exclusive_and_expiry():
    svc = CoordService(4)
    clock = ManualClock()
    lm = LeaseManager(svc, ttl_s=0.25, clock=clock)
    l0 = lm.acquire(0, "ckpt:100")
    assert l0 is not None
    assert lm.acquire(1, "ckpt:100") is None      # exclusive
    assert lm.renew(l0)
    clock.advance(0.3)                            # past the TTL
    l1 = lm.acquire(1, "ckpt:100")                # expiry steal
    assert l1 is not None and l1.epoch == l0.epoch + 1
    assert not lm.renew(l0)                       # old epoch fenced off


def test_lease_single_writer_under_contention():
    svc = CoordService(4)
    lm = LeaseManager(svc, ttl_s=5.0, clock=ManualClock())
    wins = []

    def contender(n):
        lease = lm.acquire(n, "ckpt:7")
        if lease is not None:
            wins.append(n)

    ths = [threading.Thread(target=contender, args=(n,)) for n in range(8)]
    [t.start() for t in ths]
    [t.join() for t in ths]
    assert len(wins) == 1


def test_lease_acquire_retry_rides_out_expiry():
    svc = CoordService(4)
    clock = ManualClock()
    lm = LeaseManager(svc, ttl_s=0.5, clock=clock)
    l0 = lm.acquire(0, "ckpt:42")
    assert l0 is not None
    assert lm.acquire(1, "ckpt:42") is None and clock.t == 0.0
    # backoff schedule 0.2, 0.4 pushes t to 0.6 > ttl: attempt 3 steals
    l1 = lm.acquire(1, "ckpt:42", attempts=3, backoff_base_s=0.2)
    assert l1 is not None and l1.epoch == l0.epoch + 1
    assert clock.t == 0.2 + 0.4


def test_lease_acquire_retry_deadline_and_jitter_deterministic():
    svc = CoordService(4)
    clock = ManualClock()
    lm = LeaseManager(svc, ttl_s=10.0, clock=clock)
    assert lm.acquire(0, "log") is not None
    assert lm.acquire(1, "log", attempts=50, backoff_base_s=0.2,
                      deadline_s=1.0) is None
    assert clock.t <= 1.0
    t0 = clock.t
    lm.acquire(1, "log", attempts=4, backoff_base_s=0.2,
               rng=random.Random(7))
    d1 = clock.t - t0
    t0 = clock.t
    lm.acquire(1, "log", attempts=4, backoff_base_s=0.2,
               rng=random.Random(7))
    assert clock.t - t0 == d1
    nominal = 0.2 + 0.4 + 0.8
    assert nominal * 0.5 <= d1 < nominal
    with pytest.raises(ValueError, match="attempts"):
        lm.acquire(1, "log", attempts=0)


def test_membership_and_straggler_steal():
    svc = CoordService(4)
    clock = ManualClock()
    mem = Membership(svc, heartbeat_ttl=0.5, clock=clock)
    for n in range(3):
        mem.join(n)
    assert mem.alive() == [0, 1, 2]
    owned0 = mem.assign_shards(0, 9)
    assert len(owned0) == 3
    # node 0 heartbeated within the TTL: the steal aborts
    kept = mem.steal_from(2, dead_node=0)
    assert set(kept).isdisjoint(owned0)
    assert [s for s, n in svc.get("shards").items() if n == 0] == owned0
    clock.advance(0.6)
    mem.heartbeat(2)
    stolen = mem.steal_from(2, dead_node=0)
    assert set(owned0) <= set(stolen)
    mem.heartbeat(1)
    assert mem.alive() == [1, 2]


def test_names_hash_onto_the_reference_cells():
    port = CoordService(3, locks_per_node=4)
    ref = R.ref_coord_service.CoordService(3, locks_per_node=4)
    names = ["kv:members", "lease:shard:0", "shards", "ckpt:7", "log"]
    assert [port.lock_id(n) for n in names] == [ref.lock_id(n)
                                                for n in names]


def _churn(mod, seed):
    return mod.Workload("alock", 3, 4, 12, locality=0.9, seed=seed,
                        phases=(mod.Phase(frac=0.3),
                                mod.Phase(frac=0.4, down_nodes=(2,),
                                          zipf_s=2.0),
                                mod.Phase(frac=0.3)))


@pytest.mark.parametrize("seed", [0, 1])
def test_coord_stress_fixed_fields_equal_reference(seed):
    got = run_coord_stress(_churn(port_workloads, seed), ops_per_thread=30,
                           clock=ManualClock())
    want = R.ref_coord_stress.run_coord_stress(
        _churn(R.ref_workloads, seed), ops_per_thread=30,
        clock=R.ref_coord_stress.ManualClock())
    assert {f: getattr(got, f) for f in FIXED} \
        == {f: getattr(want, f) for f in FIXED}
    assert got.lease_retries > 0 and got.lease_steals > 0
    assert got.phase_members == [[0, 1, 2], [0, 1], [0, 1, 2]]
    assert got.per_node_ops[2] < min(got.per_node_ops[:2])
    assert got.local_ops + got.remote_ops > 0


def test_coord_stress_scenario_rows_equal_reference():
    got = run_scenario("coord-stress", n_seeds=1, n_events=3000,
                       options=ExecOptions(device="cpu"))
    want = R.ref_registry.run_scenario("coord-stress", n_seeds=1,
                                       n_events=3000)
    assert [{k: r[k] for k in ROW_FIXED} for r in got] \
        == [{k: r[k] for k in ROW_FIXED} for r in want]
    assert set(got[0]) == set(want[0])


def test_workload_spec_is_the_ports():
    w = Workload("alock", 3, 4, 12, locality=0.9,
                 phases=(Phase(frac=1.0),))
    rep = run_coord_stress(w, ops_per_thread=5, clock=ManualClock())
    assert rep.per_node_ops == [4 * 5] * 3
    assert rep.phase_members == [[0, 1, 2]]
