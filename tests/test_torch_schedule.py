"""The port's semantic machine (``Sem``, ``init_sem``, ``sem_step``,
``run_schedule``) against the JAX reference's, on the CPU.

``run_schedule`` drives one single-lock machine with an explicit thread
schedule; its per-step trace ``(pc, tail[0], victim[0], budget)`` and
final ``Sem`` must equal the reference's for all five algorithms, and its
pc trace the Python machines' (as ``tests/test_sim_and_kernels.py:13-43``
checks the reference). ``sem_step`` is also held against the reference's
step by step on a multi-lock state with explicit re-arm values, reader
draws and a rack map, one replica and a batch. Tolerance: zero — every
value is int32.
"""
import numpy as np
import numpy.random as npr
import pytest
import torch
from hypothesis_compat import given, settings, st

import torch_ref as R
from repro_torch.core import machine as mc
from repro_torch.core.sim import Sem, init_sem, run_schedule, sem_step

jax, jnp = R.jax, R.jnp

ALGS = ["alock", "mcs", "spinlock", "hlock", "alock-rw"]
TRACE = ("pc", "tail0", "victim0", "budget")


def _assert_same(alg, cohorts, b_init, sched):
    rs, rt = R.ref_sim.run_schedule(alg, cohorts, b_init, sched)
    gs, gt = run_schedule(alg, cohorts, b_init, sched, device="cpu")
    R.assert_bitwise([np.asarray(x) for x in rt], gt, TRACE)
    R.assert_bitwise([np.asarray(x) for x in rs], list(gs), Sem._fields)
    return gs, gt


@pytest.mark.parametrize("alg", ALGS)
def test_run_schedule_matches_reference(alg):
    rng = npr.default_rng(0)
    sched = rng.integers(0, 4, 600)
    _assert_same(alg, (0, 0, 1, 1), (2, 3), sched)


@pytest.mark.parametrize("alg", ["alock", "mcs", "spinlock"])
def test_run_schedule_matches_python_machine(alg):
    rng = npr.default_rng(0)
    cohorts = (0, 0, 1, 1)
    sched = rng.integers(0, 4, 600)
    st_ = mc.initial_state(4)
    pcs = []
    for tid in sched:
        st_, _ = mc.MACHINES[alg](st_, int(tid), cohorts[tid], (2, 3))
        pcs.append(st_.pc)
    _, trace = run_schedule(alg, cohorts, (2, 3), sched, device="cpu")
    assert np.array_equal(np.asarray(pcs), trace[0].numpy())


@given(st.integers(0, 2**31 - 1), st.sampled_from(ALGS))
@settings(max_examples=6, deadline=None)
def test_run_schedule_matches_reference_hypothesis(seed, alg):
    rng = npr.default_rng(seed)
    cohorts = tuple(rng.integers(0, 2, 3).tolist())
    sched = rng.integers(0, 3, 150)
    gs, _ = _assert_same(alg, cohorts, (1, 2), sched)
    if alg in ("alock", "mcs"):        # and the Python machine's end state
        st_ = mc.initial_state(3)
        for tid in sched:
            st_, _ = mc.MACHINES[alg](st_, int(tid), cohorts[tid], (1, 2))
        assert tuple(gs.pc.tolist()) == st_.pc
        assert tuple(gs.budget.tolist()) == st_.budget


def test_run_schedule_several_locks_and_empty_schedule():
    _assert_same("alock", (0, 1, 1), (2, 2), np.array([0, 1, 2, 0, 0, 1]))
    gs, gt = run_schedule("mcs", (0, 1), (1, 1), [], n_locks=2,
                          device="cpu")
    assert [tuple(t.shape) for t in gt] == [(0, 2), (0, 2), (0,), (0, 2)]
    rs, _ = R.ref_sim.run_schedule("mcs", (0, 1), (1, 1),
                                   np.zeros(1, np.int32), n_locks=2)
    assert tuple(gs.tail.shape) == tuple(np.asarray(rs.tail).shape)


def _draws(rng, S, T, K):
    return (rng.integers(0, T, S), rng.integers(0, K, S),
            rng.integers(0, 2, S), rng.integers(0, 2, S))


@pytest.mark.parametrize("alg", ALGS)
def test_sem_step_matches_reference(alg):
    """Three locks on two nodes, the NCS re-arm's target, cohort and read
    flag drawn per step, hlock's racks given: state, opcode and node after
    every step."""
    T, K = 5, 3
    tn, ln, rack = [0, 0, 1, 1, 1], [0, 1, 1], [0, 0]
    if alg == "hlock":
        rack = [0, 1]
    rng = npr.default_rng(ALGS.index(alg))
    tids, tgts, cohs, reads = _draws(rng, 400, T, K)
    rsem = R.ref_sim.init_sem(T, K, targets=[0, 1, 2, 0, 1],
                              cohorts=[0, 1, 0, 1, 1])
    gsem = init_sem(T, K, targets=[0, 1, 2, 0, 1], cohorts=[0, 1, 0, 1, 1],
                    device="cpu")
    R.assert_bitwise([np.asarray(x) for x in rsem], list(gsem))
    step = jax.jit(lambda s, t, a, b, c: R.ref_sim.sem_step(
        alg, s, t, (2, 3), tn, ln, a, b, c, rack=jnp.asarray(rack)))
    for i in range(len(tids)):
        t, a, b, c = (np.int32(v[i]) for v in (tids, tgts, cohs, reads))
        rsem, rcode, rnode = step(rsem, t, a, b, c)
        gsem, gcode, gnode = sem_step(alg, gsem, int(t), (2, 3), tn, ln,
                                      int(a), int(b), int(c), rack=rack)
        R.assert_bitwise([np.asarray(x) for x in rsem] + [rcode, rnode],
                         list(gsem) + [gcode, gnode],
                         list(Sem._fields) + ["code", "node"])


def test_sem_step_batch_equals_replica_by_replica():
    """B replicas in one call equal B one-replica calls; the input state
    is left as it was."""
    T, K, B = 4, 2, 3
    rng = npr.default_rng(7)
    single = [init_sem(T, K, targets=[0, 1, 1, 0], cohorts=[0, 0, 1, 1],
                       device="cpu") for _ in range(B)]
    batch = Sem(*(torch.stack(f) for f in zip(*single)))
    tn, ln = [0, 0, 1, 1], [0, 1]
    for _ in range(200):
        tids, tgts, cohs, _ = _draws(rng, B, T, K)
        given, kept = batch, [a.clone() for a in batch]
        batch, code, node = sem_step(
            "alock", batch, torch.from_numpy(tids), (2, 3), tn, ln,
            torch.from_numpy(tgts).int(), torch.from_numpy(cohs).int())
        assert all(torch.equal(a, b) for a, b in zip(given, kept))
        for r in range(B):
            single[r], c1, n1 = sem_step(
                "alock", single[r], int(tids[r]), (2, 3), tn, ln,
                int(tgts[r]), int(cohs[r]))
            assert all(torch.equal(a[r], b)
                       for a, b in zip(batch, single[r]))
            assert int(code[r]) == int(c1) and int(node[r]) == int(n1)


def test_sem_step_leaves_its_input_alone():
    sem = init_sem(3, 1, device="cpu")
    before = [a.clone() for a in sem]
    for tid in (0, 0, 1, 0):
        new, _, _ = sem_step("alock", sem, tid, (1, 1), [0, 0, 1], [0])
        assert all(torch.equal(a, b) for a, b in zip(sem, before))
        sem, before = new, [a.clone() for a in new]


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_schedule("alock", (0, 1), (1, 1), [0, 1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_sem(2, 1)


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError, match="unknown algorithm"):
        run_schedule("ticket", (0, 1), (1, 1), [0], device="cpu")
