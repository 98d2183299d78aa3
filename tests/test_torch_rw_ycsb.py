"""The reader-writer lock table under YCSB's core mixes, on the CPU.

``ycsb-rw-1000`` (``simbench/configs/``) is ``alock-rw`` with Zipfian(0.99)
keys and read shares 0.5, 0.95 and 1.0 (YCSB A, B and C). Here it is cut to
a few threads, 12 locks and a few hundred events: the port's ``sweep`` on
the plain engine against the JAX reference's, bit for bit; the engine's
count of lock operations begun (``ops``) and begun shared (``reads``)
against a recount from its own trajectory; and ``reads`` nought for the
algorithms without readers. The ``card`` case holds the kernel's counts to
the plain engine's on a CUDA device:
``PYTHONPATH=src python -m pytest -q -m card --confcutdir=tests
tests/test_torch_rw_ycsb.py``.
"""
import numpy as np
import pytest
import torch

import torch_ref as R
from repro_torch.core import batch
from repro_torch.core import machine as mc
from repro_torch.core.cost_model import CostModel
from repro_torch.kernels.event_loop import ref as plain
from repro_torch.kernels.event_loop.ops import run_events
from repro_torch.workloads import Workload, lower

N_EVENTS, N_SEEDS = 300, 2
MIXES = {"A": 0.5, "B": 0.95, "C": 1.0}
ARRAYS = ("seeds", "ops", "sim_ns", "throughput_mops", "lat_ns",
          "per_thread_ops", "reacquires", "passes")


def _spec(workload, read_frac, seed=2**31 - 77):
    return workload("alock-rw", 3, 3, 12, locality=0.95, zipf_s=0.99,
                    b_init=(5, 20), read_frac=read_frac, seed=seed)


@pytest.fixture
def card():
    """``"cuda"``, or a skip where the process sees no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(scope="module")
def swept():
    ref_ws = [_spec(R.ref_workloads.Workload, f) for f in MIXES.values()]
    ref = R.ref_batch.sweep(ref_ws, n_seeds=N_SEEDS, n_events=N_EVENTS,
                            backend="xla")
    batch.reset_exec_stats()
    port = batch.sweep([R.to_port(w) for w in ref_ws], n_seeds=N_SEEDS,
                       n_events=N_EVENTS, device="cpu")
    return ref, port, batch.exec_stats()


@pytest.mark.parametrize("i,mix", enumerate(MIXES))
def test_ycsb_mix_equals_the_reference(swept, i, mix):
    ref, port, stats = swept
    for f in ARRAYS:
        want, got = np.array(getattr(ref[i], f)), getattr(port[i], f)
        assert want.dtype == got.dtype and want.shape == got.shape, f
        assert torch.equal(torch.from_numpy(want), torch.from_numpy(got)), \
            (mix, f)
    for row in ("mean_mops", "ci95_mops", "mean_lat_us", "p50_lat_ns",
                "p99_lat_ns"):
        assert getattr(ref[i], row) == getattr(port[i], row), (mix, row)
    # the mean read the ring's sums, reduced where the engine ran
    assert port[i].lat_stats.shape == (port[i].n_seeds, 3)
    assert port[i].ops.sum() > 0
    # the three mixes share one bucket: one dispatch for the sweep
    assert stats["dispatches"] == 1


def test_ops_and_reads_equal_a_recount_of_the_trajectory(swept,
                                                         monkeypatch):
    """Every step of the plain engine goes through ``sem_step``: a lock
    operation begins where thread ``tid`` leaves NCS, shared where it
    enters RD_TRY. The recount wraps ``sem_step`` and reads that off each
    step's state before and after."""
    seen = {"ops": 0, "reads": 0}
    step = plain.sem_step

    def recount(alg, sem, tid, *args, **kw):
        out = step(alg, sem, tid, *args, **kw)
        rows = torch.arange(sem.pc.shape[0])
        began = sem.pc[rows, tid] == mc.NCS
        seen["ops"] += int(began.sum())
        seen["reads"] += int((began & (out[0].pc[rows, tid]
                                       == mc.RD_TRY)).sum())
        return out

    monkeypatch.setattr(plain, "sem_step", recount)
    ws = [_spec(Workload, f) for f in MIXES.values()]
    batch.reset_exec_stats()
    again = batch.sweep(ws, n_seeds=N_SEEDS, n_events=N_EVENTS,
                        device="cpu")
    ev = batch.exec_stats()["events"]
    assert (ev["ops"], ev["reads"]) == (seen["ops"], seen["reads"])
    assert 0 < ev["reads"] < ev["ops"] < ev["drawn"] == ev["run"]
    # the count changes nothing the sweep returns
    _, port, stats = swept
    assert stats["events"] == ev
    for a, b in zip(again, port):
        assert np.array_equal(a.lat_ns, b.lat_ns)


def _diag(w, n_seeds, device, backend, n_events=N_EVENTS):
    """``run_events`` of ``w`` x ``n_seeds`` (packed as ``sweep`` packs a
    bucket) with a ``diag``: outputs and diag on the host."""
    low = lower(w, n_events)
    T = w.n_nodes * w.threads_per_node
    tn, ln, _, wl = batch._pack(low.shape_key, [low.operands], n_seeds, 1,
                                CostModel())
    diag = torch.full((n_seeds, plain.DIAG_COLS), -7, dtype=torch.int32,
                      device=device)
    out = run_events(w.alg, T, w.n_nodes, w.n_locks, n_events, wl, tn, ln,
                     backend=backend, device=device, diag=diag)
    return [o.cpu() for o in out], diag.cpu()


def test_reads_are_nought_without_readers():
    ws = [_spec(Workload, 0.95).replace(alg=a)
          for a in ("alock", "mcs", "spinlock")]
    batch.reset_exec_stats()
    batch.sweep(ws, n_seeds=N_SEEDS, n_events=N_EVENTS, device="cpu")
    ev = batch.exec_stats()["events"]
    assert ev["reads"] == 0 and 0 < ev["ops"] < ev["run"]
    _, diag = _diag(ws[0], N_SEEDS, "cpu", "plain")
    assert (diag[:, 3:] == 0).all() and (diag[:, 2] > 0).all()
    assert (diag[:, 0] == N_EVENTS).all()


@pytest.mark.card
def test_kernel_counts_equal_the_plain_engine(card):
    n = 2000
    for w in ([_spec(Workload, f) for f in MIXES.values()]
              + [_spec(Workload, 0.5).replace(alg="mcs")]):
        k_out, k_diag = _diag(w, 3, card, "kernel", n)
        p_out, p_diag = _diag(w, 3, "cpu", "plain", n)
        assert torch.equal(k_diag, p_diag), w
        assert all(torch.equal(a, b) for a, b in zip(k_out, p_out)), w
