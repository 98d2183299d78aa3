"""Packaging rules of the port: it stands alone, and it never falls back.

No module under ``src/repro_torch/`` and not ``chip_smoke.py`` imports
``jax`` or the reference package ``repro``; without a CUDA device the
default device raises instead of running on the CPU.
"""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "optax"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


def test_package_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    assert "src/repro_torch/kernels/event_loop/kernel.py" in names
    for mod in ("_build", "flash_attention/kernel", "flash_attention/"
                "kernel_bwd", "flash_attention/ops", "flash_attention/ref",
                "ssd_scan/kernel", "ssd_scan/ops", "ssd_scan/ref",
                "alock_tick/kernel", "alock_tick/ops", "alock_tick/ref"):
        assert f"src/repro_torch/kernels/{mod}.py" in names
    assert "src/repro_torch/core/tla.py" in names
    for src in ("event_loop.cu", "flash_attention.cu",
                "flash_attention_bwd.cu", "ssd_scan.cu", "flash_common.cuh",
                "flash_hopper.cuh", "alock_tick.cu"):
        assert (PKG / "csrc" / src).exists()


@pytest.mark.parametrize(
    "path", FILES, ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_jax_or_reference_import(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path}: forbidden imports {bad}"


def test_import_leaves_jax_and_reference_unloaded():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core.sim, repro_torch.core.batch\n"
        "import repro_torch.experiments, repro_torch.workloads\n"
        "import repro_torch.kernels.event_loop.ops, repro_torch.traffic\n"
        "import repro_torch.experiments.registry\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.ssd_scan.ops\n"
        "import repro_torch.kernels.alock_tick.ops, repro_torch.core.tla\n"
        "import repro_torch.parallel.sharding, repro_torch.coord.stress\n"
        "import repro_torch.core.lock_table\n"
        "import repro_torch.kernels.event_loop.i32pair\n"
        "import repro_torch.analysis, repro_torch.analysis.__main__\n"
        "import repro_torch.analysis.fixtures\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


DOCTEST_MODULES = [
    "repro_torch.analysis", "repro_torch.analysis.entrypoints",
    "repro_torch.analysis.imports", "repro_torch.analysis.rules",
    "repro_torch.core.batch", "repro_torch.core.cost_model",
    "repro_torch.experiments", "repro_torch.experiments.registry",
    "repro_torch.experiments.slo", "repro_torch.kernels.alock_tick.ops",
    "repro_torch.kernels.event_loop.i32pair",
    "repro_torch.kernels.event_loop.ops", "repro_torch.parallel.sharding",
    "repro_torch.traffic.metrics", "repro_torch.traffic.stream",
    "repro_torch.workloads", "repro_torch.workloads.lower",
    "repro_torch.workloads.spec",
]


def test_every_module_with_examples_is_listed():
    found = []
    for path in sorted(PKG.rglob("*.py")):
        if ">>>" in path.read_text():
            parts = path.relative_to(ROOT / "src").with_suffix("").parts
            found.append(".".join(p for p in parts if p != "__init__"))
    assert found == sorted(DOCTEST_MODULES)


@pytest.mark.parametrize("name", DOCTEST_MODULES)
def test_docstring_examples_run(name):
    import doctest
    import importlib
    res = doctest.testmod(importlib.import_module(name),
                          optionflags=doctest.ELLIPSIS)
    assert res.attempted > 0 and res.failed == 0


def _workload():
    from repro_torch.workloads import Workload
    return Workload("alock", 2, 2, 8, locality=0.9, seed=1)


def test_default_device_raises_without_cuda(monkeypatch):
    import torch
    from repro_torch.core.batch import sweep
    from repro_torch.core.sim import simulate
    from repro_torch.experiments import Experiment
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate(_workload(), n_events=50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep([_workload()], n_events=50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Experiment("x", n_events=50).add(_workload()).run()


def test_kernel_backend_on_cpu_raises():
    from repro_torch.core.sim import simulate
    with pytest.raises(ValueError, match="needs a CUDA device"):
        simulate(_workload(), n_events=50, backend="kernel", device="cpu")


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches for CUDA tensors or raises — it never hands a
    CPU tensor to the plain version on its own."""
    import numpy as np
    from repro_torch.core.sim import topology
    from repro_torch.kernels.event_loop import kernel
    from repro_torch.kernels.event_loop.ops import precompute_draws
    from repro_torch.workloads import WorkloadOperands, lower, to_device
    w = _workload()
    ops = lower(w, 50).operands
    wl = to_device(WorkloadOperands(*(np.asarray(a)[None] for a in ops)),
                   "cpu")
    tn, ln, _ = topology("alock", 2, 2, 8)
    streams = precompute_draws(wl.seed, wl.edges, wl.zcdf, 50, 2, 4,
                               device="cpu")
    before = kernel.LIB.launches()
    import torch
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernel.run_events_kernel("alock", 4, 2, 8, 50, wl,
                                 torch.from_numpy(tn),
                                 torch.from_numpy(ln), streams,
                                 lat_samples=64)
    assert kernel.LIB.launches() == before


def test_smem_budget_raises_actionably():
    from repro_torch.kernels.event_loop.kernel import smem_bytes, smem_table
    # the paper's largest shape fits with room to spare
    assert smem_bytes("alock", 160, 20, 1000, 1) < 20 * 1024
    assert smem_bytes("mcs", 160, 20, 1000, 1) \
        < smem_bytes("alock", 160, 20, 1000, 1) \
        < smem_bytes("alock-rw", 160, 20, 1000, 1)
    with pytest.raises(ValueError, match="tail0/word") as ei:
        smem_bytes("alock", 160, 20, 40_000, 1)
    assert "n_locks" in str(ei.value)
    # open loop: the request rows are priced (8 B arrival time + four
    # 4 B rows per slot, one bound request per thread), and the
    # registry's topology at R = 256 fits
    closed = smem_bytes("alock", 16, 4, 16, 3)
    assert smem_bytes("alock", 16, 4, 16, 3, 256) \
        == closed + 256 * (8 + 4 * 4) + 4 * 16
    assert smem_table("mcs", 16, 4, 16, 3, 256)["arrival"] == 8 * 256
    assert smem_bytes("alock", 16, 4, 16, 3, 256) < 10 * 1024
    with pytest.raises(ValueError, match="max_requests"):
        smem_bytes("alock", 16, 4, 16, 3, 10_000)


@pytest.mark.parametrize("kw", [{"devices": ["cpu", "cpu"]},
                                {"chunk": 1}])
def test_sharded_dispatch_raises_not_implemented(kw):
    """Sharded dispatch is ported: two shards on one device, and chunks of
    one row, return the unsharded sweep's arrays (this test once asserted
    that ``devices=`` / ``chunk=`` raise ``NotImplementedError``)."""
    import numpy as np
    from repro_torch.core import batch
    base = batch.sweep([_workload()], n_seeds=3, n_events=50, device="cpu")
    batch.reset_exec_stats()
    got = batch.sweep([_workload()], n_seeds=3, n_events=50, device="cpu",
                      **kw)
    # ["cpu", "cpu"]: one superchunk of 4 rows (one padding row) in two
    # shards; chunk=1: 3 units -> superchunks of 2 and 1 rows
    assert batch.exec_stats()["dispatches"] == (1 if "devices" in kw else 2)
    for f in ("seeds", "ops", "sim_ns", "lat_ns", "per_thread_ops",
              "reacquires", "passes"):
        assert np.array_equal(getattr(base[0], f), getattr(got[0], f)), f


def test_open_loop_raises_not_implemented():
    """The open loop is ported: ``simulate`` and ``sweep`` run an
    open-loop spec on the CPU and return the per-request arrays (this
    test once asserted the opposite)."""
    import numpy as np
    from repro_torch.core.batch import sweep
    from repro_torch.core.sim import simulate
    from repro_torch.workloads import Arrivals
    w = _workload().replace(arrivals=Arrivals(rate_per_us=1.0,
                                              max_requests=8))
    one = simulate(w, n_events=200, device="cpu")
    br = sweep([w], n_events=200, device="cpu")[0]
    for arrs in ((one.arr_ns, one.wait_ns, one.sojourn_ns, one.rstat),
                 (br.arr_ns[0], br.wait_ns[0], br.sojourn_ns[0],
                  br.rstat[0])):
        assert [a.shape for a in arrs] == [(8,)] * 4
        assert [a.dtype for a in arrs] == [np.int64] * 3 + [np.int32]
    assert br.open_loop and br.serving(0)["arrived"] > 0
    np.testing.assert_array_equal(one.rstat, br.rstat[0])
