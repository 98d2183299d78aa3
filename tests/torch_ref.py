"""Import helper for the port's tests: the JAX reference next to the port.

Importing this module applies the ``jax.experimental.enable_x64`` alias
the reference needs on recent JAX releases (the same one the root
``conftest.py`` installs, repeated here so a test file also works when it
is imported outside pytest), pins JAX to the CPU, and re-exports the
reference modules the port is held against. Data crosses between the two
frameworks as numpy arrays only.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.experimental as _je  # noqa: E402

if not hasattr(_je, "enable_x64"):
    _je.enable_x64 = jax.enable_x64
if not hasattr(_je, "disable_x64"):
    _je.disable_x64 = lambda: jax.enable_x64(False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.analysis.entrypoints as ref_analysis_entrypoints  # noqa: E402,E501
import repro.analysis.imports as ref_analysis_imports  # noqa: E402
import repro.analysis.rules as ref_analysis_rules  # noqa: E402
import repro.coord.service as ref_coord_service  # noqa: E402
import repro.coord.stress as ref_coord_stress  # noqa: E402
import repro.core.batch as ref_batch  # noqa: E402
import repro.core.lock_table as ref_lock_table  # noqa: E402
import repro.core.machine as ref_machine  # noqa: E402
import repro.core.sim as ref_sim  # noqa: E402
import repro.core.tla as ref_tla  # noqa: E402
import repro.experiments as ref_experiments  # noqa: E402
import repro.experiments.registry as ref_registry  # noqa: E402
import repro.kernels.alock_tick.kernel as ref_tick_kernel  # noqa: E402
import repro.kernels.alock_tick.ops as ref_tick_ops  # noqa: E402
import repro.kernels.alock_tick.ref as ref_tick_ref  # noqa: E402
import repro.kernels.event_loop.i32pair as ref_i32pair  # noqa: E402
import repro.kernels.event_loop.ops as ref_ops  # noqa: E402
import repro.kernels.event_loop.ref as ref_ref  # noqa: E402
import repro.kernels.flash_attention.kernel as ref_flash_kernel  # noqa: E402
import repro.kernels.flash_attention.kernel_bwd as ref_flash_kernel_bwd  # noqa: E402,E501
import repro.kernels.flash_attention.ops as ref_flash_ops  # noqa: E402
import repro.kernels.flash_attention.ref as ref_flash_ref  # noqa: E402
import repro.kernels.ssd_scan.kernel as ref_ssd_kernel  # noqa: E402
import repro.kernels.ssd_scan.ops as ref_ssd_ops  # noqa: E402
import repro.kernels.ssd_scan.ref as ref_ssd_ref  # noqa: E402
import repro.traffic.stream as ref_traffic_stream  # noqa: E402
import repro.workloads as ref_workloads  # noqa: E402

__all__ = ["jax", "jnp", "np", "ref_analysis_entrypoints",
           "ref_analysis_imports", "ref_analysis_rules", "ref_batch", "ref_sim", "ref_experiments",
           "ref_registry", "ref_ops", "ref_ref", "ref_workloads",
           "ref_flash_kernel", "ref_flash_kernel_bwd", "ref_flash_ops", "ref_flash_ref",
           "ref_ssd_kernel", "ref_ssd_ops", "ref_ssd_ref", "ref_machine",
           "ref_tla", "ref_tick_kernel", "ref_tick_ops", "ref_tick_ref",
           "ref_coord_service", "ref_coord_stress", "ref_lock_table",
           "ref_i32pair", "ref_traffic_stream",
           "ref_lowered_batched", "assert_bitwise", "to_port", "OUT_NAMES"]

OUT_NAMES = ("done", "lat", "lat_n", "t_end", "nreacq", "npass")


def to_port(obj):
    """A reference spec object (Workload, Phase, Mixed, Arrivals,
    CostModel, ... — frozen dataclasses) rebuilt from the port's classes
    of the same name, field for field."""
    import dataclasses
    import importlib
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        mod = obj.__class__.__module__
        assert mod.startswith("repro."), mod
        cls = getattr(importlib.import_module(
            "repro_torch." + mod[len("repro."):]), obj.__class__.__name__)
        return cls(**{f.name: to_port(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(to_port(o) for o in obj)
    return obj


def ref_lowered_batched(workloads, n_events, seeds=None):
    """Lower ``workloads`` (reference specs of one shape bucket) with the
    reference and stack the operands on a leading replica axis, padding
    phases to the bucket maximum. ``seeds`` overrides the per-replica
    seeds. Returns a reference ``WorkloadOperands`` of numpy arrays."""
    lws = [ref_workloads.lower(w, n_events) for w in workloads]
    pmax = max(lw.operands.n_phases for lw in lws)
    padded = [ref_workloads.pad_phases(lw.operands, pmax) for lw in lws]
    stacked = ref_workloads.WorkloadOperands(
        *(np.stack([np.asarray(getattr(o, f)) for o in padded])
          for f in ref_workloads.WorkloadOperands._fields))
    if seeds is not None:
        stacked = stacked._replace(seed=np.asarray(seeds, np.int32))
    return stacked


def assert_bitwise(ref_arrays, port_arrays, names=None):
    """Tolerance zero: every pair equal element for element, dtype and
    shape included. ``port_arrays`` may hold torch tensors."""
    assert len(ref_arrays) == len(port_arrays)
    names = names or [str(i) for i in range(len(ref_arrays))]
    for n, r, p in zip(names, ref_arrays, port_arrays):
        r = np.asarray(r)
        p = p.cpu().numpy() if hasattr(p, "cpu") else np.asarray(p)
        assert r.dtype == p.dtype, (n, r.dtype, p.dtype)
        assert r.shape == p.shape, (n, r.shape, p.shape)
        assert np.array_equal(r, p), (
            n, int((r != p).sum()), "elements differ")
