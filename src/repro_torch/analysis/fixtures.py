"""Known-bad fixture corpus: one minimal offender per rule.

The analyzer's own regression suite. Each fixture is the *smallest*
injected input that commits exactly the hazard a rule exists to catch;
``run_corpus`` runs every rule against its offender and returns the
findings per family. A family whose offender produces **zero** findings
means the rule has gone blind — the ``--selftest`` CLI mode and
``tests/test_torch_analysis.py`` both fail on that. No fixture needs a
device, and none runs ``nvcc``.

Offenders:

  * ``corrupt_smem_table`` — K1's ``smem_table`` with the ``victim`` row
    grown, against a real registry bucket (S001);
  * ``corrupt_open_smem_table`` — the open-loop drift: ``curreq``, a row
    the table has only when the bucket carries ``R > 0`` request slots,
    grown, against a real open-loop bucket (S001);
  * ``lazy_resolver`` — reads ``REPRO_BACKEND`` once and keeps it (R002);
  * ``bucket_offender`` — one sweep bucket holding two operand signatures:
    the second replica's ``locality`` leaked float64 (R003);
  * ``headerless_key`` — a library key that hashes the ``.cu`` but not the
    headers beside it (R004);
  * ``leaky_pairs`` — ``run_events_pairs`` with one output widened to
    int64 (X001);
  * ``FAST_MATH_FLAGS_OFFENDER`` and ``CONTRACTED_SOURCE`` — a flags tuple
    with ``--use_fast_math``, and a cost scaling ``rintf((float)c * m)``
    that nvcc may contract into an FMA (K001);
  * ``BAD_DOC`` — a text naming ``repro_torch.core.no_such_name`` (D001).

The reference's ``mosaic_offender`` and ``rack_offender`` trace a Pallas
kernel Mosaic would reject; the port has no Mosaic and no counterpart.
"""
from __future__ import annotations

import functools
import hashlib
import os

import numpy as np

from repro_torch.analysis.rules import (RULES, _stamp,
                                        check_bucket_signatures,
                                        check_build_key,
                                        check_doc_references,
                                        check_env_resolution,
                                        check_kernel_build,
                                        check_pairs_contract,
                                        check_smem_consistency)

__all__ = ["run_corpus", "corrupt_smem_table", "corrupt_open_smem_table",
           "lazy_resolver", "bucket_offender", "headerless_key",
           "leaky_pairs", "FAST_MATH_FLAGS_OFFENDER", "CONTRACTED_SOURCE",
           "BAD_DOC"]

#: a library's flags with the option that changes f32 results
FAST_MATH_FLAGS_OFFENDER = ("-O3", "--use_fast_math")
#: the cost scaling as nvcc may contract it (``event_loop.cu``'s is
#: ``rintf(__fmul_rn((float)c, m))``)
CONTRACTED_SOURCE = ("__device__ int scale(int c, float m) {\n"
                     "  return (int)rintf((float)c * m);\n}\n")
#: a doc naming what does not exist
BAD_DOC = "Call `repro_torch.core.no_such_name` to run a sweep.\n"


def corrupt_smem_table(*args) -> dict:
    """``smem_plan.smem_table`` with ``victim`` silently grown — the
    planner now prices a buffer the kernel does not allocate."""
    from repro_torch.kernels.event_loop.smem_plan import smem_table
    table = dict(smem_table(*args))
    table["victim"] += 2
    return table


def corrupt_open_smem_table(*args) -> dict:
    """The open-loop drift: ``curreq`` — the per-thread current-request
    row the open loop adds — grew by a thread. Only meaningful for an
    ``R > 0`` bucket (the closed-loop table has no such row)."""
    from repro_torch.kernels.event_loop.smem_plan import smem_table
    table = dict(smem_table(*args))
    table["curreq"] += 4
    return table


@functools.cache
def lazy_resolver() -> str:
    """Reads ``REPRO_BACKEND`` at its first call and keeps the value: a
    change of the variable afterwards is never seen."""
    return os.environ.get("REPRO_BACKEND", "auto")


def bucket_offender() -> dict:
    """One sweep bucket, two operand signatures: replica 2's locality
    leaked float64 (e.g. an un-pinned ``np.asarray``)."""
    from repro_torch.workloads import Workload, lower
    ops = lower(Workload("alock", 2, 2, 8, locality=0.9), 512).operands
    drifted = ops._replace(locality=np.asarray(ops.locality, np.float64))
    return {"corpus:('alock', 4, 2, 8, 512, 0)": [ops, drifted]}


def headerless_key(source, flags, nvcc_version: str) -> str:
    """A library key that leaves out the ``.cuh`` headers: an edit to a
    header would load the library built before it."""
    text = source.read_bytes() + " ".join(flags).encode() \
        + nvcc_version.encode()
    return hashlib.sha256(text).hexdigest()[:16]


def leaky_pairs(*args, **kw):
    """``run_events_pairs`` whose ``lat_n`` comes back as int64."""
    from repro_torch.kernels.event_loop.ops import run_events_pairs
    out = list(run_events_pairs(*args, **kw))
    out[2] = out[2].long()
    return tuple(out)


def _k1_entrypoints() -> tuple:
    """A real closed (node-churn) and open-loop (burst-storm) bucket."""
    from repro_torch.analysis.entrypoints import collect_entrypoints
    eps = collect_entrypoints(["node-churn", "burst-storm"], n_events=256)
    closed = next(ep for ep in eps if ep.kind == "k1-closed"
                  and ep.dims["alg"] in ("alock", "hlock", "alock-rw"))
    opened = next(ep for ep in eps if ep.kind == "k1-open")
    return closed, opened


def run_corpus() -> dict:
    """Run each rule against its known-bad offender.

    Returns ``{family: [Finding, ...]}`` — every list must be non-empty
    for the analyzer to be considered alive (``--selftest`` gates on it).
    """
    closed, opened = _k1_entrypoints()
    smem = _stamp(RULES["S001"], check_smem_consistency(
        closed, table_fn=corrupt_smem_table))
    smem += _stamp(RULES["S001"], check_smem_consistency(
        opened, table_fn=corrupt_open_smem_table))
    retrace = _stamp(RULES["R002"], check_env_resolution(lazy_resolver))
    retrace += _stamp(RULES["R003"], check_bucket_signatures(
        lowered_by_bucket=bucket_offender()))
    return {
        "smem-consistency": smem,
        "retrace-hazards": retrace,
        "rebuild-hazards": _stamp(RULES["R004"], check_build_key(
            key_fn=headerless_key)),
        "x64-cleanliness": _stamp(RULES["X001"], check_pairs_contract(
            pairs_fn=leaky_pairs)),
        "kernel-build": _stamp(RULES["K001"], check_kernel_build(
            flag_sets={"offender": FAST_MATH_FLAGS_OFFENDER},
            sources={"offender.cu": CONTRACTED_SOURCE})),
        "docs": _stamp(RULES["D001"], check_doc_references(
            texts={"offender.md": BAD_DOC})),
    }
