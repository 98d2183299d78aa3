"""Static lint of the port: check, don't launch.

``repro_torch.analysis`` is the counterpart of the reference's
``repro.analysis``. The reference traces jaxprs; the port has none, so its
rules read the port's own hazards from launch shapes (``entrypoints``:
every sweep bucket of the scenario registry through K1, and K2-K6 at their
paths' shapes), from its tables, its build key, its flags and its docs.
Six rule families ship (``rules``):

  * **smem-consistency** (S001) — each wrapper's Python shared-memory
    table must match its kernel's C function (on a CUDA device) and fit
    the block limit;
  * **retrace-hazards** (R002, R003) — ``REPRO_BACKEND`` followed when it
    is read; one operand signature per sweep bucket;
  * **rebuild-hazards** (R004) — a library's key covers its source, the
    headers beside it, its flags and the ``nvcc`` version;
  * **x64-cleanliness** (X001) — the hi/lo pairs contract returns int32
    arrays only;
  * **kernel-build** (K001) — no flag that changes f32 results, and the
    cost scaling rounds a ``__fmul_rn`` product;
  * **docs** (D001) — every dotted ``repro_torch`` name in the docs
    resolves.

The CPU legs need no device; the card legs run only when the caller names
a CUDA device. CLI: ``python -m repro_torch.analysis --device cpu``
(report), ``--strict`` (exit 1 on any finding), ``--selftest`` (run the
known-bad fixture corpus), ``--imports`` (import-graph gate).

>>> from repro_torch.analysis import Finding, RULES
>>> sorted(RULES)
['D001', 'K001', 'R002', 'R003', 'R004', 'S001', 'X001']
>>> print(Finding("S001", "smem-consistency", "error",
...               "k3:hd=128", "k3 C library",
...               "the C function gives (1,) B").format())
S001 (smem-consistency, error) k3:hd=128 [k3 C library]
      the C function gives (1,) B
"""
from repro_torch.analysis.entrypoints import (Entrypoint, collect_buckets,
                                              collect_entrypoints)
from repro_torch.analysis.rules import (RULES, Finding, Rule,
                                        bucket_signature,
                                        check_bucket_signatures,
                                        check_build_key,
                                        check_doc_references,
                                        check_env_resolution,
                                        check_kernel_build,
                                        check_pairs_contract,
                                        check_smem_consistency, legs, rule,
                                        run_rules, smem_sizes)

__all__ = [
    "Entrypoint", "collect_buckets", "collect_entrypoints",
    "Finding", "Rule", "RULES", "rule", "run_rules", "legs", "smem_sizes",
    "bucket_signature", "check_bucket_signatures", "check_build_key",
    "check_doc_references", "check_env_resolution", "check_kernel_build",
    "check_pairs_contract", "check_smem_consistency",
]
