"""Rule registry + the port's rule families.

A *rule* inspects the port's entrypoints (``repro_torch.analysis.
entrypoints``: launch shapes, nothing traced or launched) or a
package-wide invariant, and emits structured :class:`Finding`\\ s. Rules
come in two scopes:

  * ``entrypoint`` — run once per entrypoint;
  * ``global`` — run once per analysis over invariants that are not a
    property of any one launch (environment knobs, bucket signatures, the
    build key, the pairs contract, build flags, the docs).

A rule may also have a *card leg* (``card=``: what it checks on a CUDA
device). Its check is then called with ``device=`` too, and runs that leg
only when ``device`` is a CUDA device; the CPU legs always run.

Shipped families (rule ids are stable — the counterpart of a reference
rule keeps its id):

  ============ ======== ====================================================
  family       rules    catches
  ============ ======== ====================================================
  smem-        S001     a wrapper's shared-memory table drifted from its C
  consistency           function, or a plan above the block limit
  retrace-     R002     ``REPRO_BACKEND`` not followed when it is read
  hazards      R003     >1 operand signature per sweep bucket
  rebuild-     R004     a library key that misses the source, a header
  hazards               beside it, the flags or the ``nvcc`` version
  x64-         X001     a 64-bit array in the hi/lo pairs contract
  cleanliness
  kernel-      K001     a compiler flag that changes f32 results; a cost
  build                 scaling or arrival gap ``nvcc`` may contract into
                        an FMA
  docs         D001     a dotted ``repro_torch`` name in the docs that does
                        not resolve
  ============ ======== ====================================================

Adding a rule: write a check function returning a list of findings and
decorate it —

>>> from repro_torch.analysis.rules import RULES, rule
>>> @rule("T900", family="demo", severity="error",
...       summary="never fires (docs example)")
... def _demo(ep):
...     return []
>>> RULES["T900"].family
'demo'
>>> _ = RULES.pop("T900")      # keep the registry clean after the demo

``run_rules`` drives every registered rule over a list of entrypoints and
returns the combined findings (empty list == lint-clean).
"""
from __future__ import annotations

import importlib
import os
import re
import shutil
import tempfile
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Callable, Iterable

import numpy as np

from repro_torch.analysis.entrypoints import DEFAULT_TRACE_EVENTS

__all__ = ["Finding", "Rule", "RULES", "rule", "run_rules", "legs",
           "on_card", "smem_sizes", "check_smem_consistency",
           "check_env_resolution", "bucket_signature",
           "check_bucket_signatures", "check_build_key",
           "check_pairs_contract", "check_kernel_build",
           "check_doc_references", "kernel_builds"]

#: the checkout's root (``src/repro_torch/analysis/rules.py`` -> root)
ROOT = Path(__file__).resolve().parents[3]


@dataclass(frozen=True)
class Finding:
    """One structured lint hit: what fired, where, and how to fix it."""
    rule: str            # stable id, e.g. "S001"
    family: str          # rule family, e.g. "smem-consistency"
    severity: str        # "error" | "warning"
    entrypoint: str      # entrypoint name (or "<global>")
    where: str           # the table, function or file:line at fault
    message: str
    hint: str = ""

    def format(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        tail = f"\n      hint: {self.hint}" if self.hint else ""
        return (f"{self.rule} ({self.family}, {self.severity}) "
                f"{self.entrypoint}{loc}\n      {self.message}{tail}")


@dataclass(frozen=True)
class Rule:
    id: str
    family: str
    severity: str
    summary: str
    scope: str                       # "entrypoint" | "global"
    check: Callable = field(compare=False)
    card: str = ""                   # what the card leg checks; "" = none


RULES: dict[str, Rule] = {}


def rule(id: str, *, family: str, severity: str = "error",
         summary: str = "", scope: str = "entrypoint", card: str = ""):
    """Register a check function under a stable rule id.

    ``scope="entrypoint"`` checks are called as ``check(ep)`` per
    entrypoint; ``scope="global"`` checks are called once as
    ``check(entrypoints)``. A rule with a card leg (``card=``) is called
    with ``device=`` as well. Both return an iterable of findings (the
    decorator stamps ``rule``/``family``/``severity`` onto any finding the
    check left blank, so checks can just describe the defect).
    """
    if scope not in ("entrypoint", "global"):
        raise ValueError(f"scope must be 'entrypoint' or 'global', "
                         f"got {scope!r}")

    def deco(fn):
        if id in RULES:
            raise ValueError(f"rule {id!r} already registered")
        RULES[id] = Rule(id, family, severity, summary, scope, fn, card)
        return fn
    return deco


def _stamp(r: Rule, findings: Iterable[Finding]) -> list[Finding]:
    out = []
    for f in findings:
        if not f.rule:
            f = replace(f, rule=r.id, family=r.family, severity=r.severity)
        out.append(f)
    return out


def run_rules(entrypoints, rules: Iterable[str] | None = None,
              device=None) -> list[Finding]:
    """Run the selected rules (default: all) over the entrypoints; card
    legs run when ``device`` is a CUDA device.

    Returns every finding, entrypoint-scoped rules first (in entrypoint
    order), then global rules. An empty list means lint-clean.
    """
    eps = list(entrypoints)
    active = [RULES[i] for i in rules] if rules is not None \
        else list(RULES.values())

    def call(r, arg):
        return _stamp(r, r.check(arg, device=device) if r.card
                      else r.check(arg))
    findings: list[Finding] = []
    for r in active:
        if r.scope == "entrypoint":
            for ep in eps:
                findings += call(r, ep)
    for r in active:
        if r.scope == "global":
            findings += call(r, eps)
    return findings


def on_card(device) -> bool:
    """True when ``device`` names a CUDA device: the card legs run."""
    if device is None:
        return False
    import torch
    return torch.device(device).type == "cuda"


def legs(rules: Iterable[str] | None = None, device=None) -> dict:
    """Which legs a run with ``rules`` (default: all) on ``device`` runs:
    ``{"cpu": [rule ids], "card": [rule ids]}``."""
    ids = sorted(rules) if rules is not None else sorted(RULES)
    return {"cpu": ids,
            "card": [i for i in ids if RULES[i].card and on_card(device)]}


def _f(ep_name, where, message, hint="") -> Finding:
    return Finding("", "", "", ep_name, where, message, hint)


# ---------------------------------------------------------------------------
# smem-consistency: each wrapper prices its kernel's dynamic shared memory in
# Python (to plan and to refuse a launch); the C library computes the bytes
# it launches with. Drift means a plan for a kernel that no longer exists.


def smem_sizes(ep, device=None) -> dict:
    """One entrypoint's dynamic shared memory by the Python wrapper and,
    when ``device`` is a CUDA device, by the library's C function:
    ``{"python": (bytes, ...), "c": (bytes, ...) or None}``. K1 gives one
    replica's region and one block of the plan's ``W`` regions."""
    d, kind = ep.dims, ep.kind
    if kind.startswith("k1"):
        from repro_torch.kernels.event_loop import kernel as mod
        args = (d["T"], d["N"], d["K"], d["P"], d["R"])
        py = (mod.smem_bytes(d["alg"], *args), ep.plan.total_bytes)

        def c(lib):
            a = mod.ALGS.index(d["alg"])
            return (lib.event_loop_smem_bytes(a, *args),
                    lib.event_loop_block_bytes(a, *args, ep.plan.warps))
    elif kind == "k2":
        from repro_torch.kernels.alock_tick import kernel as mod
        args = (d["T"], d["chain_warps"], d["stage_steps"], d["stages"])
        py = (mod.layout_bytes(*args),)

        def c(lib):
            return (lib.alock_tick_smem_bytes(*args),)
    elif kind in ("k3", "k4", "k5"):
        from repro_torch.kernels.flash_attention import kernel as fwd
        from repro_torch.kernels.flash_attention import kernel_bwd as bwd
        mod = fwd if kind == "k3" else bwd
        hd = d["hd"]
        py = ((fwd.smem_bytes(hd),) if kind == "k3"
              else (bwd.smem_bytes(hd)["dq" if kind == "k4" else "dkv"],))
        fn = {"k3": "flash_fwd_smem_bytes", "k4": "flash_dq_smem_bytes",
              "k5": "flash_dkv_smem_bytes"}[kind]

        def c(lib):
            return (getattr(lib, fn)(hd),)
    elif kind == "k6":
        from repro_torch.kernels.ssd_scan import kernel as mod
        args = (d["L"], d["P"], d["N"], d["hb"])
        py = (mod.smem_bytes(*args),)

        def c(lib):
            return (lib.ssd_smem_bytes(*args),)
    else:
        raise ValueError(f"unknown entrypoint kind {kind!r}")
    return {"python": py,
            "c": c(mod.LIB.load()) if on_card(device) else None}


def check_smem_consistency(ep, device=None, table_fn=None) -> list[Finding]:
    """S001 core. CPU: K1's ``smem_table`` sums to ``smem_bytes`` and its
    plan's block is ``W`` rounded regions; K2's regions follow each other
    inside ``layout_bytes``; every size fits ``_build.SMEM_LIMIT``. Card:
    the C function returns the Python numbers, and the limit is the card's
    ``cudaDevAttrMaxSharedMemoryPerBlockOptin``. ``table_fn`` injects
    another K1 or K2 table (the fixture corpus passes a corrupted one)."""
    from repro_torch.kernels._build import SMEM_LIMIT
    d, out = ep.dims, []
    if ep.kind.startswith("k1"):
        from repro_torch.kernels.event_loop import smem_plan
        args = (d["alg"], d["T"], d["N"], d["K"], d["P"], d["R"])
        table = (table_fn or smem_plan.smem_table)(*args)
        want = smem_plan.smem_bytes(*args)
        if sum(table.values()) != want:
            out.append(_f(ep.name, "smem_plan.smem_table",
                          f"the table sums to {sum(table.values()):,} B but "
                          f"smem_bytes prices one region at {want:,} B",
                          "keep smem_table row for row with the .cu's "
                          "carve-up and event_loop_smem_bytes"))
        plan = ep.plan
        if plan.total_bytes != plan.warps * smem_plan.region_bytes(want):
            out.append(_f(ep.name, "smem_plan.plan_smem",
                          f"the plan's block is {plan.total_bytes:,} B, not "
                          f"{plan.warps} regions of {want:,} B rounded up",
                          "plan_smem must price W x region_bytes"))
    elif ep.kind == "k2":
        from repro_torch.kernels.alock_tick import kernel as tk
        args = (d["T"], d["chain_warps"], d["stage_steps"], d["stages"])
        end = 0
        for name, (off, size) in (table_fn or tk.smem_table)(*args).items():
            if off < end:
                out.append(_f(ep.name, "alock_tick.kernel.smem_table",
                              f"`{name}` starts at {off:,} B, inside the "
                              f"region before it (which ends at {end:,} B)",
                              "regions follow the .cu's Layout in order"))
            end = off + size
        if -(-end // 16) * 16 != tk.layout_bytes(*args):
            out.append(_f(ep.name, "alock_tick.kernel.smem_table",
                          f"the table ends at {end:,} B but layout_bytes "
                          f"is {tk.layout_bytes(*args):,} B",
                          "keep smem_table and layout_bytes in lockstep "
                          "with alock_tick_smem_bytes"))
    sizes = smem_sizes(ep, device)
    if max(sizes["python"]) > SMEM_LIMIT:
        out.append(_f(ep.name, "_build.SMEM_LIMIT",
                      f"{max(sizes['python']):,} B of shared memory, above "
                      f"the {SMEM_LIMIT:,} B a block may use",
                      "the planner must shrink the launch to fit"))
    if on_card(device):
        import torch
        if sizes["c"] != sizes["python"]:
            out.append(_f(ep.name, f"{ep.kind} C library",
                          f"the C function gives {sizes['c']} B, the Python "
                          f"wrapper {sizes['python']} B",
                          "update the wrapper's table to the .cu's"))
        optin = torch.cuda.get_device_properties(
            torch.device(device)).shared_memory_per_block_optin
        if optin != SMEM_LIMIT:
            out.append(_f(ep.name, "_build.SMEM_LIMIT",
                          f"the planners plan against {SMEM_LIMIT:,} B but "
                          f"{torch.cuda.get_device_name(device)} lets a "
                          f"block opt in to {optin:,} B",
                          "set _build.SMEM_LIMIT to the card's opt-in "
                          "limit"))
    return out


@rule("S001", family="smem-consistency",
      summary="Python shared-memory tables must match the kernels' C "
              "functions and fit the block limit",
      card="C function == Python for every launch shape; limit == the "
           "card's opt-in")
def _smem_drift(ep, device=None):
    return check_smem_consistency(ep, device)


# ---------------------------------------------------------------------------
# retrace-hazards. The port compiles nothing per shape, so the reference's
# hazards become: an environment knob that a run does not follow, and a
# sweep bucket whose replicas cannot stack into one launch.

#: the port's one environment knob and the values it takes
BACKEND_ENV = "REPRO_BACKEND"


def check_env_resolution(resolver=None) -> list[Finding]:
    """R002 core: ``REPRO_BACKEND`` must be read when the options are made
    (``ExecOptions.from_env``), not once and kept. Flips the variable
    through ``auto``, ``kernel`` and ``plain`` and asserts the resolver
    (``resolver()`` -> backend name) follows it; restores the variable."""
    from repro_torch.device import BACKENDS
    if resolver is None:
        from repro_torch.experiments.options import ExecOptions

        def resolver():
            return ExecOptions.from_env().backend
    findings = []
    old = os.environ.get(BACKEND_ENV)
    try:
        for env in BACKENDS:
            os.environ[BACKEND_ENV] = env
            got = resolver()
            if got != env:
                findings.append(_f(
                    "<global>", "ExecOptions.from_env",
                    f"{BACKEND_ENV}={env!r} resolved to {got!r} — the "
                    f"resolver does not follow the variable when it is "
                    f"called, so a run would take another engine than the "
                    f"one asked for",
                    "read the variable in ExecOptions.from_env at each "
                    "call (experiments/options.py)"))
    finally:
        if old is None:
            os.environ.pop(BACKEND_ENV, None)
        else:
            os.environ[BACKEND_ENV] = old
    return findings


@rule("R002", family="retrace-hazards", scope="global",
      summary="REPRO_BACKEND must be read when the options are made")
def _lazy_env(_eps):
    return check_env_resolution()


def bucket_signature(operands) -> tuple:
    """The abstract signature of one lowered replica: (field, shape,
    dtype) triples — what stacking a bucket's replicas sees after the
    static shape key. Two replicas in one sweep bucket with different
    signatures cannot stack into one launch as they are."""
    return tuple((f, tuple(np.shape(a)), str(np.asarray(a).dtype))
                 for f, a in zip(type(operands)._fields, operands))


def check_bucket_signatures(n_events: int = DEFAULT_TRACE_EVENTS,
                            scenarios: Iterable[str] | None = None,
                            lowered_by_bucket=None) -> list[Finding]:
    """R003 core: one operand signature per sweep bucket — **nothing is
    launched**. Mirrors ``batch.sweep``'s bucketing (shape key +
    pad_phases to the bucket max) for every registered simulator scenario
    and asserts each bucket collapses to exactly one signature: a second
    one is a bucket whose stacked operands get promoted, or refused by
    K1's wrapper, mid-sweep. ``lowered_by_bucket`` injects a pre-bucketed
    ``{bucket_name: [WorkloadOperands]}`` mapping instead (the fixture
    corpus uses this)."""
    if lowered_by_bucket is None:
        from repro_torch.analysis.entrypoints import \
            lowered_by_bucket as lowered
        lowered_by_bucket = lowered(scenarios, n_events)
    findings = []
    for bucket, ops in lowered_by_bucket.items():
        sigs = {bucket_signature(o) for o in ops}
        if len(sigs) > 1:
            findings.append(_f(
                "<global>", bucket,
                f"sweep bucket holds {len(sigs)} distinct operand "
                f"signatures across {len(ops)} replicas — stacked, they "
                f"promote to the widest dtype, or K1's wrapper refuses "
                f"them mid-sweep",
                "pad_phases/dtype-pin the lowered operands so every "
                "replica of a shape bucket shares one signature"))
    return findings


@rule("R003", family="retrace-hazards", scope="global",
      summary="one operand signature per sweep bucket")
def _bucket_sigs(_eps):
    return check_bucket_signatures()


# ---------------------------------------------------------------------------
# rebuild-hazards: a library is found by its name, so the name must change
# with everything that changes the machine code


def kernel_builds() -> list:
    """``(stem, source, flags, load)`` of every kernel library the port
    builds, as its wrapper declares it (``_build.declared()``)."""
    from repro_torch.kernels import _build
    return [(lib.stem, lib.source, lib.flags, lib.load)
            for lib in _build.declared().values()]


def check_build_key(key_fn=None, device=None) -> list[Finding]:
    """R004 core. CPU: on a copy of ``csrc/`` in a temporary directory,
    the key (``key_fn(source, flags, nvcc_version)``, default
    ``_build.build_key``) is the same for the same inputs and changes with
    the ``.cu``, a ``.cuh`` beside it, the flags and the ``nvcc`` version
    text — ``nvcc`` is not run. Card: every library the wrappers load
    carries the key of this process's ``nvcc``."""
    from repro_torch.kernels import _build
    key_fn = key_fn or _build.build_key
    findings = []
    flags = _build.FLAGS
    with tempfile.TemporaryDirectory() as tmp:
        csrc = Path(tmp) / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        src = csrc / "event_loop.cu"
        header = sorted(csrc.glob("*.cuh"))[0]

        def key(*, fl=flags, version="nvcc A"):
            return key_fn(src, fl, version)

        def edited(path):
            text = path.read_bytes()
            path.write_bytes(text + b"\n// edited\n")
            try:
                return key()
            finally:
                path.write_bytes(text)
        base = key()
        if key() != base:
            findings.append(_f("<global>", "_build.build_key",
                               "the key differs for the same inputs",
                               "hash only the source, headers, flags and "
                               "the nvcc version"))
        for what, k in (("the .cu source", edited(src)),
                        (f"a header beside it ({header.name})",
                         edited(header)),
                        ("the flags", key(fl=flags + ("-lineinfo",))),
                        ("the nvcc version", key(version="nvcc B"))):
            if k == base:
                findings.append(_f(
                    "<global>", "_build.build_key",
                    f"the library key does not change with {what}: a "
                    f"library built before the change would be loaded",
                    "hash the .cu, every .cuh beside it, the flags and "
                    "`nvcc --version`'s output into the key"))
    if on_card(device):
        live = _build.nvcc_version()
        for stem, source, fl, load in kernel_builds():
            load()
            got = _build.loaded_path(stem).name
            want = f"lib{stem}_{key_fn(source, fl, live)}.so"
            if got != want:
                findings.append(_f(
                    "<global>", f"_build.load({stem})",
                    f"the loaded library is {got}, but this nvcc's key "
                    f"names {want}",
                    "load through _build.library_path"))
    return findings


@rule("R004", family="rebuild-hazards", scope="global",
      summary="the library key covers source, headers, flags and nvcc",
      card="every loaded library carries the live nvcc's key")
def _build_key(_eps, device=None):
    return check_build_key(device=device)


# ---------------------------------------------------------------------------
# x64-cleanliness: the hi/lo pairs contract holds int32 arrays only

#: events of the pairs contract's two tiny cases (alock, 2 nodes x 2
#: threads, 8 locks, one replica; closed, and open with 16 request slots)
PAIRS_EVENTS = 256


def _pairs_cases(device):
    from repro_torch.core.sim import topology
    from repro_torch.workloads import (Arrivals, Workload,
                                       operands_from_numpy, lower)
    base = Workload("alock", 2, 2, 8, locality=0.8, seed=5)
    tn, ln, _ = topology("alock", 2, 2, 8)
    for name, w in (("closed", base), ("open", base.replace(
            arrivals=Arrivals(rate_per_us=4.0, max_requests=16,
                              queue_cap=4)))):
        ops = lower(w, PAIRS_EVENTS).operands
        wl = operands_from_numpy(tuple(np.asarray(a)[None] for a in ops),
                                 device)
        yield name, wl, tn, ln


def _flat(out):
    return [a for o in out for a in (o if isinstance(o, tuple) else (o,))]


def check_pairs_contract(device=None, pairs_fn=None,
                         times_fn=None) -> list[Finding]:
    """X001 core: ``run_events_pairs`` (``pairs_fn``) and
    ``traffic.arrival_times_pairs`` (``times_fn``) return int32 arrays
    only, on one tiny closed and one tiny open case: on the CPU by the
    plain engine, and on a CUDA ``device`` by the kernel path."""
    import torch
    from repro_torch.kernels.event_loop.ops import (precompute_plan,
                                                    run_events_pairs)
    from repro_torch.traffic import arrival_times_pairs
    pairs_fn = pairs_fn or run_events_pairs
    times_fn = times_fn or arrival_times_pairs
    findings = []
    for dev in ["cpu"] + ([device] if on_card(device) else []):
        for name, wl, tn, ln in _pairs_cases(dev):
            outs = {"run_events_pairs": pairs_fn(
                "alock", 4, 2, 8, PAIRS_EVENTS, wl, tn, ln, device=dev)}
            if name == "open":
                plan = precompute_plan(wl, PAIRS_EVENTS, device=dev)
                outs["arrival_times_pairs"] = times_fn(plan.gaps)
            for fn, out in outs.items():
                arrays = _flat(out if isinstance(out, tuple) else (out,))
                for i, a in enumerate(arrays):
                    if a.dtype != torch.int32:
                        findings.append(_f(
                            f"pairs:{name}@{torch.device(dev).type}",
                            f"{fn} output {i}",
                            f"{a.dtype} array {tuple(a.shape)} in the hi/lo "
                            f"pairs contract, which returns int32 only",
                            "split the int64 value with i32pair.unpack"))
    return findings


@rule("X001", family="x64-cleanliness", scope="global",
      summary="the hi/lo pairs contract returns int32 arrays only",
      card="the kernel path's pairs")
def _pairs_int32(_eps, device=None):
    return check_pairs_contract(device)


# ---------------------------------------------------------------------------
# kernel-build: the bitwise contract and the float tolerances assume IEEE
# f32 arithmetic where the source asks for it

#: nvcc options that change f32 results (leading dashes stripped)
FAST_MATH_FLAGS = frozenset({"use_fast_math", "ftz=true", "prec-div=false",
                             "prec-sqrt=false"})
_RINTF = re.compile(r"\brintf\s*\(")


def check_kernel_build(flag_sets=None, sources=None) -> list[Finding]:
    """K001 core: no library's flags (``flag_sets``: name -> flags,
    default every ``kernel_builds()`` entry and ``_build.FLAGS``) carry a
    fast-math option, and every ``rintf(`` of ``csrc/event_loop.cu`` and
    ``csrc/arrival_plan.cu`` (``sources``: name -> text) rounds a
    ``__fmul_rn(`` product — nvcc contracts ``a * b`` into an FMA by
    default, and the cost scaling and the arrival gaps must round the
    product, as the reference's f32 multiply does."""
    from repro_torch.kernels import _build
    if flag_sets is None:
        flag_sets = {"_build.FLAGS": _build.FLAGS}
        flag_sets.update({stem: fl for stem, _, fl, _ in kernel_builds()})
    if sources is None:
        sources = {f"csrc/{name}": (_build.CSRC / name).read_text()
                   for name in ("event_loop.cu", "arrival_plan.cu")}
    findings = []
    for name, flags in flag_sets.items():
        for fl in flags:
            if fl.lstrip("-") in FAST_MATH_FLAGS:
                findings.append(_f(
                    "<global>", name,
                    f"`{fl}` changes f32 results (flush to zero, "
                    f"approximate division, square root or intrinsics) "
                    f"that the bitwise contract and the tolerances rely on",
                    "drop the flag; use an intrinsic where speed matters "
                    "and the tolerance allows it"))
    for name, text in sources.items():
        for m in _RINTF.finditer(text):
            if not text[m.end():].lstrip().startswith("__fmul_rn("):
                line = text.count("\n", 0, m.start()) + 1
                findings.append(_f(
                    "<global>", f"{name}:{line}",
                    "rintf( of an expression that is not a __fmul_rn( "
                    "product: nvcc may contract the scaling into an FMA "
                    "and round it differently from the reference",
                    "write rintf(__fmul_rn(a, b))"))
    return findings


@rule("K001", family="kernel-build", scope="global",
      summary="no fast-math flags; the cost scaling rounds its product")
def _kernel_build(_eps):
    return check_kernel_build()


# ---------------------------------------------------------------------------
# docs: every dotted repro_torch name the docs give resolves

#: the docs whose dotted ``repro_torch.*`` names must resolve
DOC_FILES = ("README.md", "docs/port.md")
_DOTTED = re.compile(r"\brepro_torch(?:\.[A-Za-z_]\w*)+")


def _resolves(dotted: str) -> bool:
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        mod = ".".join(parts[:i])
        try:
            obj = importlib.import_module(mod)
        except ModuleNotFoundError as e:
            if e.name != mod:
                return False
            continue
        for p in parts[i:]:
            if not hasattr(obj, p):
                return False
            obj = getattr(obj, p)
        return True
    return False


def check_doc_references(texts=None) -> list[Finding]:
    """D001 core: every dotted ``repro_torch.*`` name in ``texts``
    (name -> text; default the ``DOC_FILES`` of the checkout that exist)
    resolves to a module or attribute, importing only ``repro_torch``."""
    if texts is None:
        texts = {f: (ROOT / f).read_text(encoding="utf-8")
                 for f in DOC_FILES if (ROOT / f).exists()}
    findings = []
    for name, text in texts.items():
        seen = set()
        for m in _DOTTED.finditer(text):
            dotted = m.group(0)
            if dotted in seen:
                continue
            seen.add(dotted)
            if _resolves(dotted):
                continue
            line = text.count("\n", 0, m.start()) + 1
            findings.append(_f(
                "<global>", f"{name}:{line}",
                f"`{dotted}` resolves to no module or attribute",
                "fix the name, or the code it names"))
    return findings


@rule("D001", family="docs", scope="global",
      summary="dotted repro_torch names in the docs resolve")
def _doc_refs(_eps):
    return check_doc_references()
