"""The port's lint, ``repro_torch.analysis``, against the reference's.

The import-graph walker over ``src/repro`` and ``Finding.format`` equal the
reference's (``repro.analysis``); ``bucket_signature`` over the port's
lowering equals the reference's over its own, bucket for bucket, for every
registry scenario. Every rule is clean on the tree (its CPU legs) and
fires on its known-bad fixture; the card legs' logic runs here against
fake libraries, the real ones run in ``chip_smoke.py``'s ``analysis``
phase. The CLI is driven through ``main(argv)`` in process. Pure Python:
no device, no ``nvcc``, no subprocess, nothing of the reference traced.
"""
import shutil
from pathlib import Path

import pytest

import torch_ref as R
from repro_torch.analysis import (RULES, Finding, bucket_signature,
                                  check_build_key, check_env_resolution,
                                  check_smem_consistency, collect_buckets,
                                  collect_entrypoints, legs, run_rules,
                                  smem_sizes)
from repro_torch.analysis import imports as gate
from repro_torch.analysis import rules
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.fixtures import run_corpus
from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
EVENTS = 256


@pytest.fixture(scope="module")
def entrypoints():
    return collect_entrypoints(n_events=EVENTS)


@pytest.fixture(scope="module")
def corpus():
    return run_corpus()


# -- held against the reference ----------------------------------------------

def test_build_graph_equals_reference():
    want = R.ref_analysis_imports.build_graph()
    got = gate.build_graph(ROOT / "src" / "repro", package="repro")
    assert got.modules == want.modules
    assert got.edges == want.edges
    assert got.roots() == want.roots()
    assert got.unreachable() == want.unreachable()
    # the same quarantine, re-prefixed
    assert [p.replace("repro_torch.", "repro.") for p in gate.QUARANTINED] \
        == list(R.ref_analysis_imports.QUARANTINED)


@pytest.mark.parametrize("fields", [
    ("S001", "smem-consistency", "error", "k1-open:x", "smem_plan",
     "the table drifted", "fix it"),
    ("D001", "docs", "warning", "<global>", "", "no such name", ""),
], ids=["where-hint", "bare"])
def test_finding_format_equals_reference(fields):
    assert Finding(*fields).format() \
        == R.ref_analysis_rules.Finding(*fields).format()


def test_bucket_signatures_equal_reference():
    got = collect_buckets(n_events=EVENTS)
    want = R.ref_analysis_entrypoints.collect_buckets(n_events=EVENTS)
    assert list(got) == list(want) and len(got) == 11
    for key, (wl, meta) in got.items():
        ref_wl, ref_meta = want[key]
        assert meta == ref_meta, key
        assert bucket_signature(wl) \
            == R.ref_analysis_rules.bucket_signature(ref_wl), key


# -- the imports gate ---------------------------------------------------------

def test_imports_gate_clean_on_tree():
    quarantined, unexpected, stale, forbidden = gate.classify()
    assert (unexpected, stale, forbidden) == ([], [], [])
    # each parked tree keeps its entry module unreachable; the lint reads
    # the kernel wrappers beside them
    assert sorted(quarantined) == [
        "repro_torch.core.tla", "repro_torch.kernels.alock_tick.ops",
        "repro_torch.kernels.flash_attention.ops",
        "repro_torch.kernels.ssd_scan.ops"]
    assert {gate._covering(m) for m in quarantined} == set(gate.QUARANTINED)
    text, rc = gate.report()
    assert rc == 0 and text.endswith("imports gate: clean.")


def _spoil(src: Path, how: str) -> None:
    if how == "unexpected":
        (src / "orphan.py").write_text("X = 1\n")
    elif how == "stale":
        (src / "core" / "tla.py").unlink()
    else:
        with open(src / "workloads" / "spec.py", "a") as f:
            f.write("\n\ndef _late():\n    import jax.numpy\n"
                    "    return jax.numpy\n")


@pytest.mark.parametrize("how", ["unexpected", "stale", "forbidden"])
def test_imports_gate_fails_on_a_spoiled_tree(tmp_path, how):
    src = tmp_path / "src" / "repro_torch"
    shutil.copytree(ROOT / "src" / "repro_torch", src,
                    ignore=shutil.ignore_patterns("__pycache__"))
    _spoil(src, how)
    quarantined, unexpected, stale, forbidden = gate.classify(src)
    assert {"unexpected": unexpected == ["repro_torch.orphan"],
            "stale": stale == ["repro_torch.core.tla"],
            "forbidden": [(p.name, m) for p, _, m in forbidden]
            == [("spec.py", "jax.numpy")]}[how]
    text, rc = gate.report(src)
    assert rc == 1 and text.endswith("FAILED (see above).")


# -- every rule: clean on the tree, firing on its fixture ---------------------

@pytest.mark.parametrize("rule_id", sorted(RULES))
def test_rule_clean_on_tree(entrypoints, rule_id):
    assert run_rules(entrypoints, rules=[rule_id], device="cpu") == []


@pytest.mark.parametrize("family", sorted({r.family for r in
                                           RULES.values()}))
def test_rule_fires_on_fixture(corpus, family):
    assert sorted(corpus) == sorted({r.family for r in RULES.values()})
    assert corpus[family], f"{family} went blind"
    assert {RULES[f.rule].family for f in corpus[family]} == {family}


@pytest.mark.parametrize("value", [None, "plain"])
def test_env_resolution_restores_the_variable(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(rules.BACKEND_ENV, raising=False)
    else:
        monkeypatch.setenv(rules.BACKEND_ENV, value)
    assert check_env_resolution() == []
    assert rules.os.environ.get(rules.BACKEND_ENV) == value


# -- the card legs, against fake libraries ------------------------------------

class _FakeLib:
    """Every ``*_smem_bytes`` C function as the Python wrappers price it,
    ``drift`` bytes off."""

    def __init__(self, drift):
        from repro_torch.kernels.alock_tick import kernel as tk
        from repro_torch.kernels.event_loop import smem_plan as sp
        from repro_torch.kernels.flash_attention import kernel as fk
        from repro_torch.kernels.flash_attention import kernel_bwd as fkb
        from repro_torch.kernels.ssd_scan import kernel as sk
        algs = sp.ALGS

        def off(fn):
            return lambda *a: fn(*a) + drift
        self.event_loop_smem_bytes = off(
            lambda a, *d: sp.smem_bytes(algs[a], *d))
        self.event_loop_block_bytes = off(
            lambda a, T, N, K, P, R, W: W * sp.region_bytes(
                sp.smem_bytes(algs[a], T, N, K, P, R)))
        self.alock_tick_smem_bytes = off(tk.layout_bytes)
        self.flash_fwd_smem_bytes = off(fk.smem_bytes)
        self.flash_dq_smem_bytes = off(lambda hd: fkb.smem_bytes(hd)["dq"])
        self.flash_dkv_smem_bytes = off(
            lambda hd: fkb.smem_bytes(hd)["dkv"])
        self.ssd_smem_bytes = off(sk.smem_bytes)


@pytest.mark.parametrize("drift", [0, 16])
def test_smem_card_leg_against_fake_libraries(monkeypatch, entrypoints,
                                              drift):
    import torch
    from types import SimpleNamespace
    from repro_torch.kernels.alock_tick import kernel as tk
    from repro_torch.kernels.event_loop import kernel as el
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import kernel_bwd as fkb
    from repro_torch.kernels.ssd_scan import kernel as sk
    lib = _FakeLib(drift)
    for mod in (el, tk, fk, fkb, sk):
        monkeypatch.setattr(mod.LIB, "load", lambda: lib)
    monkeypatch.setattr(rules, "on_card", lambda device: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(
                            shared_memory_per_block_optin=_build.SMEM_LIMIT))
    for ep in entrypoints:
        sizes = smem_sizes(ep, "cuda")
        assert len(sizes["c"]) == len(sizes["python"])
        found = check_smem_consistency(ep, "cuda")
        assert len(found) == (1 if drift else 0), (ep.name, found)


@pytest.mark.parametrize("right", [True, False])
def test_build_key_card_leg_against_fake_loads(monkeypatch, right):
    monkeypatch.setattr(rules, "on_card", lambda device: True)
    monkeypatch.setattr(_build, "nvcc_version", lambda: "Cuda 12.8")
    builds = {stem: (src, fl) for stem, src, fl, _ in rules.kernel_builds()}

    def loaded(stem):
        src, fl = builds[stem]
        return _build.library_path(src, stem, fl if right else ())
    monkeypatch.setattr(_build, "loaded_path", loaded)
    monkeypatch.setattr(rules, "kernel_builds", lambda: [
        (s, src, fl, lambda: None) for s, (src, fl) in builds.items()])
    found = check_build_key(device="cuda")
    assert len(found) == (0 if right else len(builds))


def test_every_kernel_library_is_declared_once():
    """Each ``csrc/*.cu`` has one ``Library`` declaration, in the module
    that launches it, and ``kernel_builds()`` lists exactly those."""
    libs = _build.declared()
    stems = [stem for stem, *_ in rules.kernel_builds()]
    assert sorted(libs) == sorted(stems) == sorted(
        p.stem for p in _build.CSRC.glob("*.cu"))
    assert all(lib.source.exists() and lib.stem == stem
               for stem, lib in libs.items())
    wrappers = (ROOT / "src" / "repro_torch" / "kernels").rglob("*.py")
    assert sum(p.read_text().count("_build.Library(")
               for p in wrappers) == len(libs)


def test_a_second_declaration_of_a_library_raises():
    from repro_torch.kernels.event_loop import kernel as el
    with pytest.raises(ValueError, match="declared twice"):
        _build.Library("event_loop", {})
    assert _build.LIBRARIES["event_loop"] is el.LIB


def test_build_key_covers_the_nvcc_version(monkeypatch):
    src = _build.CSRC / "event_loop.cu"
    assert _build.build_key(src, _build.FLAGS, "release 12.8") \
        != _build.build_key(src, _build.FLAGS, "release 12.9")
    monkeypatch.setattr(_build, "nvcc_version", lambda: "release 12.8")
    path = _build.library_path(src, "event_loop", _build.FLAGS)
    assert path.parent == ROOT / "build"
    assert path.name == "libevent_loop_" + _build.build_key(
        src, _build.FLAGS, "release 12.8") + ".so"


def test_one_shared_memory_limit():
    from repro_torch.kernels.alock_tick import kernel as tk
    from repro_torch.kernels.event_loop import smem_plan as sp
    from repro_torch.kernels.ssd_scan import kernel as sk
    assert _build.SMEM_LIMIT == 227 * 1024
    assert sp.SMEM_LIMIT is tk.SMEM_LIMIT is sk.SMEM_LIMIT \
        is _build.SMEM_LIMIT


def test_card_legs_run_only_on_a_cuda_device():
    assert legs(device="cpu") == {"cpu": sorted(RULES), "card": []}
    assert legs(device="cuda")["card"] == ["R004", "S001", "X001"]


# -- the CLI ------------------------------------------------------------------

@pytest.mark.parametrize("argv, rc", [
    (["--strict", "--device", "cpu"], 0),
    (["--selftest"], 0),
    (["--imports"], 0),
    (["--rules", "S001,Z999", "--device", "cpu"], 2),
], ids=["strict", "selftest", "imports", "unknown-rule"])
def test_cli_modes(argv, rc, capsys):
    assert main(argv) == rc
    out = capsys.readouterr().out
    if argv[0] == "--strict":
        assert "card legs: none" in out and out.endswith("lint-clean.\n")


def test_cli_without_a_card_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--strict"])
