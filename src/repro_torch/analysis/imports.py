"""Static import-graph gate: dead weight, and imports the port may not make.

Parses every module under ``src/repro_torch`` with ``ast`` (nothing is
imported or executed), resolves ``import``/``from``-imports — including
relative and function-local ones — to edges between the package's
modules, and walks reachability from its entry packages
(:data:`ROOT_PACKAGES`). Modules no root can reach are *unreachable*:
nothing the engine, the experiment registry or the coordinator runs can
ever import them.

The gate fails (``python -m repro_torch.analysis --imports`` exits 1) on
three things:

  * an unreachable module that no :data:`QUARANTINED` entry covers;
  * a quarantine entry that went stale (its modules vanished or became
    reachable);
  * a *forbidden import*: ``jax``, ``jaxlib``, the reference package
    ``repro`` (or ``flax`` / ``optax``, which import JAX) imported anywhere
    in ``src/repro_torch`` or ``chip_smoke.py``, function-local imports
    included — the port runs where there is no JAX.

Resolution rules (the reference's, ``repro/analysis/imports.py``, with the
package name a parameter so the same walker reads either package):

  * ``from pkg.a.b import c`` edges to ``pkg.a.b.c`` when that is a
    module, else to ``pkg.a.b``;
  * importing ``pkg.a.b`` also edges to package ``pkg.a`` (its
    ``__init__`` runs) — namespace dirs without an ``__init__.py``
    contribute no such edge;
  * relative imports resolve against the importing module's package;
  * imports of modules outside the package are ignored.

>>> g = build_graph()
>>> "repro_torch.core.sim" in g.modules
True
>>> "repro_torch.kernels.event_loop.i32pair" in g.reachable()
True
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["ROOT_PACKAGES", "QUARANTINED", "FORBIDDEN", "ImportGraph",
           "build_graph", "forbidden_imports", "report", "classify"]

#: reachability roots: the packages whose public surface the engine, the
#: scenario registry and the coordinator expose. For a namespace package
#: (no ``__init__.py``) the roots are its direct child modules.
#: ``repro_torch.analysis.__main__`` is the lint CLI itself — an
#: executable entry, reached by ``python -m``, not by imports.
ROOT_PACKAGES = ("repro_torch.core", "repro_torch.kernels",
                 "repro_torch.workloads", "repro_torch.experiments",
                 "repro_torch.coord", "repro_torch.analysis",
                 "repro_torch.analysis.__main__")

#: Explicitly parked module trees: unreachable from every root *on
#: purpose*, with the reason recorded here. A prefix covers the module
#: itself and everything below it. Anything unreachable and NOT covered
#: fails the ``--imports`` gate; so does a stale entry.
QUARANTINED: dict[str, str] = {
    "repro_torch.core.tla": "the TLA+ explorer and spec emitter — "
                            "developer tooling called by hand and by its "
                            "tests, outside the engine's import surface "
                            "(as the reference's core.tla)",
    "repro_torch.kernels.alock_tick": "the lock-property path's entry "
                                      "(ops.monte_carlo_cs_entries), "
                                      "called by its users and "
                                      "chip_smoke.py, never by the "
                                      "event-driven engine; the lint "
                                      "reads the kernel wrapper beside it",
    "repro_torch.kernels.flash_attention": "the attention exemplar's "
                                           "entry points (ops.mha, "
                                           "mha_vjp), unrelated to the "
                                           "lock simulator; the lint "
                                           "reads the kernel wrappers "
                                           "beside them",
    "repro_torch.kernels.ssd_scan": "the SSD exemplar's entry point "
                                    "(ops.ssd_forward), unrelated to the "
                                    "lock simulator; the lint reads the "
                                    "kernel wrapper beside it",
}

#: top-level packages the port may not import (the reference and JAX)
FORBIDDEN = ("jax", "jaxlib", "repro", "flax", "optax")


def _src_root() -> Path:
    return Path(__file__).resolve().parent.parent


@dataclass
class ImportGraph:
    modules: dict = field(default_factory=dict)   # name -> Path
    edges: dict = field(default_factory=dict)     # name -> set[str]
    root_packages: tuple = ROOT_PACKAGES
    #: name -> [(line, module)] of every absolute import, in or out of
    #: the package
    absolute: dict = field(default_factory=dict)

    def roots(self) -> list:
        out = []
        for pkg in self.root_packages:
            if pkg in self.modules:               # real package: __init__
                out.append(pkg)
            else:                                 # namespace: direct children
                prefix = pkg + "."
                out += [m for m in self.modules
                        if m.startswith(prefix)
                        and "." not in m[len(prefix):]]
        return sorted(set(out))

    def reachable(self) -> set:
        seen, todo = set(), list(self.roots())
        while todo:
            m = todo.pop()
            if m in seen:
                continue
            seen.add(m)
            todo += [d for d in self.edges.get(m, ()) if d not in seen]
        return seen

    def unreachable(self) -> list:
        return sorted(set(self.modules) - self.reachable())


def _module_name(path: Path, src: Path, package: str) -> str:
    rel = path.relative_to(src).with_suffix("")
    parts = (package,) + rel.parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _resolve(target: str, modules: dict) -> list:
    """Longest known prefix of a dotted import target (with its package
    chain), or [] for anything outside the package."""
    out = []
    parts = target.split(".")
    for i in range(len(parts), 0, -1):
        cand = ".".join(parts[:i])
        if cand in modules:
            out.append(cand)
            # packages up the chain run their __init__ on import
            for j in range(i - 1, 0, -1):
                pkg = ".".join(parts[:j])
                if pkg in modules:
                    out.append(pkg)
            break
    return out


def _absolute_imports(tree) -> list:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, node.module or ""))
    return out


def build_graph(src: Path | None = None,
                package: str = "repro_torch") -> ImportGraph:
    """The import graph of the package ``package`` rooted at ``src``
    (default: this package). Its roots are :data:`ROOT_PACKAGES` with
    ``repro_torch`` replaced by ``package``."""
    src = Path(src) if src is not None else _src_root()
    g = ImportGraph(root_packages=tuple(
        package + p[len("repro_torch"):] for p in ROOT_PACKAGES))
    for path in sorted(src.rglob("*.py")):
        g.modules[_module_name(path, src, package)] = path
    for name, path in g.modules.items():
        deps = g.edges.setdefault(name, set())
        try:
            tree = ast.parse(path.read_text(encoding="utf-8"))
        except SyntaxError:
            continue
        g.absolute[name] = _absolute_imports(tree)
        pkg_parts = name.split(".")[:-1] if not _is_pkg(name, g.modules) \
            else name.split(".")
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    deps.update(_resolve(alias.name, g.modules))
            elif isinstance(node, ast.ImportFrom):
                if node.level:                    # relative import
                    base = pkg_parts[:len(pkg_parts) - node.level + 1]
                    mod = ".".join(base + ([node.module]
                                           if node.module else []))
                else:
                    mod = node.module or ""
                for alias in node.names:
                    hits = _resolve(f"{mod}.{alias.name}", g.modules) \
                        or _resolve(mod, g.modules)
                    deps.update(hits)
        deps.discard(name)
    return g


def _is_pkg(name: str, modules: dict) -> bool:
    path = modules.get(name)
    return path is not None and path.name == "__init__.py"


def forbidden_imports(g: ImportGraph, smoke: Path | None = None) -> list:
    """``(path, line, module)`` of every import of a :data:`FORBIDDEN`
    package in the graph's modules and in ``smoke`` (``chip_smoke.py``)."""
    found = [(g.modules[name], line, mod)
             for name, imps in g.absolute.items() for line, mod in imps]
    if smoke is not None and smoke.exists():
        tree = ast.parse(smoke.read_text(encoding="utf-8"), str(smoke))
        found += [(smoke, line, mod)
                  for line, mod in _absolute_imports(tree)]
    return [f for f in found if f[2].split(".")[0] in FORBIDDEN]


def _covering(module: str) -> str | None:
    """The QUARANTINED prefix covering ``module``, if any."""
    for prefix in QUARANTINED:
        if module == prefix or module.startswith(prefix + "."):
            return prefix
    return None


def _split(g: ImportGraph) -> tuple:
    dead = g.unreachable()
    quarantined = [m for m in dead if _covering(m)]
    unexpected = [m for m in dead if not _covering(m)]
    hit = {_covering(m) for m in quarantined}
    stale = sorted(p for p in QUARANTINED if p not in hit)
    return quarantined, unexpected, stale


def classify(src: Path | None = None) -> tuple:
    """Split the graph's unreachable set against :data:`QUARANTINED`.

    Returns ``(quarantined, unexpected, stale, forbidden)``: unreachable
    modules covered by a quarantine prefix, unreachable modules covered by
    nothing (gate failures), quarantine prefixes that no longer cover any
    unreachable module (stale entries — also gate failures), and the
    forbidden imports of the package and of the ``chip_smoke.py`` beside
    its ``src/`` (``forbidden_imports`` — gate failures).
    """
    src = Path(src) if src is not None else _src_root()
    g = build_graph(src)
    return _split(g) + (forbidden_imports(
        g, src.parent.parent / "chip_smoke.py"),)


def report(src: Path | None = None) -> tuple:
    """The ``--imports`` gate: ``(human-readable text, exit code)``.

    Exit 0 iff every unreachable module is explicitly quarantined, every
    quarantine entry still earns its keep, and nothing imports a
    forbidden package.
    """
    src = Path(src) if src is not None else _src_root()
    g = build_graph(src)
    quarantined, unexpected, stale = _split(g)
    forbidden = forbidden_imports(g, src.parent.parent / "chip_smoke.py")
    dead = g.unreachable()
    rel = src.parent
    lines = [f"import graph: {len(g.modules)} modules under "
             f"{src.parent.name}/{src.name}, {len(g.roots())} roots, "
             f"{len(g.reachable())} reachable, {len(dead)} unreachable "
             f"({len(quarantined)} quarantined, {len(unexpected)} "
             f"unexpected); {len(forbidden)} forbidden import(s)",
             f"roots: {', '.join(ROOT_PACKAGES)}", ""]
    if quarantined:
        lines.append("quarantined (unreachable on purpose — see "
                     "repro_torch.analysis.imports.QUARANTINED):")
        last = None
        for m in quarantined:
            prefix = _covering(m)
            if prefix != last:
                lines.append(f"  [{prefix}] {QUARANTINED[prefix]}")
                last = prefix
            lines.append(f"    {m}  ({g.modules[m].relative_to(rel)})")
        lines.append("")
    if unexpected:
        lines.append("UNEXPECTED unreachable modules — wire them into an "
                     "entry package, delete them, or quarantine them "
                     "with a reason:")
        for m in unexpected:
            lines.append(f"  {m}  ({g.modules[m].relative_to(rel)})")
        lines.append("")
    if stale:
        lines.append("STALE quarantine entries — every module under the "
                     "prefix is now reachable (or gone); delete the "
                     "entry:")
        for p in stale:
            lines.append(f"  {p}")
        lines.append("")
    if forbidden:
        lines.append("FORBIDDEN imports — the port runs without JAX and "
                     "without the reference package:")
        for path, line, mod in forbidden:
            lines.append(f"  {path.relative_to(rel.parent)}:{line}  "
                         f"import {mod}")
        lines.append("")
    ok = not unexpected and not stale and not forbidden
    lines.append("imports gate: "
                 + ("clean." if ok else "FAILED (see above)."))
    return "\n".join(lines), (0 if ok else 1)
