"""Latency/throughput SLOs for scenario programs.

An :class:`Slo` is a small declarative contract a registered scenario can
carry (``@scenario(..., slo=Slo(...))``): simulated p99 acquire->release
latency must stay under ``p99_ns``, and the harness must sustain at least
``min_events_per_sec`` simulated events per wall-clock second.
:func:`check_slo` evaluates a contract against the scenario's result rows
and returns an :class:`SloReport`, which a runner turns into a process
exit code.

The two bounds deliberately live on different clocks:

  * ``p99_ns`` reads the *simulated* latency pool (deterministic for a
    fixed spec + seed set — a tightened bound fails reproducibly, which
    the exit-code tests rely on);
  * ``min_events_per_sec`` reads the harness's *wall-clock* event rate —
    registered scenarios keep this floor loose enough for smoke runs; it
    was set for another machine and is no measurement of this one.

Beyond the scenario-wide bounds, ``per_label`` attaches a *sub-contract*
to individual result rows by name: ``Slo(per_label={"alock-rw.rf99":
Slo(p99_ns=2e5)})`` gates only the row named ``alock-rw.rf99``, with its
own (usually tighter) bounds. A per-label entry whose row never appears
is a violation, exactly like a scenario-wide bound matching nothing —
renaming a workload label cannot silently un-gate it.

>>> from repro_torch.experiments.slo import Slo, check_slo
>>> slo = Slo(p99_ns=5e6, min_events_per_sec=1.0)
>>> rows = [{"name": "a", "p99_lat_ns": 4e6},
...         {"name": "w", "events_per_sec": 20.0}]
>>> check_slo(slo, rows).ok
True
>>> rep = check_slo(Slo(p99_ns=1.0), rows)
>>> rep.ok, len(rep.violations)
(False, 1)
>>> tiered = Slo(p99_ns=5e6, per_label={"a": Slo(p99_ns=4.5e6)})
>>> check_slo(tiered, rows).ok
True
>>> rep = check_slo(Slo(p99_ns=5e6,
...                     per_label={"a": Slo(p99_ns=1e6),
...                                "gone": Slo(p99_ns=1e6)}), rows)
>>> rep.ok, len(rep.violations)
(False, 2)
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Slo:
    """A scenario-level service objective (either bound may be None).

    p99_ns: ceiling on simulated p99 acquire->release latency, in ns,
      checked against every result row carrying a ``p99_lat_ns`` key.
    min_events_per_sec: floor on the harness's wall-clock simulated-event
      rate, checked against every row carrying an ``events_per_sec`` key
      (the per-scenario summary row a runner appends).
    """
    p99_ns: float | None = None
    min_events_per_sec: float | None = None
    #: per-row sub-contracts: ``{row name: Slo}`` (or a pair tuple) —
    #: each applies its own bounds to exactly the row of that name, on
    #: top of the scenario-wide bounds above. One level only.
    per_label: object = ()

    def __post_init__(self):
        for name in ("p99_ns", "min_events_per_sec"):
            v = getattr(self, name)
            if v is None:
                continue
            v = float(v)
            if not math.isfinite(v) or v <= 0.0:
                raise ValueError(
                    f"Slo.{name} must be finite and > 0, got {v}")
            object.__setattr__(self, name, v)
        pl = self.per_label
        pl = tuple(sorted(pl.items())) if isinstance(pl, dict) \
            else tuple(tuple(p) for p in pl)
        for label, sub in pl:
            if not isinstance(sub, Slo):
                raise TypeError(f"per_label[{label!r}] must be an Slo, "
                                f"got {type(sub).__name__}")
            if sub.per_label:
                raise ValueError(f"per_label[{label!r}] may not nest its "
                                 f"own per_label bounds")
        object.__setattr__(self, "per_label", pl)
        if self.p99_ns is None and self.min_events_per_sec is None \
                and not pl:
            raise ValueError("an Slo needs at least one bound")


@dataclass(frozen=True)
class SloReport:
    """The outcome of one :func:`check_slo` evaluation."""
    slo: Slo
    checked: int                    # rows any bound applied to
    violations: tuple = ()          # human-readable, one per failing row

    @property
    def ok(self) -> bool:
        return not self.violations


def check_slo(slo: Slo, rows) -> SloReport:
    """Evaluate ``slo`` against scenario result rows.

    Rows are the dicts a registry scenario returns (plus the summary row
    the benchmark runner appends). A row participates in a bound iff it
    carries that bound's key — rows without latency/rate keys (ratio
    rows, coord-plane rows) pass through unexamined. A bound that
    matched *no* row at all is itself a violation: an SLO that silently
    checks nothing would gate nothing. ``per_label`` sub-contracts are
    evaluated against exactly the rows bearing their name, with the same
    matched-nothing rule per entry.
    """
    violations = []
    checked = 0
    matched = {"p99_ns": False, "min_events_per_sec": False}
    for r in rows:
        name = r.get("name", "?")
        if slo.p99_ns is not None and "p99_lat_ns" in r:
            matched["p99_ns"] = True
            checked += 1
            p99 = float(r["p99_lat_ns"])
            if not (p99 <= slo.p99_ns):        # NaN (no samples) fails too
                violations.append(
                    f"{name}: p99 latency {p99:.0f}ns exceeds SLO "
                    f"{slo.p99_ns:.0f}ns")
        if slo.min_events_per_sec is not None and "events_per_sec" in r:
            matched["min_events_per_sec"] = True
            checked += 1
            eps = float(r["events_per_sec"])
            if not (eps >= slo.min_events_per_sec):
                violations.append(
                    f"{name}: {eps:.1f} events/sec under SLO floor "
                    f"{slo.min_events_per_sec:.1f}")
    for bound, hit in matched.items():
        if getattr(slo, bound) is not None and not hit:
            violations.append(
                f"slo bound {bound} matched no result row — nothing was "
                f"checked")
    for label, sub in slo.per_label:
        sub_rows = [r for r in rows if r.get("name") == label]
        rep = check_slo(sub, sub_rows)
        checked += rep.checked
        violations.extend(f"[{label}] {v}" for v in rep.violations)
    return SloReport(slo=slo, checked=checked, violations=tuple(violations))
