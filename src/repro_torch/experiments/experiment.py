""":class:`Experiment`: labeled workload grids x seeds x
:class:`~repro_torch.experiments.options.ExecOptions`, run as one batched sweep.

An Experiment is the declarative counterpart of a hand-rolled config list:
you ``add`` workloads (or ``add_grid`` a cartesian product of spec-field
axes), then ``run()`` lowers everything through ``repro_torch.core.batch.sweep``
— duplicates deduped, one engine call per shape bucket, per-seed error bars —
and returns an :class:`ExperimentResult` addressable by label or spec.
"""
from __future__ import annotations

import itertools

from repro_torch.core.batch import BatchResult, stage, sweep
from repro_torch.core.cost_model import CostModel
from repro_torch.experiments.options import ExecOptions
from repro_torch.workloads import Workload, as_workload


def _fmt_axis(name: str, value) -> str:
    if isinstance(value, str):          # e.g. alg="alock" -> "alock"
        return value
    if isinstance(value, float):
        return f"{name}{value:g}"
    if isinstance(value, (tuple, list)):
        return f"{name}{'x'.join(str(v) for v in value)}"
    return f"{name}{value}"


class Experiment:
    def __init__(self, name: str = "", *, n_seeds: int = 1,
                 n_events: int = 400_000, cm: CostModel = CostModel(),
                 options: ExecOptions = ExecOptions()):
        if n_seeds < 1:
            raise ValueError(f"n_seeds must be >= 1, got {n_seeds}")
        self.name = name
        self.n_seeds = n_seeds
        self.n_events = n_events
        self.cm = cm
        self.options = options
        self._entries: list[tuple[str, Workload]] = []
        self._labels: set[str] = set()

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def workloads(self) -> list[Workload]:
        return [w for _, w in self._entries]

    def add(self, workload, label: str | None = None) -> "Experiment":
        """Add one workload (SimConfig rides the adapter). Chainable."""
        w = as_workload(workload)
        if label is None:
            label = f"{w.alg}.{len(self._entries)}"
        if label in self._labels:
            raise ValueError(f"duplicate label {label!r}")
        self._labels.add(label)
        self._entries.append((label, w))
        return self

    def add_grid(self, base: Workload, prefix: str = "",
                 **axes) -> "Experiment":
        """Cartesian product over spec fields, e.g.
        ``add_grid(base, alg=("alock", "mcs"), locality=(0.85, 1.0))``.
        Labels are ``prefix + axis-value`` segments joined with ``.``."""
        names = list(axes)
        for combo in itertools.product(*(axes[n] for n in names)):
            w = base.replace(**dict(zip(names, combo)))
            seg = ".".join(_fmt_axis(n, v) for n, v in zip(names, combo))
            self.add(w, label=f"{prefix}{seg}" if prefix else seg)
        return self

    @stage("experiment.run")
    def run(self) -> "ExperimentResult":
        """One deduped batched sweep over every entry (the host span
        ``experiment.run`` under ``torch.profiler``)."""
        uniq = list(dict.fromkeys(w for _, w in self._entries))
        res = dict(zip(uniq, sweep(
            uniq, n_seeds=self.n_seeds, n_events=self.n_events, cm=self.cm,
            **self.options.sweep_kwargs())))
        return ExperimentResult(
            [(lbl, w, res[w]) for lbl, w in self._entries])


class ExperimentResult:
    """Results addressable by label (str) or by the Workload spec itself."""

    def __init__(self, rows: list[tuple[str, Workload, BatchResult]]):
        self._rows = rows
        self._by_label = {lbl: br for lbl, _, br in rows}
        self._by_workload = {w: br for _, w, br in rows}

    def __iter__(self):
        return iter(self._rows)

    def __len__(self) -> int:
        return len(self._rows)

    @property
    def labels(self) -> list[str]:
        return [lbl for lbl, _, _ in self._rows]

    def __getitem__(self, key) -> BatchResult:
        if isinstance(key, str):
            return self._by_label[key]
        return self._by_workload[as_workload(key)]
