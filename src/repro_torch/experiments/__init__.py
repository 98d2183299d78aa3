"""Experiment composition: workload grids x seeds x execution options.

An :class:`Experiment` collects labeled ``repro_torch.workloads.Workload``
specs (or whole cartesian grids of them), then runs everything as one
deduped batched sweep — one engine call per ``(alg, T, N, K, n_events)``
shape bucket, per-seed error bars, results addressable by label or by
spec:

>>> from repro_torch.experiments import Experiment, ExecOptions
>>> from repro_torch.workloads import Workload
>>> exp = (Experiment("demo", n_seeds=2, n_events=300,
...                   options=ExecOptions(device="cpu"))
...        .add_grid(Workload("alock", 2, 2, 8), locality=(0.85, 1.0)))
>>> res = exp.run()
>>> res.labels
['locality0.85', 'locality1']

``ExecOptions`` is the immutable how-to-execute value (backend, device)
threaded explicitly through ``Experiment.run`` — there is no process-wide
execution state.
"""
from repro_torch.experiments.experiment import Experiment, ExperimentResult
from repro_torch.experiments.options import ExecOptions

__all__ = ["ExecOptions", "Experiment", "ExperimentResult"]
