"""The system under test, ``repro_torch``, as the benchmark drives it.

This is the one module of the benchmark that imports the program. A job
is one ``Experiment.run()`` of the job's workloads (each with the job's
seed) at the configuration's seeds and events, followed by the rows a
figure or the serving scenario makes of the results: throughput and
latency per workload and, for an open-loop workload, its seed-averaged
serving summary; where the configuration names an offered-load ramp and
the job holds the whole ramp of a group, ``detect_knee`` over it.
"""
from __future__ import annotations

import numpy as np

from simbench.inputs import ramp_groups


def _tuple(v):
    return tuple(v) if isinstance(v, list) else v


def to_workload(d: dict):
    """A workload of the configuration files as the program's spec."""
    from repro_torch.workloads import Arrivals, Phase, Workload, mixed

    def common(src: dict) -> dict:
        kw = {}
        for k, v in src.items():
            if k in ("locality", "read_frac") and isinstance(v, dict):
                v = mixed(**v)
            elif k == "node_mult" and isinstance(v, dict):
                v = {int(n): float(m) for n, m in v.items()}
            elif k == "cost" and isinstance(v, dict):
                v = dict(v)
            kw[k] = _tuple(v)
        return kw

    kw = common({k: v for k, v in d.items()
                 if k not in ("phases", "arrivals")})
    if d.get("phases"):
        kw["phases"] = tuple(Phase(**common(p)) for p in d["phases"])
    if d.get("arrivals"):
        kw["arrivals"] = Arrivals(**{k: _tuple(v) for k, v in
                                     d["arrivals"].items()})
    return Workload(**kw)


class Program:
    """The program on one device: runs jobs and reads its own stages."""

    def __init__(self, device: str):
        import torch

        from repro_torch.core import batch
        from repro_torch.experiments import ExecOptions, Experiment
        from repro_torch.traffic.metrics import detect_knee
        self.torch, self.batch = torch, batch
        self.Experiment, self.detect_knee = Experiment, detect_knee
        self.options = ExecOptions(device=device)
        self.device = device

    def sync(self):
        if self.device != "cpu":
            self.torch.cuda.synchronize()

    def experiment(self, workloads, n_seeds: int, n_events: int):
        exp = self.Experiment("simbench", n_seeds=n_seeds,
                              n_events=n_events, options=self.options)
        for i, d in enumerate(workloads):
            exp.add(to_workload(d), label=str(i))
        return exp

    def warm_up(self, workloads, n_seeds: int, n_events: int):
        """Every bucket of ``workloads`` once, at ``n_events`` events."""
        self.experiment(workloads, n_seeds, n_events).run()
        self.sync()

    def run_job(self, workloads, config: dict) -> list[dict]:
        """One job; per workload a dict of its ``BatchResult`` and rows,
        and under ``"knee"`` the knee row of each whole ramp group."""
        n_seeds, n_events = config["n_seeds"], config["n_events"]
        res = self.experiment(workloads, n_seeds, n_events).run()
        out = []
        for (_, _, br), d in zip(res, workloads):
            rows = {"mean_mops": br.mean_mops, "ci95_mops": br.ci95_mops,
                    "mean_lat_us": br.mean_lat_us}
            if br.open_loop:
                rows["serving"] = br.serving_mean()
            out.append({"workload": d, "result": br, "rows": rows})
        knee = config.get("knee")
        if knee:
            for key, idx in ramp_groups(workloads, knee).items():
                sms = [out[i]["rows"]["serving"] for i in idx]
                k = self.detect_knee([s["offered_per_us"] for s in sms],
                                     [s["goodput_per_us"] for s in sms],
                                     knee.get("efficiency", 0.9))
                row = {"knee_index": k,
                       "knee_goodput_per_us": (None if k is None else
                                               sms[k]["goodput_per_us"])}
                for i in idx:
                    out[i]["knee"] = (key, row)
        return out

    def arrays(self, item: dict, s: int) -> dict:
        """Seed ``s``'s outputs of a job's workload, as plain arrays."""
        br = item["result"]
        a = {"done": br.per_thread_ops[s], "lat": br.lat_ns[s],
             "sim_ns": int(br.sim_ns[s]), "reacquires": int(br.reacquires[s]),
             "passes": int(br.passes[s])}
        if br.open_loop:
            a.update(arr=br.arr_ns[s], wait=br.wait_ns[s],
                     sojourn=br.sojourn_ns[s], rstat=br.rstat[s])
        return {k: np.array(v) if isinstance(v, np.ndarray) else v
                for k, v in a.items()}

    def full_rows(self, item: dict) -> dict:
        """A workload's rows with the latency percentiles, which the
        check reads from the program's own result after the window."""
        br = item["result"]
        return {**item["rows"], "p50_lat_ns": br.p50_lat_ns,
                "p99_lat_ns": br.p99_lat_ns}

    def knee_of(self, item: dict):
        """The job's knee row of the ramp group ``item`` belongs to, as
        ``(group, row)``; None where the job holds no whole group."""
        return item.get("knee")

    def reset_stats(self):
        self.batch.reset_exec_stats()
        if self.device != "cpu":
            self.torch.cuda.reset_peak_memory_stats()

    def stats(self) -> dict:
        return self.batch.exec_stats()

    def peak_bytes(self) -> int:
        if self.device == "cpu":
            return 0
        return int(self.torch.cuda.max_memory_allocated())

