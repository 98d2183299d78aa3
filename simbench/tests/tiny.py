"""A benchmark tree at a test's size: the cells of ``BENCHMARK.json``
over its two configurations cut to a few replicas and events, in a directory
the test owns."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

FIG5 = {"grids": [{"base": {"alg": "alock", "n_nodes": 2,
                            "threads_per_node": 2, "n_locks": 12,
                            "locality": 0.85, "b_init": [5, 20]},
                   "axes": {"alg": ["alock", "mcs", "spinlock"]}}]}
OPEN = {"grids": [{"base": {"alg": "alock", "n_nodes": 2,
                            "threads_per_node": 2, "n_locks": 4,
                            "locality": 0.95,
                            "arrivals": {"rate_per_us": 2.0,
                                         "max_requests": 12,
                                         "queue_cap": 4}},
                   "axes": {"alg": ["alock", "mcs"],
                            "arrivals.rate_per_us": [2.0, 16.0]}}],
        "knee": {"ramp": "arrivals.rate_per_us", "values": [2.0, 16.0],
                 "efficiency": 0.9}}


def make(dst: Path, n_events: int = 60, n_seeds: int = 2) -> Path:
    """``dst`` holding ``BENCHMARK.json`` and ``simbench/`` with its two
    configurations cut to ``n_seeds`` seeds of ``n_events`` events."""
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "simbench", dst / "simbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, cut in (("fig5-paper", FIG5), ("open-loop-4n", OPEN)):
        path = dst / "simbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(cut, n_seeds=n_seeds, n_events=n_events)
        path.write_text(json.dumps(cfg))
    return dst
