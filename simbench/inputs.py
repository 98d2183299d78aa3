"""What the benchmark feeds the program: cells, configurations, traffic.

Every piece is a file found by its name in ``BENCHMARK.json``:
``workloads/<cell>.json`` (the configuration, the traffic mix and how
much the check reads), ``configs/<config>.json`` (the grid of simulated
clusters, seeds and events) and ``traffic/<mix>.json`` (how the grid is
cut into jobs). ``jobs`` is the one generator every traffic mix goes
through; it draws everything from ``--seed``.

A traffic mix has ``per_job``: ``"all"`` (each job is the whole grid, in
the configuration's order) or a count ``n`` (each job is ``n`` workloads
of the grid, taken in an order drawn from the seed, a fresh order each
time the grid has been used up).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

M64 = (1 << 64) - 1
#: job seeds stay below this, so a job's seeds ``seed + [0, n_seeds)`` are
#: int32 for any configuration of fewer than 2**16 seeds
SEED_SPAN = (1 << 31) - (1 << 16)


def load(root: Path, kind: str, name: str) -> dict:
    """``simbench/<kind>/<name>.json`` under the checkout ``root``."""
    path = root / "simbench" / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(root: Path, name: str) -> dict:
    """A cell with its configuration and traffic mix resolved; the cell
    file and ``BENCHMARK.json`` have to name the same two."""
    entry = next((w for w in benchmark(root)["workloads"]
                  if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no cell {name!r}")
    spec = load(root, "workloads", name)
    for k in ("config", "traffic"):
        if spec[k] != entry[k]:
            raise ValueError(f"cell {name}: {k} {spec[k]!r} in its file, "
                             f"{entry[k]!r} in BENCHMARK.json")
    return {"name": name, "entry": entry, "spec": spec,
            "config": load(root, "configs", spec["config"]),
            "traffic": load(root, "traffic", spec["traffic"])}


def grid(config: dict) -> list[dict]:
    """The distinct workloads of a configuration, in its order: each of
    ``grids`` is a ``base`` workload crossed with ``axes`` (a field, dotted
    for a field of ``arrivals``, and its values) in the order given."""
    out, seen = [], set()
    for g in config["grids"]:
        combos = [{}]
        for name, values in g["axes"].items():
            combos = [{**c, name: v} for c in combos for v in values]
        for c in combos:
            w = json.loads(json.dumps(g["base"]))
            for name, v in c.items():
                head, _, tail = name.partition(".")
                if tail:
                    w[head] = {**w[head], tail: v}
                else:
                    w[head] = v
            key = json.dumps(w, sort_keys=True)
            if key not in seen:
                seen.add(key)
                out.append(w)
    return out


def mix(*words: int) -> int:
    """A 64-bit hash of integers (splitmix64 over their sum chain)."""
    x = 0
    for w in words:
        x = (x + (int(w) & M64) + 0x9E3779B97F4A7C15) & M64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
        x ^= x >> 31
    return x


def rng(*words: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(mix(*words)))


def job_seed(seed: int, j: int) -> int:
    """The seed of job ``j`` of a run with ``--seed seed``."""
    return mix(seed, j, 1) % SEED_SPAN


def jobs(config: dict, traffic: dict, seed: int):
    """Endless jobs: ``(index, workloads)``, each workload with its job's
    seed."""
    ws = grid(config)
    per = traffic["per_job"]
    order: list[int] = []
    j = cycle = 0
    while True:
        if per == "all":
            pick = list(range(len(ws)))
        else:
            while len(order) < per:
                cycle += 1
                order += rng(seed, cycle, 2).permutation(len(ws)).tolist()
            pick, order = order[:per], order[per:]
        s = job_seed(seed, j)
        yield j, [dict(ws[i], seed=s) for i in pick]
        j += 1


def ramp_field(d: dict, field: str):
    head, _, tail = field.partition(".")
    return d[head][tail] if tail else d[head]


def ramp_groups(workloads, knee: dict) -> dict:
    """Indices of ``workloads`` by ramp group (workloads equal but for the
    ramp field), each in the order of the ramp's ``values``; only groups
    that hold every value."""
    field, values = knee["ramp"], knee["values"]
    head, _, tail = field.partition(".")
    groups: dict = {}
    for i, d in enumerate(workloads):
        rest = dict(d)
        if tail:
            rest[head] = {k: x for k, x in d[head].items() if k != tail}
        else:
            rest.pop(head)
        key = json.dumps(rest, sort_keys=True)
        groups.setdefault(key, {})[ramp_field(d, field)] = i
    return {k: [g[v] for v in values] for k, g in groups.items()
            if all(v in g for v in values)}
