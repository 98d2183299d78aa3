"""Write ``tests/golden/torch_algs_full.json``: the JAX reference at full
depth on the parts of the machine the other digests leave out, as digests
the port's GPU smoke run can check without JAX.

Not collected by pytest (no ``test_`` prefix). Run from the repository
root with the reference importable::

    PYTHONPATH=src python tests/make_torch_golden_algs.py

It takes every workload of the reference registry's ``read-heavy``
(alock-rw readers and writers), ``rack-locality`` (hlock's rack cohorts),
``limping-node`` (``node_mult``) and ``node-churn`` (a phase program with
a node down and back) scenarios, with seeds 0 and 1, groups them by
algorithm (phases padded to the group's maximum, as a sweep's bucket
does), runs the reference's XLA engine for 150,000 events, and records
per replica ``ops``, ``sim_ns``, ``reacquires``, ``passes``, ``lat_n``
and the SHA-256 of the raw bytes of ``done`` (int32) and ``lat`` (int64),
little-endian, C order. ``chip_smoke.py`` recomputes the same digests
from the CUDA kernel's outputs.
"""
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_ref as R  # noqa: E402

np, jax, jnp = R.np, R.jax, R.jnp

SCENARIOS = ("read-heavy", "rack-locality", "limping-node", "node-churn")
N_EVENTS = 150_000
SEEDS = (0, 1)
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                   "torch_algs_full.json")


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def cases():
    """(case name, reference Workload) of every golden configuration:
    ``<scenario>.<index in the scenario's workload list>``."""
    return [(f"{name}.{i}", w) for name in SCENARIOS
            for i, w in enumerate(R.ref_registry.scenario_workloads(name))]


def main() -> None:
    groups: dict[tuple, list] = {}
    for case, w in cases():
        key = (w.alg, w.n_nodes, w.threads_per_node, w.n_locks)
        groups.setdefault(key, []).append((case, w))
    rows = []
    for (alg, N, tpn, K), items in groups.items():
        ws = [w.replace(seed=s) for _, w in items for s in SEEDS]
        wl = R.ref_lowered_batched(ws, N_EVENTS)
        tn, ln, _ = R.ref_sim.topology(alg, N, tpn, K)
        t0 = time.perf_counter()
        with jax.enable_x64(True):
            wj = type(wl)(*(jnp.asarray(a) for a in wl))
            out = R.ref_ref.run_events_ref(alg, N * tpn, N, K, N_EVENTS,
                                           wj, tn, ln)
            done, lat, lat_n, t_end, nreacq, npass = (
                np.asarray(o) for o in out)
        print(f"{alg} x {len(ws)}: {time.perf_counter() - t0:.1f}s",
              file=sys.stderr)
        assert done.dtype == np.int32 and lat.dtype == np.int64
        j = 0
        for case, w in items:
            for s in SEEDS:
                rows.append({
                    "case": case, "alg": alg, "seed": s,
                    "ops": int(done[j].sum()),
                    "sim_ns": max(int(t_end[j]), 1),
                    "reacquires": int(nreacq[j]), "passes": int(npass[j]),
                    "lat_n": int(lat_n[j]),
                    "done_sha256": digest(done[j]),
                    "lat_sha256": digest(lat[j])})
                j += 1
    rows.sort(key=lambda r: [c for c, _ in cases()].index(r["case"]))
    doc = {"source": "repro.kernels.event_loop.ref.run_events_ref (XLA "
                     "engine, CPU, x64) on repro.experiments.registry's "
                     + ", ".join(SCENARIOS) + " specs",
           "jax": jax.__version__, "n_events": N_EVENTS,
           "seeds": list(SEEDS), "scenarios": list(SCENARIOS),
           "replicas": rows}
    with open(OUT, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
