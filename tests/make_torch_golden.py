"""Write ``tests/golden/torch_fig5_full.json``: the JAX reference at full
width, as digests the port's GPU smoke run can check without JAX.

Not collected by pytest (no ``test_`` prefix). Run from the repository
root with the reference importable::

    PYTHONPATH=src python tests/make_torch_golden.py

For each of alock / spinlock / mcs at the paper's largest Fig. 5 shape
(20 nodes x 8 threads, 1000 locks, locality 0.95) it runs the reference's
XLA engine for 150,000 events with seeds 0 and 1 and records, per replica,
``ops``, ``sim_ns``, ``reacquires``, ``passes``, ``lat_n`` and the SHA-256
of the raw bytes of the ``done`` (int32) and ``lat`` (int64) arrays
(little-endian, C order). ``chip_smoke.py`` recomputes the same digests
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

SHAPE = dict(n_nodes=20, threads_per_node=8, n_locks=1000, locality=0.95)
ALGS = ("alock", "spinlock", "mcs")
N_EVENTS = 150_000
SEEDS = (0, 1)
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                   "torch_fig5_full.json")


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main() -> None:
    rows = []
    for alg in ALGS:
        ws = [R.ref_workloads.Workload(alg, seed=s, **SHAPE) for s in SEEDS]
        wl = R.ref_lowered_batched(ws, N_EVENTS)
        N, tpn, K = (SHAPE["n_nodes"], SHAPE["threads_per_node"],
                     SHAPE["n_locks"])
        tn, ln, _ = R.ref_sim.topology(alg, N, tpn, K)
        t0 = time.perf_counter()
        with jax.enable_x64(True):
            wj = type(wl)(*(jnp.asarray(a) for a in wl))
            out = R.ref_ref.run_events_ref(alg, N * tpn, N, K, N_EVENTS,
                                           wj, tn, ln)
            done, lat, lat_n, t_end, nreacq, npass = (
                np.asarray(o) for o in out)
        print(f"{alg}: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
        assert done.dtype == np.int32 and lat.dtype == np.int64
        for i, s in enumerate(SEEDS):
            rows.append({
                "alg": alg, "seed": s, "ops": int(done[i].sum()),
                "sim_ns": max(int(t_end[i]), 1),
                "reacquires": int(nreacq[i]), "passes": int(npass[i]),
                "lat_n": int(lat_n[i]),
                "done_sha256": digest(done[i]),
                "lat_sha256": digest(lat[i]),
            })
    doc = {"source": "repro.kernels.event_loop.ref.run_events_ref (XLA "
                     "engine, CPU, x64)",
           "jax": jax.__version__, "n_events": N_EVENTS, **SHAPE,
           "replicas": rows}
    with open(OUT, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
