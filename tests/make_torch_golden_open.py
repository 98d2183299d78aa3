"""Write ``tests/golden/torch_open_loop_full.json``: the JAX reference's
open loop at full width, as digests the port's GPU smoke run can check
without JAX.

Not collected by pytest (no ``test_`` prefix). Run from the repository
root with the reference importable::

    PYTHONPATH=src python tests/make_torch_golden_open.py

At the scenario registry's topology (4 nodes x 4 threads, 16 locks,
locality 0.95, 256 request slots) it runs the reference's XLA engine for
150,000 events with seeds 0 and 1, for alock / mcs / spinlock at the
``open-loop-ramp`` rate of 8 req/us (queue bound 32) and for alock / mcs
under ``burst-storm``'s ``token`` policy, and records per replica the
counters and the SHA-256 of the raw bytes of ``done`` (int32), ``lat``,
``arr``, ``wq``, ``soj`` (int64) and ``rstat`` (int32), little-endian, C
order. ``chip_smoke.py`` recomputes the same digests from the CUDA
kernel's outputs.
"""
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_ref as R  # noqa: E402

np, jax, jnp = R.np, R.jax, R.jnp

N_EVENTS = 150_000
SEEDS = (0, 1)
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                   "torch_open_loop_full.json")
NAMES = ("done", "lat", "lat_n", "t_end", "nreacq", "npass", "arr", "wq",
         "soj", "rstat")
DIGESTED = ("done", "lat", "arr", "wq", "soj", "rstat")


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def cases():
    """(case name, reference Workload) of every golden configuration,
    taken from the reference registry's own specs."""
    reg = R.ref_registry
    out = []
    for w in reg._open_loop_ramp_workloads():
        if w.arrivals.rate_per_us == 8.0:
            out.append((f"open-loop-ramp.{w.alg}.rate8", w))
    for w in reg._burst_storm_workloads():
        if w.arrivals.token_rate_per_us > 0.0:
            out.append((f"burst-storm.{w.alg}.token", w))
    return out


def main() -> None:
    rows = []
    for case, w in cases():
        ws = [w.replace(seed=s) for s in SEEDS]
        wl = R.ref_lowered_batched(ws, N_EVENTS)
        N, tpn, K = w.n_nodes, w.threads_per_node, w.n_locks
        tn, ln, _ = R.ref_sim.topology(w.alg, N, tpn, K)
        t0 = time.perf_counter()
        with jax.enable_x64(True):
            wj = type(wl)(*(jnp.asarray(a) for a in wl))
            out = R.ref_ref.run_events_ref(w.alg, N * tpn, N, K, N_EVENTS,
                                           wj, tn, ln)
            out = dict(zip(NAMES, (np.asarray(o) for o in out)))
        print(f"{case}: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
        assert out["arr"].dtype == np.int64 and out["rstat"].dtype == np.int32
        for i, s in enumerate(SEEDS):
            rstat = out["rstat"][i]
            row = {"case": case, "alg": w.alg, "seed": s,
                   "ops": int(out["done"][i].sum()),
                   "sim_ns": max(int(out["t_end"][i]), 1),
                   "reacquires": int(out["nreacq"][i]),
                   "passes": int(out["npass"][i]),
                   "lat_n": int(out["lat_n"][i]),
                   "completed": int((rstat == 3).sum()),
                   "dropped": int((rstat == 2).sum())}
            for name in DIGESTED:
                row[f"{name}_sha256"] = digest(out[name][i])
            rows.append(row)
    doc = {"source": "repro.kernels.event_loop.ref.run_events_ref (XLA "
                     "engine, CPU, x64) on repro.experiments.registry's "
                     "open-loop-ramp (rate 8) and burst-storm (token) specs",
           "jax": jax.__version__, "n_events": N_EVENTS,
           "seeds": list(SEEDS), "replicas": rows}
    with open(OUT, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
