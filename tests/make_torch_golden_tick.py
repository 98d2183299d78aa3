"""Write ``tests/golden/torch_tick_full.json``: the JAX reference's
Monte-Carlo lock-table run at full width, as digests the port's GPU smoke
run can check without JAX.

Not collected by pytest (no ``test_`` prefix). Run from the repository
root with the reference importable::

    PYTHONPATH=src python tests/make_torch_golden_tick.py

It repeats ``repro.kernels.alock_tick.ops.monte_carlo_cs_entries(4096,
16, 150_000, (0,)*8 + (1,)*8, b_init=(5, 20), seed=0, use_kernel=False)``
step by step: the schedule from ``jax.random.randint`` in one call, fresh
tables, then the oracle ``alock_tick_ref`` over slabs of tables (tables
are independent, so slabbing changes no bit and bounds the oracle's
memory), then ``in_cs_frac`` and ``final_pc_histogram`` exactly as the
reference computes them from the final pc. It records the SHA-256 of the
raw bytes (int32, little-endian, C order) of the schedule and of the six
final arrays in the kernel's contract (tails (Tab,2), victim (Tab,1),
pc, budget, nxt, prev (Tab,T)), the two statistics, the jax version and
the seconds each stage took (about 2.5 minutes in all on a CPU; the
schedule alone is 2.46 GB).
"""
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_ref as R  # noqa: E402

np, jax, jnp = R.np, R.jax, R.jnp

N_TABLES, N_THREADS, STEPS = 4096, 16, 150_000
COHORTS = (0,) * 8 + (1,) * 8
B_INIT = (5, 20)
SEED = 0
SLAB = 256
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                   "torch_tick_full.json")
NAMES = ("tails", "victim", "pc", "budget", "nxt", "prev")


def digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main() -> None:
    from repro.core import machine as mc
    from repro.kernels.alock_tick.ops import fresh_tables
    from repro.kernels.alock_tick.ref import alock_tick_ref
    t0 = time.perf_counter()
    sched = jax.random.randint(jax.random.key(SEED), (N_TABLES, STEPS), 0,
                               N_THREADS, dtype=jnp.int32)
    sched = np.asarray(sched)
    t1 = time.perf_counter()
    tables = [np.asarray(a) for a in fresh_tables(N_TABLES, N_THREADS)]
    coh = jnp.asarray(COHORTS, jnp.int32)
    b_init = jnp.asarray(B_INIT, jnp.int32)
    oracle = jax.jit(alock_tick_ref)
    outs = [[] for _ in NAMES]
    for r0 in range(0, N_TABLES, SLAB):
        sl = slice(r0, r0 + SLAB)
        tails, vic, pc, bud, nxt, prev = (jnp.asarray(a[sl]) for a in tables)
        out = oracle(tails, vic[:, 0], pc, bud, nxt, prev,
                     jnp.asarray(sched[sl]), coh, b_init)
        for acc, o in zip(outs, out):
            acc.append(np.asarray(o))
        print(f"tables {r0 + SLAB}/{N_TABLES}", flush=True)
    final = [np.concatenate(a) for a in outs]
    final[1] = final[1][:, None]            # victim in the kernel's (Tab,1)
    t2 = time.perf_counter()
    pc_fin = jnp.asarray(final[2])
    in_cs = pc_fin == mc.CS
    in_cs_frac = float(in_cs.mean())
    hist = np.asarray(jnp.bincount(pc_fin.reshape(-1), length=14))
    t3 = time.perf_counter()
    doc = {
        "source": "repro.kernels.alock_tick: jax.random.randint schedule + "
                  "ref.alock_tick_ref (monte_carlo_cs_entries with "
                  "use_kernel=False), CPU",
        "jax": jax.__version__,
        "n_tables": N_TABLES, "n_threads": N_THREADS, "steps": STEPS,
        "cohorts": list(COHORTS), "b_init": list(B_INIT), "seed": SEED,
        "sched_sha256": digest(sched.astype(np.int32)),
        "final_sha256": {n: digest(a.astype(np.int32))
                         for n, a in zip(NAMES, final)},
        "in_cs_frac": in_cs_frac,
        "final_pc_histogram": [int(x) for x in hist],
        "seconds": {"schedule": t1 - t0, "oracle": t2 - t1,
                    "statistics": t3 - t2},
    }
    with open(OUT, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in doc.items()
                      if k not in ("final_sha256",)}))


if __name__ == "__main__":
    main()
