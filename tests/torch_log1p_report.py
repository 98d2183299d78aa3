"""Print how far the obvious f32 ``log1p`` choices are from the JAX
reference's, and that the port's ``log1p_f32`` / ``fma_f32`` close the gap.

Not collected by pytest (no ``test_`` prefix). Run from the repository
root with the reference importable::

    PYTHONPATH=src python tests/torch_log1p_report.py

Inputs: 2·10⁶ seeded f32 uniforms, the 10⁴ f32 values just below 1 and 0
(the set ``tests/test_torch_traffic.py`` uses). For each candidate it
prints the raw f32 values that differ from jitted ``jnp.log1p(-u)`` and
the integer arrival gaps ``round(-log1p(-u) * gap_ns)`` that differ at a
few mean gaps; then the token-bucket admissions that differ from the
reference's ``arrival_plan`` with the refill fused and unfused.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import torch_ref as R  # noqa: E402
import repro.traffic.stream as ref_stream  # noqa: E402
from repro_torch.traffic import stream  # noqa: E402
from repro_torch.workloads import operands_from_numpy  # noqa: E402

np, jax, jnp = R.np, R.jax, R.jnp
GAPS_NS = (1000.0, 2000.0, 500.0, 125.0)


def _plain_fma(a, b, c):
    """``a * b + c`` with two f32 roundings."""
    return a * b + c


def main() -> None:
    u = np.random.default_rng(0).random(2_000_000, dtype=np.float32)
    u = np.concatenate([u, (1.0 - np.arange(1, 10_001) * 2.0**-24)
                        .astype(np.float32), np.float32([0.0])])
    ut = torch.from_numpy(u)
    ref = np.asarray(jax.jit(jnp.log1p)(jnp.asarray(-u))).view(np.uint32)
    saved = stream.fma_f32
    stream.fma_f32 = _plain_fma
    unfused = stream.log1p_f32(-ut)
    stream.fma_f32 = saved
    cands = {"torch.log1p": torch.log1p(-ut),
             "np.log1p": torch.from_numpy(np.log1p(-u)),
             "f64 log1p": torch.log1p(-ut.double()).float(),
             "XLA sequence, unfused": unfused,
             "log1p_f32": stream.log1p_f32(-ut)}
    print(f"{u.size} inputs")
    for name, v in cands.items():
        raw = int((v.numpy().view(np.uint32) != ref).sum())
        gaps = []
        for g in GAPS_NS:
            want = np.asarray(jax.jit(lambda x, g=g: jnp.round(
                -jnp.log1p(-x) * np.float32(g)).astype(jnp.int32))(
                    jnp.asarray(u)))
            got = torch.round(-v * np.float32(g)).to(torch.int32).numpy()
            gaps.append(int((got != want).sum()))
        print(f"{name:24s} raw values differing {raw:8d}   gaps differing "
              + "  ".join(f"{g:g} ns: {n}" for g, n in zip(GAPS_NS, gaps)))

    W, A, Ph = (R.ref_workloads.Workload, R.ref_workloads.Arrivals,
                R.ref_workloads.Phase)
    base = W("alock", 4, 4, 16, locality=0.95)
    burst = (Ph(frac=0.4), Ph(frac=0.2, rate_per_us=12.0), Ph(frac=0.4))
    ws = [base.replace(phases=burst, arrivals=a) for a in (
        A(rate_per_us=1.0, max_requests=256),
        A(rate_per_us=1.0, max_requests=256, queue_cap=16),
        A(rate_per_us=1.0, max_requests=256, token_rate_per_us=2.0,
          token_burst=16.0))]
    seeds = (0, 1, 7, 2**31 - 1)
    wl = R.ref_lowered_batched(
        [w for _ in seeds for w in ws], 150_000,
        seeds=np.repeat(np.asarray(seeds, np.int64), 3).astype(np.int32))
    with jax.enable_x64(True):
        wj = type(wl)(*(jnp.asarray(a) for a in wl))
        want = np.asarray(jax.vmap(
            lambda w: ref_stream.arrival_plan(w, 150_000))(wj).tok)
    ops = operands_from_numpy(tuple(np.asarray(a) for a in wl), "cpu")
    fused = stream.arrival_plan(ops, 150_000).tok.numpy()
    stream.fma_f32 = _plain_fma
    plain = stream.arrival_plan(ops, 150_000).tok.numpy()
    stream.fma_f32 = saved
    print(f"token admissions differing over {want.size} burst-storm slots: "
          f"refill fused {int((fused != want).sum())}, unfused "
          f"{int((plain != want).sum())}")


if __name__ == "__main__":
    main()
