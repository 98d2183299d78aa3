"""The plain reference against the program's plain PyTorch engine on the
CPU, bit for bit, at small sizes: every algorithm, phases, a down node,
Zipf keys, cost profiles, fail-slow nodes, racks, readers, and the open
loop with its queue bound and token bucket."""
import numpy as np
import pytest
import torch

from simbench import check
from simbench.program import to_workload
from simbench.reference import engine, prng, spec, stream

N_EVENTS, N_SEEDS = 100, 2
SEED = 2**31 - 100

CASES = {
    "alock": dict(alg="alock", n_nodes=2, threads_per_node=3, n_locks=8,
                  locality=0.9),
    "mcs": dict(alg="mcs", n_nodes=3, threads_per_node=2, n_locks=9,
                locality=0.85),
    "spinlock": dict(alg="spinlock", n_nodes=3, threads_per_node=2,
                     n_locks=6, locality=0.5),
    "phases": dict(alg="alock", n_nodes=4, threads_per_node=2, n_locks=8,
                   locality=0.95, zipf_s=1.2,
                   phases=[dict(frac=0.3), dict(frac=0.4, down_nodes=[3]),
                           dict(frac=0.3, cost="congested-nic",
                                b_init=[2, 40])]),
    "fail-slow": dict(alg="mcs", n_nodes=4, threads_per_node=2, n_locks=8,
                      locality={"local": 0.95, "frac": 0.5, "rest": 0.5},
                      node_mult={"0": 4.0}, think="short"),
    "hlock": dict(alg="hlock", n_nodes=4, threads_per_node=2, n_locks=8,
                  locality=0.7, topology=[0, 0, 1, 1]),
    "alock-rw": dict(alg="alock-rw", n_nodes=2, threads_per_node=3,
                     n_locks=8, locality=0.9, read_frac=0.8),
    "open": dict(alg="alock", n_nodes=4, threads_per_node=4, n_locks=16,
                 locality=0.95,
                 arrivals=dict(rate_per_us=16.0, max_requests=24,
                               queue_cap=4)),
    "open-token": dict(alg="mcs", n_nodes=4, threads_per_node=2, n_locks=8,
                       locality=0.95,
                       phases=[dict(frac=0.4), dict(frac=0.2, rate_per_us=12.0),
                               dict(frac=0.4, down_nodes=[1])],
                       arrivals=dict(rate_per_us=1.0, max_requests=24,
                                     token_rate_per_us=2.0,
                                     token_burst=4.0)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_the_plain_engine(name):
    from repro_torch.core.batch import sweep
    d = dict(CASES[name], seed=SEED)
    br = sweep([to_workload(d)], n_seeds=N_SEEDS, n_events=N_EVENTS,
               device="cpu")[0]
    lw = spec.lower(d, N_EVENTS)
    reps = [engine.run(lw, SEED + s, N_EVENTS) for s in range(N_SEEDS)]
    for s, r in enumerate(reps):
        got = {"done": br.per_thread_ops[s], "lat": br.lat_ns[s],
               "sim_ns": br.sim_ns[s], "reacquires": br.reacquires[s],
               "passes": br.passes[s]}
        if br.open_loop:
            got.update(arr=br.arr_ns[s], wait=br.wait_ns[s],
                       sojourn=br.sojourn_ns[s], rstat=br.rstat[s])
        assert check.differing(got, check.as_arrays(r)) == 0
    want = check.rows_of(reps)
    rows = {"mean_mops": br.mean_mops, "ci95_mops": br.ci95_mops,
            "mean_lat_us": br.mean_lat_us, "p50_lat_ns": br.p50_lat_ns,
            "p99_lat_ns": br.p99_lat_ns}
    if br.open_loop:
        rows["serving"] = br.serving_mean()
    assert check.rows_differing(rows, want) == 0


def test_draws_match_the_program_at_large_counters():
    from repro_torch.core import prng as tprng
    seeds = np.array([0, 1, 2**31 - 1, -5], np.int32)
    ev = np.array([0, 7, 149_999, 2**32 - 3], np.int64)
    k = tprng.key(torch.from_numpy(seeds))
    sub = tprng.split(tprng.fold_in((k[0][:, None], k[1][:, None]),
                                    torch.from_numpy(ev)[None]), 3)
    u = tprng.uniform((sub[0][0], sub[1][0]))
    r = tprng.randint((sub[0][1], sub[1][1]), (), 0, 19)
    for b, sd in enumerate(seeds):
        rsub = prng.split(prng.fold_in(prng.key(int(sd)), ev), 3)
        np.testing.assert_array_equal(prng.uniform(rsub[0]), u[b].numpy())
        np.testing.assert_array_equal(prng.randint(rsub[1], 0, 19),
                                      r[b].numpy())


def test_log1p_matches_the_program():
    from repro_torch.traffic.stream import log1p_f32
    x = -np.random.default_rng(0).random(20_000, np.float32)
    x = np.concatenate([x, np.float32([0.0, -0.5, -0.41421357, -1e-30])])
    want = log1p_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(stream.log1p_f32(x), want)


def test_bf16_rounds_to_nearest_even_and_uniforms_down():
    x = np.float32([1.0, 1.00390625, 1.005859375, 0.9, -3.0])
    assert stream.bf16(x).tolist() == [1.0, 1.0, 1.0078125, 0.8984375,
                                       -3.0]
    u = np.float32([0.99999994, 0.5, 0.9])
    assert stream.bf16_down(u).tolist() == [0.99609375, 0.5, 0.8984375]
