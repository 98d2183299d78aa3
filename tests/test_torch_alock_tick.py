"""The port's batched ALock tables (K2's plain versions, ``alock_tick``,
``monte_carlo_cs_entries``) and its shaped schedule stream against the JAX
reference, on the CPU.

The same seeded numpy inputs go through the reference — its Pallas kernel
``alock_tick`` in interpret mode, as ``tests/test_sim_and_kernels.py``
runs it, and its oracle ``alock_tick_ref`` — and through the port, which
on CPU tensors takes the plain version. Tolerance: zero — every output is
int32 (``in_cs_frac`` an f32 value compared with ``==``). Shapes are the
reference tests' (Tab 8, T 4, 300 steps, tile 4; Tab 6, T 3, 150 steps,
tile 4, which pads). The CUDA kernel itself runs only on the card, where
``chip_smoke.py`` holds it against ``alock_tick_plain``.
"""
import numpy as np
import pytest
import torch

import torch_ref as R
from repro_torch.core import machine as mc
from repro_torch.core import prng
from repro_torch.kernels.alock_tick import kernel as tk
from repro_torch.kernels.alock_tick import ops
from repro_torch.kernels.alock_tick.kernel import alock_tick
from repro_torch.kernels.alock_tick.ref import alock_tick_plain, alock_tick_ref

jax, jnp = R.jax, R.jnp

NAMES = ("tails", "victim", "pc", "budget", "nxt", "prev")
# (rng seed, Tab, T, steps, tile): the reference tests' two shapes
SHAPES = [(5, 8, 4, 300, 4), (11, 6, 3, 150, 4)]


def _fresh(Tab, T):
    return [np.zeros((Tab, 2), np.int32), np.zeros((Tab, 1), np.int32),
            np.full((Tab, T), mc.NCS, np.int32),
            np.full((Tab, T), -1, np.int32), np.zeros((Tab, T), np.int32),
            np.zeros((Tab, T), np.int32)]


def _ref_kernel(state, sched, coh, b_init, tile):
    out = R.ref_tick_kernel.alock_tick(
        *map(jnp.asarray, state), jnp.asarray(sched), jnp.asarray(coh),
        b_init=b_init, tile=tile, interpret=True)
    return [np.array(o) for o in out]


def _port(state, sched, coh, b_init, tile):
    return alock_tick(*map(torch.from_numpy, state), torch.from_numpy(sched),
                      torch.from_numpy(coh), b_init=b_init, tile=tile)


@pytest.mark.parametrize("rng_seed,Tab,T,steps,tile", SHAPES)
def test_plain_and_oracle_match_reference(rng_seed, Tab, T, steps, tile):
    rng = np.random.default_rng(rng_seed)
    coh = rng.integers(0, 2, T).astype(np.int32)
    sched = rng.integers(0, T, (Tab, steps)).astype(np.int32)
    state = _fresh(Tab, T)
    coh_tab = np.broadcast_to(coh, (Tab, T)).copy()
    want = _ref_kernel(state, sched, coh_tab, (2, 3), tile)
    R.assert_bitwise(want, _port(state, sched, coh_tab, (2, 3), tile), NAMES)
    R.assert_bitwise(want, alock_tick_plain(
        *map(torch.from_numpy, state), torch.from_numpy(sched),
        torch.from_numpy(coh_tab), b_init=(2, 3), tile=tile), NAMES)
    # the oracle's contract: victim (Tab,), shared cohorts, b_init array
    s1 = list(state)
    s1[1] = s1[1][:, 0]
    b = np.array([2, 3], np.int32)
    ref = R.ref_tick_ref.alock_tick_ref(
        *map(jnp.asarray, s1), jnp.asarray(sched), jnp.asarray(coh),
        jnp.asarray(b))
    got = alock_tick_ref(*map(torch.from_numpy, s1), torch.from_numpy(sched),
                         torch.from_numpy(coh), b)
    R.assert_bitwise([np.asarray(r) for r in ref], got, NAMES)


@pytest.mark.parametrize("b_init", [(5, 20), (1, 1), (3, 1)])
def test_per_table_cohorts_match_reference_kernel(b_init):
    """Cohorts that differ from table to table, mid-run state as input
    (the output of a first run), and several budget pairs."""
    rng = np.random.default_rng(sum(b_init))
    Tab, T, steps = 9, 5, 200
    coh = rng.integers(0, 2, (Tab, T)).astype(np.int32)
    sched = rng.integers(0, T, (Tab, steps)).astype(np.int32)
    mid = _ref_kernel(_fresh(Tab, T), sched[:, ::-1].copy(), coh, b_init, 4)
    want = _ref_kernel(mid, sched, coh, b_init, 4)
    R.assert_bitwise(want, _port(mid, sched, coh, b_init, 4), NAMES)


def test_out_of_range_threads_change_nothing():
    """Schedule entries outside [0, T) select no thread in the reference
    kernel's one-hot masks: the table stays as it was."""
    rng = np.random.default_rng(3)
    Tab, T, steps = 4, 4, 120
    coh = np.broadcast_to(np.array([0, 1, 0, 1], np.int32), (Tab, T)).copy()
    sched = rng.integers(-2, T + 2, (Tab, steps)).astype(np.int32)
    want = _ref_kernel(_fresh(Tab, T), sched, coh, (2, 3), 4)
    R.assert_bitwise(want, _port(_fresh(Tab, T), sched, coh, (2, 3), 4),
                     NAMES)


@pytest.mark.parametrize("rng_seed,Tab,T,steps,tile", SHAPES)
def test_plain_matches_python_machine(rng_seed, Tab, T, steps, tile):
    rng = np.random.default_rng(rng_seed + 100)
    coh = rng.integers(0, 2, T).astype(np.int32)
    sched = rng.integers(0, T, (Tab, steps)).astype(np.int32)
    out = _port(_fresh(Tab, T), sched, np.broadcast_to(coh, (Tab, T)).copy(),
                (2, 3), tile)
    for t in range(Tab):
        st_ = mc.initial_state(T)
        for tid in sched[t]:
            st_, _ = mc.alock_step(st_, int(tid), int(coh[tid]), (2, 3))
        assert tuple(out[2][t].tolist()) == st_.pc
        assert tuple(out[0][t].tolist()) == st_.tail
        assert int(out[1][t, 0]) == st_.victim
        assert tuple(out[3][t].tolist()) == st_.budget
        assert tuple(out[4][t].tolist()) == st_.next
        assert tuple(out[5][t].tolist()) == st_.prev


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1])
def test_monte_carlo_matches_reference(seed):
    args = (7, 4, 90, (0, 0, 1, 1))
    ref = R.ref_tick_ops.monte_carlo_cs_entries(*args, seed=seed,
                                                use_kernel=False)
    got = ops.monte_carlo_cs_entries(*args, seed=seed, device="cpu")
    assert got["in_cs_frac"] == ref["in_cs_frac"]
    assert np.array_equal(got["final_pc_histogram"].numpy(),
                          np.asarray(ref["final_pc_histogram"]))


def test_monte_carlo_matches_reference_kernel_path():
    """The reference's kernel path (interpret mode), remote-heavy cohorts,
    other budgets, a table count that is not a power of two."""
    args = (6, 5, 70, (1, 0, 1, 1, 0))
    ref = R.ref_tick_ops.monte_carlo_cs_entries(*args, b_init=(2, 7),
                                                seed=9, use_kernel=True,
                                                interpret=True)
    got = ops.monte_carlo_cs_entries(*args, b_init=(2, 7), seed=9,
                                     backend="plain", device="cpu")
    assert got["in_cs_frac"] == ref["in_cs_frac"]
    assert np.array_equal(got["final_pc_histogram"].numpy(),
                          np.asarray(ref["final_pc_histogram"]))


@pytest.mark.parametrize("shape", [(1,), (600,), (300, 2), (3, 4, 5),
                                   (1200, 1)])
def test_in_cs_fraction_is_the_reference_mean(shape):
    """XLA's f32 mean of 0/1 values, last bit included."""
    rng = np.random.default_rng(len(shape) * 1000 + shape[0])
    pc = rng.integers(0, 12, shape).astype(np.int32)
    want = float(jnp.mean(jnp.asarray(pc) == mc.CS))
    assert ops.in_cs_fraction(torch.from_numpy(pc)) == want


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("shape,lo,hi", [((5, 300), 0, 16), ((4, 33), 0, 3),
                                         ((7,), 2, 9), ((2, 3, 5), -4, 100),
                                         ((), 0, 16), ((3, 4), 5, 5)])
def test_shaped_randint_bitwise(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.key(seed), shape, lo,
                                         hi, dtype=jnp.int32))
    k = prng.key(torch.tensor(seed, dtype=torch.int32))
    got = prng.randint(k, shape, lo, hi)
    R.assert_bitwise([want], [got])
    if len(shape) > 1:          # any slab of rows is its part of the draw
        got_rows = torch.cat([prng.randint(k, shape, lo, hi, rows=(r, r + 1))
                              for r in range(shape[0])])
        R.assert_bitwise([want], [got_rows])


def test_random_bits_counter_hi_word():
    """Past 2**32 elements the flat index carries into the counter's hi
    word: a slab of a (2**20, 2**13) draw against the reference's
    threefry primitive on the same (hi, lo) counters."""
    from jax._src.prng import threefry2x32_p
    shape, r0 = (1 << 20, 1 << 13), 600_000
    c = np.arange(r0 << 13, (r0 + 2) << 13, dtype=np.uint64)
    assert (c >> 32).min() > 0
    k1, k2 = np.uint32(0), np.uint32(123)
    b1, b2 = threefry2x32_p.bind(
        *(jnp.full(c.shape, v, jnp.uint32) for v in (k1, k2)),
        jnp.asarray((c >> 32).astype(np.uint32)),
        jnp.asarray((c & 0xFFFFFFFF).astype(np.uint32)))
    want = (np.asarray(b1) ^ np.asarray(b2)).astype(np.int64).reshape(2, -1)
    got = prng.random_bits((torch.tensor(0), torch.tensor(123)), shape,
                           rows=(r0, r0 + 2))
    R.assert_bitwise([want], [got])


def test_schedule_slabs_change_nothing(monkeypatch):
    want = np.asarray(jax.random.randint(jax.random.key(5), (9, 37), 0, 6,
                                         dtype=jnp.int32))
    monkeypatch.setattr(ops, "SCHED_CHUNK_ELEMS", 80)   # 2 rows per slab
    R.assert_bitwise([want], [ops.schedule(9, 37, 6, seed=5,
                                           device="cpu")])


def test_tile_changes_no_result():
    rng = np.random.default_rng(2)
    Tab, T = 13, 4
    coh = rng.integers(0, 2, (Tab, T)).astype(np.int32)
    sched = rng.integers(0, T, (Tab, 80)).astype(np.int32)
    outs = [_port(_fresh(Tab, T), sched, coh, (2, 3), tile)
            for tile in (1, 4, 128)]
    for o in outs[1:]:
        R.assert_bitwise([x.numpy() for x in outs[0]], o, NAMES)


def test_fresh_tables_match_reference():
    ref = R.ref_tick_ops.fresh_tables(5, 3)
    R.assert_bitwise([np.asarray(r) for r in ref],
                     ops.fresh_tables(5, 3, device="cpu"), NAMES)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.monte_carlo_cs_entries(4, 2, 10, (0, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.fresh_tables(4, 2)


def test_kernel_backend_on_cpu_raises():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        ops.monte_carlo_cs_entries(4, 2, 10, (0, 1), backend="kernel",
                                   device="cpu")
    state = [torch.from_numpy(a) for a in _fresh(3, 2)]
    sched = torch.zeros((3, 5), dtype=torch.int32)
    coh = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        alock_tick(*state, sched, coh, backend="kernel")


def test_kernel_wrapper_refuses_cpu_tensors():
    """The launcher takes CUDA tensors or raises, and counts nothing."""
    state = [torch.from_numpy(a) for a in _fresh(3, 2)]
    before = tk.LIB.launches()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tk.tick_kernel(*state, torch.zeros((3, 5), dtype=torch.int32),
                       torch.zeros((3, 2), dtype=torch.int32))
    assert tk.LIB.launches() == before


def test_shape_checks():
    state = [torch.from_numpy(a) for a in _fresh(3, 2)]
    with pytest.raises(ValueError, match="expected tails"):
        alock_tick(*state, torch.zeros((2, 5), dtype=torch.int32),
                   torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="expected tails"):
        alock_tick(*state, torch.zeros((3, 5), dtype=torch.int32),
                   torch.zeros((2,), dtype=torch.int32))
    with pytest.raises(ValueError, match="tile must be >= 1"):
        alock_tick(*state, torch.zeros((3, 5), dtype=torch.int32),
                   torch.zeros((3, 2), dtype=torch.int32), tile=0)


def test_smem_budget():
    # the path shape: one warp of 32 tables of 16 threads a block (about
    # one block per SM at 4,096 tables): barriers, 16-byte records (and a
    # scratch record a table), cohorts, a ring of 4 stages of 64 steps
    assert tk.smem_bytes(16, 128) == (64 + 16 * 17 * 32 + 4 * 16 * 32
                                      + 4 * 4 * 32 * 68)
    assert tk.tables_per_block(16, 128) == 32
    # the tables of a block are whole warps of them
    per = tk.tables_per_block(200, 128)
    assert per % 32 == 0 and 0 < per < 128
    assert tk.smem_bytes(200, 128) == (64 + 16 * 201 * per + 4 * 200 * per
                                       + 4 * 4 * per * 68) <= tk.SMEM_LIMIT
    with pytest.raises(ValueError, match="232,448 B of shared memory"):
        tk.smem_bytes(400, 128)
