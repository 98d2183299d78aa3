"""K2's drawn schedule and shared-memory plan, and the exact-state rules of
its transition, on the CPU.

The kernel draws its schedule from launch words derived on the host
(``kernel.draw_words``: two subkeys, span, ``2**32 % span``, a division
magic, the first row and the row pitch of the counter). Those words go
through ``ref.drawn_schedule_plain``, a plain mirror of the kernel's
per-element arithmetic, and are held bitwise against
``jax.random.randint(jax.random.key(seed), shape, 0, T, int32)`` and, for
rows whose 64-bit counters pass 2**32, against the reference's threefry
primitive on those counters with randint's combine. The plan's Python
side (``kernel.tick_plan``) is checked here; ``chip_smoke.py`` compares it
with the C table of the built kernel. The transition's rules for hand-made
mid-run states (a predecessor or successor equal to the stepped thread,
PCs and links outside their ranges, scheduled threads out of range) are
held through ``alock_tick_plain`` against the reference's Pallas kernel in
interpret mode. Tolerance: zero everywhere.
"""
import numpy as np
import pytest
import torch

import torch_ref as R
from repro_torch.core import prng
from repro_torch.kernels.alock_tick import kernel as tk
from repro_torch.kernels.alock_tick import ops
from repro_torch.kernels.alock_tick.ref import (alock_tick_plain,
                                                drawn_schedule_plain)

jax, jnp = R.jax, R.jnp

SEEDS = (0, 1, 7, 2**31 - 1)
NAMES = ("tails", "victim", "pc", "budget", "nxt", "prev")


@pytest.mark.parametrize("T", [1, 3, 4, 16, 100])
@pytest.mark.parametrize("seed", SEEDS)
def test_launch_words_mirror_matches_jax_randint(seed, T):
    shape = (3, 41)
    words = tk.draw_words(seed, T, 0, shape[1])
    want = np.asarray(jax.random.randint(jax.random.key(seed), shape, 0, T,
                                         dtype=jnp.int32))
    R.assert_bitwise([want], [drawn_schedule_plain(words, *shape)])
    keys = np.asarray(jax.random.key_data(jax.random.split(
        jax.random.key(seed), 2)))
    assert keys.tolist() == [[words.hi0, words.hi1], [words.lo0, words.lo1]]


def _ref_randint_rows(seed, T, r0, rows, pitch, steps):
    """randint's combine on the reference's threefry primitive at the
    counters of rows ``r0 ..`` of a ``(*, pitch)`` draw: what
    ``jax.random.randint`` gives there (the whole draw is too large to
    make)."""
    from jax._src.prng import threefry2x32_p
    keys = np.asarray(jax.random.key_data(jax.random.split(
        jax.random.key(seed), 2)))
    c = ((np.uint64(r0) + np.arange(rows, dtype=np.uint64))[:, None]
         * np.uint64(pitch) + np.arange(steps, dtype=np.uint64)[None])
    hi_w = jnp.asarray((c >> np.uint64(32)).astype(np.uint32))
    lo_w = jnp.asarray((c & np.uint64(0xFFFFFFFF)).astype(np.uint32))

    def bits(k):
        b1, b2 = threefry2x32_p.bind(
            *(jnp.full(c.shape, v, jnp.uint32) for v in k), hi_w, lo_w)
        return (np.asarray(b1) ^ np.asarray(b2)).astype(np.uint64)
    span = np.uint64(max(T, 1))
    mult = np.uint64((1 << 32) % int(span))
    off = ((bits(keys[0]) % span) * mult + bits(keys[1]) % span) \
        & np.uint64(0xFFFFFFFF)
    return (off % span).astype(np.int32)


@pytest.mark.parametrize("T", [3, 16, 100])
def test_launch_words_rows_past_2_32(T):
    """Rows 29,000+ of a (30000, 150000) draw: counters carry into the hi
    word. The mirror equals the reference's primitive and the port's
    ``prng.randint(rows=)``."""
    r0, pitch, rows, steps = 29_000, 150_000, 2, 64
    assert r0 * pitch >= 1 << 32
    words = tk.draw_words(7, T, r0, pitch)
    got = drawn_schedule_plain(words, rows, steps)
    R.assert_bitwise([_ref_randint_rows(7, T, r0, rows, pitch, steps)],
                     [got])
    k = prng.key(torch.tensor(7, dtype=torch.int32))
    slab = prng.randint(k, (30_000, pitch), 0, T, rows=(r0, r0 + rows))
    assert torch.equal(slab[:, :steps], got)


@pytest.mark.parametrize("span", [3, 5, 6, 7, 12, 100, 1000, 12_345,
                                  65_537, 2**31 - 1])
def test_span_magic_divides_exactly(span):
    magic, shift = tk.span_magic(span)
    rng = np.random.default_rng(span)
    x = np.concatenate([
        rng.integers(0, 1 << 32, 20_000, dtype=np.uint64),
        np.array([0, 1, span - 1, span, span + 1, (1 << 32) - 1,
                  (1 << 32) - 2, (1 << 31), (1 << 31) - 1], np.uint64),
        (np.arange(1, 200, dtype=np.uint64) * np.uint64(span)
         + np.uint64(span - 1)) % np.uint64(1 << 32)])
    h = (x * np.uint64(magic)) >> np.uint64(32)
    q = (((x - h) >> np.uint64(1)) + h) >> np.uint64(shift)
    assert np.array_equal(q, x // np.uint64(span))


@pytest.mark.parametrize("T", [1, 2, 16, 64])
def test_power_of_two_span_draws_one_hash(T):
    """``2**32 % span`` is 0 for a power of two, so the higher bits drop
    out of randint's combine: the kernel draws only the lower bits."""
    words = tk.draw_words(3, T, 0, 50)
    assert words.mult == 0 and tk.span_magic(words.span) == (0, 0)
    flipped = words._replace(hi0=words.hi0 ^ 0xFFFF, hi1=words.hi1 ^ 1)
    assert torch.equal(drawn_schedule_plain(words, 4, 50),
                       drawn_schedule_plain(flipped, 4, 50))
    if T == 1:
        assert not drawn_schedule_plain(words, 4, 50).any()


def test_flipped_key_word_changes_the_draw():
    words = tk.draw_words(0, 5, 0, 200)
    base = drawn_schedule_plain(words, 8, 200)
    for f in ("hi0", "hi1", "lo0", "lo1"):
        bad = words._replace(**{f: getattr(words, f) ^ 1})
        assert not torch.equal(base, drawn_schedule_plain(bad, 8, 200)), f


# -- the shared-memory plan ---------------------------------------------------

def test_plan_at_the_path_shape():
    p = tk.tick_plan(16, 128, 4096, "drawn")
    assert (p.tables_per_block, p.chain_warps, p.draw_warps, p.stage_steps,
            p.stages) == (32, 1, 3, 64, 4)
    assert -(-4096 // p.tables_per_block) == 128     # blocks: ~one per SM
    assert tk.tick_plan(16, 128, 4096, "given").draw_warps == 1
    table = tk.smem_table(16, 1, 64, 4)
    assert table == {"barriers": (0, 64), "records": (64, 16 * 17 * 32),
                     "cohorts": (64 + 16 * 17 * 32, 4 * 16 * 32),
                     "ring": (10_816, 4 * 32 * 68 * 4)}
    assert p.smem_bytes == tk.layout_bytes(16, 1, 64, 4) == 45_632


@pytest.mark.parametrize("T,tile,mode,cw", [
    (3, 4, "given", 1), (16, 128, "drawn", 1), (100, 128, "drawn", 1),
    (300, 64, "given", 1), (200, 128, "given", 4), (16, 128, "drawn", 4),
    (340, 128, "drawn", 1)])
def test_plan_tables_agree(T, tile, mode, cw):
    """The fields ``chip_smoke.py`` compares with the C table
    (``alock_tick_smem_bytes(T, chain_warps, stage_steps, stages)``):
    the plan's bytes are its layout's, every region 16-byte aligned,
    disjoint and in order, and within the limit."""
    p = tk.tick_plan(T, tile, None, mode, chain_warps=cw)
    assert set(p.as_dict()) == {"mode", "T", "tables_per_block",
                                "chain_warps", "draw_warps", "stage_steps",
                                "stages", "smem_bytes"}
    assert p.smem_bytes == tk.layout_bytes(T, p.chain_warps, p.stage_steps,
                                           p.stages) <= tk.SMEM_LIMIT
    assert p.tables_per_block <= min(tile, 32 * p.chain_warps)
    end = 0
    for off, size in tk.smem_table(T, p.chain_warps, p.stage_steps,
                                   p.stages).values():
        assert off >= end and off % 16 == 0
        end = off + size
    assert end <= p.smem_bytes


def test_plan_shrinks_to_whole_warps():
    """Four warps of 200-thread tables do not fit: the block keeps the
    whole warps that do, then steps its ring down."""
    p = tk.tick_plan(200, 128, None, "given", chain_warps=4)
    assert p.chain_warps < 4 and p.tables_per_block == 32 * p.chain_warps
    assert tk.layout_bytes(200, p.chain_warps + 1, 8, 2) > tk.SMEM_LIMIT
    q = tk.tick_plan(340, 128, None, "drawn")
    assert (q.stage_steps, q.stages) < (64, 4) and q.chain_warps == 1
    assert tk.layout_bytes(340, 1, 64, 2) > tk.SMEM_LIMIT


def test_plan_raises_at_the_limit():
    with pytest.raises(ValueError, match="232,448 B of shared memory"):
        tk.tick_plan(400, 128)
    with pytest.raises(ValueError, match="multiple of 4"):
        tk.tick_plan(16, 128, stage_steps=30)
    with pytest.raises(ValueError, match="at most 8 in all"):
        tk.tick_plan(16, 128, chain_warps=4, draw_warps=5)
    with pytest.raises(ValueError, match="'given' or 'drawn'"):
        tk.tick_plan(16, 128, mode="draw_only")


def test_tile_caps_tables_per_block():
    assert tk.tick_plan(16, 8, 100).tables_per_block == 8
    assert tk.tick_plan(16, 128, 5).tables_per_block == 5
    assert tk.tick_plan(16, 128, 300, chain_warps=4).tables_per_block == 128


def test_drawn_wrappers_refuse_cpu_tensors():
    """The drawn launchers take CUDA tensors or raise, and count
    nothing."""
    state = ops.fresh_tables(3, 2, device="cpu")
    coh = torch.zeros((3, 2), dtype=torch.int32)
    before = tk.LIB.launches()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tk.tick_drawn(*state, coh, seed=0, steps=5)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tk.draw_schedule(3, 5, 2, device="cpu")
    assert tk.LIB.launches() == before
    assert "plan" in ops.exec_stats()


# -- the exact-state rules ----------------------------------------------------

def _ref_kernel(state, sched, coh, b_init, tile):
    out = R.ref_tick_kernel.alock_tick(
        *map(jnp.asarray, state), jnp.asarray(sched), jnp.asarray(coh),
        b_init=b_init, tile=tile, interpret=True)
    return [np.array(o) for o in out]


def _plain(state, sched, coh, b_init):
    return alock_tick_plain(*map(torch.from_numpy, state),
                            torch.from_numpy(sched), torch.from_numpy(coh),
                            b_init=b_init)


@pytest.mark.parametrize("rng_seed,Tab,T,steps,tile",
                         [(5, 8, 4, 60, 4), (11, 6, 3, 40, 4)])
def test_pred_and_succ_equal_to_tid(rng_seed, Tab, T, steps, tile):
    """Thread t at WRITE_NEXT with prev = t + 1 (its own predecessor) and
    thread u at PASS with next = u + 1 (its own successor), stepped first:
    the own record's store and the remote field's store land on one
    record, and the remote one wins, as the reference's masks leave it."""
    rng = np.random.default_rng(rng_seed)
    pc = np.full((Tab, T), 0, np.int32)
    bud = rng.integers(-1, 4, (Tab, T)).astype(np.int32)
    nxt = np.zeros((Tab, T), np.int32)
    prev = np.zeros((Tab, T), np.int32)
    first = np.zeros((Tab, 2), np.int32)
    for k in range(Tab):
        t, u = rng.choice(T, 2, replace=False)
        pc[k, t], prev[k, t] = 2, t + 1          # WRITE_NEXT, pred == tid
        pc[k, u], nxt[k, u] = 11, u + 1          # PASS, succ == tid
        first[k] = (t, u)
    state = [rng.integers(0, T + 1, (Tab, 2)).astype(np.int32),
             rng.integers(0, 2, (Tab, 1)).astype(np.int32), pc, bud, nxt,
             prev]
    sched = np.concatenate([first, rng.integers(0, T, (Tab, steps - 2))],
                           1).astype(np.int32)
    coh = rng.integers(0, 2, (Tab, T)).astype(np.int32)
    want = _ref_kernel(state, sched, coh, (2, 3), tile)
    R.assert_bitwise(want, _plain(state, sched, coh, (2, 3)), NAMES)
    one = _plain(state, sched[:, :2].copy(), coh, (2, 3))
    rows = np.arange(Tab)
    assert np.array_equal(one[4].numpy()[rows, first[:, 0]],
                          first[:, 0] + 1)              # nxt[t] = t + 1
    assert np.array_equal(one[3].numpy()[rows, first[:, 1]],
                          bud[rows, first[:, 1]] - 1)    # budget[u] - 1


@pytest.mark.parametrize("rng_seed", [0, 1, 2])
def test_mid_run_states_out_of_range(rng_seed):
    """Hand-made states with PCs outside the twelve, links and tails
    outside [0, T], cohorts other than 0 and 1, and scheduled threads out
    of range: every such rule as the reference's kernel applies it."""
    rng = np.random.default_rng(rng_seed)
    Tab, T, steps = 8, 4, 60
    state = [rng.integers(-1, T + 2, (Tab, 2)).astype(np.int32),
             rng.integers(-1, 3, (Tab, 1)).astype(np.int32),
             rng.integers(-2, 14, (Tab, T)).astype(np.int32),
             rng.integers(-2, 4, (Tab, T)).astype(np.int32),
             rng.integers(-1, T + 2, (Tab, T)).astype(np.int32),
             rng.integers(-1, T + 2, (Tab, T)).astype(np.int32)]
    sched = rng.integers(-2, T + 2, (Tab, steps)).astype(np.int32)
    coh = rng.integers(0, 3, (Tab, T)).astype(np.int32)
    want = _ref_kernel(state, sched, coh, (1, 2), 4)
    R.assert_bitwise(want, _plain(state, sched, coh, (1, 2)), NAMES)
