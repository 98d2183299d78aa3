"""The event-loop kernel's shared-memory planner (``kernels/event_loop/
smem_plan.py``), on the CPU: no kernel is built or launched.

The cases of the reference's ``tests/test_vmem_planner.py`` that carry
over to one block of ``W`` replica regions: the block's table is ``W``
times one replica's ``smem_table``; an oversize request shrinks by halving,
deterministically; a shape whose one region cannot fit raises an
actionable error; the plan surfaces through ``exec_stats()["smem_plan"]``;
the tail block's replica count is right. The C side's table is compared
with this one on the card (``chip_smoke.py``, kernel_check).
"""
import pytest

from repro_torch.core import batch
from repro_torch.kernels.event_loop import smem_plan as sp

SHAPES = [
    ("alock", 160, 20, 1000, 1, 0),       # the widest Fig. 5 bucket
    ("mcs", 40, 5, 20, 1, 0),
    ("hlock", 16, 4, 16, 3, 0),
    ("alock-rw", 16, 4, 16, 2, 0),
    ("alock", 16, 4, 16, 1, 256),         # the open-loop registry shape
    ("spinlock", 16, 4, 16, 3, 256),
]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("warps", [1, 3, 8])
def test_block_table_is_w_times_the_replica_table(shape, warps):
    alg, T, N, K, P, R = shape
    plan = sp.plan_smem(alg, 64, T, N, K, P, R, warps=warps)
    per = sp.smem_table(alg, T, N, K, P, R)
    W = plan.warps
    assert plan.breakdown == {n: W * b for n, b in per.items()}
    assert plan.replica_bytes == sum(per.values()) \
        == sp.smem_bytes(alg, T, N, K, P, R)
    assert plan.region_bytes % sp.REGION_ALIGN == 0
    assert 0 <= plan.region_bytes - plan.replica_bytes < sp.REGION_ALIGN
    assert plan.total_bytes == W * plan.region_bytes <= sp.SMEM_LIMIT
    assert sum(plan.breakdown.values()) <= plan.total_bytes
    # the per-replica rows the kernel carves, in its order: 8-byte clocks
    # first, 16-bit lock rows last
    names = list(per)
    assert names[:3] == ["ready", "op_start", "busy"]
    assert names[-1] == "lock_node" and "tail0/word" in names


def test_oversize_request_shrinks_deterministically():
    # one region of ~65 KB: 8 regions do not fit 227 KB, 4 do not, 2 do
    args = ("alock", 64, 16, 4, 8000, 1)
    p1 = sp.plan_smem(*args, warps=8)
    p2 = sp.plan_smem(*args, warps=8)
    assert p1 == p2                                  # deterministic
    assert p1.requested_warps == 8 and p1.shrunk
    assert p1.warps == 2 and p1.total_bytes <= sp.SMEM_LIMIT
    # halving: the next-larger count would not have fit
    assert 2 * p1.warps * p1.region_bytes > sp.SMEM_LIMIT
    d = p1.as_dict()
    assert d["shrunk"] and d["warps"] == 2 and d["requested_warps"] == 8
    # a tighter limit of the caller's shrinks further, the same way
    tight = sp.plan_smem(*args, warps=8, limit=p1.region_bytes + 1)
    assert tight.warps == 1 and tight.shrunk
    # a request that fits is kept
    roomy = sp.plan_smem("alock", 96, 160, 20, 1000, 1, warps=8)
    assert roomy.warps == 8 and not roomy.shrunk


def test_impossible_shape_raises_actionably():
    with pytest.raises(ValueError, match="tail0/word") as ei:
        sp.plan_smem("alock", 4, 160, 20, 40_000, 1, warps=1)
    assert "n_locks" in str(ei.value)
    with pytest.raises(ValueError, match="max_requests"):
        sp.plan_smem("mcs", 4, 16, 4, 16, 3, 10_000, warps=2)
    # a limit below one region, and bad arguments, are errors too
    with pytest.raises(ValueError, match="limit"):
        sp.plan_smem("mcs", 4, 16, 4, 16, 1, warps=1, limit=1000)
    with pytest.raises(ValueError, match="warps"):
        sp.plan_smem("mcs", 4, 16, 4, 16, 1, warps=0)
    with pytest.raises(ValueError, match="B"):
        sp.plan_smem("mcs", 0, 16, 4, 16, 1, warps=1)
    with pytest.raises(ValueError, match="unknown algorithm"):
        sp.plan_smem("ticket", 4, 16, 4, 16, 1, warps=1)


def test_plan_surfaces_through_exec_stats():
    batch.reset_exec_stats()
    assert batch.exec_stats()["smem_plan"] is None
    plan = sp.plan_for_run("alock", 192, 16, 4, 16, 3, 256, n_sm=132)
    st = batch.exec_stats()
    assert st["smem_plan"] == plan.as_dict()
    assert st["smem_plan"]["warps"] == 2          # 192 replicas, 132 SMs
    assert st["smem_plan"]["blocks"] == 96
    batch.reset_exec_stats()
    assert batch.exec_stats()["smem_plan"] is None


@pytest.mark.parametrize("B,warps,want", [
    (7, 3, (3, 3, 1)),        # 3 + 3 + 1
    (9, 8, (5, 2, 4)),        # evened out: two blocks, 5 + 4, not 8 + 1
    (96, 8, (8, 12, 8)),
    (97, 8, (8, 13, 1)),
    (1, 8, (1, 1, 1)),
    (5, 1, (1, 5, 1)),
])
def test_tail_block_replica_count(B, warps, want):
    plan = sp.plan_smem("mcs", B, 16, 4, 16, 1, warps=warps)
    assert (plan.warps, plan.blocks, plan.tail_replicas) == want
    assert (plan.blocks - 1) * plan.warps + plan.tail_replicas == B
    assert 1 <= plan.tail_replicas <= plan.warps


@pytest.mark.parametrize("B,n_sm,want", [
    (96, 132, 1), (132, 132, 1), (133, 132, 2), (192, 132, 2),
    (5000, 132, sp.MAX_WARPS), (1, 132, 1)])
def test_default_request_spreads_a_launch_over_the_card(B, n_sm, want):
    assert sp.default_warps(B, n_sm) == want
