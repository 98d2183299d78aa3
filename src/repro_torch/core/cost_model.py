"""RDMA cluster cost model (calibrated to the paper's CloudLab/CX3 setup).

Three effects drive the paper's results and are modeled explicitly:
  1. operation asymmetry — shared-memory ops ~100ns vs one-sided RDMA ~1.5us;
  2. RNIC serialization + loopback PCIe pressure — every RDMA op occupies the
     target card for `rnic_svc_ns`; loopback traffic additionally inflates
     service linearly in the number of co-located loopback-active threads
     past a knee (Fig. 1's rise-then-collapse);
  3. QP-context thrashing — past ~450 cached QPs (StaR), service inflates.

All factors that depend only on the configuration (thread/node counts,
algorithm) are precomputed to integer-ns scalars — the 8 *cost rows* of
:meth:`CostModel.cost_rows` — so the event loop stays branch-light.

Named profiles
--------------
A :class:`CostProfile` is a :class:`CostModel` with a name, registered in
:data:`COST_PROFILES`. Profiles let a ``repro_torch.workloads.Workload`` (or a
single :class:`~repro_torch.workloads.Phase` of one) swap the whole ns table —
e.g. a mid-run NIC-congestion burst — while the table stays a *traced
operand* of the engines, so mixing profiles never adds a compile:

>>> from repro_torch.core.cost_model import COST_PROFILES, CostProfile
>>> sorted(COST_PROFILES)
['congested-nic', 'default', 'idle-nic']
>>> COST_PROFILES["default"].cost_rows("alock", 2, 2)
(100, 400, 250, 300, 250, 250, 1500, 1800)
>>> c = COST_PROFILES["congested-nic"]
>>> c.rnic_svc_ns > CostProfile().rnic_svc_ns
True

``resolve_cost`` is the single coercion point the workload layer uses:
``None`` (inherit), a profile name, an explicit model, or a field-override
mapping all resolve to a concrete :class:`CostModel`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# Width of the cost_rows() table the engines consume. Row order: (local,
# poll, cs, think, svc_remote, svc_loopback, wire_remote, wire_loopback).
# Index 3 (think) is carried for layout parity with the legacy topology()
# tuple; the engines take think time from the separate per-phase
# ``think_ns`` operand (which folds in the spec's think multiplier).
N_COST_ROWS = 8


@dataclass(frozen=True)
class CostModel:
    # Constant provenance: the defaults reproduce the paper's testbed
    # (CloudLab r320/c6220 nodes, ConnectX-3 RNICs; evaluation setup in
    # §5, mechanisms in §2). Per-constant anchors:
    local_ns: float = 100.0        # shared-memory op (§2: ALock's local
    #   cohort never touches the RNIC; ~100ns cache-coherent CAS/read)
    spin_poll_ns: float = 400.0    # local spin re-check interval (§3:
    #   descriptor polling cadence of the embedded MCS queues)
    remote_wire_ns: float = 1500.0  # one-sided RDMA wire+DMA latency
    #   (§5/Fig. 6: ~1.5us median one-sided verb on CX3)
    loopback_wire_ns: float = 1800.0  # loopback: PCIe down+up through the
    #   card (§2: loopback pays the PCIe round trip twice; > remote wire)
    rnic_svc_ns: float = 250.0     # per-op card occupancy (§5: CX3
    #   saturates at ~3-4 Mops/s of one-sided ops => ~250-330ns/op)
    cs_ns: float = 250.0           # critical-section body (§5 workload:
    #   short CS touching a few cached lines)
    think_ns: float = 300.0        # app work between lock ops (§5
    #   workload generator's inter-op gap)
    pcie_knee: int = 2             # threads of loopback traffic a card
    #   absorbs before RX-buffer/PCIe pressure shows (Fig. 1's knee)
    pcie_beta: float = 0.8         # loopback service inflation per extra
    #   thread past the knee (Fig. 1's collapse slope)
    qp_cache: int = 450            # QPC cache capacity (StaR; §2 cites
    #   QP-context thrashing past ~450 cached QPs)
    qp_alpha: float = 1.2          # service inflation slope past the cache
    thrash_cap: float = 5.0        # inflation ceiling (thrashed service
    #   plateaus rather than diverging)

    def qp_count(self, n_nodes: int, threads_per_node: int,
                 uses_loopback: bool) -> int:
        """QPs a single card must track. ALock drops the loopback share
        (~1/n of the system's QPs, §2 of the paper)."""
        t, n = threads_per_node, n_nodes
        inbound = (n - 1) * t
        outbound = t * max(n - 1, 0)
        loop = t if uses_loopback else 0
        return inbound + outbound + 2 * loop

    def thrash_factor(self, n_nodes: int, threads_per_node: int,
                      uses_loopback: bool) -> float:
        qps = self.qp_count(n_nodes, threads_per_node, uses_loopback)
        if qps <= self.qp_cache:
            return 1.0
        return min(1.0 + self.qp_alpha * (qps / self.qp_cache - 1.0),
                   self.thrash_cap)

    def loopback_factor(self, threads_per_node: int,
                        uses_loopback: bool) -> float:
        """PCIe/RX-buffer pressure from loopback traffic (Fig. 1)."""
        if not uses_loopback:
            return 1.0
        extra = max(0, threads_per_node - self.pcie_knee)
        return 1.0 + self.pcie_beta * extra

    def svc_ns(self, n_nodes: int, threads_per_node: int,
               uses_loopback: bool, is_loopback_op: bool) -> float:
        f = self.thrash_factor(n_nodes, threads_per_node, uses_loopback)
        if is_loopback_op:
            f *= self.loopback_factor(threads_per_node, uses_loopback)
        return self.rnic_svc_ns * f

    def cost_rows(self, alg: str, n_nodes: int,
                  threads_per_node: int) -> tuple[int, ...]:
        """The 8 integer-ns cost rows the event loop consumes, in operand
        order: ``(local, poll, cs, think, svc_remote, svc_loopback,
        wire_remote, wire_loopback)``.

        This is the single source of the row arithmetic — ``sim.topology``
        and the workload lowering both call it, which is what keeps a
        default-profile :class:`~repro_torch.workloads.Workload` bitwise-equal
        to the pre-profile engine (asserted in tests).
        """
        uses_loopback = alg != "alock"
        return tuple(int(round(v)) for v in (
            self.local_ns, self.spin_poll_ns, self.cs_ns, self.think_ns,
            self.svc_ns(n_nodes, threads_per_node, uses_loopback, False),
            self.svc_ns(n_nodes, threads_per_node, uses_loopback, True),
            self.remote_wire_ns, self.loopback_wire_ns,
        ))


@dataclass(frozen=True)
class CostProfile(CostModel):
    """A named :class:`CostModel` ns table (frozen, hashable — rides
    inside ``Workload``/``Phase`` specs as the ``cost`` field)."""
    name: str = "default"


# Named profiles for phase programs. "default" must stay field-for-field
# identical to CostModel() — the bitwise contract of every pre-profile
# workload rests on it (tests assert the rows match).
COST_PROFILES: dict[str, CostProfile] = {
    "default": CostProfile(),
    # An unloaded fabric: the card is below its serialization point and
    # the wire is quiet — service/wire at the low end of the paper's §5
    # microbenchmark range.
    "idle-nic": CostProfile(
        name="idle-nic", rnic_svc_ns=150.0, remote_wire_ns=1200.0,
        loopback_wire_ns=1500.0),
    # A congested fabric: card occupancy past the CX3 saturation point
    # and inflated wire/PCIe latencies — the regime of Fig. 1's collapse
    # and the §5 high-contention tails. Loopback designs hurt doubly
    # (steeper pcie_beta); ALock's local cohort is immune by §2's
    # construction (no RNIC on the local path).
    "congested-nic": CostProfile(
        name="congested-nic", rnic_svc_ns=900.0, remote_wire_ns=3500.0,
        loopback_wire_ns=5200.0, pcie_beta=1.6, qp_alpha=1.8),
}

_FIELD_NAMES = tuple(f.name for f in dataclasses.fields(CostModel))


def resolve_cost(cost, base: CostModel) -> CostModel:
    """Coerce a spec-level ``cost`` value to a concrete :class:`CostModel`.

    Accepted forms (the canonical frozen forms stored by
    ``repro_torch.workloads``): ``None`` -> ``base`` unchanged; a profile name
    from :data:`COST_PROFILES`; a ``CostModel``/``CostProfile`` instance;
    or a tuple of ``(field, value)`` override pairs applied on top of
    ``base`` (the frozen form of a ``{"rnic_svc_ns": 900.0}``-style dict).
    """
    if cost is None:
        return base
    if isinstance(cost, str):
        try:
            return COST_PROFILES[cost]
        except KeyError:
            raise ValueError(
                f"unknown cost profile {cost!r}; registered: "
                f"{sorted(COST_PROFILES)}") from None
    if isinstance(cost, CostModel):
        return cost
    if isinstance(cost, tuple):
        return dataclasses.replace(base, **dict(cost))
    raise TypeError(f"cost must be None, a profile name, a CostModel or "
                    f"field overrides, got {type(cost)!r}")


def freeze_cost(cost):
    """Validate + canonicalize a user-facing ``cost`` value to the frozen,
    hashable form ``resolve_cost`` accepts. Mappings become sorted
    ``(field, float)`` tuples; unknown field names are rejected here, at
    spec-construction time, not at lowering time."""
    if cost is None or isinstance(cost, CostModel):
        return cost
    if isinstance(cost, str):
        if cost not in COST_PROFILES:
            raise ValueError(f"unknown cost profile {cost!r}; registered: "
                             f"{sorted(COST_PROFILES)}")
        return cost
    if isinstance(cost, dict):
        cost = tuple(sorted(cost.items()))
    if isinstance(cost, tuple):
        bad = [k for k, _ in cost if k not in _FIELD_NAMES]
        if bad:
            raise ValueError(f"unknown cost-model field(s) {bad}; pick "
                             f"from {_FIELD_NAMES}")
        return tuple((str(k), float(v)) for k, v in cost)
    raise TypeError(f"cost must be None, a profile name, a CostModel, or "
                    f"a field-override mapping, got {type(cost)!r}")
