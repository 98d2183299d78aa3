"""Public workload API: declarative specs + lowering to traced operands.

A :class:`Workload` says *what the threads do*; phases make every knob —
locality, Zipf skew, think class, the node set, the RDMA **cost profile**
and the ALock **budget pair** — a piecewise program over the run:

>>> from repro_torch.workloads import Workload, Phase, mixed
>>> w = Workload("alock", n_nodes=4, threads_per_node=8, n_locks=64,
...              locality=mixed(local=0.9, frac=0.5), zipf_s=1.2,
...              phases=(Phase(frac=0.5),
...                      Phase(frac=0.5, zipf_s=3.0)))   # hot-key storm
>>> burst = Workload("alock", n_nodes=2, threads_per_node=2, n_locks=8,
...                  phases=(Phase(frac=0.5),
...                          Phase(frac=0.5, cost="congested-nic",
...                                b_init=(2, 40))))
>>> lw = lower(burst, n_events=1000)      # -> traced operand struct
>>> lw.operands.cost_rows.shape, lw.operands.b_init.shape
((2, 8), (2, 2))
>>> lw.shape_key                          # the compile bucket
('alock', 4, 2, 8, 1000, 0)

Run a spec with ``repro_torch.experiments.Experiment`` (batched, labeled, with
error bars) or directly with ``repro_torch.core.sim.simulate(w)``. Everything
workload-shaped lowers to *traced operands* (``WorkloadOperands``), so
sweeps mixing arbitrary specs of one shape bucket share one compiled
executable.
"""
from repro_torch.core.cost_model import (COST_PROFILES, CostModel,
                                         CostProfile, resolve_cost)
from repro_torch.workloads.lower import (Lowered, N_COST_ROWS,
                                         OPERAND_DTYPES, WorkloadOperands,
                                         as_workload, from_simconfig, lower,
                                         operands_from_numpy, pad_phases,
                                         resolve_locality, resolve_read_frac,
                                         to_device, zipf_cdf)
from repro_torch.workloads.spec import (ALGS, Arrivals, Mixed,
                                        NODE_MULT_PROFILES, Phase,
                                        THINK_CLASSES, Workload,
                                        freeze_node_mult, freeze_topology,
                                        mixed, node_mult_pairs, racks_of,
                                        resolve_node_mult)

__all__ = [
    "ALGS", "Arrivals", "COST_PROFILES", "CostModel", "CostProfile",
    "Lowered", "Mixed", "NODE_MULT_PROFILES", "N_COST_ROWS",
    "OPERAND_DTYPES", "Phase",
    "THINK_CLASSES", "Workload", "WorkloadOperands", "as_workload",
    "freeze_node_mult", "freeze_topology", "from_simconfig", "lower",
    "mixed", "node_mult_pairs", "operands_from_numpy", "pad_phases",
    "racks_of", "resolve_cost",
    "resolve_locality", "resolve_node_mult", "resolve_read_frac",
    "to_device", "zipf_cdf",
]
