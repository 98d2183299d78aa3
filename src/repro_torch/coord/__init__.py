"""The coordination plane on the threaded ALock lock table.

``service.CoordService`` hashes names onto the cells of
``repro_torch.core.lock_table.LockTable`` and keeps a small KV under them;
``LeaseManager`` (writer leases with expiry, bounded retry, backoff and
jitter on an injectable clock) and ``Membership`` (heartbeats, shard
ownership, stealing a dead node's shards) run on it. ``stress.
run_coord_stress`` drives all three through a ``Workload``'s phase program
(the registry's ``coord-stress`` scenario). Host threads only: nothing
here touches a tensor.
"""
from repro_torch.coord.service import (CoordService, Lease, LeaseManager,
                                       Membership)
from repro_torch.coord.stress import (ManualClock, StressReport,
                                      run_coord_stress)

__all__ = ["CoordService", "Lease", "LeaseManager", "ManualClock",
           "Membership", "StressReport", "run_coord_stress"]
