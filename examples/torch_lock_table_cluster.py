"""The paper's evaluation app on the PyTorch/CUDA port: a distributed lock
table under a mixed-locality workload, on (a) real threads and (b) the
calibrated simulator (the event-loop kernel of the card with
``--device cuda``, the default; the plain PyTorch engine with ``--device
cpu``, where ``--events`` near 2,000 keeps it to seconds).

Run: PYTHONPATH=src python examples/torch_lock_table_cluster.py [--nodes 5]
"""
import argparse
import random
import threading
import time

from repro_torch.core.batch import sweep
from repro_torch.core.lock_table import LockTable
from repro_torch.workloads import Workload


def threaded_cluster(nodes: int, tpn: int, locks_per_node: int,
                     locality: float, ops: int):
    table = LockTable(nodes, locks_per_node)
    t0 = time.perf_counter()

    def worker(node, seed):
        rng = random.Random(seed)
        for _ in range(ops):
            if rng.random() < locality:
                target_node = node
            else:
                target_node = rng.choice([n for n in range(nodes)
                                          if n != node])
            lk = target_node * locks_per_node + \
                rng.randrange(locks_per_node)
            with table.critical(node, lk):
                pass
    ths = [threading.Thread(target=worker, args=(n, 31 * n + i))
           for n in range(nodes) for i in range(tpn)]
    [t.start() for t in ths]
    [t.join() for t in ths]
    dt = time.perf_counter() - t0
    total = table.stats.ops
    print(f"  threaded: {total} ops in {dt:.2f}s "
          f"({total/dt/1e3:.1f} Kops/s wall) "
          f"local={table.stats.local_ops} remote={table.stats.remote_ops} "
          f"reacquires={table.stats.reacquires}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--tpn", type=int, default=3)
    ap.add_argument("--locality", type=float, default=0.9)
    ap.add_argument("--seeds", type=int, default=1,
                    help="independent simulator seeds per algorithm "
                         "(one engine call per algorithm; >1 adds ±ci95)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--events", type=int, default=100_000)
    args = ap.parse_args()
    if args.seeds < 1:
        ap.error(f"--seeds must be >= 1, got {args.seeds}")

    print(f"== threaded lock table ({args.nodes} nodes x {args.tpn} "
          f"threads, locality {args.locality:.0%}) ==")
    threaded_cluster(args.nodes, args.tpn, 8, args.locality, 400)

    print(f"== calibrated simulator, same topology, all algorithms "
          f"({args.seeds} seed{'s' if args.seeds > 1 else ''}, "
          f"{args.device}) ==")
    algs = ("alock", "spinlock", "mcs")
    cfgs = [Workload(alg, args.nodes, args.tpn, 8 * args.nodes,
                     locality=args.locality) for alg in algs]
    for alg, br in zip(algs, sweep(cfgs, n_seeds=args.seeds,
                                   n_events=args.events,
                                   device=args.device)):
        print(f"  {alg:9s} {br.mean_mops:7.2f} ±{br.ci95_mops:.2f} Mops/s "
              f"(simulated)")


if __name__ == "__main__":
    main()
