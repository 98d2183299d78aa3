"""Quickstart on the PyTorch/CUDA port: the framework's layers in one page.

  1. the ALock itself (threaded, real concurrency, host only),
  2. the cluster simulator through the declarative Workload/Experiment
     API — the paper's headline comparison plus a phased hot-key storm —
     on the event-loop kernel of the card (``--device cuda``, the default)
     or on the plain PyTorch engine (``--device cpu``: keep ``--events``
     near 2,000 there, as it costs about a millisecond an event).

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import threading

from repro_torch.core.lock_table import LockTable
from repro_torch.experiments import ExecOptions, Experiment
from repro_torch.workloads import Phase, Workload


def demo_lock_table():
    print("== 1. ALock lock table (threaded) ==")
    table = LockTable(n_nodes=2, locks_per_node=4)
    counter = {"v": 0}

    def worker(node):
        for i in range(500):
            with table.critical(node, i % 8):
                counter["v"] += 1

    ths = [threading.Thread(target=worker, args=(n,)) for n in (0, 1, 0, 1)]
    [t.start() for t in ths]
    [t.join() for t in ths]
    print(f"  counter={counter['v']} (expected 2000), "
          f"local_ops={table.stats.local_ops}, "
          f"remote_ops={table.stats.remote_ops}")


def demo_simulator(device: str, n_events: int):
    print(f"== 2. cluster simulator (5 nodes x 4 threads, 95% locality, "
          f"{device}) ==")
    base = Workload("alock", n_nodes=5, threads_per_node=4, n_locks=100,
                    locality=0.95)
    storm = (Phase(frac=0.4), Phase(frac=0.2, zipf_s=3.0),
             Phase(frac=0.4))
    exp = (Experiment("quickstart", n_events=n_events,
                      options=ExecOptions(backend="auto", device=device))
           .add_grid(base, alg=("alock", "spinlock", "mcs"))
           .add(base.replace(phases=storm), label="alock.hotkey_storm"))
    for label, _, br in exp.run():
        r = br.result(0)
        print(f"  {label:18s} {r.throughput_mops:7.2f} Mops/s "
              f"(passes={r.passes}, reacquires={r.reacquires})")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--events", type=int, default=80_000)
    args = ap.parse_args()
    demo_lock_table()
    demo_simulator(args.device, args.events)
