"""The card's peaks and the work the draws and the event loop need.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense, at the full
700 W power limit): HBM at 3.35 TB/s, and 32-bit integer instructions at
64 lanes on each of 132 SMs (16 in each of an SM's four partitions; the
H100 Tensor Core GPU Architecture white paper) at the 1.98 GHz maximum
SM clock; no integer instruction counts twice, as an FMA does in the
float rates.

The work is counted from what the simulation needs, whatever computes
it: per event ``split(fold_in(key(seed), i), 3)`` and the draws made from
its subkeys, ``THREEFRY_CALLS`` hashes of ``THREEFRY_OPS`` integer
instructions each, their conversions, the Zipf inverse-CDF as a binary
search, and the event loop's masked argmin over the threads (2 a thread)
and its transition (``STEP_OPS``). Bytes are each replica's operands read
once and its outputs written once; draws that are made and consumed on
the card are not counted, since a generator inside the loop needs none.
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
N_SM = 132
SM_CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = N_SM * 64 * SM_CLOCK_HZ
#: integer instructions of one threefry2x32 hash: 2 key adds, 20 rounds of
#: add, rotate and xor, 5 key injections of two adds each
THREEFRY_OPS = 72
#: hashes an event needs: fold_in 1, split 3 (4 with the read coin), one
#: uniform from each of subkeys 0 and 2 (and 3), randint's split 2 and its
#: two draws 2
THREEFRY_CALLS = {False: 10, True: 12}
#: a uniform from its bits: shift, or, subtract
UNIFORM_OPS = 3
#: randint's combine: two remainders, multiply, add, remainder, add
RANDINT_OPS = 6
#: scalar operations of one event step besides the argmin, counted from
#: the event loop's source: phase resolve and draw hand-off ~14, the
#: longest transition ~20, cost application ~20, accounting ~10
STEP_OPS = 64
LAT_SAMPLES = 1 << 15


def event_ops(w: dict) -> float:
    """Integer operations one event of workload ``w`` needs."""
    rw = w["alg"] == "alock-rw"
    T = w["n_nodes"] * w["threads_per_node"]
    kpn = w["n_locks"] // w["n_nodes"]
    n_uniform = 3 if rw else 2
    return (THREEFRY_CALLS[rw] * THREEFRY_OPS + n_uniform * UNIFORM_OPS
            + RANDINT_OPS + math.ceil(math.log2(kpn)) + 1
            + 2 * T + STEP_OPS)


def replica_bytes(w: dict) -> float:
    """Bytes one replica of ``w`` reads (its operands) and writes (its
    outputs) at least once."""
    T, N = w["n_nodes"] * w["threads_per_node"], w["n_nodes"]
    P = max(1, len(w.get("phases") or ()))
    kpn = w["n_locks"] // N
    operands = 4 * (P * (3 * T + kpn + N + 2 + 2 + 8 + 4 + 2) + N + 1)
    outputs = 4 * T + 8 * LAT_SAMPLES + 4 + 8 + 4 + 4
    return operands + outputs


def least_seconds(workloads, n_seeds: int, n_events: int) -> float:
    """The least time the card can take for the draws and event loop of
    ``workloads``, closed loop: the larger of its operations over the
    integer rate and its bytes over the HBM rate."""
    ops = sum(event_ops(w) for w in workloads) * n_seeds * n_events
    nbytes = sum(replica_bytes(w) for w in workloads) * n_seeds
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
