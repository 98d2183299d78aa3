"""Wrapper of the CUDA event-loop kernel (``csrc/event_loop.cu``).

Replaces the TPU kernel ``repro/kernels/event_loop/kernel.py::
event_loop_kernel``, closed and open loop. The kernel is latency-bound on
this card — a replica is one chain of ``n_events`` dependent steps — so
its design keeps a replica's whole machine state and the current phase's
operands (and, open loop, its request rows) in a shared-memory region,
gives each replica one warp and packs ``W`` replicas into a block (the
planner ``smem_plan.py`` chooses ``W``), and reads device memory only for
the draw streams, the latency ring and the per-request waits and
sojourns (see the header of the ``.cu`` file).

Build: at the first launch ``csrc/event_loop.cu`` is compiled by ``nvcc``
for ``sm_90a`` into ``build/`` at the repository root (``kernels/_build``),
a shared library with a plain C interface, loaded with ``ctypes``; the
build keeps ptxas's report of registers and spills (``REPORT_FLAGS``).
Nothing here runs at import time: importing this module needs neither
``nvcc`` nor a CUDA device.

``run_events_kernel`` launches the kernel for CUDA tensors or raises —
there is no path from here to the plain version. ``owner_lane`` says
which of its two bodies a launch runs: the closed loop at up to
``LANE_MAX_T`` threads steps each thread on the lane that owns it, with
the argmin keys in registers; the open loop, and the closed loop past
``LANE_MAX_T`` threads, step every thread on lane 0. ``LIB`` declares the
library; it counts the launches (one per call), and nothing else does.
``smem_table`` / ``smem_bytes`` price one replica's region
(``smem_plan.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.event_loop.ref import DIAG_COLS
from repro_torch.kernels.event_loop.smem_plan import (  # noqa: F401
    ALGS, plan_for_run, smem_bytes, smem_table)

#: threads the closed loop's owner-lane body serves at most: 32 lanes x
#: ``LANE_SLOTS`` (8) in ``csrc/event_loop.cu``
LANE_MAX_T = 256

_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = _build.Library("event_loop", {
    "event_loop_launch": [_ci] + [_vp] * 29 + [_ci] * 9 + [_vp],
    "event_loop_smem_bytes": [_ci] * 6,
    "event_loop_block_bytes": [_ci] * 7,
}, _build.REPORT_FLAGS)


def owner_lane(T: int, R: int) -> bool:
    """Whether a launch of ``T`` threads and ``R`` request slots runs the
    kernel's owner-lane body (the closed loop, ``R == 0``, at ``T <=
    LANE_MAX_T``); the kernel picks its body by the same rule."""
    return R == 0 and T <= LANE_MAX_T


def run_events_kernel(alg, T, N, K, n_events, wl, thread_node, lock_node,
                      streams, *, lat_samples: int, plan=None, arr=None,
                      warps: int | None = None, diag=None):
    """Launch the CUDA event loop for B replicas on the current stream.

    Same contract as ``ref.run_events_plain``. The wrapper checks device,
    dtype, shape and contiguity, plans the replicas per block
    (``smem_plan.plan_for_run``; ``warps`` overrides the request),
    allocates and pre-fills every output (``lat``, ``wq``, ``soj`` = -1),
    launches without synchronising, checks the launch error and raises on
    anything the kernel does not take. ``diag``, an optional ``(B, 5)``
    int32 CUDA tensor, receives per replica the events the loop ran before
    it stopped (``n_events`` unless an open-loop replica fell idle for
    good), 1 where the open loop took its pointer path (0: the exact
    R-wide scans, or a closed loop), the lock operations the loop began
    (its NCS steps), how many of them began shared (alock-rw's readers; 0
    for every other algorithm) and how many on the loopback tier (hlock's
    locks in another node of the same rack; 0 for every other
    algorithm).
    """
    R = wl.arr_fix.shape[-1]
    if R > 0 and (plan is None or arr is None):
        raise ValueError("an open-loop run (R > 0) needs its arrival plan "
                         "and arrival times")
    if n_events < 1 or lat_samples < 1:
        raise ValueError(f"need n_events >= 1 and lat_samples >= 1, got "
                         f"({n_events}, {lat_samples})")
    if N < 1 or K % N != 0:
        raise ValueError(f"n_locks={K} must be a positive multiple of "
                         f"n_nodes={N}")
    B = wl.seed.shape[0]
    P = wl.edges.shape[1]
    is_rw, is_hl = alg == "alock-rw", alg == "hlock"
    smem_bytes(alg, T, N, K, P, R)
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    u1, r2, r3 = streams[:3]
    ops = dict(
        u1=(u1, f32, (B, n_events)), r2=(r2, i32, (B, n_events)),
        r3=(r3, i32, (B, n_events)), edges=(wl.edges, i32, (B, P)),
        think_ns=(wl.think_ns, i32, (B, P)),
        locality=(wl.locality, f32, (B, P, T)),
        active=(wl.active, i32, (B, P, T)),
        b_init=(wl.b_init, i32, (B, P, 2)),
        cost_rows=(wl.cost_rows, i32, (B, P, 8)),
        node_mult=(wl.node_mult, f32, (B, P, N)),
        thread_node=(thread_node, i32, (T,)), lock_node=(lock_node, i32, (K,)))
    u4 = read_frac = rack = None
    if is_rw:
        u4, read_frac = streams[3], wl.read_frac
        ops.update(u4=(u4, f32, (B, n_events)),
                   read_frac=(read_frac, f32, (B, P, T)))
    if is_hl:
        rack = wl.rack
        ops.update(rack=(rack, i32, (B, N)))
    tok = tokcum = qcap = wq = soj = rstat = None
    if R:
        tok, tokcum, qcap = plan.tok, plan.tokcum, plan.qcap
        ops.update(arr=(arr, i64, (B, R)), tok=(tok, i32, (B, R)),
                   tokcum=(tokcum, i32, (B, R)), qcap=(qcap, i32, (B, R)))
    if diag is not None:
        ops.update(diag=(diag, i32, (B, DIAG_COLS)))
    _build.check_operands("event-loop kernel", **ops)
    dev = u1.device
    splan = plan_for_run(
        alg, B, T, N, K, P, R, warps=warps,
        n_sm=torch.cuda.get_device_properties(dev).multi_processor_count)

    lib = LIB.load()
    done = torch.zeros((B, T), dtype=i32, device=dev)
    lat = torch.full((B, lat_samples), -1, dtype=i64, device=dev)
    lat_n = torch.zeros(B, dtype=i32, device=dev)
    t_end = torch.zeros(B, dtype=i64, device=dev)
    nreacq = torch.zeros(B, dtype=i32, device=dev)
    npass = torch.zeros(B, dtype=i32, device=dev)
    if R:
        wq = torch.full((B, R), -1, dtype=i64, device=dev)
        soj = torch.full((B, R), -1, dtype=i64, device=dev)
        rstat = torch.empty((B, R), dtype=i32, device=dev)   # kernel-written

    def ptr(t):
        return None if t is None else t.data_ptr()

    # the launch is asynchronous: operands and outputs stay valid because
    # the caching allocator reuses a freed block only in stream order, and
    # the kernel runs on the stream the tensors were made on
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.event_loop_launch(
            ALGS.index(alg), ptr(u1), ptr(r2), ptr(r3), ptr(u4),
            ptr(wl.edges), ptr(wl.think_ns), ptr(wl.locality),
            ptr(read_frac), ptr(wl.active), ptr(wl.b_init),
            ptr(wl.cost_rows), ptr(wl.node_mult), ptr(thread_node),
            ptr(lock_node), ptr(rack), ptr(done), ptr(lat), ptr(lat_n),
            ptr(t_end), ptr(nreacq), ptr(npass), ptr(arr), ptr(tok),
            ptr(tokcum), ptr(qcap), ptr(wq), ptr(soj), ptr(rstat),
            ptr(diag), B, splan.warps, T, N, K, P, R, n_events, lat_samples,
            stream)
    _build.check_launch(lib, err, f"event-loop kernel (alg={alg}, B={B}, "
                                  f"W={splan.warps}, T={T}, N={N}, K={K}, "
                                  f"P={P}, R={R}, n_events={n_events})")
    LIB.count()
    out = (done, lat, lat_n, t_end, nreacq, npass)
    return out + (arr, wq, soj, rstat) if R else out
