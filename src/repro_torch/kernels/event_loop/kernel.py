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
a shared library with a plain C interface, loaded with ``ctypes``.
Nothing here runs at import time: importing this module needs neither
``nvcc`` nor a CUDA device.

``run_events_kernel`` launches the kernel for CUDA tensors or raises —
there is no path from here to the plain version. ``LAUNCHES`` counts the
launches (one per call), and nothing else increments it. ``smem_table`` /
``smem_bytes`` price one replica's region (``smem_plan.py``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.event_loop.smem_plan import (  # noqa: F401
    ALGS, plan_for_run, smem_bytes, smem_table)

#: number of kernel launches since the last ``reset_launches()``
LAUNCHES = 0

SOURCE = _build.CSRC / "event_loop.cu"
NVCC_FLAGS = _build.FLAGS


def launches() -> int:
    return LAUNCHES


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def build() -> Path:
    """Compile ``csrc/event_loop.cu`` if no library for the current source
    exists; return the library's path."""
    return _build.build(SOURCE, "event_loop", NVCC_FLAGS)


def build_seconds():
    """Wall seconds the last ``nvcc`` run of this process took (None when
    the library was already there)."""
    return _build.BUILD_SECONDS.get("event_loop")


def _setup(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.event_loop_launch.argtypes = [ci] + [vp] * 29 + [ci] * 9 + [vp]
    lib.event_loop_launch.restype = ci
    lib.event_loop_smem_bytes.argtypes = [ci] * 6
    lib.event_loop_smem_bytes.restype = ci
    lib.event_loop_block_bytes.argtypes = [ci] * 7
    lib.event_loop_block_bytes.restype = ci
    lib.event_loop_error_string.argtypes = [ci]
    lib.event_loop_error_string.restype = ctypes.c_char_p


def load():
    """The loaded library (built on first use), with ``argtypes`` set."""
    return _build.load(SOURCE, "event_loop", _setup, NVCC_FLAGS)


def _check(name, t, dtype, shape):
    if not t.is_cuda:
        raise ValueError(
            f"event-loop kernel needs CUDA tensors, {name} lies on "
            f"{t.device}; use backend='plain' for the PyTorch version")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def run_events_kernel(alg, T, N, K, n_events, wl, thread_node, lock_node,
                      streams, *, lat_samples: int, plan=None, arr=None,
                      warps: int | None = None, diag=None):
    """Launch the CUDA event loop for B replicas on the current stream.

    Same contract as ``ref.run_events_plain``. The wrapper checks device,
    dtype, shape and contiguity, plans the replicas per block
    (``smem_plan.plan_for_run``; ``warps`` overrides the request),
    allocates and pre-fills every output (``lat``, ``wq``, ``soj`` = -1),
    launches without synchronising, checks the launch error and raises on
    anything the kernel does not take. ``diag``, an optional ``(B, 4)``
    int32 CUDA tensor, receives per replica the events the loop ran before
    it stopped (``n_events`` unless an open-loop replica fell idle for
    good), 1 where the open loop took its pointer path (0: the exact
    R-wide scans, or a closed loop), the lock operations the loop began
    (its NCS steps) and how many of them began shared (alock-rw's
    readers; 0 for every other algorithm).
    """
    global LAUNCHES
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
    _check("u1", u1, f32, (B, n_events))
    _check("r2", r2, i32, (B, n_events))
    _check("r3", r3, i32, (B, n_events))
    for name, t, dt, shape in (
            ("edges", wl.edges, i32, (B, P)),
            ("think_ns", wl.think_ns, i32, (B, P)),
            ("locality", wl.locality, f32, (B, P, T)),
            ("active", wl.active, i32, (B, P, T)),
            ("b_init", wl.b_init, i32, (B, P, 2)),
            ("cost_rows", wl.cost_rows, i32, (B, P, 8)),
            ("node_mult", wl.node_mult, f32, (B, P, N)),
            ("thread_node", thread_node, i32, (T,)),
            ("lock_node", lock_node, i32, (K,))):
        _check(name, t, dt, shape)
    u4 = read_frac = rack = None
    if is_rw:
        u4, read_frac = streams[3], wl.read_frac
        _check("u4", u4, f32, (B, n_events))
        _check("read_frac", read_frac, f32, (B, P, T))
    if is_hl:
        rack = wl.rack
        _check("rack", rack, i32, (B, N))
    tok = tokcum = qcap = wq = soj = rstat = None
    if R:
        _check("arr", arr, i64, (B, R))
        for name, t in (("tok", plan.tok), ("tokcum", plan.tokcum),
                        ("qcap", plan.qcap)):
            _check(name, t, i32, (B, R))
        tok, tokcum, qcap = plan.tok, plan.tokcum, plan.qcap
    if diag is not None:
        _check("diag", diag, i32, (B, 4))
    dev = u1.device
    for t in (wl.edges, thread_node, lock_node, r2, r3) + (
            (arr, tok) if R else ()) + ((diag,) if diag is not None else ()):
        if t.device != dev:
            raise ValueError("all operands must lie on one CUDA device")
    splan = plan_for_run(
        alg, B, T, N, K, P, R, warps=warps,
        n_sm=torch.cuda.get_device_properties(dev).multi_processor_count)

    lib = load()
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
    if err != 0:
        msg = lib.event_loop_error_string(err).decode()
        raise RuntimeError(
            f"event-loop kernel launch failed for (alg={alg}, B={B}, "
            f"W={splan.warps}, T={T}, N={N}, K={K}, P={P}, R={R}, "
            f"n_events={n_events}): CUDA error {err} ({msg})")
    LAUNCHES += 1
    out = (done, lat, lat_n, t_end, nreacq, npass)
    return out + (arr, wq, soj, rstat) if R else out
