"""Wrapper of the CUDA event-loop kernel (``csrc/event_loop.cu``).

Replaces the TPU kernel ``repro/kernels/event_loop/kernel.py::
event_loop_kernel``. The kernel is latency-bound on this card — a replica
is one chain of ``n_events`` dependent steps — so its design keeps a
replica's whole machine state in shared memory, gives each replica one
warp, and reads device memory only for the draw streams and the latency
ring (see the header of the ``.cu`` file).

Build: at the first launch the sources under ``csrc/`` are compiled by
``nvcc`` for ``sm_90a`` into ``build/`` at the repository root, a shared
library with a plain C interface, loaded with ``ctypes``. The library's
name carries a hash of the sources and the flags, so an edit rebuilds. A failed build raises.
Nothing here runs at import time: importing this module needs neither
``nvcc`` nor a CUDA device.

``run_events_kernel`` launches the kernel for CUDA tensors or raises —
there is no path from here to the plain version. ``LAUNCHES`` counts the
launches (one per call), and nothing else increments it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.kernels.event_loop.ref import OPEN_LOOP_MSG

ALGS = ("alock", "mcs", "spinlock", "hlock", "alock-rw")

#: number of kernel launches since the last ``reset_launches()``
LAUNCHES = 0

#: shared memory one block may use on Hopper (dynamic, opt-in above 48 KB)
SMEM_LIMIT = 227 * 1024

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "event_loop.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIB = None
_BUILD_SECONDS = None


def launches() -> int:
    return LAUNCHES


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def build_dir() -> Path:
    # src/repro_torch/kernels/event_loop/kernel.py -> repository root
    return Path(__file__).resolve().parents[4] / "build"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc was not found (looked at PATH and "
        "/usr/local/cuda/bin/nvcc); the event-loop kernel is built from "
        f"{SOURCE} at first use and cannot run without it")


def build() -> Path:
    """Compile ``csrc/event_loop.cu`` if no library for the current
    sources exists; return the library's path. (Add ``-Xptxas -v`` to
    ``NVCC_FLAGS`` to see registers, shared memory and spills.)"""
    global _BUILD_SECONDS
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir()
    lib = out_dir / f"libevent_loop_{tag}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{lib.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _BUILD_SECONDS = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the event-loop kernel failed (exit "
            f"{proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n"
            f"{proc.stderr}")
    os.replace(tmp, lib)        # atomic: concurrent builds agree
    return lib


def build_seconds():
    """Wall seconds the last ``nvcc`` run of this process took (None when
    the library was already there)."""
    return _BUILD_SECONDS


def load():
    """The loaded library (built on first use), with ``argtypes`` set."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.event_loop_launch.argtypes = [ci] + [vp] * 21 + [ci] * 7 + [vp]
    lib.event_loop_launch.restype = ci
    lib.event_loop_smem_bytes.argtypes = [ci] * 5
    lib.event_loop_smem_bytes.restype = ci
    lib.event_loop_error_string.argtypes = [ci]
    lib.event_loop_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def smem_table(alg: str, T: int, N: int, K: int, P: int) -> dict:
    """name -> bytes of every per-replica shared-memory buffer of one
    block (one replica per block); mirrors the carve-up in the ``.cu``."""
    fam = alg in ("alock", "hlock", "alock-rw")
    table = {"ready": 8 * T, "op_start": 8 * T, "busy": 8 * N,
             "tail0/word": 4 * K}
    if fam:
        table["tail1"] = 4 * K
        table["victim"] = 4 * K
    if alg == "alock-rw":
        table["reader_count"] = 4 * K
    for name in ("pc", "budget", "nxt", "prev", "target", "cohort", "done"):
        table[name] = 4 * T
    table["edges"] = 4 * P
    return table


def smem_bytes(alg: str, T: int, N: int, K: int, P: int) -> int:
    """Price the per-replica on-chip state before launch. Raises an
    actionable ``ValueError`` naming the dominant buffers when it exceeds
    what one block may hold (227 KB)."""
    if alg not in ALGS:
        raise ValueError(f"unknown algorithm {alg!r}; expected one of {ALGS}")
    table = smem_table(alg, T, N, K, P)
    total = sum(table.values())
    if total > SMEM_LIMIT:
        top = sorted(table.items(), key=lambda kv: -kv[1])[:3]
        detail = ", ".join(f"{n}={b:,}B" for n, b in top)
        raise ValueError(
            f"event-loop kernel cannot fit one replica's state into the "
            f"{SMEM_LIMIT:,}B of shared memory a block may use: "
            f"(alg={alg}, T={T}, N={N}, K={K}, P={P}) needs {total:,}B "
            f"(largest buffers: {detail}). The K-sized lock tables "
            f"dominate: lower n_locks, or run this shape with "
            f"backend='plain'.")
    return total


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
                      streams, *, lat_samples: int):
    """Launch the CUDA event loop for B replicas on the current stream.

    Same contract as ``ref.run_events_plain``. The wrapper checks device,
    dtype, shape and contiguity, allocates and pre-fills every output
    (``lat = -1``), launches without synchronising, checks the launch
    error and raises on anything the kernel does not take.
    """
    global LAUNCHES
    if wl.arr_fix.shape[-1] > 0:
        raise NotImplementedError(OPEN_LOOP_MSG)
    if n_events < 1 or lat_samples < 1:
        raise ValueError(f"need n_events >= 1 and lat_samples >= 1, got "
                         f"({n_events}, {lat_samples})")
    if N < 1 or K % N != 0:
        raise ValueError(f"n_locks={K} must be a positive multiple of "
                         f"n_nodes={N}")
    B = wl.seed.shape[0]
    P = wl.edges.shape[1]
    is_rw, is_hl = alg == "alock-rw", alg == "hlock"
    smem_bytes(alg, T, N, K, P)
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
    dev = u1.device
    for t in (wl.edges, thread_node, lock_node, r2, r3):
        if t.device != dev:
            raise ValueError("all operands must lie on one CUDA device")

    lib = load()
    done = torch.zeros((B, T), dtype=i32, device=dev)
    lat = torch.full((B, lat_samples), -1, dtype=i64, device=dev)
    lat_n = torch.zeros(B, dtype=i32, device=dev)
    t_end = torch.zeros(B, dtype=i64, device=dev)
    nreacq = torch.zeros(B, dtype=i32, device=dev)
    npass = torch.zeros(B, dtype=i32, device=dev)

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
            ptr(t_end), ptr(nreacq), ptr(npass), B, T, N, K, P, n_events,
            lat_samples, stream)
    if err != 0:
        msg = lib.event_loop_error_string(err).decode()
        raise RuntimeError(
            f"event-loop kernel launch failed for (alg={alg}, B={B}, T={T}, "
            f"N={N}, K={K}, P={P}, n_events={n_events}): CUDA error {err} "
            f"({msg})")
    LAUNCHES += 1
    return done, lat, lat_n, t_end, nreacq, npass
