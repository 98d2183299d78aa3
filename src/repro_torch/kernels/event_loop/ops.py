"""Public entry points of the event-loop engine.

``run_events`` takes a ``WorkloadOperands`` whose leaves carry a leading
replica axis B and returns ``(done, lat, lat_n, t_end, nreacq, npass)``,
plus ``(arr, wq, soj, rstat)`` for an open-loop bucket (``R > 0``).
``run_events_pairs`` returns the same outputs in the reference's hi/lo
int32 contract (``i32pair``). ``backend="kernel"`` launches the
hand-written CUDA kernel (``kernel.py`` / ``csrc/event_loop.cu``) and
needs CUDA tensors;
``backend="plain"`` runs ``ref.run_events_plain`` on whatever device was
asked for; ``"auto"`` is the kernel on a CUDA device and the plain version
on an explicitly requested CPU.

The state-independent half of the workload draw stream is precomputed
here (``precompute_draws``: one launch of the CUDA kernel ``draws.py`` /
``csrc/draw_stream.cu`` on the kernel backend, ``ref.draw_stream_plain``
in torch ops on the plain one): the raw locality
uniform, the remote-node offset and the phase-resolved Zipf offset depend
only on ``(seed, event index)``, never
on simulation state. The thread-dependent half (comparing the uniform
against ``locality[phase, tid]``) runs inside the loop, because ``tid`` is
the argmin of the ready clocks and only exists at run time. The open
loop's arrival plan (``precompute_plan``: gaps, token-admit mask, its
prefix count, queue bounds) is state-independent too and is made the same
way, before the loop: one launch of the CUDA kernel ``arrivals.py`` /
``csrc/arrival_plan.cu`` on the kernel backend, ``traffic/stream.py`` in
torch ops on the plain one.

>>> from repro_torch.workloads import Workload, lower, to_device
>>> from repro_torch.kernels.event_loop.ops import precompute_draws
>>> o = to_device(lower(Workload("alock", 2, 2, 8, locality=0.9),
...                     n_events=64).operands, "cpu")
>>> u1, r2, r3 = precompute_draws(o.seed[None], o.edges[None],
...                               o.zcdf[None], n_events=64, N=2, kpn=4,
...                               device="cpu")
>>> tuple(u1.shape), str(r2.dtype), tuple(r3.shape)
((1, 64), 'torch.int32', (1, 64))
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_backend, resolve_device
from repro_torch.kernels.event_loop import arrivals as _arrivals
from repro_torch.kernels.event_loop import draws as _draws
from repro_torch.kernels.event_loop import i32pair
from repro_torch.kernels.event_loop import kernel as _kernel
from repro_torch.kernels.event_loop.ref import (
    LAT_SAMPLES, draw_stream_plain, run_events_plain)
from repro_torch.traffic.stream import (ArrivalPlan, arrival_plan,
                                        arrival_times_i64)
from repro_torch.workloads import WorkloadOperands, to_device


def precompute_draws(seed, edges, zcdf, n_events: int, N: int, kpn: int,
                     rw: bool = False, device="cuda", backend: str = "auto"):
    """The state-independent per-event draw stream, replica-batched.

    ``seed (B,) i32``, ``edges (B, P) i32``, ``zcdf (B, P, kpn) f32``
    (tensors, moved to ``device``). Returns ``(B, n_events)`` tensors
    ``(u1 f32, r2 i32, r3 i32)`` — the values the engine draws at event
    ``i`` from ``split(fold_in(key(seed), i), 3)``: the locality uniform,
    ``randint(0, max(N - 1, 1))`` and the Zipf inverse-CDF offset resolved
    against the phase active at event ``i``. ``rw=True`` is the alock-rw
    engine's 4-way split and appends the reader/writer coin ``u4 f32``.

    ``backend="kernel"`` makes the whole stream in one launch of the CUDA
    kernel ``draws.draw_stream`` (``csrc/draw_stream.cu``) and needs a
    CUDA device; ``"plain"`` runs ``ref.draw_stream_plain`` on whatever
    device was asked for; ``"auto"`` is the kernel on a CUDA device and the
    plain version on an explicitly requested CPU. The two give the same
    bits.
    """
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    seed = torch.as_tensor(seed).to(dev)
    edges = torch.as_tensor(edges).to(dev)
    zcdf = torch.as_tensor(zcdf).to(dev)
    if backend == "kernel":
        # prng.key takes the seed's low 32 bits, as this cast does
        return _draws.draw_stream(seed.to(torch.int32).contiguous(),
                                  edges.contiguous(), zcdf.contiguous(),
                                  n_events, N, kpn, rw=rw)
    return draw_stream_plain(seed, edges, zcdf, n_events, N, kpn, rw=rw)


def _as_tensor(a, dev, dtype=None) -> torch.Tensor:
    """Array or tensor -> contiguous tensor on ``dev`` (arrays are copied:
    torch refuses to wrap read-only ones)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(device=dev, dtype=dtype).contiguous()


def precompute_plan(wl, n_events: int, device="cuda",
                    backend: str = "auto") -> ArrivalPlan:
    """The state-independent request plan of an open-loop ``wl`` (leaves
    with a leading replica axis B, ``R > 0``), on ``device``: the
    counterpart of ``precompute_draws`` for the arrival stream.

    ``backend="kernel"`` makes the whole plan in one launch of the CUDA
    kernel ``arrivals.arrival_plan`` (``csrc/arrival_plan.cu``) and needs a
    CUDA device; ``"plain"`` runs ``traffic.stream.arrival_plan`` on
    whatever device was asked for; ``"auto"`` is the kernel on a CUDA
    device and the plain version on an explicitly requested CPU. The two
    give the same bits.
    """
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    wl = to_device(WorkloadOperands(*wl), dev)
    if backend == "kernel":
        return _arrivals.arrival_plan(wl.seed, wl.arr_fix, wl.arr_edges,
                                      wl.arr_gap_ns, wl.arr_token,
                                      wl.arr_qcap, n_events)
    return arrival_plan(wl, n_events)


def run_events(alg, T, N, K, n_events, wl, thread_node, lock_node, *,
               lat_samples: int = LAT_SAMPLES, backend: str = "auto",
               device="cuda", streams=None, plan=None, diag=None):
    """Batched event loop, closed or open.

    ``wl`` is a ``WorkloadOperands`` with a leading replica axis B on
    every leaf (numpy arrays or tensors; moved to ``device``): locality
    (B,P,T) f32, zcdf (B,P,K//N) f32, edges/think_ns (B,P) i32, active
    (B,P,T) i32, b_init (B,P,2) i32, cost_rows (B,P,8) i32, node_mult
    (B,P,N) f32, the arrival rows, rack (B,N) i32, read_frac (B,P,T) f32,
    seed (B,) i32; ``thread_node (T,)`` / ``lock_node (K,)`` broadcast.
    Returns ``(done (B,T) i32, lat (B,lat_samples) i64, lat_n (B,) i32,
    t_end (B,) i64, nreacq (B,) i32, npass (B,) i32)`` on ``device``; an
    open-loop ``wl`` (``arr_fix (B,R)``, ``R > 0``) appends ``(arr (B,R)
    i64, wq (B,R) i64, soj (B,R) i64, rstat (B,R) i32)``: arrival times,
    queue waits and sojourns (-1 when never dispatched / completed) and
    ``traffic.metrics`` status codes.

    ``streams`` injects a precomputed ``(u1, r2, r3[, u4])`` instead of
    drawing it from ``wl.seed``, and ``plan`` a precomputed
    ``ArrivalPlan`` — the tests use them to tell a fault in the engine
    from a fault in a generator.

    ``diag``, an optional ``(B, 5)`` int32 tensor on ``device``, receives
    per replica the events the loop ran, 1 where an open-loop replica's
    arrival times are non-decreasing (the kernel's pointer path), the lock
    operations the loop began (its NCS steps, where it reads an event's
    draws), how many of them began shared (alock-rw's readers; 0 for
    the others) and how many on the loopback tier (hlock's locks in
    another node of the lock taker's rack; 0 for the others). A
    replica runs every event unless it is open loop and falls idle for
    good: at the first event ``i`` at which every thread is idle, no
    admitted request is pending and the arrival stream is drained, it
    stops with ``i + 1``. The kernel and the plain engine fill
    it by that one rule; the draw stream is made for every event either
    way, so ``diag[:, 0] / n_events`` is the share of it the loop used.
    """
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    wl = to_device(WorkloadOperands(*wl), dev)
    R = wl.arr_fix.shape[-1]
    B = wl.seed.shape[0]
    thread_node = _as_tensor(thread_node, dev, torch.int32)
    lock_node = _as_tensor(lock_node, dev, torch.int32)
    arr = None
    if R:
        plan = (precompute_plan(wl, n_events, device=dev, backend=backend)
                if plan is None else
                ArrivalPlan(*(_as_tensor(a, dev, torch.int32)
                              for a in plan)))
        arr = arrival_times_i64(plan.gaps)
    if n_events < 1:
        # degenerate run: the loop's 0-iteration outputs
        z = torch.zeros(B, dtype=torch.int32, device=dev)
        out = (torch.zeros((B, T), dtype=torch.int32, device=dev),
               torch.full((B, lat_samples), -1, dtype=torch.int64,
                          device=dev),
               z, torch.zeros(B, dtype=torch.int64, device=dev),
               z.clone(), z.clone())
        if diag is not None:
            diag.zero_()
        if not R:
            return out
        m1 = torch.full((B, R), -1, dtype=torch.int64, device=dev)
        return out + (arr, m1, m1.clone(),
                      torch.zeros((B, R), dtype=torch.int32, device=dev))
    is_rw = alg == "alock-rw"
    if streams is None:
        streams = precompute_draws(wl.seed, wl.edges, wl.zcdf, n_events, N,
                                   K // N, rw=is_rw, device=dev,
                                   backend=backend)
    else:
        streams = tuple(_as_tensor(s, dev) for s in streams)
        if len(streams) != (4 if is_rw else 3):
            raise ValueError(f"{alg!r} takes {4 if is_rw else 3} draw "
                             f"streams, got {len(streams)}")
    run = _kernel.run_events_kernel if backend == "kernel" \
        else run_events_plain
    return run(alg, T, N, K, n_events, wl, thread_node, lock_node, streams,
               lat_samples=lat_samples, plan=plan, arr=arr, diag=diag)


def run_events_pairs(alg, T, N, K, n_events, wl, thread_node, lock_node, *,
                     lat_samples: int = LAT_SAMPLES, backend: str = "auto",
                     device="cuda", streams=None, plan=None):
    """``run_events`` with every int64 output as a hi/lo int32 pair.

    Returns ``(done (B,T) i32, (lat_hi, lat_lo) (B,lat_samples) i32 each,
    lat_n (B,) i32, (t_end_hi, t_end_lo) (B,) i32 each, nreacq (B,) i32,
    npass (B,) i32)``; an open-loop ``wl`` appends ``(arr, wq, soj)`` as
    ``(hi, lo)`` pairs of ``(B,R)`` i32 each and ``rstat (B,R) i32`` —
    the reference's ``run_events_pairs`` tuple. Combine pairs with
    ``i32pair.pack`` / ``pack_np``. The engine is ``run_events``'s (the
    kernel's clocks are native int64); only its clock outputs are split.
    """
    out = run_events(alg, T, N, K, n_events, wl, thread_node, lock_node,
                     lat_samples=lat_samples, backend=backend, device=device,
                     streams=streams, plan=plan)
    done, lat, lat_n, t_end, nreacq, npass = out[:6]
    base = (done, i32pair.unpack(lat), lat_n, i32pair.unpack(t_end), nreacq,
            npass)
    if len(out) == 6:
        return base
    arr, wq, soj, rstat = out[6:]
    return base + (i32pair.unpack(arr), i32pair.unpack(wq),
                   i32pair.unpack(soj), rstat)
