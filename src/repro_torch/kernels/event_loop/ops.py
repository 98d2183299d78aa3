"""Public entry points of the event-loop engine.

``run_events`` takes a ``WorkloadOperands`` whose leaves carry a leading
replica axis B and returns ``(done, lat, lat_n, t_end, nreacq, npass)``,
plus ``(arr, wq, soj, rstat)`` for an open-loop bucket (``R > 0``).
``backend="kernel"`` launches the hand-written CUDA kernel
(``kernel.py`` / ``csrc/event_loop.cu``) and needs CUDA tensors;
``backend="plain"`` runs ``ref.run_events_plain`` on whatever device was
asked for; ``"auto"`` is the kernel on a CUDA device and the plain version
on an explicitly requested CPU.

The state-independent half of the workload draw stream is precomputed
here (``precompute_draws``) with the counter-based generator of
``core/prng.py``: the raw locality uniform, the remote-node offset and the
phase-resolved Zipf offset depend only on ``(seed, event index)``, never
on simulation state. The thread-dependent half (comparing the uniform
against ``locality[phase, tid]``) runs inside the loop, because ``tid`` is
the argmin of the ready clocks and only exists at run time. The open
loop's arrival plan (``precompute_plan``: gaps, token-admit mask, its
prefix count, queue bounds) is state-independent too and is computed the
same way, before the loop.

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

from repro_torch.core import prng
from repro_torch.device import resolve_backend, resolve_device
from repro_torch.kernels.event_loop import kernel as _kernel
from repro_torch.kernels.event_loop.ref import LAT_SAMPLES, run_events_plain
from repro_torch.traffic.stream import (ArrivalPlan, arrival_plan,
                                        arrival_times_i64)
from repro_torch.workloads import WorkloadOperands, to_device

#: bound on the (replica x event) elements hashed at once: every threefry
#: temporary is an int64 tensor of a small multiple of this many elements
DRAW_CHUNK_ELEMS = 1 << 22
#: bound on the (replica x event x kpn) booleans of one inverse-CDF pass
CDF_CHUNK_ELEMS = 1 << 27

def _zipf_offsets(u3, ph, zcdf, kpn):
    """``min(sum(u3 >= zcdf[ph]), kpn - 1)`` per (replica, event), int32.
    ``ph`` is None for single-phase operands."""
    B, E = u3.shape
    P = zcdf.shape[1]
    out = torch.empty((B, E), dtype=torch.int32, device=u3.device)
    step = max(1, CDF_CHUNK_ELEMS // max(1, B * kpn))
    for s in range(0, E, step):
        u = u3[:, s:s + step, None]
        cnt = (u >= zcdf[:, 0, None, :]).sum(-1)
        for p in range(1, P):
            cnt_p = (u >= zcdf[:, p, None, :]).sum(-1)
            cnt = torch.where(ph[:, s:s + step] == p, cnt_p, cnt)
        out[:, s:s + step] = cnt.clamp(max=kpn - 1).to(torch.int32)
    return out


def precompute_draws(seed, edges, zcdf, n_events: int, N: int, kpn: int,
                     rw: bool = False, device="cuda"):
    """The state-independent per-event draw stream, replica-batched.

    ``seed (B,) i32``, ``edges (B, P) i32``, ``zcdf (B, P, kpn) f32``
    (tensors, moved to ``device``). Returns ``(B, n_events)`` tensors
    ``(u1 f32, r2 i32, r3 i32)`` — the values the engine draws at event
    ``i`` from ``split(fold_in(key(seed), i), 3)``: the locality uniform,
    ``randint(0, max(N - 1, 1))`` and the Zipf inverse-CDF offset resolved
    against the phase active at event ``i``. ``rw=True`` is the alock-rw
    engine's 4-way split and appends the reader/writer coin ``u4 f32``.

    The event axis is processed in chunks so that temporaries stay
    bounded whatever ``B * n_events`` is.
    """
    dev = resolve_device(device)
    seed = torch.as_tensor(seed).to(dev)
    edges = torch.as_tensor(edges).to(dev)
    zcdf = torch.as_tensor(zcdf).to(dev)
    B = seed.shape[0]
    P = edges.shape[1]
    n_sub = 4 if rw else 3
    u1 = torch.empty((B, n_events), dtype=torch.float32, device=dev)
    r2 = torch.empty((B, n_events), dtype=torch.int32, device=dev)
    r3 = torch.empty((B, n_events), dtype=torch.int32, device=dev)
    u4 = torch.empty_like(u1) if rw else None
    k0 = prng.key(seed)
    k0 = (k0[0][:, None], k0[1][:, None])
    step = max(1, DRAW_CHUNK_ELEMS // max(1, B))
    for s in range(0, n_events, step):
        i = torch.arange(s, min(s + step, n_events), dtype=torch.int64,
                         device=dev)[None]
        sub = prng.split(prng.fold_in(k0, i), n_sub)     # (n_sub, B, E)
        # subkeys 0, 2 (, 3) feed uniforms; subkey 1 feeds randint
        uni = [0, 2, 3][:n_sub - 1]
        fl = prng.uniform((sub[0][uni], sub[1][uni]))
        u1[:, s:s + step] = fl[0]
        r2[:, s:s + step] = prng.randint((sub[0][1], sub[1][1]), 0,
                                         max(N - 1, 1))
        ph = ((i[:, :, None] >= edges[:, None, :]).sum(-1) - 1
              if P > 1 else None)
        r3[:, s:s + step] = _zipf_offsets(fl[1], ph, zcdf, kpn)
        if rw:
            u4[:, s:s + step] = fl[2]
    return (u1, r2, r3, u4) if rw else (u1, r2, r3)


def _as_tensor(a, dev, dtype=None) -> torch.Tensor:
    """Array or tensor -> contiguous tensor on ``dev`` (arrays are copied:
    torch refuses to wrap read-only ones)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(device=dev, dtype=dtype).contiguous()


def precompute_plan(wl, n_events: int, device="cuda") -> ArrivalPlan:
    """The state-independent request plan of an open-loop ``wl`` (leaves
    with a leading replica axis B, ``R > 0``): ``traffic.stream.
    arrival_plan`` on ``device``, the counterpart of ``precompute_draws``
    for the arrival stream."""
    dev = resolve_device(device)
    return arrival_plan(to_device(WorkloadOperands(*wl), dev), n_events)


def run_events(alg, T, N, K, n_events, wl, thread_node, lock_node, *,
               lat_samples: int = LAT_SAMPLES, backend: str = "auto",
               device="cuda", streams=None, plan=None):
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
        plan = (arrival_plan(wl, n_events) if plan is None else
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
        if not R:
            return out
        m1 = torch.full((B, R), -1, dtype=torch.int64, device=dev)
        return out + (arr, m1, m1.clone(),
                      torch.zeros((B, R), dtype=torch.int32, device=dev))
    is_rw = alg == "alock-rw"
    if streams is None:
        streams = precompute_draws(wl.seed, wl.edges, wl.zcdf, n_events, N,
                                   K // N, rw=is_rw, device=dev)
    else:
        streams = tuple(_as_tensor(s, dev) for s in streams)
        if len(streams) != (4 if is_rw else 3):
            raise ValueError(f"{alg!r} takes {4 if is_rw else 3} draw "
                             f"streams, got {len(streams)}")
    run = _kernel.run_events_kernel if backend == "kernel" \
        else run_events_plain
    return run(alg, T, N, K, n_events, wl, thread_node, lock_node, streams,
               lat_samples=lat_samples, plan=plan, arr=arr)
