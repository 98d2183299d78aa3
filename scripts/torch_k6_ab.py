#!/usr/bin/env python3
"""Time K6 (``csrc/ssd_scan.cu``) of several checkouts the same way.

``python3 scripts/torch_k6_ab.py ROOT [ROOT ...]`` on a machine with an
NVIDIA H100 and ``nvcc``, each ROOT a checkout of this repo (for an A/B:
parent, change, change, parent). Each ROOT runs in a process of its own,
which builds that checkout's kernel into its ``build/`` and, at the
exemplar path shape (SSD B=2, S=2048, H=16, P=64, N=128, chunk 128, f32;
inputs made as ``chip_smoke.py`` makes them, seed 302), times
``kernel.ssd_kernel`` and the plain ``ref.ssd_chunk_ref`` with CUDA events
over 3 and over 20 calls after a warm-up. The kernel's outputs are held
against the plain version's at 2e-4 absolute plus 2e-4 relative, as
``chip_smoke.py`` holds them. Prints one JSON object per ROOT, the
last line the card's ``nvidia-smi`` name and power limit.
"""
import json
import subprocess
import sys
from pathlib import Path

PATH = dict(B=2, S=2048, H=16, P=64, N=128, L=128)
REPS = (3, 20)
TOL = 2e-4


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels.ssd_scan import kernel as K
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref

    dev = torch.device("cuda")
    B, S, H, P, N, L = (PATH[x] for x in "BSHPNL")
    nc = S // L
    g = torch.Generator(device=dev).manual_seed(302)

    def rn(*shape):
        return torch.randn(shape, device=dev, generator=g)
    xh, dt = rn(B, S, H, P), torch.nn.functional.softplus(rn(B, S, H))
    a, b, c = -torch.exp(rn(H) * 0.3), rn(B, S, N) * 0.5, rn(B, S, N) * 0.5
    ops = ((xh * dt[..., None]).reshape(B, nc, L, H, P),
           (dt * a).reshape(B, nc, L, H), b.reshape(B, nc, L, N),
           c.reshape(B, nc, L, N))

    def timed(fn, reps):
        fn()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    got, want = K.ssd_kernel(*ops), ssd_chunk_ref(*ops)
    err = max(float((x - y).abs().max()) for x, y in zip(got, want))
    ok = all(bool(torch.allclose(x, y, atol=TOL, rtol=TOL))
             for x, y in zip(got, want))
    return {"root": str(root), "max_abs_err": err, "ok": ok,
            **{f"ms_{r}": timed(lambda: K.ssd_kernel(*ops), r)
               for r in REPS},
            **{f"plain_ms_{r}": timed(lambda: ssd_chunk_ref(*ops), r)
               for r in REPS}}


def main(argv):
    if argv[:1] == ["--one"]:
        print(json.dumps(measure(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    ok = True
    for root in argv:
        run = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True)
        sys.stdout.write(run.stdout)
        sys.stderr.write(run.stderr[-4000:])
        ok = ok and run.returncode == 0 and '"ok": true' in run.stdout
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
