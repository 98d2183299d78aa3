#!/usr/bin/env python3
"""Time K6 (``csrc/ssd_scan.cu``) against variants of its own design.

``python3 scripts/torch_k6_variants.py`` on a machine with an NVIDIA H100
and ``nvcc``. At the exemplar path shape (SSD B=2, S=2048, H=16, P=64,
N=128, chunk 128, f32) it times, with CUDA events over 20 launches after a
warm-up:

- the kernel as committed, under its plan (``kernel.ssd_plan``) and at
  head tiles of 1, 2, 4 and 8;
- build-local copies of the source, each with one design choice changed
  (``VARIANTS``): c b^T kept in shared memory instead of registers (b then
  split into TF32 halves at each use, as there is no room for both), b's
  halves split at each use instead of once, each accumulator's three
  TF32 products issued back to back instead of each product over all
  accumulators in turn, the products' ``asm`` not volatile (free for the
  compiler to schedule), state tiles of 32 rows instead of 16 or of 16 or
  32 columns instead of 64, dealt to the warps in a fixed order instead of
  from a counter, and the state product's k loop unrolled by two;
- a copy with ``clock64()`` stamps in lane 0 of every warp
  (``PROFILE_STAMPS``): the cycles of the CTA's phases (the copies of b
  and c, the scans, c b^T, b's split, then per head y and the states),
  averaged over the CTAs, the slowest warp's and the mean warp's;

each copy checked equal to the committed kernel's outputs, bit for bit.
It writes the committed library's SASS to ``build/k6_sass.txt``. Prints
one JSON object per line, the last the card's ``nvidia-smi`` name
and power limit. Builds go to ``build/``.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SRC = ROOT / "src" / "repro_torch" / "csrc" / "ssd_scan.cu"
PATH = dict(B=2, S=2048, H=16, P=64, N=128, L=128)

_B_HALVES = (
    "            bb[j][0] = __float_as_uint(Bb[8 * j]);\n"
    "            bb[j][1] = __float_as_uint(Bb[LDB + 8 * j]);\n"
    "            bs[j][0] = __float_as_uint(Bs[8 * j]);\n"
    "            bs[j][1] = __float_as_uint(Bs[LDB + 8 * j]);\n")
_B_SPLIT_AT_USE = (
    "            split_tf32(Bb[8 * j], bb[j][0], bs[j][0]);\n"
    "            split_tf32(Bb[LDB + 8 * j], bb[j][1], bs[j][1]);\n")
_STATE_PRODUCT = ("            if (i < ni && j < nj) "
                  "mma_tf32(acc[i][j], {});\n")
_SPLIT_LOOP = (
    "#pragma unroll 4\n"
    "  for (int i = tid; i < LP * LDB; i += THREADS) {\n"
    "    const float x = bB[i];\n"
    "    const uint32_t big = tf32_rna(x);\n"
    "    bB[i] = __uint_as_float(big);\n"
    "    bS[i] = __uint_as_float(tf32_rna(x - __uint_as_float(big)));\n"
    "  }\n")

#: name -> [(text in the committed source, its replacement)]
VARIANTS = {
    "att_in_shared_memory": [
        (_SPLIT_LOOP,
         "  if (has_rows) {\n"
         "#pragma unroll\n"
         "    for (int j = 0; j < MAX_L / 8; ++j) {\n"
         "      if (j < nj) {\n"
         "#pragma unroll\n"
         "        for (int e = 0; e < 4; ++e)\n"
         "          bS[acc_row(e, wi, lane) * LDB + 8 * j + acc_col(e, lane)]"
         " = att[j][e];\n"
         "      }\n    }\n  }\n"),
        ("att[kb][0]", "bS[l0 * LDB + m]"),
        ("att[kb][1]", "bS[l0 * LDB + m + 1]"),
        ("att[kb][2]", "bS[l1 * LDB + m]"),
        ("att[kb][3]", "bS[l1 * LDB + m + 1]"),
        (_B_HALVES, _B_SPLIT_AT_USE)],
    "b_split_at_each_use": [(_SPLIT_LOOP, ""), (_B_HALVES, _B_SPLIT_AT_USE)],
    "products_in_chain_order": [
        ("#pragma unroll\n  for (int j = 0; j < J; ++j)\n"
         "    if (j < n) mma_tf32(c[j], as, bb[j]);\n"
         "#pragma unroll\n  for (int j = 0; j < J; ++j)\n"
         "    if (j < n) mma_tf32(c[j], ab, bs[j]);\n"
         "#pragma unroll\n  for (int j = 0; j < J; ++j)\n"
         "    if (j < n) mma_tf32(c[j], ab, bb[j]);\n",
         "#pragma unroll\n  for (int j = 0; j < J; ++j)\n"
         "    if (j < n) mma_3xtf32(c[j], ab, as, bb[j], bs[j]);\n"),
        (_STATE_PRODUCT.format("as[i], bb[j]"),
         "            if (i < ni && j < nj)\n"
         "              mma_3xtf32(acc[i][j], ab[i], as[i], bb[j], bs[j]);\n"),
        (_STATE_PRODUCT.format("ab[i], bs[j]"), "            if (false) {}\n"),
        (_STATE_PRODUCT.format("ab[i], bb[j]"), "            if (false) {}\n")],
    "products_not_volatile": [
        ("namespace {\n\nusing namespace flash;\n",
         "namespace {\n\nusing namespace flash;\n"
         "__device__ __forceinline__ void mma_nv(float* c, "
         "const uint32_t (&a)[4], const uint32_t (&b)[2]) {\n"
         "  asm(\"mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
         "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
         "{%0, %1, %2, %3};\\n\"\n"
         "      : \"+f\"(c[0]), \"+f\"(c[1]), \"+f\"(c[2]), \"+f\"(c[3])\n"
         "      : \"r\"(a[0]), \"r\"(a[1]), \"r\"(a[2]), \"r\"(a[3]), "
         "\"r\"(b[0]), \"r\"(b[1]));\n}\n"),
        ("mma_tf32(", "mma_nv(")],
    "state_tiles_32_rows": [("constexpr int TI = 1;",
                             "constexpr int TI = 2;")],
    "state_tiles_16_columns": [("constexpr int TN = 64;",
                                "constexpr int TN = 16;")],
    "state_tiles_32_columns": [("constexpr int TN = 64;",
                                "constexpr int TN = 32;")],
    "state_tiles_in_fixed_order": [
        ("    for (;;) {\n      int tile = 0;\n"
         "      if (lane == 0) tile = atomicAdd(ctr + hh, 1);\n"
         "      tile = __shfl_sync(0xffffffffu, tile, 0);\n",
         "    for (int k = 0;; ++k) {\n"
         "      const int tile = k * WARPS + wi;\n")],
    "state_k_loop_unrolled_by_2": [
        ("#pragma unroll 1\n      for (int lb = 0; lb < LP; lb += 8) {",
         "#pragma unroll 2\n      for (int lb = 0; lb < LP; lb += 8) {")],
}

#: slots of the profile: the CTA's phases, then three a head
SLOTS = 64
PROFILE_STAMPS = [
    ("namespace {\n\nusing namespace flash;\n",
     "namespace {\n\nusing namespace flash;\n"
     "__device__ long long g_prof[512 * 8 * 64];\n"
     "#define STAMP(k) if ((threadIdx.x & 31) == 0) g_prof[((blockIdx.z * "
     "gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * 512 + "
     "(threadIdx.x >> 5) * 64 + (k)] = clock64();\n"),
    ("  const int gq = lane >> 2, tq = lane & 3;\n",
     "  const int gq = lane >> 2, tq = lane & 3;\n  STAMP(0);\n"),
    ("  __syncthreads();\n\n  for (int hh = wi; hh < hb; hh += WARPS)\n",
     "  __syncthreads();\n  STAMP(1);\n\n"
     "  for (int hh = wi; hh < hb; hh += WARPS)\n"),
    ("  // att = c b^T, this warp's 16 rows x the column blocks j < nj\n",
     "  STAMP(2);\n"
     "  // att = c b^T, this warp's 16 rows x the column blocks j < nj\n"),
    ("  __syncthreads();  // c is read: its space takes b's small halves\n",
     "  STAMP(3);\n"
     "  __syncthreads();  // c is read: its space takes b's small halves\n"
     "  STAMP(4);\n"),
    ("  const int tiles_n = (NP + TN - 1) / TN",
     "  STAMP(5);\n  const int tiles_n = (NP + TN - 1) / TN"),
    ("    const int h = h0 + hh;\n",
     "    STAMP(6 + 3 * hh);\n    const int h = h0 + hh;\n"),
    ("    // states = (xd * w)^T b, a tile of 16 TI x TN at a time\n",
     "    STAMP(7 + 3 * hh);\n"
     "    // states = (xd * w)^T b, a tile of 16 TI x TN at a time\n"),
    ("  }\n}\n\n}  // namespace\n",
     "    STAMP(8 + 3 * hh);\n  }\n}\n\n}  // namespace\n"
     "extern \"C\" int ssd_profile(void* dst, int bytes) {\n"
     "  return (int)cudaMemcpyFromSymbol(dst, g_prof, bytes);\n}\n"),
]
PHASES = {"copies_b_c": (0, 1), "scans": (1, 2), "c_bT": (2, 3),
          "c_bT_barrier": (3, 4), "b_split": (4, 5)}


def emit(obj):
    print(json.dumps(obj), flush=True)


def edited(name, edits):
    text = SRC.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    path = ROOT / "build" / f"k6_variant_{name}.cu"
    path.parent.mkdir(exist_ok=True)
    path.write_text(text)
    return path


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_k6_variants: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import kernel as K
    dev = torch.device("cuda")
    flags = K.LIB.flags + ("-I", str(_build.CSRC))
    names = list(VARIANTS) + ["profile"]
    _build.build_all(
        [(edited(n, VARIANTS.get(n, PROFILE_STAMPS)), f"k6_variant_{n}",
          flags) for n in names])
    profile = dict(K.LIB.signatures,
                   ssd_profile=[ctypes.c_void_p, ctypes.c_int])
    libs = {n: _build.load(ROOT / "build" / f"k6_variant_{n}.cu",
                           f"k6_variant_{n}",
                           lambda lib, n=n: _build.bind(
                               lib, profile if n == "profile"
                               else K.LIB.signatures), flags)
            for n in names}
    regs = {n: [ln.strip() for ln in _build.BUILD_LOG.get(
        f"k6_variant_{n}", "").splitlines()
        if "registers" in ln or "spill" in ln] for n in names}

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

    def launch(lib, hb):
        y = torch.empty((B, nc, L, H, P), device=dev)
        st = torch.empty((B, nc, H, P, N), device=dev)
        dec = torch.empty((B, nc, H), device=dev)
        err = lib.ssd_launch(*(t.data_ptr() for t in (*ops, y, st, dec)),
                             B, nc, L, H, P, N, hb,
                             torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(lib.kernel_error_string(err).decode())
        return y, st, dec

    def timed(fn, reps=20):
        fn()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    plan = K.ssd_plan(B, nc, H, L, P, N)
    committed = K.LIB.load()
    ref = launch(committed, plan.hb)
    emit({"variant": "committed", "plan": plan.as_dict(),
          "ms": timed(lambda: K.ssd_kernel(*ops))})
    for hb in (1, 2, 4, 8):
        out = launch(committed, hb)
        emit({"variant": "committed", "hb": hb,
              "equal_to_committed": all(torch.equal(x, y)
                                        for x, y in zip(out, ref)),
              "ms": timed(lambda: launch(committed, hb))})
    for name in VARIANTS:
        out = launch(libs[name], plan.hb)
        emit({"variant": name, "hb": plan.hb, "ptxas": regs[name],
              "equal_to_committed": all(torch.equal(x, y)
                                        for x, y in zip(out, ref)),
              "ms": timed(lambda: launch(libs[name], plan.hb))})
    emit({"variant": "committed", "plan": plan.as_dict(),
          "ms": timed(lambda: K.ssd_kernel(*ops))})
    sass = subprocess.run(["cuobjdump", "--dump-sass",
                           str(K.LIB.build())],
                          capture_output=True, text=True).stdout
    (ROOT / "build" / "k6_sass.txt").write_text(sass)
    emit({"sass_lines": len(sass.splitlines()),
          "HMMA": sum(" HMMA." in ln for ln in sass.splitlines()),
          "local_memory": sum(("LDL" in ln or "STL" in ln)
                              for ln in sass.splitlines())})

    # where a CTA's cycles go
    out = launch(libs["profile"], plan.hb)
    torch.cuda.synchronize()
    buf = torch.zeros(512 * 8 * SLOTS, dtype=torch.int64)
    err = libs["profile"].ssd_profile(buf.data_ptr(), buf.numel() * 8)
    if err:
        raise RuntimeError(f"cudaMemcpyFromSymbol: {err}")
    st = buf.view(512, 8, SLOTS)[:plan.ctas].double()
    phases = dict(PHASES)
    for hh in range(plan.hb):
        k = 5 + 3 * hh
        phases[f"head{hh}_barrier"] = (k, k + 1)
        phases[f"head{hh}_y"] = (k + 1, k + 2)
        phases[f"head{hh}_states"] = (k + 2, k + 3)
    rows = {}
    for name, (s0, s1) in phases.items():
        d = st[:, :, s1] - st[:, :, s0]
        rows[name] = {"slowest_warp": float(d.max(1).values.mean()),
                      "mean_warp": float(d.mean()),
                      "per_warp": [round(float(v), 1) for v in d.mean(0)]}
    end = 5 + 3 * plan.hb
    emit({"profile": "cycles, lane 0 of each warp, mean over CTAs",
          "equal_to_committed": all(torch.equal(x, y)
                                    for x, y in zip(out, ref)),
          "whole_cta": float((st[:, :, end].max(1).values
                              - st[:, :, 0].min(1).values).mean()),
          "phases": rows})
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
