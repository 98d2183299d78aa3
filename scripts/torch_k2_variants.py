#!/usr/bin/env python3
"""Time K2 (``csrc/alock_tick.cu``) against variants of its own design.

``python3 scripts/torch_k2_variants.py`` on a machine with an NVIDIA H100
and ``nvcc``. At the Monte-Carlo path shape (4,096 tables x 16 threads, 8
local + 8 remote, 150,000 steps, budgets (5, 20), seed 0) it times, with
CUDA events over 3 launches after a warm-up:

- the kernel as committed, schedule drawn and schedule given, then under
  other launch plans (``kernel.tick_plan``): given with 1-3 draw (copy)
  warps; drawn with 32, 64 and 128 tables a block (1, 2, 4 chain warps),
  1-4 draw warps, 2, 4 and 8 ring stages, 32 and 128 steps a stage;
- build-local copies of the source, each with one design choice undone
  (``VARIANTS``), drawn and given: the next step's record loaded after
  this step's stores instead of before them and fixed up, the next PC by
  an OR of the disjoint classes' terms instead of a chain of selects, one
  step per ring load instead of four, the remote store predicated (by an
  ``if``, or in PTX) instead of made unconditional into a scratch record;
- a copy with ``clock64()`` stamps in lane 0 of each chain warp
  (``PROFILE_STAMPS``): the cycles of one step's parts (the next record's
  loads issued, the transition's selects, the stores, the fix-up of the
  next record) and of the stage hand-off, averaged over the blocks;

each copy checked equal to the committed kernel's outputs. It writes the
committed library's SASS to ``build/k2_sass.txt`` and prints its
instruction count per kernel. Prints one JSON object per line, the last
the card's ``nvidia-smi`` name and power limit. Builds go to ``build/``.
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SRC = ROOT / "src" / "repro_torch" / "csrc" / "alock_tick.cu"
PATH = dict(tables=4096, T=16, steps=150_000)
COHORTS = (0,) * 8 + (1,) * 8

#: name -> [(text in the committed source, its replacement)]
VARIANTS = {
    "load_after_stores": [
        ("    const int4 rn = my[idx_n * ps];\n"
         "    const int cn = mc[idx_n * ps];\n", ""),
        ("    // the next record as these stores leave it\n",
         "    const int4 rn = my[idx_n * ps];\n"
         "    const int cn = mc[idx_n * ps];\n"
         "    // the next record as these stores leave it\n")],
    "next_pc_by_or_of_terms": [
        ("    np = is_pass ? NCS : np;\n",
         "    np = (unsigned)p < 12u\n"
         "        ? (((is_ncs | is_wn | is_sv | (p == CS)) ? p + 1 : 0)\n"
         "           | (is_swap ? (tail_c == 0 ? SET_VICTIM : WRITE_NEXT) : 0)\n"
         "           | (p == SPIN_BUDGET ? (bud == -1 ? SPIN_BUDGET\n"
         "              : (bud == 0 ? SET_VICTIM_R : CS)) : 0)\n"
         "           | (is_pw ? (can ? CS : p) : 0)\n"
         "           | ((is_rc & !solo) ? SPIN_NEXT : 0)\n"
         "           | (p == SPIN_NEXT ? (nx != 0 ? PASS : SPIN_NEXT) : 0))\n"
         "        : r.x;\n")],
    "one_step_per_ring_load": [
        ("    for (; j + 4 <= cnt; j += 4) {", "    for (; false;) {")],
    "remote_store_predicated_by_if": [
        ("    reinterpret_cast<int*>(my + to * ps)[is_wn ? 2 : 1] = rval;\n",
         "    if (rem) reinterpret_cast<int*>(my + tgt * ps)"
         "[is_wn ? 2 : 1] = rval;\n")],
    "remote_store_predicated_in_ptx": [
        ("    reinterpret_cast<int*>(my + to * ps)[is_wn ? 2 : 1] = rval;\n",
         "    asm volatile(\"{\\n.reg .pred q;\\nsetp.ne.u32 q, %2, 0;\\n"
         "@q st.shared.b32 [%0], %1;\\n}\\n\" :: \"r\"(flash::saddr("
         "reinterpret_cast<int*>(my + tgt * ps) + (is_wn ? 2 : 1))), "
         "\"r\"(rval), \"r\"((int)rem) : \"memory\");\n")],
}

#: clock64() stamps in lane 0 of each chain warp; the sums leave through
#: sched_out (unused in the drawn mode), 8 words a block
PROFILE_STAMPS = [
    ("  int t0, t1, v;\n",
     "  int t0, t1, v;\n  long long pr[6];\n"),
    ("    const int idx_n = (unsigned)x < (unsigned)T ? x : 0;\n",
     "    const long long s0 = clock64();\n"
     "    const int idx_n = (unsigned)x < (unsigned)T ? x : 0;\n"),
    ("    // -- one ALock step of thread tid, branch-free",
     "    const long long s1 = clock64();\n"
     "    // -- one ALock step of thread tid, branch-free"),
    ("    my[idx * ps] = nr;\n",
     "    const long long s2 = clock64();\n    my[idx * ps] = nr;\n"),
    ("    // the next record as these stores leave it\n",
     "    const long long s3 = clock64();\n"
     "    // the next record as these stores leave it\n"),
    ("    c = cn;\n  }\n",
     "    c = cn;\n    const long long s4 = clock64();\n"
     "    pr[0] += s1 - s0; pr[1] += s2 - s1; pr[2] += s3 - s2;\n"
     "    pr[3] += s4 - s3; pr[4] += 1;\n  }\n"),
    ("  ln.t0 = ln.t1 = ln.v = 0;\n",
     "  ln.t0 = ln.t1 = ln.v = 0;\n"
     "  for (int q = 0; q < 6; ++q) ln.pr[q] = 0;\n"
     "  const long long run0 = clock64();\n"),
    ("    bar_wait(&full[s], (int)((g / a.stages) & 1));\n",
     "    const long long h0 = clock64();\n"
     "    bar_wait(&full[s], (int)((g / a.stages) & 1));\n"
     "    ln.pr[5] += clock64() - h0;\n"),
    ("      a.victim_out[tab] = ln.v;\n",
     "      a.victim_out[tab] = ln.v;\n"
     "      if (k == 0) {\n"
     "        long long* o = reinterpret_cast<long long*>(a.sched_out)"
     " + blockIdx.x * 8;\n"
     "        for (int q = 0; q < 6; ++q) o[q] = ln.pr[q];\n"
     "        o[6] = clock64() - run0;\n      }\n"),
]


def emit(obj):
    print(json.dumps(obj), flush=True)


def edited(name, edits):
    text = SRC.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new, 1)
    path = ROOT / "build" / f"k2_variant_{name}.cu"
    path.parent.mkdir(exist_ok=True)
    path.write_text(text)
    return path


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_k2_variants: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.alock_tick import kernel as K
    from repro_torch.kernels.alock_tick import ops
    dev = torch.device("cuda")
    flags = _build.FLAGS + ("-I", str(_build.CSRC))
    names = list(VARIANTS) + ["profile"]
    _build.build_all(
        [(edited(n, VARIANTS.get(n, PROFILE_STAMPS)), f"k2_variant_{n}",
          flags) for n in names])

    libs = {n: _build.load(ROOT / "build" / f"k2_variant_{n}.cu",
                           f"k2_variant_{n}",
                           lambda lib: _build.bind(lib, K.LIB.signatures),
                           flags) for n in names}
    committed = K.LIB.load()

    Tab, T, steps = PATH["tables"], PATH["T"], PATH["steps"]
    coh = torch.tensor(COHORTS, dtype=torch.int32, device=dev).expand(
        Tab, T).contiguous()
    state = ops.fresh_tables(Tab, T, dev)
    words = K.draw_words(0, T, 0, steps)

    def run(lib=committed, plan=None, sched_out=None):
        p = plan or K.tick_plan(T, 128, Tab, "drawn")
        return K.launch(lib, "drawn", p, state, coh, sched_out=sched_out,
                        words=words, steps=steps, b_init=(5, 20))

    def timed(fn, reps=3):
        fn()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    ref = run()
    emit({"variant": "committed, drawn", "plan": K.last_plan(),
          "ms": timed(run)})
    sched = ops.schedule(Tab, steps, T, 0, dev)
    given = K.tick_kernel(*state, sched, coh)
    emit({"variant": "committed, given", "plan": K.last_plan(),
          "equal_to_drawn": all(torch.equal(x, y)
                                for x, y in zip(given, ref)),
          "ms": timed(lambda: K.tick_kernel(*state, sched, coh))})
    for dw in (1, 2, 3):
        p = K.tick_plan(T, 128, Tab, "given", draw_warps=dw)

        def given_run():
            return K.launch(committed, "given", p, state, coh, sched=sched,
                            steps=steps, b_init=(5, 20))
        emit({"variant": "plan, given", "plan": p.as_dict(),
              "equal_to_committed": all(torch.equal(x, y)
                                        for x, y in zip(given_run(), ref)),
              "ms": timed(given_run)})
    del sched, given
    plans = ([dict(tile=32 * cw, chain_warps=cw) for cw in (2, 4)]
             + [dict(draw_warps=dw) for dw in (1, 2, 3, 4)]
             + [dict(stages=st) for st in (2, 8)]
             + [dict(stage_steps=ss) for ss in (32, 128)])
    for kw in plans:
        p = K.tick_plan(T, kw.pop("tile", 128), Tab, "drawn", **kw)
        out = run(plan=p)
        emit({"variant": "plan", "plan": p.as_dict(),
              "equal_to_committed": all(torch.equal(x, y)
                                        for x, y in zip(out, ref)),
              "ms": timed(lambda: run(plan=p))})
    sched = ops.schedule(Tab, steps, T, 0, dev)
    pg = K.tick_plan(T, 128, Tab, "given")
    for name in VARIANTS:
        def given_run():
            return K.launch(libs[name], "given", pg, state, coh, sched=sched,
                            steps=steps, b_init=(5, 20))
        equal = all(torch.equal(x, y) for x, y in zip(run(libs[name]), ref))
        equal &= all(torch.equal(x, y) for x, y in zip(given_run(), ref))
        emit({"variant": name, "equal_to_committed": equal,
              "ms": timed(lambda: run(libs[name])),
              "ms_given": timed(given_run)})
    del sched
    emit({"variant": "committed, drawn", "ms": timed(run)})

    # where a step's cycles go
    p = K.tick_plan(T, 128, Tab, "drawn")
    blocks = -(-Tab // p.tables_per_block)
    buf = torch.zeros(blocks * 16, dtype=torch.int32, device=dev)
    out = run(libs["profile"], sched_out=buf)
    prof = buf.view(torch.int64).view(blocks, 8).double().cpu()
    n = prof[:, 4]
    emit({"profile": "cycles per step, lane 0 of each chain warp, "
                     "mean over blocks",
          "equal_to_committed": all(torch.equal(x, y)
                                    for x, y in zip(out, ref)),
          "steps": float(n.mean()),
          "next_record_loads": float((prof[:, 0] / n).mean()),
          "transition_selects": float((prof[:, 1] / n).mean()),
          "stores": float((prof[:, 2] / n).mean()),
          "next_record_fixup": float((prof[:, 3] / n).mean()),
          "stage_hand_off": float((prof[:, 5] / n).mean()),
          "whole_run_per_step": float((prof[:, 6] / n).mean())})

    sass = subprocess.run(["cuobjdump", "--dump-sass",
                           str(K.LIB.build())],
                          capture_output=True, text=True).stdout
    (ROOT / "build" / "k2_sass.txt").write_text(sass)
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn and line.strip().startswith("/*") and "*/" in line \
                and ";" in line:
            counts[fn] += 1
    emit({"sass_instructions": counts})
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
