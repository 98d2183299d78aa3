"""CLI for the port's lint: ``python -m repro_torch.analysis``.

Modes (mutually exclusive; default is a lint report):

  (default)    collect the entrypoints, run every rule, print the
               findings; exit 0 regardless
  --strict     same, but exit 1 when any finding fires (the CI lint leg)
  --selftest   run the known-bad fixture corpus and verify every rule
               family still fires (>= 4 distinct rule ids, every family);
               exit 1 when a family has gone blind
  --imports    static import-graph gate: every src/repro_torch module no
               entry package can reach must carry an explicit quarantine
               entry, and nothing may import JAX or the reference (exit 1
               on unexpected unreachables, stale quarantines or a
               forbidden import)

``--device`` (default ``cuda``; resolved by ``repro_torch.device.
resolve_device``, so it raises where there is no CUDA device) is where the
lint's card legs run: the CPU legs always run, the card legs only on a
CUDA device, and ``--device cpu`` is the caller asking for the CPU.
``--imports`` and ``--selftest`` touch no device.

Scoping/output knobs: ``--scenarios a,b`` restricts the sweep buckets to
named scenarios, ``--events N`` sets the lowered event count (shapes
only), ``--rules S001,X001`` restricts the rule set, ``--json PATH`` writes
machine-readable findings.
"""
from __future__ import annotations

import argparse
import json
import sys


def _lint(args) -> int:
    from repro_torch.analysis.entrypoints import collect_entrypoints
    from repro_torch.analysis.rules import RULES, legs, run_rules
    from repro_torch.device import resolve_device
    scenarios = args.scenarios.split(",") if args.scenarios else None
    rules = args.rules.split(",") if args.rules else None
    unknown = set(rules or ()) - set(RULES)
    if unknown:
        print(f"unknown rule ids: {', '.join(sorted(unknown))} "
              f"(known: {', '.join(sorted(RULES))})", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    eps = collect_entrypoints(scenarios=scenarios, n_events=args.events)
    findings = run_rules(eps, rules=rules, device=device)
    ran = legs(rules, device)
    buckets = sum(ep.kind.startswith("k1") for ep in eps)
    print(f"collected {len(eps)} entrypoints ({buckets} sweep buckets); "
          f"{len(ran['cpu'])} rules on {device}; CPU legs: "
          f"{', '.join(ran['cpu'])}; card legs: "
          f"{', '.join(ran['card']) or 'none (no CUDA device asked for)'}; "
          f"{len(findings)} finding(s)")
    for f in findings:
        print(f.format())
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump([vars(f) for f in findings], fh, indent=2)
        print(f"wrote {args.json}")
    if findings:
        return 1 if args.strict else 0
    print("lint-clean.")
    return 0


def _selftest(args) -> int:
    from repro_torch.analysis.fixtures import run_corpus
    from repro_torch.analysis.rules import RULES
    per_family = run_corpus()
    fired = {f.rule for fs in per_family.values() for f in fs}
    ok = True
    for family, fs in sorted(per_family.items()):
        ids = sorted({f.rule for f in fs})
        status = "ok" if fs else "BLIND"
        ok &= bool(fs)
        print(f"{family:22s} {status:6s} "
              f"({len(fs)} finding(s): {', '.join(ids) or '-'})")
    families = {RULES[r].family for r in fired}
    every = {r.family for r in RULES.values()}
    print(f"corpus: {len(fired)} distinct rule ids across "
          f"{len(families)} of {len(every)} families")
    if len(fired) < 4 or families != every:
        print(f"selftest FAILED: need >= 4 rule ids across all "
              f"{len(every)} families", file=sys.stderr)
        return 1
    if not ok:
        print("selftest FAILED: a rule family no longer flags its "
              "known-bad fixture", file=sys.stderr)
        return 1
    print("selftest passed.")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static lint of the port: shared-memory tables, "
                    "environment knobs, bucket signatures, the build key, "
                    "the pairs contract, build flags and doc names")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--strict", action="store_true",
                      help="exit 1 when any finding fires")
    mode.add_argument("--selftest", action="store_true",
                      help="run the known-bad fixture corpus")
    mode.add_argument("--imports", action="store_true",
                      help="import-graph gate (quarantine-checked dead "
                           "weight, forbidden imports; exit 1 on drift)")
    ap.add_argument("--scenarios", default="",
                    help="comma-separated scenario names (default: all)")
    ap.add_argument("--events", type=int, default=None,
                    help="lowered event count (shapes only; default 2048)")
    ap.add_argument("--rules", default="",
                    help="comma-separated rule ids (default: all)")
    ap.add_argument("--json", default="",
                    help="write findings as JSON to this path")
    ap.add_argument("--device", default="cuda",
                    help="where the card legs run (default: cuda; raises "
                         "without a CUDA device); 'cpu' runs the CPU legs "
                         "only")
    args = ap.parse_args(argv)
    if args.events is None:
        from repro_torch.analysis.entrypoints import DEFAULT_TRACE_EVENTS
        args.events = DEFAULT_TRACE_EVENTS
    if args.imports:
        from repro_torch.analysis.imports import report
        text, rc = report()
        print(text)
        return rc
    if args.selftest:
        return _selftest(args)
    return _lint(args)


if __name__ == "__main__":
    sys.exit(main())
