"""``python -m mpi_knn_tpu_torch lint`` — the port's lint entry point.

Without ``--host`` it runs the rule matrix (R1–R8, ``analysis/rules.py``)
over the port's own recorded runs, one cell of the JAX package's matrix
each, on the card unless ``--device cpu`` asks for the CPU, and writes
``report.json`` (and with ``--memory`` / ``--cost`` the ledgers) under
``--out`` (default ``artifacts/lint/torch``). Exit status is the gate:
0 every cell run passed every rule that applies, 1 a finding (or ledger
drift), 2 a usage error.

``lint --host`` runs the host concurrency lint (``analysis/host/``, rules
H1–H4 over the threaded host modules), which loads no torch. This module
loads no torch at import either.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

METRICS = ("l2", "cosine")
DEFAULT_OUT = "artifacts/lint/torch"


def build_parser() -> argparse.ArgumentParser:
    from mpi_knn_tpu_torch.analysis.lowering import (
        LINT_BACKENDS,
        LINT_DTYPES,
        LINT_QUANTS,
    )

    p = argparse.ArgumentParser(
        prog="python -m mpi_knn_tpu_torch lint",
        description="run every backend's cell of the lint matrix recorded and "
        "check rules R1-R8 on the runs (--host: the host concurrency lint)")
    p.add_argument("--backend", action="append", choices=LINT_BACKENDS,
                   help="restrict to backend(s); repeatable")
    p.add_argument("--metric", action="append", choices=METRICS,
                   help="restrict to metric(s); repeatable")
    p.add_argument("--dtype", action="append", choices=LINT_DTYPES,
                   help="restrict to dtype(s); repeatable")
    p.add_argument("--policy", action="append", choices=["exact", "mixed"],
                   help="restrict to precision policy(ies); repeatable")
    p.add_argument("--schedule", action="append", choices=["uni", "bidir"],
                   help="restrict to ring schedule(s); repeatable")
    p.add_argument("--serve", action="store_true",
                   help="restrict to the serving-engine cells")
    p.add_argument("--frontend", action="store_true",
                   help="restrict to the serving-front-end cells")
    p.add_argument("--mutate", action="append",
                   choices=["upsert", "delete", "compact"],
                   help="restrict to the live-mutation cells; repeatable")
    p.add_argument("--quant", action="append", choices=list(LINT_QUANTS),
                   help="restrict to quantized cells; repeatable")
    p.add_argument("--fusion", action="append", choices=["xla", "fused"],
                   help="restrict to ring-fusion form(s); repeatable")
    p.add_argument("--host", action="store_true",
                   help="run the host concurrency lint instead (torch-free; "
                   "its own flags follow)")
    p.add_argument("--memory", action="store_true",
                   help="write every checked cell's R7 numbers into the "
                   "memory ledger (with --ledger-check: compare instead)")
    p.add_argument("--cost", action="store_true",
                   help="write every checked cell's R8 numbers into the cost "
                   "ledger (with --ledger-check: compare instead)")
    p.add_argument("--ledger-check", action="store_true",
                   help="with --memory and/or --cost: exit 1 when a cell's "
                   "ledgered figure drifts beyond the committed ledger's "
                   "tolerance either way, or a committed cell vanished from a "
                   "full sweep; never writes")
    p.add_argument("--ledger", default=None, metavar="PATH",
                   help="memory ledger path (default <--out>/memory_ledger.json)")
    p.add_argument("--cost-ledger", default=None, metavar="PATH",
                   help="cost ledger path (default <--out>/cost_ledger.json)")
    p.add_argument("--rule", action="append", metavar="NAME",
                   help="run only the named rule(s), e.g. R2-memory; "
                   "repeatable")
    p.add_argument("--out", default=DEFAULT_OUT, metavar="DIR",
                   help=f"report directory (default {DEFAULT_OUT})")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule registry and exit")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the cells run: the card (default, the hand "
                   "kernels) or the CPU (their plain versions)")
    p.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="refused: the JAX package's lint caches XLA "
                   "compilations; an eager run compiles no program")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def _targets(args) -> list:
    from mpi_knn_tpu_torch.analysis.lowering import default_targets

    return [
        t for t in default_targets()
        if (not args.backend or t.backend in args.backend)
        and (not args.metric or t.metric in args.metric)
        and (not args.dtype or t.dtype in args.dtype)
        and (not args.policy or t.policy in args.policy)
        and (not args.schedule or t.schedule in args.schedule)
        and (not args.quant or t.quant in args.quant)
        and (not args.fusion or t.fusion in args.fusion)
        and (not args.mutate or t.mutate in args.mutate)
        and (t.serve or not args.serve)
        and (t.frontend or not args.frontend)
    ]


def _ledgers(args, report, targets) -> int:
    """Write or check the requested ledgers; the exit status they add."""
    from mpi_knn_tpu_torch.analysis import cost, ledger, memory
    from mpi_knn_tpu_torch.analysis.lowering import default_targets

    full = len(targets) == len(default_targets())
    skipped = {r.target.label for r in report.results if r.skipped is not None}
    gates = []
    if args.memory:
        gates.append((memory.LEDGER_SPEC, pathlib.Path(
            args.ledger or pathlib.Path(args.out) / "memory_ledger.json"),
            {r.target.label: r.memory for r in report.results
             if r.skipped is None and r.memory is not None}))
    if args.cost:
        gates.append((cost.LEDGER_SPEC, pathlib.Path(
            args.cost_ledger or pathlib.Path(args.out) / "cost_ledger.json"),
            {r.target.label: r.cost for r in report.results
             if r.skipped is None and r.cost is not None}))
    rc = 0
    for spec, path, cells in gates:
        try:
            committed = ledger.load_ledger(path, spec)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if args.ledger_check:
            if committed is None:
                print(f"error: no committed {spec.kind} ledger at {path} "
                      f"(generate one with `{spec.regen_cmd}`)",
                      file=sys.stderr)
                return 2
            drift = ledger.ledger_drift(committed, cells, spec,
                                        full_matrix=full,
                                        skipped_labels=skipped)
            for why in drift:
                print(f"  LEDGER-DRIFT {why}")
            if not args.quiet:
                print(f"{spec.kind} ledger check: {len(cells)} cell(s) vs "
                      f"{path}: " + ("GREEN" if not drift
                                     else f"{len(drift)} drift finding(s)"))
            rc = max(rc, 1 if drift else 0)
        else:
            ledger.save_ledger(path, cells, spec, merge_into=ledger.merge_base_for(
                committed, full_matrix=full, skipped_labels=skipped),
                platform=report.platform)
            if not args.quiet:
                print(f"{spec.kind} ledger: {len(cells)} cell(s) written to "
                      f"{path}")
    return rc


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--host" in argv:
        from mpi_knn_tpu_torch.analysis.host.cli import main as host_main

        return host_main([a for a in argv if a != "--host"])
    args = build_parser().parse_args(argv)
    if args.cache_dir is not None:
        print("error: --cache-dir has no counterpart in the port's lint: the "
              "JAX package caches its XLA compilations there, and an eager "
              "run compiles no program (the kernels' cache is the serving "
              "CLIs' --cache-dir)", file=sys.stderr)
        return 2
    if args.list_rules:
        from mpi_knn_tpu_torch.analysis.rules import RULES

        for r in RULES:
            print(f"{r.name}: {r.description}")
        return 0
    targets = _targets(args)
    if not targets:
        print("error: no targets match the given filters", file=sys.stderr)
        return 2
    if args.ledger_check and not (args.memory or args.cost):
        print("error: --ledger-check requires --memory or --cost",
              file=sys.stderr)
        return 2
    for flag, name, rule in ((args.memory, "--memory", "R7-peak-memory"),
                             (args.cost, "--cost", "R8-cost")):
        if flag and args.rule and rule not in args.rule:
            print(f"error: {name} needs rule {rule} in the sweep (drop --rule "
                  "or include it)", file=sys.stderr)
            return 2

    from mpi_knn_tpu_torch.analysis.engine import run_matrix
    from mpi_knn_tpu_torch.device import resolve_device

    device = resolve_device(args.device)

    def progress(res):
        if args.quiet:
            return
        if res.skipped is not None:
            print(f"  SKIP {res.target.label}: {res.skipped}")
        else:
            state = "ok" if res.ok else f"{len(res.findings)} finding(s)"
            print(f"  {res.target.label}: {state} [{', '.join(res.rules_run)}]")
            for f in res.findings:
                print(f"    [{f.rule}] {f.message}")

    try:
        report = run_matrix(targets, rule_names=args.rule, progress=progress,
                            device=device)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    path = report.save(args.out)
    ledger_rc = _ledgers(args, report, targets) if (args.memory or args.cost) else 0
    if not args.quiet:
        s = report.to_json()["summary"]
        print(f"lint: {s['targets_checked']} target(s) checked, "
              f"{s['targets_skipped']} skipped, {s['findings']} finding(s) "
              f"on {report.platform}; report: {path}")
        for f in report.findings:
            print(f"  VIOLATION [{f.rule}] {f.target} {f.stage}: {f.message}")
    return max(0 if report.ok else 1, ledger_rc)
