"""``python -m mpi_knn_tpu_torch lint --host`` — the host concurrency lint.

Exit status: 0 = clean (waivers allowed, counted), 1 = at least one
finding (or a stale guard map / a lock-graph cycle), 2 = usage error.
Torch-free and fast: the analyzer reads source text, it never imports
(let alone runs) the modules it checks. The report goes to
``artifacts/lint/torch/host_report.json`` by default, beside (never
over) the JAX package's ``artifacts/lint/host_report.json``.
"""

from __future__ import annotations

import argparse
import sys

DEFAULT_OUT = "artifacts/lint/torch"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_knn_tpu_torch lint --host",
        description="statically lint the threaded host modules: lock "
        "discipline (H1), lock ordering (H2), thread confinement (H3), "
        "atomic publication (H4)",
    )
    p.add_argument("--rule", action="append", metavar="NAME",
                   help="run only the named rule(s), e.g. H2-lock-order; "
                   "repeatable")
    p.add_argument("--out", default=DEFAULT_OUT, metavar="DIR",
                   help=f"report directory (default: {DEFAULT_OUT}; the "
                   "report file is host_report.json)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule registry and exit")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from mpi_knn_tpu_torch.analysis.host.engine import run_host_lint
    from mpi_knn_tpu_torch.analysis.host.rules import RULES

    if args.list_rules:
        for name, desc in RULES.items():
            print(f"{name}: {desc}")
        return 0

    try:
        report = run_host_lint(rule_names=args.rule)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    path = report.save(args.out)

    if not args.quiet:
        s = report.to_json()["summary"]
        print(
            f"host lint: {s['targets']} target(s), "
            f"{s['classes_checked']} classes, {s['findings']} finding(s), "
            f"{s['waivers']} waiver(s), lock graph "
            f"{'acyclic' if s['lock_graph_acyclic'] else 'CYCLIC'} "
            f"({s['lock_edges']} edges); report: {path}"
        )
        for prob in report.problems:
            print(f"  CONFIG {prob}")
        for f in report.findings:
            print(
                f"  VIOLATION [{f.rule}] {f.where}:{f.lineno}: {f.message}"
            )
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
