"""Host-lint engine: scan the targets, run H1–H4, write the report.

``python -m mpi_knn_tpu_torch lint --host`` calls :func:`run_host_lint`
over the production eight-target sweep; tests call the same function
over fixture modules with fixture guard maps, so every injected
counterexample fires through the exact production rule path. The report
(``artifacts/lint/torch/host_report.json``, the JAX package's schema)
carries the findings, the full
lock-acquisition graph with its cycle census, the thread-root map, and
every waiver with its rationale — waivers are counted in the summary so
they cannot accrete silently.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from dataclasses import field

from mpi_knn_tpu_torch.analysis.host import rules as rules_mod
from mpi_knn_tpu_torch.analysis.host.astscan import ModuleScan, scan_module
from mpi_knn_tpu_torch.analysis.host.guards import (
    GuardMap,
    HostTarget,
    default_guards,
    default_targets,
)
from mpi_knn_tpu_torch.analysis.host.rules import (
    RULES,
    HostFinding,
    LockGraph,
    Program,
)

SCHEMA_VERSION = 1


@dataclasses.dataclass
class HostReport:
    findings: list[HostFinding] = field(default_factory=list)
    waivers: list[dict] = field(default_factory=list)
    lock_graph: LockGraph = field(default_factory=LockGraph)
    targets: list[dict] = field(default_factory=list)
    roots: dict[str, list[str]] = field(default_factory=dict)
    problems: list[str] = field(default_factory=list)
    rules_run: list[str] = field(default_factory=list)
    classes_checked: int = 0

    @property
    def ok(self) -> bool:
        return (
            not self.findings
            and not self.problems
            and self.lock_graph.acyclic
        )

    def to_json(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "source": "mpi_knn_tpu_torch.analysis.host",
            "ok": self.ok,
            "rules": {name: RULES[name] for name in self.rules_run},
            "summary": {
                "targets": len(self.targets),
                "classes_checked": self.classes_checked,
                "findings": len(self.findings),
                "waivers": len(self.waivers),
                "roots": len(self.roots),
                "lock_edges": len(self.lock_graph.edges),
                "lock_graph_acyclic": self.lock_graph.acyclic,
                "problems": len(self.problems),
            },
            "targets": self.targets,
            "roots": {k: sorted(v) for k, v in sorted(self.roots.items())},
            "lock_graph": self.lock_graph.to_json(),
            "waivers": self.waivers,
            "problems": self.problems,
            "findings": [f.to_json() for f in self.findings],
        }

    def save(self, out_dir: str | pathlib.Path) -> pathlib.Path:
        out = pathlib.Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / "host_report.json"
        path.write_text(json.dumps(self.to_json(), indent=1) + "\n")
        return path


def run_host_lint(
    targets: list[HostTarget] | None = None,
    guards: GuardMap | None = None,
    rule_names: list[str] | None = None,
) -> HostReport:
    """Scan ``targets`` (default: the eight production threaded-module
    targets) and run the host rules under ``guards`` (default: the
    production guard map). ``rule_names`` filters to a subset of
    H1/H2/H3/H4 (H1 and H3 share the attribute-discipline pass)."""
    targets = default_targets() if targets is None else targets
    guards = default_guards() if guards is None else guards
    wanted = set(RULES) if not rule_names else set(rule_names)
    unknown = wanted - set(RULES)
    if unknown:
        raise KeyError(f"unknown host rule(s): {sorted(unknown)}")

    scans: list[ModuleScan] = []
    module_target: dict[str, str] = {}
    for t in targets:
        for module, path in t.modules:
            scans.append(scan_module(module, path))
            module_target[module] = t.name
    prog = Program(scans, guards)
    target_modules = set(module_target)

    report = HostReport(rules_run=sorted(wanted))
    report.roots = {k: sorted(v) for k, v in prog.roots.items()}
    report.classes_checked = sum(
        1 for c, m in prog.class_module.items() if m in target_modules
    )

    findings: list[HostFinding] = []
    waivers: list[dict] = []
    if wanted & {"H1-lock-discipline", "H3-confinement"}:
        f, w = rules_mod.check_attr_discipline(prog, target_modules)
        findings.extend(
            x for x in f if x.rule in wanted
        )
        waivers.extend(w)
    if "H2-lock-order" in wanted:
        graph, f = prog.lock_graph()
        report.lock_graph = graph
        findings.extend(f)
    if "H4-atomic-publish" in wanted:
        f, w = rules_mod.check_atomic_publish(prog, target_modules)
        findings.extend(f)
        waivers.extend(w)

    report.findings = sorted(
        findings, key=lambda f: (f.rule, f.module, f.where, f.lineno)
    )
    report.waivers = sorted(waivers, key=lambda w: str(w["where"]))
    report.problems = list(prog.problems)

    by_target: dict[str, list[HostFinding]] = {t.name: [] for t in targets}
    for f in report.findings:
        by_target.setdefault(
            module_target.get(f.module, f.module), []
        ).append(f)
    report.targets = [
        {
            "name": t.name,
            "modules": [m for m, _ in t.modules],
            "ok": not by_target[t.name],
            "findings": len(by_target[t.name]),
        }
        for t in targets
    ]
    return report
