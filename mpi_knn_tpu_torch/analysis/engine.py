"""The rule engine: run each cell recorded, run every rule that applies,
gather a machine-readable report (the JAX package's ``analysis/engine.py``,
with the same report schema).

``python -m mpi_knn_tpu_torch lint`` writes the report to
``artifacts/lint/torch/report.json`` and exits non-zero on any finding.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from dataclasses import field

from mpi_knn_tpu_torch.analysis import rules as rules_mod
from mpi_knn_tpu_torch.analysis.lowering import (
    LintTarget,
    UnsupportedTarget,
    default_targets,
    lower_target,
)
from mpi_knn_tpu_torch.analysis.rules import Finding, rules_by_name

SCHEMA_VERSION = 1


@dataclasses.dataclass
class LintContext:
    """What a rule may know: the cell, the config it ran with, the facts
    of its run, and ``stage``, the device type it ran on."""

    target: LintTarget
    cfg: object
    meta: dict
    stage: str = "cpu"


@dataclasses.dataclass
class TargetResult:
    target: LintTarget
    findings: list[Finding] = field(default_factory=list)
    rules_run: list[str] = field(default_factory=list)
    stages: list[str] = field(default_factory=list)
    skipped: str | None = None  # UnsupportedTarget's reason
    memory: dict | None = None  # R7's ledger entry
    cost: dict | None = None  # R8's ledger entry
    launches: dict = field(default_factory=dict)  # kernel -> launches
    overrides: dict = field(default_factory=dict)  # lower_target's

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        t = self.target
        return {
            "label": t.label, "backend": t.backend, "metric": t.metric,
            "dtype": t.dtype, "policy": t.policy, "schedule": t.schedule,
            "fusion": t.fusion, "quant": t.quant, "serve": t.serve,
            "ladder": t.ladder, "frontend": t.frontend, "mutate": t.mutate,
            "ok": self.ok, "skipped": self.skipped,
            "rules_run": self.rules_run, "stages": self.stages,
            "findings": [f.to_json() for f in self.findings],
            "memory": self.memory, "cost": self.cost,
            "launches": self.launches, "overrides": self.overrides,
        }


@dataclasses.dataclass
class LintReport:
    results: list[TargetResult]
    platform: str = "cpu"
    device_name: str = ""

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    @property
    def findings(self) -> list[Finding]:
        return [f for r in self.results for f in r.findings]

    def to_json(self) -> dict:
        import torch

        checked = [r for r in self.results if r.skipped is None]
        return {
            "schema_version": SCHEMA_VERSION,
            "source": "mpi_knn_tpu_torch.analysis",
            "torch_version": torch.__version__,
            "platform": self.platform,
            "device_name": self.device_name,
            "device_count": 1,
            "ok": self.ok,
            "summary": {
                "targets_checked": len(checked),
                "targets_skipped": len(self.results) - len(checked),
                "findings": len(self.findings),
            },
            "targets": [r.to_json() for r in self.results],
        }

    def save(self, out_dir) -> pathlib.Path:
        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / "report.json"
        path.write_text(json.dumps(self.to_json(), indent=1) + "\n")
        return path


def run_rules(trace, ctx: LintContext, rules: list | None = None
              ) -> tuple[list[Finding], list[str]]:
    """Every applicable rule over one recorded run. Split out from
    :func:`lint_target` so tests feed deliberately broken runs through the
    production rule path."""
    rules = rules_mod.RULES if rules is None else rules
    findings, ran = [], []
    for rule in rules:
        if rule.applies(ctx):
            ran.append(rule.name)
            findings.extend(rule.check(ctx, trace))
    return findings, ran


def lint_target(target: LintTarget, rule_names: list[str] | None = None,
                device="cuda", overrides=None) -> TargetResult:
    """Run one cell recorded on ``device`` (with ``overrides``, see
    ``lowering.lower_target``) and every applicable rule."""
    import torch

    from mpi_knn_tpu_torch.analysis.cost import profile_for_device

    rules = rules_by_name(rule_names)
    res = TargetResult(target=target, overrides=dict(overrides or {}))
    dev = torch.device(device)
    try:
        trace, cfg, meta = lower_target(target, dev, overrides)
    except UnsupportedTarget as e:
        res.skipped = str(e)
        return res
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else ""
    meta = dict(meta, profile=profile_for_device(dev.type, card),
                allocator_growth=trace.allocator_growth)
    res.stages = [dev.type]
    res.launches = {}
    for k in trace.kernels():
        res.launches[k.name] = res.launches.get(k.name, 0) + 1
    ctx = LintContext(target=target, cfg=cfg, meta=meta, stage=dev.type)
    res.findings, res.rules_run = run_rules(trace, ctx, rules)
    res.memory = ctx.meta.get("r7_analysis")
    res.cost = ctx.meta.get("r8_analysis")
    return res


def run_matrix(targets: list[LintTarget] | None = None,
               rule_names: list[str] | None = None, progress=None,
               device="cuda") -> LintReport:
    """The full sweep (or a filtered subset) on ``device``."""
    import torch

    dev = torch.device(device)
    targets = default_targets() if targets is None else targets
    results = []
    for t in targets:
        r = lint_target(t, rule_names, dev)
        if progress is not None:
            progress(r)
        results.append(r)
    return LintReport(results, dev.type,
                      torch.cuda.get_device_name(dev) if dev.type == "cuda" else "")
