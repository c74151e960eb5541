"""Structured findings, the analysis report and the exit-code contract
(counterpart of ``dlbb_tpu/analysis/findings.py``).

A finding is one violation or notable observation from a pass (the source
lint ``source_lint``, the collective audit ``hlo_audit``, the device-trace
analysis ``obs/devtrace.py``), with enough structure for machines (the
JSON report) and humans (one line in the CLI summary).  ``AnalysisReport``
is one ``analyze`` run's aggregate, with JAX's fields and JSON keys, so a
report of the same findings writes JAX's JSON.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"

# JAX's exit-code contract of ``analyze`` and ``obs``: 0 = clean, 1 =
# findings (errors, or warnings under --strict-warnings), 2 = the tool
# itself crashed (or unusable arguments)
EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_CRASH = 2


@dataclass
class Finding:
    """One finding.

    pass_name: "hlo", "lint", "schedule", "memory", "numerics" or
               "devtrace".
    rule:      stable rule identifier.
    severity:  "error" findings fail the run; "warning" findings do not.
    target:    audit-target name (hlo), repo-relative file path (lint),
               or a capture label or directory (devtrace).
    message:   human-readable one-liner.
    location:  "file:line" when known.
    details:   rule-specific structure.
    """

    pass_name: str
    rule: str
    severity: str
    target: str
    message: str
    location: Optional[str] = None
    details: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "pass": self.pass_name,
            "rule": self.rule,
            "severity": self.severity,
            "target": self.target,
            "message": self.message,
            "location": self.location,
            "details": self.details,
        }

    def render(self) -> str:
        loc = f" ({self.location})" if self.location else ""
        return (f"[{self.pass_name}/{self.severity}] {self.rule} "
                f"@ {self.target}{loc}: {self.message}")


def exit_code(findings: list[Finding], strict_warnings: bool = False) -> int:
    """JAX's ``AnalysisReport.exit_code`` over ``findings``."""
    if any(f.severity == SEVERITY_ERROR for f in findings):
        return EXIT_FINDINGS
    if strict_warnings and any(f.severity == SEVERITY_WARNING for f in findings):
        return EXIT_FINDINGS
    return EXIT_CLEAN


@dataclass
class AnalysisReport:
    """Aggregate result of one ``analyze`` run (JAX's fields, in JAX's
    order).  ``schedule``, ``memory`` and ``numerics`` hold the per-target
    meta of those passes; the collective audit and the lint leave them
    empty."""

    findings: list[Finding] = field(default_factory=list)
    suppressed: int = 0
    targets_audited: list[str] = field(default_factory=list)
    files_linted: int = 0
    skipped_targets: list[dict[str, str]] = field(default_factory=list)
    schedule: dict[str, dict] = field(default_factory=dict)
    memory: dict[str, dict] = field(default_factory=dict)
    numerics: dict[str, dict] = field(default_factory=dict)

    def extend(self, other: "AnalysisReport") -> None:
        self.findings.extend(other.findings)
        self.suppressed += other.suppressed
        self.targets_audited.extend(other.targets_audited)
        self.files_linted += other.files_linted
        self.skipped_targets.extend(other.skipped_targets)
        self.schedule.update(other.schedule)
        self.memory.update(other.memory)
        self.numerics.update(other.numerics)

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == SEVERITY_ERROR]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == SEVERITY_WARNING]

    def exit_code(self, strict_warnings: bool = False) -> int:
        return exit_code(self.findings, strict_warnings=strict_warnings)

    def to_dict(self) -> dict[str, Any]:
        return {
            "findings": [f.to_dict() for f in self.findings],
            "schedule": self.schedule,
            "memory": self.memory,
            "numerics": self.numerics,
            "summary": {
                "errors": len(self.errors),
                "warnings": len(self.warnings),
                "suppressed": self.suppressed,
                "targets_audited": self.targets_audited,
                "files_linted": self.files_linted,
                "skipped_targets": self.skipped_targets,
            },
        }

    def write_json(self, path) -> None:
        from dlbb_tpu_torch.utils.config import atomic_write_text

        atomic_write_text(json.dumps(self.to_dict(), indent=2, sort_keys=True), Path(path))

    def render_summary(self) -> str:
        lines = [f.render() for f in self.findings]
        lines.append(
            f"comm-lint: {len(self.errors)} error(s), "
            f"{len(self.warnings)} warning(s), {self.suppressed} suppressed; "
            f"{len(self.targets_audited)} HLO target(s) audited, "
            f"{self.files_linted} file(s) linted"
            + (f", {len(self.schedule)} schedule report(s)" if self.schedule else "")
            + (f", {len(self.memory)} memory report(s)" if self.memory else "")
            + (f", {len(self.numerics)} numerics report(s)" if self.numerics else "")
            + (f", {len(self.skipped_targets)} target(s) skipped"
               if self.skipped_targets else "")
        )
        return "\n".join(lines)
