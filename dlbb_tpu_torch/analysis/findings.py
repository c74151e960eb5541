"""Structured findings and the exit-code contract (the part of
``dlbb_tpu/analysis/findings.py`` that ``obs/devtrace.py`` reports
through).

A finding is one violation or notable observation, with enough structure
for machines (the JSON report) and humans (one line in the CLI summary).
``AnalysisReport`` and the audit passes that fill it are item 15.
"""

from __future__ import annotations

from dataclasses import dataclass, field
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

    pass_name: the pass that raised it ("devtrace" here).
    rule:      stable rule identifier.
    severity:  "error" findings fail the run; "warning" findings do not.
    target:    what the finding is about (a capture label, a directory).
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
