"""Observability (counterpart of ``dlbb_tpu/obs``): the span tracer
(``spans``) and the metrics registry with its Prometheus textfile export
(``export``), copies of the JAX modules; the gated per-config device
capture over ``torch.profiler`` (``capture``) and its analysis
(``devtrace``, with ``corpus``'s op samples).  The sweep runner and the
serving harness emit into all of them (ROADMAP Queue 1, Slice F, item 13).

``cli obs trace`` rebuilds a run's timeline from its journal and ``cli obs
devtrace`` parses its device captures (:func:`run_obs`); the cost model's
calibration, diff, fit and attribution are items 14 and 15.  Exit codes
follow ``analysis.findings.EXIT_*``: 0 clean / 1 findings / 2 crash.
"""

from __future__ import annotations

from typing import Optional

from dlbb_tpu_torch.analysis.findings import EXIT_CLEAN, EXIT_CRASH, exit_code
from dlbb_tpu_torch.obs.export import LabeledCounter, MetricsRegistry
from dlbb_tpu_torch.obs.spans import (
    SpanTracer,
    instant,
    journal_sink,
    journal_to_trace,
    span,
    tracing,
    validate_trace_events,
)

__all__ = [
    "LabeledCounter",
    "MetricsRegistry",
    "SpanTracer",
    "instant",
    "journal_sink",
    "journal_to_trace",
    "run_obs",
    "span",
    "tracing",
    "validate_trace_events",
]

OBS_COMMANDS = ("trace", "calibrate", "diff", "fit", "attribute", "devtrace")
# JAX's obs subcommands that wait for the port's cost model (item 14) and
# its schedule audit (item 15)
_NOT_PORTED = {
    "calibrate": "ROADMAP Queue 1, Slice F, item 14 (the cost model's calibration)",
    "diff": ("ROADMAP Queue 1, Slice F, item 14 (the calibration gate), over item 15's "
             "schedule baselines"),
    "fit": "ROADMAP Queue 1, Slice F, item 14 (the fitted cost model)",
    "attribute": "ROADMAP Queue 1, Slice F, item 14 (span attribution against the cost model)",
}


def run_obs(which: str, journal: Optional[str] = None, output: Optional[str] = None,
            strict_warnings: bool = False, verbose: bool = True) -> int:
    """``cli obs``: JAX's exit-code contract, an internal exception
    surfacing as ``EXIT_CRASH``."""
    try:
        return _run_obs(which, journal, output, strict_warnings, verbose)
    except Exception:  # noqa: BLE001 — the exit-code contract
        import traceback

        traceback.print_exc()
        return EXIT_CRASH


def _run_obs(which: str, journal: Optional[str], output: Optional[str],
             strict_warnings: bool, verbose: bool) -> int:
    from pathlib import Path

    if which == "trace":
        if not journal:
            print("error: obs trace needs --journal DIR (a sweep output directory "
                  "holding sweep_journal.jsonl)")
            return EXIT_CRASH
        out = Path(output) if output else Path(journal) / "sweep_trace.json"
        path, n_events, torn = journal_to_trace(journal, out)
        if verbose:
            print(f"[obs] {n_events} journal event(s) -> {path}"
                  + (f" ({torn} torn line(s) skipped)" if torn else ""))
        return EXIT_CLEAN
    if which == "devtrace":
        from dlbb_tpu_torch.obs.devtrace import run_devtrace

        if not journal:
            print("error: obs devtrace needs --journal DIR (a sweep or serving output "
                  "directory whose artifacts record device captures)")
            return EXIT_CRASH
        _report, findings = run_devtrace(input_dir=journal, out_dir=output, verbose=verbose)
        if findings and verbose:
            for f in findings:
                print(f.render())
            errors = sum(1 for f in findings if f.severity == "error")
            print(f"devtrace: {errors} error(s), {len(findings) - errors} warning(s)")
        return exit_code(findings, strict_warnings=strict_warnings)
    if which in _NOT_PORTED:
        print(f"error: obs {which} is not ported yet ({_NOT_PORTED[which]})")
        return EXIT_CRASH
    print(f"error: unknown obs command {which!r}; known: {', '.join(OBS_COMMANDS)}")
    return EXIT_CRASH
