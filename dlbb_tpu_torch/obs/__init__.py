"""Observability (counterpart of ``dlbb_tpu/obs``): the span tracer
(``spans``) and the metrics registry with its Prometheus textfile export
(``export``), copies of the JAX modules; the gated per-config device
capture over ``torch.profiler`` (``capture``) and its analysis
(``devtrace``); the sweep-artifact corpus (``corpus``) and the cm2 fit
over it (``fit``); span-level time attribution against the cost model
(``attribution``).  The sweep runner, the train loop and the serving
harness emit into all of them (ROADMAP Queue 1, Slice F, item 13).

``cli obs trace`` rebuilds a run's timeline from its journal, ``cli obs
devtrace`` parses its device captures, ``cli obs fit`` regresses the
cost model from a results tree into the versioned DB under
``stats/torch/analysis/costmodel_fit`` and ``cli obs attribute`` partitions
a run's span trace (else its journal) into phases priced by the cost model,
MD + CSV under ``stats/torch/analysis/attribution`` (:func:`run_obs`); the
cost model's calibration and its diff are item 14, part 14b (over item
15, part 15b's schedule baselines).  Exit codes
follow ``analysis.findings.EXIT_*``: 0 clean / 1 findings / 2 crash; a
``--model cm2`` attribution of a tier with no fit is a finding (1).
"""

from __future__ import annotations

from typing import Optional

from dlbb_tpu_torch.analysis.findings import EXIT_CLEAN, EXIT_CRASH, EXIT_FINDINGS, exit_code
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
# JAX's obs subcommands that wait for the cost model's calibration
# (item 14, part 14b) and the schedule audit (item 15, part 15b)
_NOT_PORTED = {
    "calibrate": ("ROADMAP Queue 1, Slice F, item 14 (part 14b, the cost model's "
                  "calibration)"),
    "diff": ("ROADMAP Queue 1, Slice F, item 14 (part 14b, the calibration gate), over "
             "item 15's schedule baselines (part 15b)"),
}


def run_obs(which: str, journal: Optional[str] = None, output: Optional[str] = None,
            strict_warnings: bool = False, verbose: bool = True,
            results: Optional[list[str]] = None, tier: Optional[str] = None,
            fit_dir: Optional[str] = None, min_samples: Optional[int] = None,
            host_filter: Optional[str] = None, model: str = "cm1",
            trace: Optional[str] = None) -> int:
    """``cli obs``: JAX's exit-code contract, an internal exception
    surfacing as ``EXIT_CRASH``."""
    try:
        return _run_obs(which, journal, output, strict_warnings, verbose, results, tier,
                        fit_dir, min_samples, host_filter, model, trace)
    except Exception:  # noqa: BLE001 — the exit-code contract
        import traceback

        traceback.print_exc()
        return EXIT_CRASH


def _run_obs(which: str, journal: Optional[str], output: Optional[str],
             strict_warnings: bool, verbose: bool, results: Optional[list[str]],
             tier: Optional[str], fit_dir: Optional[str], min_samples: Optional[int],
             host_filter: Optional[str], model: str, trace: Optional[str]) -> int:
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
    if which == "fit":
        from dlbb_tpu_torch.obs.fit import MIN_SAMPLES, FitError, run_fit

        try:
            run_fit(results=results or ["results/torch"], tiers=[tier] if tier else None,
                    fit_dir=fit_dir or output,
                    min_samples=min_samples if min_samples is not None else MIN_SAMPLES,
                    host_filter=host_filter, verbose=verbose)
        except FitError as e:
            # a degenerate corpus is a finding (exit 1), not a crash (exit 2)
            print(f"[obs] fit refused: {e}")
            return EXIT_FINDINGS
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
    if which == "attribute":
        from dlbb_tpu_torch.analysis.costmodel import FitMissingError
        from dlbb_tpu_torch.obs.attribution import run_attribution, validate_attribution

        if not journal:
            print("error: obs attribute needs --journal DIR (a sweep or serving output "
                  "directory)")
            return EXIT_CRASH
        try:
            record = run_attribution(input_dir=journal, out_dir=output, trace=trace,
                                     model=model, tier=tier, fit_dir=fit_dir,
                                     verbose=verbose)
        except FitMissingError as e:
            print(f"[obs] attribution refused: {e}")
            return EXIT_FINDINGS
        problems = validate_attribution(record)
        if problems:
            for p in problems:
                print(f"[obs] attribution problem: {p}")
            return EXIT_FINDINGS
        return EXIT_CLEAN
    if which in _NOT_PORTED:
        print(f"error: obs {which} is not ported yet ({_NOT_PORTED[which]})")
        return EXIT_CRASH
    print(f"error: unknown obs command {which!r}; known: {', '.join(OBS_COMMANDS)}")
    return EXIT_CRASH
