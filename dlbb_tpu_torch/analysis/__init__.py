"""Static and runtime analysis (counterpart of ``dlbb_tpu/analysis``).

- ``findings`` — the findings model, ``AnalysisReport`` and the exit-code
  contract (``obs/devtrace.py`` reports through it too);
- ``expectations`` — the analytic expected-collective model and the wire
  model (``op_wire_bytes``, the compressed wire's constants);
- ``source_lint`` — the AST lint over the port's files (``analyze lint``);
- ``op_capture`` — what one call of a target issues (the ``c10d`` ops, the
  aten op stream, the flash launches, the state's storages): the port's
  counterpart of ``hlo_parse``;
- ``hlo_audit`` — the collective audit over the registered targets
  (``analyze hlo``);
- ``costmodel`` — the α–β cost-model tables.

CLI: ``python -m dlbb_tpu_torch analyze lint|hlo [--simulate N]``.  The
schedule, memory and numerics passes, ``all``, and the baseline gate
``snapshot|diff`` are ROADMAP Queue 1, Slice F, item 15, part 15b: they
exit 2.  Exit codes are JAX's pinned contract (``findings.EXIT_*``): 0
clean, 1 findings, 2 the analyzer crashed.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from dlbb_tpu_torch.analysis.findings import (  # noqa: F401
    EXIT_CLEAN,
    EXIT_CRASH,
    EXIT_FINDINGS,
    SEVERITY_ERROR,
    AnalysisReport,
    Finding,
)

# the choices of ``analyze`` the port runs; JAX's others are part 15b's
PORTED_PASSES = ("hlo", "lint")
NOT_PORTED = "not ported yet (ROADMAP Queue 1, Slice F, item 15, part 15b)"


def run_analysis(
    which: str = "all",
    root: Optional[str] = None,
    json_path: Optional[str] = None,
    verbose: bool = True,
    strict_warnings: bool = False,
    output: Optional[str] = None,
    simulate: int = 0,
) -> int:
    """Run the requested pass, print the summary, write the JSON report
    (``json_path``) and fold the per-pass gauges into ``output/metrics.prom``.
    Returns JAX's exit code: 0 clean, 1 findings, 2 crash (any exception
    surfaces as 2).  ``simulate`` N runs the collective audit on N gloo
    ranks (``bench/launch.py``); without it the audit runs in this process
    (one rank, where every target is skipped)."""
    try:
        return _run_analysis(which, root, json_path, verbose, strict_warnings, output,
                             simulate)
    except Exception:  # noqa: BLE001 — the exit-code contract
        import traceback

        traceback.print_exc()
        return EXIT_CRASH


def _run_analysis(which, root, json_path, verbose, strict_warnings, output,
                  simulate) -> int:
    if which not in PORTED_PASSES:
        print(f"error: analyze {which} is {NOT_PORTED}")
        return EXIT_CRASH
    report = AnalysisReport()
    if which == "lint":
        from dlbb_tpu_torch.analysis.source_lint import run_source_lint

        report.extend(run_source_lint(root=root, verbose=False))
    else:
        hlo = _hlo_report(simulate, verbose)
        if not hlo.targets_audited:
            # every target skipped for lack of ranks: a gate wired to the
            # exit code must not read that as a clean audit
            hlo.findings.append(Finding(
                pass_name="hlo", rule="no-targets-audited",
                severity=SEVERITY_ERROR, target="<backend>",
                message=(
                    f"0 HLO targets audited ({len(hlo.skipped_targets)} "
                    "skipped for lack of devices); pass --simulate N "
                    "(e.g. 8) to launch that many gloo ranks"
                ),
            ))
        report.extend(hlo)
    if output:
        from dlbb_tpu_torch.obs.export import analysis_metrics

        analysis_metrics(report).fold_textfile(Path(output) / "metrics.prom")
    if verbose:
        print(report.render_summary())
    if json_path:
        report.write_json(json_path)
        if verbose:
            print(f"[analyze] JSON report written to {json_path}")
    return report.exit_code(strict_warnings=strict_warnings)


def _hlo_report(simulate: int, verbose: bool) -> AnalysisReport:
    """The collective audit's report: rank 0's of ``simulate`` gloo ranks,
    or this process's at world 1."""
    from dlbb_tpu_torch.analysis.hlo_audit import _audit_rank, run_hlo_audit

    if not simulate:
        return run_hlo_audit(verbose=verbose)
    from dlbb_tpu_torch.bench.launch import launch

    return launch(_audit_rank, simulate, "cpu", args=(verbose, "cpu"))[0]
