"""Static and runtime analysis (counterpart of ``dlbb_tpu/analysis``).

- ``findings`` — the findings model, ``AnalysisReport`` and the exit-code
  contract (``obs/devtrace.py`` reports through it too);
- ``expectations`` — the analytic expected-collective model and the wire
  model (``op_wire_bytes``, the compressed wire's constants);
- ``source_lint`` — the AST lint over the port's files (``analyze lint``);
- ``op_capture`` — one call of a target as a dataflow graph (its ops,
  buffers and edges, its ``c10d`` ops, the flash kernels' nodes, the hops'
  waits, the state's storages): the port's counterpart of ``hlo_parse``;
- ``hlo_audit`` — the collective audit over the registered targets
  (``analyze hlo``), and the one call per target every pass reads;
- ``schedule_audit`` — the α–β critical path, the overlap proof, the
  divergence check across ranks, and the baseline gate (``analyze
  schedule|snapshot|diff``);
- ``memory_audit`` — buffer liveness and peak live bytes (``analyze
  memory``);
- ``numerics_audit`` and ``numerics_shadow`` — dtype flow and precision
  policy, and the fp64 shadow that replays its error bounds (``analyze
  numerics``);
- ``costmodel`` — the α–β cost-model tables.

CLI: ``python -m dlbb_tpu_torch analyze
[hlo|lint|schedule|memory|numerics|all|snapshot|diff] --simulate 8``.
``snapshot`` writes the per-target baselines under
``stats/torch/analysis/baselines/`` (refused while the audit has error
findings); ``diff`` compares a fresh audit against them.  Exit codes are
JAX's pinned contract (``findings.EXIT_*``): 0 clean, 1 findings, 2 the
analyzer crashed.
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

# the passes each choice of ``analyze`` runs over the targets (JAX's table)
_HLO_PASSES = {
    "hlo": ("hlo",),
    "schedule": ("schedule",),
    "memory": ("memory",),
    "numerics": ("numerics",),
    "all": ("hlo", "schedule", "memory", "numerics"),
    "snapshot": ("hlo", "schedule", "memory", "numerics"),
    "diff": ("hlo", "schedule", "memory", "numerics"),
}

# the memory and numerics meta keys folded into the per-target baselines
# next to the schedule keys (one gate file per target)
_MEMORY_BASELINE_KEYS = ("peak_live_bytes", "max_transient_bytes")
_NUMERICS_BASELINE_KEYS = (
    "numerics_low_precision_sites",
    "numerics_convert_count",
    "numerics_max_rel_error_bound",
)


def fold_gate_keys(report: AnalysisReport) -> AnalysisReport:
    """Fold the memory and numerics passes' gate keys into the schedule
    meta: they ride the schedule pass's baselines, one file per target."""
    for section, keys in ((report.memory, _MEMORY_BASELINE_KEYS),
                          (report.numerics, _NUMERICS_BASELINE_KEYS)):
        for target, meta in section.items():
            dest = report.schedule.setdefault(target, {})
            dest.update({k: meta[k] for k in keys if k in meta})
    return report


def run_analysis(
    which: str = "all",
    root: Optional[str] = None,
    json_path: Optional[str] = None,
    verbose: bool = True,
    strict_warnings: bool = False,
    output: Optional[str] = None,
    simulate: int = 0,
    baselines: Optional[str] = None,
    tier: Optional[str] = None,
    model: str = "cm1",
) -> int:
    """Run the requested passes, print the summary, write the JSON report
    (``json_path``) and the per-pass artifacts and gauges under
    ``output``.  Returns JAX's exit code: 0 clean, 1 findings, 2 crash
    (any exception surfaces as 2).  ``simulate`` N runs the target passes
    on N gloo ranks (``bench/launch.py``); without it they run in this
    process (one rank, where every target is skipped)."""
    try:
        return _run_analysis(which, root, json_path, verbose, strict_warnings, output,
                             simulate, baselines, tier, model)
    except Exception:  # noqa: BLE001 — the exit-code contract
        import traceback

        traceback.print_exc()
        return EXIT_CRASH


def _run_analysis(which, root, json_path, verbose, strict_warnings, output,
                  simulate, baselines, tier, model) -> int:
    from dlbb_tpu_torch.analysis.schedule_audit import DEFAULT_BASELINE_DIR

    if which not in _HLO_PASSES and which != "lint":
        raise ValueError(f"unknown analyze pass {which!r}")
    report = AnalysisReport()
    if which in ("lint", "all"):
        from dlbb_tpu_torch.analysis.source_lint import run_source_lint

        report.extend(run_source_lint(root=root, verbose=False))
    passes = _HLO_PASSES.get(which)
    if passes:
        hlo = _target_report(simulate, verbose, passes, tier, model)
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

    if which in ("all", "snapshot", "diff"):
        fold_gate_keys(report)

    if output and report.memory:
        from dlbb_tpu_torch.analysis.costmodel import resolve_tier
        from dlbb_tpu_torch.analysis.hlo_audit import default_tier
        from dlbb_tpu_torch.analysis.memory_audit import write_memory_artifacts

        device = "cpu" if simulate else None
        cost_tier = resolve_tier(tier or default_tier(device), model=model, warn=False)
        path = write_memory_artifacts(report.memory, output, cost_tier)
        if verbose:
            print(f"[analyze] memory report written to {path} "
                  "(manifest + metrics.prom updated)")
    if output and report.numerics:
        from dlbb_tpu_torch.analysis.numerics_audit import write_numerics_artifacts

        path = write_numerics_artifacts(report.numerics, output)
        if verbose:
            print(f"[analyze] numerics report written to {path} "
                  "(manifest + metrics.prom updated)")
    if output:
        from dlbb_tpu_torch.obs.export import analysis_metrics

        analysis_metrics(report).fold_textfile(Path(output) / "metrics.prom")

    base_dir = Path(baselines) if baselines else DEFAULT_BASELINE_DIR
    skipped = tuple(s["target"] for s in report.skipped_targets)
    if which == "snapshot":
        from dlbb_tpu_torch.analysis.schedule_audit import snapshot_baselines

        if report.errors:
            # a snapshot of a failing audit would launder the failure into
            # the committed gate
            print("[analyze] snapshot refused: the audit has error findings — "
                  "fix them first")
        else:
            written = snapshot_baselines(report.schedule, base_dir, skipped_targets=skipped)
            if verbose:
                print(f"[analyze] {len(written)} baseline snapshot(s) written to {base_dir}")
    elif which == "diff":
        from dlbb_tpu_torch.analysis.schedule_audit import diff_baselines

        report.findings.extend(diff_baselines(report.schedule, base_dir,
                                              skipped_targets=skipped))
    if verbose:
        print(report.render_summary())
    if json_path:
        report.write_json(json_path)
        if verbose:
            print(f"[analyze] JSON report written to {json_path}")
    return report.exit_code(strict_warnings=strict_warnings)


def _target_report(simulate: int, verbose: bool, passes, tier, model) -> AnalysisReport:
    """The target passes' report: rank 0's of ``simulate`` gloo ranks, or
    this process's at world 1."""
    from dlbb_tpu_torch.analysis.hlo_audit import _audit_rank, run_hlo_audit

    if not simulate:
        return run_hlo_audit(verbose=verbose, passes=passes, tier=tier, model=model)
    from dlbb_tpu_torch.bench.launch import launch

    return launch(_audit_rank, simulate, "cpu",
                  args=(verbose, "cpu", None, passes, tier, model))[0]
