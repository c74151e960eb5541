"""Parallelism-family comparison over the port's train results (counterpart
of ``dlbb_tpu/stats/parallelism_report.py``).

Joins ``train_*.json`` results (``run_train``, ``cli train``) into one
comparison per family: GPipe against 1F1B, ring against Ulysses, MoE dense
against capacity dispatch, and the gradient-accumulation pair, each pair
the same config except for the axis under test; and the long-context grid
of ring against Ulysses (``train_ddp_cp_s{S}_sp{P}_{impl}.json``).  A member
without a result is listed with null times.

Over gloo on one card (or on the CPU) the times are correctness runs, not
speeds; within a family the members run the same model on the same mesh,
so only their order carries information, and only on the card.

``write_autotune_report`` consolidates the autotuner's bench artifact
(``plan/autotune.py``, ``cli plan --auto --bench-out``) into
``AUTOTUNE.md``: JAX's tables and text, but for the sentences naming the
card's rows and the port's test.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

from dlbb_tpu_torch.stats.compare import md_table, write_csv
from dlbb_tpu_torch.utils.config import atomic_write_text

COLUMNS = [
    "family", "member", "experiment", "mesh", "step_time_mean_s",
    "tokens_per_second", "winner", "slowdown_vs_winner",
]

# each family a pair identical except for the axis under test (JAX's matrix)
DEFAULT_FAMILIES: dict[str, list[str]] = {
    "pipeline_schedule": ["pp2_gpipe", "pp2_1f1b"],
    "context_parallel": ["sp2_ring", "sp2_ulysses"],
    "moe_dispatch": ["ep2_moe_dense", "ep2_moe_capacity"],
    # batch 16 keeps the micro-batches divisible by dp=4, batch 20 does not
    # (each micro-step reshards it): per-token throughput compares
    "grad_accum_reshard": ["ga2_divisible_b16", "ga2_reshard_b20"],
}


def collect_family_rows(results_dir: Path, families: dict[str, list[str]]
                        ) -> list[dict[str, Any]]:
    """One row per family member from the train results in
    ``results_dir``; a member without one is listed with null times."""
    artifacts: dict[str, dict] = {}
    for f in sorted(Path(results_dir).glob("train_*.json")):
        try:
            r = json.loads(f.read_text())
        except Exception:  # noqa: BLE001 — a bad file is skipped
            continue
        name = r.get("experiment", {}).get("name")
        if name:
            artifacts[name] = r

    rows: list[dict[str, Any]] = []
    for family, members in families.items():
        present = {m: artifacts[m] for m in members if m in artifacts}
        # the winner by tokens/s (a family may differ in batch size), the
        # first member in declared order on a tie
        best_member: Optional[str] = (
            max(present, key=lambda m: present[m]["tokens_per_second"])
            if present else None)
        best = present[best_member]["tokens_per_second"] if best_member else None
        for m in members:
            r = present.get(m)
            if r is None:
                rows.append({"family": family, "member": m, "experiment": m,
                             "mesh": None, "step_time_mean_s": None,
                             "tokens_per_second": None, "winner": None,
                             "slowdown_vs_winner": None})
                continue
            tps = r["tokens_per_second"]
            rows.append({
                "family": family,
                "member": m,
                "experiment": m,
                "mesh": "x".join(f"{k}{v}" for k, v in r["mesh"].items() if v > 1)
                        or "single",
                "step_time_mean_s": round(r["step_time"]["mean"], 6),
                "tokens_per_second": round(tps, 1),
                "winner": m == best_member,
                "slowdown_vs_winner": round(best / tps, 4),
            })
    return rows


def write_parallelism_report(results_dir: Path, out_dir: Path,
                             families: dict[str, list[str]]) -> list[dict[str, Any]]:
    """``parallelism_comparison.csv`` and ``PARALLELISM.md``; returns the
    rows."""
    rows = collect_family_rows(results_dir, families)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    write_csv(rows, COLUMNS, out_dir / "parallelism_comparison.csv")
    md = [
        "# Parallelism-family benchmarks (dlbb_tpu_torch)",
        "",
        "Step-time comparison of the parallelism extensions, each family "
        "measured at an identical config except for the axis under test "
        f"(the port's `train_*.json` results in `{results_dir}`).  A member "
        "without a result has blank times.",
        "",
        "Runs of several ranks over gloo on one card or on the CPU are "
        "correctness runs, not speeds; within a family the members run the "
        "same model on the same mesh, so only their order is the signal.",
        "",
    ]
    md += md_table(rows, COLUMNS)
    md.append("")
    (out_dir / "PARALLELISM.md").write_text("\n".join(md))
    return rows


CP_COLUMNS = [
    "seq_len", "sp", "ring_tokens_per_second", "ulysses_tokens_per_second",
    "winner", "ring_over_ulysses",
]


def collect_cp_scaling_rows(results_dir: Path) -> list[dict[str, Any]]:
    """One row per (S, sp) cell of the long-context grid, from
    ``train_ddp_cp_s{S}_sp{P}_{impl}.json`` results; a cell whose result is
    a boundary record carries its reason in place of a throughput."""
    cells: dict[tuple[int, int], dict[str, Any]] = {}
    for f in sorted(Path(results_dir).glob("train_ddp_cp_s*.json")):
        try:
            r = json.loads(f.read_text())
        except Exception:  # noqa: BLE001
            continue
        name = r.get("experiment", {}).get("name", "")
        try:
            _, s_tag, sp_tag, impl = name.split("_")
            seq, sp = int(s_tag[1:]), int(sp_tag[2:])
        except ValueError:
            continue
        cell = cells.setdefault((seq, sp), {})
        status = r.get("status", "")
        est = r.get("estimated_bytes")
        tps = r.get("tokens_per_second")
        if status == "skipped_estimated_footprint" and est is not None:
            cell[impl] = f"skip ({est / 2**30:.0f} GiB est.)"
        elif status.startswith("skipped_"):
            cell[impl] = f"skip ({status.removeprefix('skipped_')})"
        elif status:
            cell[impl] = f"skip ({status})"
        elif tps is None:
            cell[impl] = "skip (unreadable artifact)"
        else:
            cell[impl] = round(tps, 1)

    def measured(x: Any) -> bool:
        return isinstance(x, (int, float)) and not isinstance(x, bool)

    rows: list[dict[str, Any]] = []
    for (seq, sp), cell in sorted(cells.items()):
        ring, uly = cell.get("ring"), cell.get("ulysses")
        both = measured(ring) and measured(uly)
        winner = None
        if both:
            winner = "tie" if ring == uly else ("ring" if ring > uly else "ulysses")
        elif measured(ring):
            winner = "ring (ulysses capped)"
        elif measured(uly):
            winner = "ulysses (ring capped)"
        rows.append({
            "seq_len": seq,
            "sp": sp,
            "ring_tokens_per_second": ring,
            "ulysses_tokens_per_second": uly,
            "winner": winner,
            "ring_over_ulysses": round(ring / uly, 4) if both else None,
        })
    return rows


def write_cp_scaling_report(results_dir: Path, out_dir: Path) -> list[dict[str, Any]]:
    """``cp_scaling.csv`` and ``CP_SCALING.md``; returns the rows."""
    rows = collect_cp_scaling_rows(results_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    write_csv(rows, CP_COLUMNS, out_dir / "cp_scaling.csv")
    md = [
        "# Long-context scaling: ring vs Ulysses context parallelism",
        "",
        "Train-step throughput (tokens/s) across the sequence axis, ring "
        "against Ulysses attention at each sp degree (the port's "
        f"`train_ddp_cp_s*_sp*_*.json` results in `{results_dir}`).  "
        "`skip (...)` cells carry a boundary record's reason.  Over gloo on "
        "one card or on the CPU these are correctness runs, not speeds.",
        "",
    ]
    md += md_table(rows, CP_COLUMNS)
    md.append("")
    (out_dir / "CP_SCALING.md").write_text("\n".join(md))
    return rows


AUTOTUNE_COLUMNS = [
    "plan", "role", "predicted_us", "predicted_rank", "measured_rank",
    "goodput_tokens_per_s", "tokens_per_second", "ttft_p50_s",
]


def write_autotune_report(bench_path: "str | Path",
                          out_dir: "str | Path") -> list[dict[str, Any]]:
    """Consolidate ``BENCH_autotune.json`` into ``AUTOTUNE.md`` — the
    model-picked vs measured-winner agreement tables for the plan
    autotuner (``cli plan --auto``, docs/autotune.md).  Returns the
    measured rows (empty when the bench artifact has none — callers
    skip, never clobber)."""
    bench_path = Path(bench_path)
    try:
        bench = json.loads(bench_path.read_text())
    except (OSError, json.JSONDecodeError):
        return []
    agreement = bench.get("agreement") or {}
    rows = agreement.get("rows") or []
    if not rows:
        return []
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    tier = bench.get("tier") or {}
    pruned = bench.get("pruned") or {}
    ranked = bench.get("ranked") or []
    md = [
        "# Plan autotuner: model-picked vs measured winner",
        "",
        f"`cli plan --auto` on the {bench.get('devices', '?')}-device "
        f"simulated mesh (target: {bench.get('target', '?')}; "
        f"docs/autotune.md).  The full plan space is enumerated, "
        f"statically pruned (every pruned point journaled with its "
        f"reason — no silent drops), ranked by the fitted cm2 tier "
        f"(`{tier.get('name', '?')}`, fit v"
        f"{(tier.get('fit') or {}).get('fit_version', '?')}), and the "
        f"top-k plus the default-heuristic plan measured through the "
        f"real engines on one shared seeded trace.",
        "",
        "Simulated-mesh caveat as everywhere in this corpus: host-core "
        "times; predicted and measured share the cpu-sim tier, so "
        "relative ordering is the honest signal.  The card's rows wait "
        "for a `cuda` fit (the bench artifact's `chip` block).",
        "",
        "## Search accounting",
        "",
        f"| searched | {' | '.join(pruned)} | ranked | measured |",
        "|---|" + "---|" * (len(pruned) + 2),
        f"| {bench.get('searched', 0)} | "
        + " | ".join(str(v) for v in pruned.values())
        + f" | {len(ranked)} | {len(rows)} |",
        "",
        "## Measured agreement (top-k + default heuristic)",
        "",
    ]
    md += md_table_from_rows(rows, AUTOTUNE_COLUMNS)
    winner = agreement.get("measured_winner")
    speedup = bench.get("speedup_vs_default")
    md += [
        "",
        f"Measured winner: **{winner}** (cm2 predicted winner: "
        f"{agreement.get('predicted_winner')}; top-2 contains measured "
        f"winner: {agreement.get('top2_contains')})."
        + (f"  Speedup vs default heuristic "
           f"`{bench.get('default_plan')}`: **{speedup:.2f}x**."
           if speedup else ""),
        "",
    ]
    cal = bench.get("calibration_agreement") or {}
    fams = [f for f in cal.get("families", [])
            if f.get("status") == "ok"]
    if fams:
        md += [
            "## Calibration-grid agreement (pinned regression)",
            "",
            f"cm2 top-2 contains the measured winner for "
            f"**{cal.get('agree')}/{cal.get('total')}** families "
            f"(ratio {cal.get('ratio'):.2f}; gate >= 0.70, "
            f"`tests/test_torch_autotune.py`) over the committed calibration "
            f"baseline `{cal.get('baseline')}`.",
            "",
            "| family | predicted order (best first) | measured winner "
            "| top-2 contains |",
            "|---|---|---|---|",
        ]
        for f in fams:
            order = " > ".join(
                m.split("::")[-1] for m in f["predicted_order"])
            md.append(
                f"| {f['family']} | {order} | "
                f"{f['measured_winner'].split('::')[-1]} | "
                f"{'yes' if f['top2_contains_winner'] else 'NO'} |")
        missing = [f for f in cal.get("families", [])
                   if f.get("status") == "missing-target"]
        for f in missing:
            md.append(f"| {f['family']} | missing targets: "
                      f"{', '.join(f['missing'])} | — | excluded |")
        md.append("")
    atomic_write_text("\n".join(md), out / "AUTOTUNE.md")
    return rows


def md_table_from_rows(rows: list[dict[str, Any]],
                       columns: list[str]) -> list[str]:
    """Markdown table over whichever of ``columns`` the rows carry
    (serving and train measured rows share a table shape but not every
    metric column)."""
    cols = [c for c in columns
            if any(r.get(c) is not None for r in rows)]
    lines = ["| " + " | ".join(cols) + " |",
             "|---|" + "---|" * (len(cols) - 1)]
    for r in rows:
        cells = []
        for c in cols:
            v = r.get(c)
            if isinstance(v, float):
                v = f"{v:.3f}" if abs(v) < 100 else f"{v:.1f}"
            cells.append("-" if v is None else str(v))
        lines.append("| " + " | ".join(cells) + " |")
    return lines
