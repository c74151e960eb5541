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
so only their order carries information, and only on the card.  The JAX
package's autotuner report belongs to ``plan/autotune.py``, which is not
ported (ROADMAP Queue 1, Slice F, item 14).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

from dlbb_tpu_torch.stats.compare import md_table, write_csv

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
