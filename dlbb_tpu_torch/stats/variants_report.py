"""Variant tuning comparison: which mesh, reduction, schedule or wire variant
wins (counterpart of ``dlbb_tpu/stats/variants_report.py``).

Joins the ``<variants stats root>/<impl>/benchmark_statistics.csv`` files
(``cli stats1d`` over each variant's sweep) into one per-size table with
the winning variant per row, as a CSV per rank count and one markdown
report; ``write_variants3d_report`` does the same for the 3D sweep against
the default corpus.  The baseline implementation is a parameter, the port's
``torch_nccl`` by default (the JAX package names ``xla_tpu``).  The join
drops a variant missing a row rather than guessing.  The default rank
counts include 1, the one NCCL world a single card gives.
"""

from __future__ import annotations

import csv
import re
from pathlib import Path
from typing import Any, Optional

from dlbb_tpu_torch.stats.compare import DEFAULT_IMPL, md_table, write_csv


def _read_rows(csv_path: Path) -> list[dict[str, Any]]:
    with csv_path.open() as f:
        return list(csv.DictReader(f))


def collect_variant_rows(variants_stats_root: Path, operation: str = "allreduce",
                         num_ranks: int = 8
                         ) -> tuple[dict[str, dict[str, float]], dict[str, int]]:
    """``({impl: {data_size_name: mean_time_us}}, {data_size_name:
    num_elements})`` for one (op, ranks); empty where the root does not
    exist."""
    out: dict[str, dict[str, float]] = {}
    size_elems: dict[str, int] = {}
    root = Path(variants_stats_root)
    if not root.is_dir():
        return out, size_elems
    for impl_dir in sorted(root.iterdir()):
        stats_csv = impl_dir / "benchmark_statistics.csv"
        if not impl_dir.is_dir() or not stats_csv.exists():
            continue
        rows: dict[str, float] = {}
        for r in _read_rows(stats_csv):
            if r["operation"] != operation or int(r["num_ranks"]) != num_ranks:
                continue
            size = r["data_size_name"]
            rows[size] = float(r["mean_time_us"])
            if r.get("num_elements"):
                size_elems[size] = int(r["num_elements"])
        if rows:
            out[impl_dir.name] = rows
    return out, size_elems


def _parse_size_label(label: str) -> int:
    """'64KB' -> 65536, '1GB' -> 2**30; an unparseable label sorts first."""
    m = re.fullmatch(r"(\d+)(KB|MB|GB)", label.strip())
    if not m:
        return 0
    return int(m.group(1)) * {"KB": 2**10, "MB": 2**20, "GB": 2**30}[m.group(2)]


def _build_table(data: dict[str, dict[str, float]], size_elems: dict[str, int],
                 baseline_impl: str):
    """(table rows, per-size winners, sizes, impls) for one rank count."""
    impls = sorted(data)
    all_sizes = {s for rows in data.values() for s in rows}
    # payload order, the label parsed where a CSV lacks num_elements, the
    # name as the last tie-break
    sizes = sorted(all_sizes, key=lambda s: (size_elems.get(s, _parse_size_label(s)), s))
    table: list[dict[str, Any]] = []
    winners: dict[str, dict[str, Any]] = {}
    for size in sizes:
        row: dict[str, Any] = {"data_size_name": size}
        present = {impl: rows[size] for impl, rows in data.items() if size in rows}
        for impl in impls:
            row[impl] = round(present[impl], 3) if impl in present else None
        winner = min(present, key=present.get)  # type: ignore[arg-type]
        row["winner"] = winner
        base = present.get(baseline_impl)
        speedup = (round(base / present[winner], 4)
                   if base is not None and present[winner] > 0 else None)
        row["winner_speedup_vs_default"] = speedup
        winners[size] = {"winner": winner, "mean_time_us": round(present[winner], 3),
                         "speedup_vs_default": speedup}
        table.append(row)
    return table, winners, sizes, impls


def write_variants_report(variants_stats_root: Path, out_dir: Optional[Path] = None,
                          operation: str = "allreduce",
                          rank_counts: tuple[int, ...] = (1, 2, 4, 8, 16),
                          primary_ranks: int = 8,
                          baseline_impl: str = DEFAULT_IMPL) -> dict[str, Any]:
    """``variants_comparison.csv`` (the ``primary_ranks`` table, or the
    largest measured rank count), ``variants_comparison_ranks{N}.csv`` for
    the others and ``VARIANTS.md``; returns the summary (the primary
    table's winners at the top level, every rank count's under
    ``"ranks"``)."""
    out_dir = Path(out_dir) if out_dir is not None else Path(variants_stats_root)
    per_rank: dict[int, tuple] = {}
    for n in rank_counts:
        data, size_elems = collect_variant_rows(variants_stats_root, operation, n)
        if data:
            per_rank[n] = _build_table(data, size_elems, baseline_impl)
    if not per_rank:
        return {"sizes": [], "winners": {}}
    primary_n = primary_ranks if primary_ranks in per_rank else max(per_rank)

    out_dir.mkdir(parents=True, exist_ok=True)
    md = [
        f"# Variant tuning comparison — {operation}",
        "",
        "Per-size mean time (µs) across the executable tuning variants "
        "(`dlbb_tpu_torch/comm/variants.py`) — the analogue of the reference's "
        "`CCL_ALLREDUCE` algorithm sweep corpus, one section per measured "
        f"rank count.  `winner_speedup_vs_default` is {baseline_impl} mean / "
        "winner mean (>1: tuning beats the default).  Blank cells: that "
        "variant has no row at this size (fixed-shape meshes only run at "
        "their own rank count; memory-capped configs are skipped).",
        "",
    ]
    for n, (table, _, _, impls) in sorted(per_rank.items()):
        columns = ["data_size_name", *impls, "winner", "winner_speedup_vs_default"]
        csv_name = ("variants_comparison.csv" if n == primary_n
                    else f"variants_comparison_ranks{n}.csv")
        write_csv(table, columns, out_dir / csv_name)
        md += [f"## {n} ranks", ""]
        md += md_table(table, columns)
        md.append("")
    (out_dir / "VARIANTS.md").write_text("\n".join(md))

    _, winners, sizes, _ = per_rank[primary_n]
    return {
        "sizes": sizes,
        "winners": winners,
        "primary_rank_count": primary_n,
        "ranks": {n: {"sizes": s, "winners": w}
                  for n, (_, w, s, _) in sorted(per_rank.items())},
    }


def write_variants3d_report(variants3d_stats_root: Path,
                            base_3d_stats_csv: Optional[Path] = None,
                            out_dir: Optional[Path] = None, operation: str = "allreduce",
                            baseline_impl: str = DEFAULT_IMPL) -> list[dict[str, Any]]:
    """The tuned variants on the 3D sweep against the default corpus: each
    ``<root>/<impl>/*_standard.csv`` joined with the baseline's standard CSV
    per (ranks, batch, seq, hidden); ``VARIANTS3D.md`` and
    ``variants3d_comparison.csv``; returns the rows.  ``base_3d_stats_csv``
    defaults to ``<stats root>/3d/<baseline>/benchmark_statistics_3d_
    <baseline>_standard.csv`` beside the variants root, ``out_dir`` to the
    variants root."""
    root = Path(variants3d_stats_root)
    if base_3d_stats_csv is None:
        base_3d_stats_csv = (root.parent / "3d" / baseline_impl
                             / f"benchmark_statistics_3d_{baseline_impl}_standard.csv")
    if out_dir is None:
        out_dir = root
    impls: dict[str, dict[tuple, float]] = {}

    def read_standard(csv_path: Path, impl: str) -> dict[tuple, float]:
        out: dict[tuple, float] = {}
        with csv_path.open() as f:
            for r in csv.DictReader(f):
                # a combined CSV must not merge other impls under this name
                if r["operation"] != operation or r.get("implementation", impl) != impl:
                    continue
                key = (int(r["num_ranks"]), int(r["batch"]), int(r["seq_len"]),
                       int(r["hidden_dim"]))
                out[key] = float(r["mean_time_ms"])
        return out

    base_3d_stats_csv = Path(base_3d_stats_csv)
    if base_3d_stats_csv.exists():
        impls[baseline_impl] = read_standard(base_3d_stats_csv, baseline_impl)
    if root.is_dir():
        for impl_dir in sorted(root.iterdir()):
            std = sorted(impl_dir.glob("*_standard.csv"))
            if not impl_dir.is_dir() or not std:
                continue
            if len(std) > 1:
                raise ValueError(f"{impl_dir} holds {len(std)} *_standard.csv files — "
                                 "ambiguous input; remove the stale one")
            if impl_dir.name in impls:
                raise ValueError(
                    f"{impl_dir} would shadow the already-loaded {impl_dir.name!r} "
                    f"corpus (baseline comes from {base_3d_stats_csv})")
            impls[impl_dir.name] = read_standard(std[0], impl_dir.name)
    if not impls:
        return []

    names = sorted(impls)
    keys = sorted(set().union(*[set(v) for v in impls.values()]))
    rows: list[dict[str, Any]] = []
    for key in keys:
        present = {n: impls[n][key] for n in names if key in impls[n]}
        if len(present) < 2:
            continue  # a comparison needs two columns
        row: dict[str, Any] = {"num_ranks": key[0], "batch": key[1], "seq_len": key[2],
                               "hidden_dim": key[3]}
        for n in names:
            row[n] = round(present[n], 4) if n in present else None
        winner = min(present, key=present.get)  # type: ignore[arg-type]
        row["winner"] = winner
        base = present.get(baseline_impl)
        row["winner_speedup_vs_default"] = (round(base / present[winner], 4)
                                            if base is not None and present[winner] > 0
                                            else None)
        rows.append(row)

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    columns = ["num_ranks", "batch", "seq_len", "hidden_dim", *names, "winner",
               "winner_speedup_vs_default"]
    write_csv(rows, columns, out_dir / "variants3d_comparison.csv")
    wins = {n: sum(1 for r in rows if r["winner"] == n) for n in names}
    md = [
        f"# 3D-shape variant comparison — {operation} (mean ms per config)",
        "",
        "The tuned variants measured on the reference's 3D LLM-shaped sweep, "
        f"against the default-variant corpus (`3d/{baseline_impl}`) — the "
        "analogue of the reference tuning its CCL algorithms on the 3D shape "
        "(`collectives/3d/launch_dsccl.sh`).  Blank cells are outside a "
        "variant's grid or memory-capped.  Wins per variant: "
        + ", ".join(f"{n}: {wins[n]}" for n in names) + ".",
        "",
    ]
    md += md_table(rows, columns)
    md.append("")
    (out_dir / "VARIANTS3D.md").write_text("\n".join(md))
    return rows
