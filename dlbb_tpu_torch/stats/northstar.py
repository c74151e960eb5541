"""The north-star curve as one table (counterpart of
``dlbb_tpu/stats/northstar.py``).

The metric is all-reduce bus bandwidth (GB/s) and p50 latency against
message size, 1 KB–1 GB, fp32 and bf16, with the allgather and broadcast
companions.  The per-config 1D stats hold it scattered; this module
collapses them into one table per op: rows are size labels in payload
order, one column per (ranks, dtype), each cell ``median_time_us /
bandwidth_gbps`` from the same stats rows (``stats1d``'s CSV of the port's
implementation, ``stats/1d/<impl>/benchmark_statistics.csv``).  Absent
cells are configs that were not measured.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Any

from dlbb_tpu_torch.stats.compare import DEFAULT_IMPL, md_table, write_csv
from dlbb_tpu_torch.stats.variants_report import _parse_size_label

NORTH_STAR_OPS = ("allreduce", "allgather", "broadcast")

_DTYPE_SHORT = {"bfloat16": "bf16", "float32": "fp32", "float16": "fp16"}


def _read_stats_csv(csv_path: Path) -> list[dict[str, Any]]:
    with Path(csv_path).open() as f:
        return list(csv.DictReader(f))


def build_curve(rows: list[dict[str, Any]], operation: str
                ) -> tuple[list[str], list[dict[str, Any]], list[str]]:
    """(size labels in payload order, table rows, column names) for one op."""
    sub = [r for r in rows if r["operation"] == operation]
    sizes = sorted({r["data_size_name"] for r in sub}, key=lambda s: (_parse_size_label(s), s))
    cols = sorted({(int(r["num_ranks"]), r.get("dtype") or "bfloat16") for r in sub})
    cells = {(r["data_size_name"], int(r["num_ranks"]), r.get("dtype") or "bfloat16"): r
             for r in sub}
    table = []
    for size in sizes:
        row: dict[str, Any] = {"size": size}
        for ranks, dtype in cols:
            r = cells.get((size, ranks, dtype))
            key = f"{ranks}r/{_DTYPE_SHORT.get(dtype, dtype)}"
            if r is None:
                row[key] = None
                continue
            med = float(r["median_time_us"])
            bw = r.get("bandwidth_gbps")
            bw_s = f"{float(bw):.3g}" if bw not in (None, "") else "?"
            row[key] = f"{med:,.0f}us / {bw_s}GB/s"
        table.append(row)
    col_names = [f"{n}r/{_DTYPE_SHORT.get(d, d)}" for n, d in cols]
    return sizes, table, col_names


def default_stats_1d_csv(stats_root: Path, impl: str = DEFAULT_IMPL) -> Path:
    """The consolidated 1D stats CSV of ``impl`` under a stats tree."""
    return Path(stats_root) / "1d" / impl / "benchmark_statistics.csv"


def write_northstar_report(stats_1d_csv: Path, out_dir: Path,
                           operations: tuple[str, ...] = NORTH_STAR_OPS) -> dict[str, int]:
    """``NORTHSTAR.md`` and ``northstar_<op>.csv`` per op; returns {op: row
    count}.  Writes nothing (and returns {}) where the stats CSV is absent
    or holds no north-star op, so that a partial run never replaces a
    report with an empty one."""
    stats_1d_csv = Path(stats_1d_csv)
    if not stats_1d_csv.exists():
        return {}
    rows = _read_stats_csv(stats_1d_csv)
    curves = {}
    for op in operations:
        _, table, col_names = build_curve(rows, op)
        if table:
            curves[op] = (table, col_names)
    if not curves:
        return {}
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    md = [
        "# North-star curve — p50 latency / bus bandwidth vs message size",
        "",
        "All-reduce bus bandwidth and p50 latency against message size, "
        "1 KB–1 GB, fp32 and bf16, with the allgather/broadcast companions.  "
        "One column per (rank count, dtype); cells are "
        f"`median_us / bandwidth_GB/s` from the port's per-config stats "
        f"(`{stats_1d_csv}`).  Size labels are the reference's (nominal — "
        "byte counts in the artifacts); blank cells were not measured.  "
        "Where the rank count is 1 there is no wire: the time is NCCL's call "
        "(or gloo's) on one rank.",
        "",
    ]
    counts: dict[str, int] = {}
    for op, (table, col_names) in curves.items():
        counts[op] = len(table)
        columns = ["size", *col_names]
        write_csv(table, columns, out_dir / f"northstar_{op}.csv")
        md += [f"## {op}", ""]
        md += md_table(table, columns)
        md.append("")
    (out_dir / "NORTHSTAR.md").write_text("\n".join(md))
    return counts
