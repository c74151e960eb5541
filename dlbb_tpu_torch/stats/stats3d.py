"""3D tensor-benchmark statistics (counterpart of ``dlbb_tpu/stats/stats3d.py``).

ms-scale stats (mean/median/min/max, reference ``collectives/3d/stats.py:32-49``),
a standard CSV (one row per config, columns :151-164) and a transposed CSV
(metrics as rows, config-id columns ``op_rX_hX_sX_bX``, a metadata block
after them, :187-282), both sorted operation → ranks → hidden_dim →
seq_len → batch (:167-173).
"""

from __future__ import annotations

import csv
import io
import json
from pathlib import Path
from typing import Any

import numpy as np

from dlbb_tpu_torch.utils.config import atomic_write_text
from dlbb_tpu_torch.utils.metrics import summarize

STANDARD_COLUMNS = [
    "implementation",
    "operation",
    "num_ranks",
    "hidden_dim",
    "seq_len",
    "batch",
    "tensor_size_mb",
    "num_elements",
    "mean_time_ms",
    "median_time_ms",
    "min_time_ms",
    "max_time_ms",
]

METRICS = ["mean_time_ms", "median_time_ms", "min_time_ms", "max_time_ms"]


def _sort_key(r):
    return (r["operation"], r["num_ranks"], r["hidden_dim"], r["seq_len"],
            r["batch"])


def calculate_statistics_3d(timings_2d: list[list[float]]) -> dict[str, float]:
    """ms-scale aggregate stats over every rank's samples."""
    s = summarize(np.asarray(timings_2d, dtype=np.float64).ravel())
    return {
        "mean_time_ms": s["mean"] * 1e3,
        "median_time_ms": s["median"] * 1e3,
        "min_time_ms": s["min"] * 1e3,
        "max_time_ms": s["max"] * 1e3,
    }


def process_3d_results(input_dir: str | Path, output_dir: str | Path,
                       implementation: str = "torch_nccl",
                       verbose: bool = True) -> list[dict[str, Any]]:
    """3D result JSONs → the standard and transposed CSVs, named after
    ``implementation`` (the reference's edit-the-constant switch,
    ``collectives/3d/stats.py:17``).  A file that fails is printed and
    skipped."""
    input_dir, output_dir = Path(input_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    results: list[dict[str, Any]] = []
    for json_file in sorted(input_dir.glob("*.json")):
        if json_file.name.endswith("_stats.json"):
            continue
        try:
            data = json.loads(json_file.read_text())
            shape = data["tensor_shape"]
            results.append({
                "implementation": data.get("implementation")
                or data.get("mpi_implementation") or implementation,
                "operation": data["operation"],
                "num_ranks": data["num_ranks"],
                "hidden_dim": shape["hidden_dim"],
                "seq_len": shape["seq_len"],
                "batch": shape["batch"],
                "tensor_size_mb": data["tensor_size_mb"],
                "num_elements": data["num_elements"],
                "timing_granularity": data.get("timing_granularity",
                                               "per_iteration"),
                **calculate_statistics_3d(data["timings"]),
            })
        except Exception as e:  # noqa: BLE001 — one bad file is skipped
            print(f"  ERROR processing {json_file.name}: {e}")
            continue
    if not results:
        return results
    results.sort(key=_sort_key)

    buf = io.StringIO()
    writer = csv.DictWriter(buf, fieldnames=STANDARD_COLUMNS)
    writer.writeheader()
    for r in results:
        writer.writerow({k: r[k] for k in STANDARD_COLUMNS})
    std_path = atomic_write_text(
        buf.getvalue(),
        output_dir / f"benchmark_statistics_3d_{implementation}_standard.csv")

    buf = io.StringIO()
    writer = csv.writer(buf)
    writer.writerow(["Metric"] + [
        f"{r['operation']}_r{r['num_ranks']}_h{r['hidden_dim']}"
        f"_s{r['seq_len']}_b{r['batch']}" for r in results])
    for metric in METRICS:
        writer.writerow([metric] + [r[metric] for r in results])
    writer.writerow([])
    writer.writerow(["--- Metadata ---"])
    for meta in ("operation", "num_ranks", "hidden_dim", "seq_len", "batch",
                 "tensor_size_mb", "timing_granularity"):
        writer.writerow([meta] + [r[meta] for r in results])
    tr_path = atomic_write_text(
        buf.getvalue(),
        output_dir / f"benchmark_statistics_3d_{implementation}_transpose.csv")
    if verbose:
        print(f"Standard CSV saved: {std_path}")
        print(f"Transposed CSV saved: {tr_path}")
    return results
