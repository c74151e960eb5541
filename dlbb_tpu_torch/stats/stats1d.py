"""1D microbenchmark statistics (counterpart of ``dlbb_tpu/stats/stats1d.py``).

Per-file stats in µs (mean/median/min/max/std/p95/p99), load imbalance %
over the per-rank means (reference ``collectives/1d/stats.py:54-61``), bus
bandwidth in GB/s from the *max* time (:178-186), a ``*_stats.json`` per
result and one ``benchmark_statistics.csv`` with the JAX package's columns.
The port gathers one timing row per rank, so the load imbalance measures
the ranks (in the JAX package, one row per host process).

The bandwidth formula is the reference's, uniform across ops
(``elements x element_size x num_ranks / time / 2**30``, :98-121), or with
``algorithm_bandwidth=True`` the standard bus-bandwidth factors.  The
``bytes_on_wire`` column is the analytic ring model,
``analysis/expectations.py::op_wire_bytes`` (JAX's, whose single home is
that module in both packages); for the quantised-wire ops it counts the
chunk padding and the fp32 scales, of the ``compression`` the result
records.
``bandwidth_gbps`` keeps the logical-payload formula, so a compressed row
and its uncompressed baseline share a normalisation and the wire saving
shows in ``bytes_on_wire``.
"""

from __future__ import annotations

import csv
import io
import json
from pathlib import Path
from typing import Any, Optional

import numpy as np

# the wire model lives in analysis/expectations.py (JAX's single home);
# read here for the ``bytes_on_wire`` column
from dlbb_tpu_torch.analysis.expectations import op_wire_bytes
from dlbb_tpu_torch.utils.config import atomic_write_text

_DTYPE_BYTES = {
    "bfloat16": 2,
    "float16": 2,
    "float32": 4,
    "float64": 8,
    # reference artifacts record numpy repr strings
    "<class 'numpy.float16'>": 2,
}

CSV_COLUMNS = [
    "mpi_implementation",
    "operation",
    "num_ranks",
    "data_size_name",
    "num_elements",
    "mean_time_us",
    "median_time_us",
    "min_time_us",
    "max_time_us",
    "std_dev_us",
    "p95_time_us",
    "p99_time_us",
    "load_imbalance_percent",
    "bandwidth_gbps",
    # the JAX package's extension columns
    "timing_granularity",
    "dtype",
    "bytes_on_wire",
]


def calculate_statistics(timings_2d: list[list[float]]) -> dict[str, Any]:
    """Aggregate stats (µs) and the load imbalance over per-rank means
    (reference ``collectives/1d/stats.py:26-75``)."""
    arr = np.asarray(timings_2d, dtype=np.float64)
    per_rank_means = arr.mean(axis=1)
    flat = arr.ravel()
    mean_of_means = per_rank_means.mean()
    load_imbalance = ((per_rank_means.max() - mean_of_means) / mean_of_means
                      * 100.0 if mean_of_means > 0 else 0.0)
    return {
        "mean_time_us": float(flat.mean() * 1e6),
        "median_time_us": float(np.median(flat) * 1e6),
        "min_time_us": float(flat.min() * 1e6),
        "max_time_us": float(flat.max() * 1e6),
        "std_dev_us": float(flat.std() * 1e6),
        "p95_time_us": float(np.percentile(flat, 95) * 1e6),
        "p99_time_us": float(np.percentile(flat, 99) * 1e6),
        "load_imbalance_percent": float(load_imbalance),
        "per_rank_means_us": (per_rank_means * 1e6).tolist(),
    }


def _algo_volume_factor(operation: str, p: int) -> float:
    """Logical bytes moved per element, in element sizes, for the standard
    bus-bandwidth accounting (cf. nccl-tests)."""
    if operation == "allreduce":
        return 2.0 * (p - 1) / p * p  # 2(P-1) x elements x size in total
    if operation in ("allgather", "reducescatter", "alltoall",
                     "broadcast", "gather", "scatter", "reduce"):
        return float(p - 1)
    return float(p)


def calculate_bandwidth(num_elements: int, dtype: str, time_seconds: float,
                        operation: str, num_ranks: int,
                        algorithm_bandwidth: bool = False) -> Optional[float]:
    """Bus bandwidth in GB/s (GiB divisor, like the reference :124)."""
    if time_seconds <= 0:
        return None
    element_size = _DTYPE_BYTES.get(dtype, 2)
    if algorithm_bandwidth:
        volume = num_elements * element_size * _algo_volume_factor(
            operation, num_ranks)
    else:
        volume = num_elements * element_size * num_ranks
    return float(volume / time_seconds / 2**30)


def process_file(json_path: Path, algorithm_bandwidth: bool = False) -> dict[str, Any]:
    with open(json_path) as f:
        data = json.load(f)
    impl = data.get("mpi_implementation") or data.get("implementation") or "unknown"
    stats = calculate_statistics(data["timings"])
    dtype = data.get("dtype", "bfloat16")
    bandwidth = calculate_bandwidth(
        data["num_elements"], dtype, stats["max_time_us"] / 1e6,
        data["operation"], data["num_ranks"],
        algorithm_bandwidth=algorithm_bandwidth)
    out = {
        "mpi_implementation": impl,
        "operation": data["operation"],
        "num_ranks": data["num_ranks"],
        "data_size_name": data.get("data_size_name", ""),
        "num_elements": data["num_elements"],
        "dtype": data.get("dtype", ""),
        **stats,
        "bandwidth_gbps": bandwidth,
        "bytes_on_wire": op_wire_bytes(data["operation"], data["num_elements"],
                                       data["num_ranks"],
                                       _DTYPE_BYTES.get(dtype, 2),
                                       compression=data.get("compression")),
        "timing_granularity": data.get("timing_granularity", "per_iteration"),
        # where it ran: "cuda", or "cpu" for gloo on the CPU
        "backend": (data.get("system_info") or {}).get("backend"),
    }
    return out


def process_1d_results(input_dir: str | Path, output_dir: str | Path,
                       csv_name: str = "benchmark_statistics.csv",
                       algorithm_bandwidth: bool = False,
                       verbose: bool = True) -> list[dict[str, Any]]:
    """Every result JSON in ``input_dir`` → a ``*_stats.json`` each and the
    consolidated CSV in ``output_dir`` (reference
    ``collectives/1d/stats.py:135-250``).  A file that fails is printed and
    skipped, as there."""
    input_dir, output_dir = Path(input_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for json_file in sorted(input_dir.glob("*.json")):
        if json_file.name.endswith("_stats.json"):
            continue
        try:
            result = process_file(json_file, algorithm_bandwidth)
        except Exception as e:  # noqa: BLE001 — one bad file is skipped
            if verbose:
                print(f"  ERROR processing {json_file.name}: {e}")
            continue
        atomic_write_text(json.dumps(result, indent=2),
                          output_dir / (json_file.stem + "_stats.json"))
        results.append(result)

    if results:
        buf = io.StringIO()
        writer = csv.DictWriter(buf, fieldnames=CSV_COLUMNS)
        writer.writeheader()
        for r in results:
            writer.writerow({k: v for k, v in r.items()
                             if k not in ("per_rank_means_us", "backend")})
        atomic_write_text(buf.getvalue(), output_dir / csv_name)
        if verbose:
            print(f"Consolidated CSV saved: {output_dir / csv_name}")
    return results
