"""Sweep-artifact samples (the part of ``dlbb_tpu/obs/corpus.py`` that
``obs/devtrace.py`` needs: ``ingest_result`` and its helpers).

One measured sweep artifact becomes one flat sample of the analytic
features the α–β model prices (per-device wire bytes, dense FLOPs, the
collective instructions one dispatch posts) beside its measured timing
quantiles.  The corpus walk, its manifest summaries and the fit that reads
them are ROADMAP Queue 1, Slice F, item 14.

The tier of a sample comes from the artifact's ``system_info.backend``:
``cpu`` is JAX's ``cpu-sim`` tier, and a card is ``cuda`` (the port's
cost-model tiers come with item 14).
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Any, Optional

from dlbb_tpu_torch.stats.stats1d import op_wire_bytes

ELEM_BYTES = {
    "bfloat16": 2, "float16": 2, "float32": 4, "float64": 8,
    "int8": 1, "uint8": 1, "fp8": 1, "float8_e4m3fn": 1,
    "int32": 4, "int64": 8,
}

# the collective-matmul micro-ops: one activation gather or scatter per
# dispatch whatever the schedule
_MATMUL_OPS = ("ag_matmul", "matmul_rs")

# each op's defining HLO collective in the JAX package (its
# ``analysis/expectations.py::OP_EXPECTED_KINDS`` "required" kind, or the
# first of "required_any"); an op outside the table is a permute chain
OP_HLO_KIND = {
    "allreduce": "all-reduce", "allreduce_hierarchical": "all-reduce",
    "allgather": "all-gather", "broadcast": "all-reduce", "gather": "all-gather",
    "scatter": "all-reduce", "reduce": "all-reduce", "alltoall": "all-to-all",
    "sendrecv": "collective-permute", "reducescatter": "reduce-scatter",
    "barrier": "all-reduce", "ag_matmul": "all-gather", "matmul_rs": "reduce-scatter",
}


def hlo_kind(op: str, variant: str = "default") -> str:
    """The HLO collective JAX lowers ``op`` under ``variant`` to: the ring
    schedules (``overlap_*``) and the quantised rings (``*_q``) are
    ``collective-permute`` chains."""
    if variant.startswith("overlap_") or op.endswith("_q"):
        return "collective-permute"
    return OP_HLO_KIND.get(op, "collective-permute")


def tier_of_result(data: dict[str, Any]) -> str:
    """The tier an artifact was measured on, from its recorded backend."""
    backend = str(data.get("system_info", {}).get("backend", "cpu")).lower()
    return "cpu-sim" if backend == "cpu" else "cuda"


def host_fingerprint(data: dict[str, Any]) -> str:
    info = data.get("system_info", {})
    return (f"{info.get('platform', '?')}"
            f"/cpu{info.get('cpu_count', '?')}"
            f"/dev{info.get('num_devices', '?')}")


def collectives_per_dispatch(op: str, variant: str, ranks: int) -> float:
    """JAX's analytic count of the collective instructions one dispatch
    posts: one for a fused lowering, one per mesh axis for the
    hierarchical reductions, one permute per hop for the ring schedules
    and the quantised rings."""
    p = max(int(ranks), 1)
    if variant.startswith("overlap_") or op.endswith("_q"):
        hops = max(p - 1, 1)
        if op == "allreduce_q":
            return 2.0 * hops
        return float(hops)
    if op == "allreduce_hierarchical" or variant.startswith("hier"):
        axes = variant[len("hier"):].count("x") + 1 if variant.startswith("hier") else 2
        return float(max(axes, 2))
    return 1.0


def op_flops(op: str, data: dict[str, Any]) -> int:
    """Dense FLOPs one dispatch executes: 2·B·S·H² for the
    collective-matmul micro-ops, 0 otherwise."""
    if op not in _MATMUL_OPS:
        return 0
    shape = data.get("tensor_shape")
    if isinstance(shape, dict):
        dims = (shape.get("batch"), shape.get("seq_len"), shape.get("hidden_dim"))
        if any(d is None for d in dims):
            return 0
        b, s, h = (int(d) for d in dims)
    elif shape and len(shape) == 3 and all(isinstance(x, (int, float)) for x in shape):
        b, s, h = (int(x) for x in shape)
    else:
        return 0
    return 2 * b * s * h * h


def sample_wire_bytes(op: str, data: dict[str, Any]) -> Optional[int]:
    """Analytic per-device wire bytes of one dispatch, or None for an op
    without a wire model."""
    n = int(data.get("num_elements", 0))
    p = int(data.get("num_ranks", 0))
    b = ELEM_BYTES.get(str(data.get("dtype", "")).lower())
    if not n or not p or b is None:
        return None
    variant = str(data.get("variant", "default"))
    compression = None
    if variant.startswith("compress_"):
        compression = "fp8" if "fp8" in variant else "int8"
    wire = op_wire_bytes(op, n, p, b, compression=compression)
    if wire is not None:
        return wire
    if op in _MATMUL_OPS:
        if p <= 1:
            return 0
        if op == "ag_matmul":
            return int((p - 1) * n * b)
        return int((p - 1) / p * n * b)
    return None


def _dispatches_per_iteration(data: dict[str, Any]) -> float:
    """Host dispatches in one timed iteration: one per per-iter sample, one
    per chunk of JAX's chained timing."""
    if data.get("timing_mode") != "chained":
        return 1.0
    m = re.search(r"chunked\((\d+)\)", str(data.get("timing_granularity", "")))
    chunk = int(m.group(1)) if m else 10
    return 1.0 / max(chunk, 1)


def _flat_timings_us(data: dict[str, Any]) -> list[float]:
    out: list[float] = []
    for group in data.get("timings", ()):
        if isinstance(group, (int, float)):
            out.append(float(group) * 1e6)
            continue
        for v in group:
            if isinstance(v, (int, float)) and math.isfinite(v):
                out.append(float(v) * 1e6)
    return out


def ingest_result(path: Path, data: dict[str, Any]) -> "tuple[Optional[dict], str]":
    """One artifact -> one sample, or ``(None, reason)`` (JAX's)."""
    op = data.get("operation")
    if not op or "timings" not in data:
        return None, "not a sweep artifact (no operation/timings)"
    timings = _flat_timings_us(data)
    if not timings:
        return None, "no finite timing samples"
    wire = sample_wire_bytes(op, data)
    if wire is None:
        return None, f"op {op!r} has no analytic wire model"
    ranks = int(data.get("num_ranks", 0))
    variant = str(data.get("variant", "default"))
    timings.sort()
    n = len(timings)
    return {
        "file": str(path),
        "op": op,
        "variant": variant,
        "kind": OP_HLO_KIND.get(op, "collective-permute"),
        "ranks": ranks,
        "dtype": data.get("dtype"),
        "num_elements": int(data.get("num_elements", 0)),
        "wire_bytes": int(wire),
        "flops": op_flops(op, data),
        "collectives": collectives_per_dispatch(op, variant, ranks),
        "dispatches": _dispatches_per_iteration(data),
        "measured_median_us": timings[n // 2],
        "measured_p90_us": timings[min(n - 1, int(n * 0.9))],
        "measured_p99_us": timings[min(n - 1, int(n * 0.99))],
        "iterations": n,
        "tier": tier_of_result(data),
        "host": host_fingerprint(data),
        "timestamp": data.get("timestamp"),
    }, ""
