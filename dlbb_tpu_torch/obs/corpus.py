"""Sweep-artifact corpus ingestion, the cm2 fit's sample table (a copy of
``dlbb_tpu/obs/corpus.py``; the port imports nothing of the JAX package).

One measured sweep artifact becomes one flat sample of the analytic
features the α–β model prices (per-device wire bytes, dense FLOPs, the
collective instructions one dispatch posts) beside its measured timing
quantiles; a devtrace report's ``op_samples`` are device-timed rows
(``source: "devtrace"``), and each ``sweep_manifest.json`` gives one
summary.  :func:`build_corpus` walks results trees into that table, the
input of ``obs/fit.py``:

    sample = {op, variant, kind, ranks, dtype, wire_bytes, flops,
              collectives, dispatches, measured_median_us,
              measured_p90_us, measured_p99_us, iterations, tier,
              host, file, ...}

The tier of a sample comes from the artifact's ``system_info.backend``:
``cpu`` is JAX's ``cpu-sim`` tier, and a card is ``cuda``
(``analysis/costmodel.py``).

Calibration reports (``dlbb_calibration_v1``) are program-scale rows in
JAX, their features joined from the schedule baselines of the schedule
auditor.  The port writes no calibration report until ROADMAP Queue 1,
Slice F, item 14, part 14b ports the calibration, so
:func:`ingest_calibration` skips every such report with its reason and
makes up no features; calibration rows come with part 14b's join over the
port's schedule baselines (``analysis/schedule_audit.py``).

Pure file processing: it runs with no device.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Any, Optional, Sequence

from dlbb_tpu_torch.analysis.expectations import OP_EXPECTED_KINDS, op_wire_bytes

CORPUS_SCHEMA = "dlbb_fit_corpus_v1"

# artifact files that are never measurement samples (manifests, traces,
# journals, reports): skipped silently, not counted as unparseable
_NON_SAMPLE_NAMES = re.compile(
    r"^(sweep_manifest|serving_manifest|serving_resume|trace_|comm_lint"
    r"|calibration_|metrics|.*_trace)", re.IGNORECASE
)
# the subset skipped WITHOUT reading the file: everything above but the two
# name families the walk parses (manifests for corpus metadata,
# calibration_* for the schema probe); a multi-MB trace is never loaded
# just to be discarded by name
_PREFILTER_NAMES = re.compile(
    r"^(serving_manifest|serving_resume|trace_|comm_lint"
    r"|metrics|.*_trace)", re.IGNORECASE
)

# the schedule auditor's committed baselines (analysis/schedule_audit.py)
DEFAULT_BASELINE_DIR = Path("stats/torch/analysis/baselines")

ELEM_BYTES = {
    "bfloat16": 2, "float16": 2, "float32": 4, "float64": 8,
    "int8": 1, "uint8": 1, "fp8": 1, "float8_e4m3fn": 1,
    "int32": 4, "int64": 8,
}

# the collective-matmul micro-ops: one activation gather or scatter per
# dispatch whatever the schedule
_MATMUL_OPS = ("ag_matmul", "matmul_rs")


def hlo_kind(op: str, variant: str = "default") -> str:
    """The HLO collective JAX lowers ``op`` under ``variant`` to: the ring
    schedules (``overlap_*``) and the quantised rings (``*_q``) are
    ``collective-permute`` chains; every other op is its
    ``OP_EXPECTED_KINDS`` row's ``cost_kind``, and an op outside the table
    a permute chain."""
    if variant.startswith("overlap_") or op.endswith("_q"):
        return "collective-permute"
    return OP_EXPECTED_KINDS.get(op, {}).get("cost_kind", "collective-permute")


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
        "kind": hlo_kind(op),
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


def ingest_calibration(path: Path, data: dict[str, Any],
                       baselines_dir: "Optional[str | Path]" = None
                       ) -> tuple[list[dict[str, Any]], list[dict]]:
    """A calibration report's rows need its targets' schedule baselines
    for their features (JAX's join): the report is skipped, with JAX's
    reason where the baselines directory is missing, and otherwise with the
    reason that the join waits for the port's calibration (ROADMAP Queue 1,
    Slice F, item 14, part 14b).  No row is ever made without its
    features."""
    baselines_dir = Path(baselines_dir or DEFAULT_BASELINE_DIR)
    if not baselines_dir.is_dir():
        return [], [{"file": str(path),
                     "reason": (f"no schedule baselines under "
                                f"{baselines_dir} to join features from")}]
    return [], [{"file": str(path),
                 "reason": (f"schedule baselines under {baselines_dir} are not joined "
                            "until the calibration is ported (ROADMAP Queue 1, Slice F, "
                            "item 14, part 14b)")}]


_DEVTRACE_SAMPLE_KEYS = ("op", "kind", "ranks", "wire_bytes",
                         "measured_median_us")


def ingest_devtrace(path: Path, data: dict[str, Any]
                    ) -> tuple[list[dict[str, Any]], list[dict]]:
    """A devtrace report's ``op_samples`` as corpus rows (``source:
    "devtrace"``): one collective's measured device time each, with
    ``dispatches: 0`` (a device-op duration carries no host dispatch) and
    ``flops: 0``, so the population identifies ``α·collectives + wire/β``
    directly."""
    samples: list[dict[str, Any]] = []
    skipped: list[dict] = []
    for n, row in enumerate(data.get("op_samples", ())):
        if not isinstance(row, dict) or any(
                k not in row for k in _DEVTRACE_SAMPLE_KEYS):
            skipped.append({"file": f"{path}::op_samples[{n}]",
                            "reason": "malformed devtrace op sample"})
            continue
        m = row.get("measured_median_us")
        if not isinstance(m, (int, float)) or not math.isfinite(m) \
                or m <= 0:
            skipped.append({"file": f"{path}::op_samples[{n}]",
                            "reason": "non-finite measured_median_us"})
            continue
        sample = dict(row)
        sample.setdefault("source", "devtrace")
        sample.setdefault("dispatches", 0.0)
        sample.setdefault("flops", 0)
        sample.setdefault("host", "devtrace")
        samples.append(sample)
    return samples, skipped


def _manifest_summary(path: Path, data: dict[str, Any]) -> dict[str, Any]:
    """Build and dedup aggregates of one ``sweep_manifest.json``: corpus
    metadata (context for a directory's samples), not samples."""
    out: dict[str, Any] = {"file": str(path)}
    for key in ("wall_seconds", "compile_seconds_total",
                "cost_model_version"):
        if key in data:
            out[key] = data[key]
    dedup = data.get("dedup") or data.get("work_units")
    if isinstance(dedup, dict):
        out["dedup"] = dedup
    cal = data.get("calibration")
    if isinstance(cal, dict):
        out["calibration"] = {
            k: cal.get(k) for k in ("tier", "cost_model_version",
                                    "geomean_error_factor")
        }
    return out


def build_corpus(roots: "Sequence[str | Path]",
                 verbose: bool = False,
                 baselines_dir: "Optional[str | Path]" = None
                 ) -> dict[str, Any]:
    """Walk one or more results trees into the normalised sample table.

    Returns ``{schema, samples, skipped, manifests, roots}``; raises
    :class:`FileNotFoundError` when no root exists (a mistyped path must
    fail loudly, not fit an empty corpus)."""
    roots = [Path(r) for r in roots]
    live = [r for r in roots if r.exists()]
    if not live:
        raise FileNotFoundError(
            f"no corpus root exists among {[str(r) for r in roots]}"
        )
    samples: list[dict[str, Any]] = []
    skipped: list[dict[str, str]] = []
    manifests: list[dict[str, Any]] = []
    for root in live:
        files = [root] if root.is_file() else sorted(root.rglob("*.json"))
        for path in files:
            if _PREFILTER_NAMES.match(path.name):
                continue
            try:
                data = json.loads(path.read_text())
            except (OSError, json.JSONDecodeError) as e:
                skipped.append({"file": str(path),
                                "reason": f"unreadable: {e}"})
                continue
            if not isinstance(data, dict):
                continue
            if path.name == "sweep_manifest.json":
                manifests.append(_manifest_summary(path, data))
                continue
            if data.get("schema") == "dlbb_calibration_v1":
                cal_samples, cal_skipped = ingest_calibration(
                    path, data, baselines_dir=baselines_dir)
                samples.extend(cal_samples)
                skipped.extend(cal_skipped)
                continue
            if data.get("schema") == "dlbb_devtrace_v1":
                dt_samples, dt_skipped = ingest_devtrace(path, data)
                samples.extend(dt_samples)
                skipped.extend(dt_skipped)
                continue
            if _NON_SAMPLE_NAMES.match(path.name):
                continue
            sample, reason = ingest_result(path, data)
            if sample is None:
                skipped.append({"file": str(path), "reason": reason})
                continue
            samples.append(sample)
    if verbose:
        tiers: dict[str, int] = {}
        for s in samples:
            tiers[s["tier"]] = tiers.get(s["tier"], 0) + 1
        print(f"[corpus] {len(samples)} sample(s) "
              f"({', '.join(f'{t}: {n}' for t, n in sorted(tiers.items()))})"
              f", {len(skipped)} skipped, {len(manifests)} manifest(s)")
    return {
        "schema": CORPUS_SCHEMA,
        "roots": [str(r) for r in roots],
        "samples": samples,
        "skipped": skipped,
        "manifests": manifests,
    }


def save_corpus(corpus: dict[str, Any], path: "str | Path") -> Path:
    from dlbb_tpu_torch.utils.config import atomic_write_text

    return atomic_write_text(json.dumps(corpus, indent=1, sort_keys=True), Path(path))
