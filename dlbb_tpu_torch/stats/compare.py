"""Reference-vs-port head-to-head comparison report (counterpart of
``dlbb_tpu/stats/compare.py``).

Runs the port's stats over both artifact corpora, the reference's result
JSONs (``<reference root>/collectives/{1d,3d}/results/<backend>/``) and the
port's own sweep results, joins them per configuration, and writes one CSV
per dimension and a markdown report stating, per (op x size x ranks) point,
whether the port (``impl``, ``torch_nccl`` by default) matches, beats or
loses to the best reference backend there (lowest mean time across the
backend directories, every tuning-variant directory included).  The CSVs
keep the JAX package's columns, ``xla_*`` naming the own side, so the two
packages' reports read the same way.

The reference root is an argument: the corpus is not in this repository,
so a comparison waits until it is given one.  Caveats carried into the
report:

- the reference corpus ran real MPI/oneCCL ranks on a 56-core CPU node;
  the port's rows measured on the CPU (gloo ranks, ``system_info.backend``
  "cpu") carry the structural verdict ``not_comparable(simulated)``, as the
  JAX package's simulated-mesh rows do, with the speedup-only
  ``raw_verdict`` beside it;
- the card gives one rank per call (NCCL puts no two ranks of a
  communicator on one GPU), and the reference measured no one-rank
  configuration, so a card corpus at world 1 joins no row;
- the E2E section reads only the port's own ``run_e2e`` result JSONs
  (``backend: "torch_cuda"``) in the directory given, against the
  re-measured reference-stack torch-CPU baseline
  (``bench_baseline_cpu.json``).  It never reads the JAX package's
  ``BENCH_r*.json``: those are TPU numbers, not the port's.
"""

from __future__ import annotations

import csv
import io
import json
from pathlib import Path
from typing import Any, Optional

import numpy as np

from dlbb_tpu_torch.stats.stats1d import process_file as process_1d_file
from dlbb_tpu_torch.stats.stats3d import calculate_statistics_3d
from dlbb_tpu_torch.utils.config import atomic_write_text

# Above/below these speedup thresholds the verdict is beat/lose; between
# them the difference is within run-to-run noise and counts as a match.
BEAT, LOSE = 1.05, 0.95

# the verdict class of rows measured on the CPU (module docstring)
NOT_COMPARABLE = "not_comparable(simulated)"

DEFAULT_IMPL = "torch_nccl"

COLUMNS_1D = [
    "operation", "data_size_name", "num_ranks", "xla_dtype",
    "ref_best_backend", "ref_best_mean_us", "ref_best_bandwidth_gbps",
    "xla_mean_us", "xla_bandwidth_gbps",
    # the own side's analytic per-device wire bytes: the bandwidth columns
    # normalise by logical payload, so a compressed row's saving shows here
    "xla_bytes_on_wire",
    "speedup", "verdict",
    "raw_verdict",
]

COLUMNS_3D = [
    "operation", "num_ranks", "batch", "seq_len", "hidden_dim",
    "tensor_size_mb", "ref_best_backend", "ref_best_mean_ms",
    "xla_mean_ms", "speedup", "verdict", "raw_verdict",
]

E2E_COLUMNS = ["config", "device", "reference_cpu_stack_tokens_per_s",
               "tokens_per_s", "speedup", "verdict"]


def _raw_verdict(speedup: float) -> str:
    if speedup >= BEAT:
        return "beat"
    if speedup <= LOSE:
        return "lose"
    return "match"


def _verdict_pair(speedup: float, own_backend: Optional[str]) -> dict:
    """verdict (class-aware) and raw_verdict (speedup only)."""
    raw = _raw_verdict(speedup)
    verdict = NOT_COMPARABLE if own_backend == "cpu" else raw
    return {"verdict": verdict, "raw_verdict": raw}


def _rows_1d(results_dir: Path) -> list[dict[str, Any]]:
    """Stats rows of every 1D result JSON in one directory (in memory)."""
    rows = []
    for f in sorted(Path(results_dir).glob("*.json")):
        if f.name.endswith("_stats.json"):
            continue
        try:
            rows.append(process_1d_file(f))
        except Exception:  # noqa: BLE001 — a bad file is skipped
            continue
    return rows


def _rows_3d(results_dir: Path, backend: str) -> list[dict[str, Any]]:
    rows = []
    for f in sorted(Path(results_dir).glob("*.json")):
        if f.name.endswith("_stats.json"):
            continue
        try:
            data = json.loads(f.read_text())
            shape = data["tensor_shape"]
            rows.append({
                "backend": backend,
                "measured_backend": (data.get("system_info") or {}).get("backend"),
                "operation": data["operation"],
                "num_ranks": data["num_ranks"],
                "batch": shape["batch"],
                "seq_len": shape["seq_len"],
                "hidden_dim": shape["hidden_dim"],
                "tensor_size_mb": data["tensor_size_mb"],
                **calculate_statistics_3d(data["timings"]),
            })
        except Exception:  # noqa: BLE001
            continue
    return rows


def compare_1d(ref_results_root: Path, own_results_dir: Path) -> list[dict[str, Any]]:
    """Join per (operation, data_size_name, num_ranks); one row per own
    config (and dtype) that the reference corpus covers."""
    own = _rows_1d(own_results_dir)
    if not own or not Path(ref_results_root).is_dir():
        return []
    ref_best: dict[tuple, dict] = {}
    for backend_dir in sorted(Path(ref_results_root).iterdir()):
        if not backend_dir.is_dir():
            continue
        for r in _rows_1d(backend_dir):
            key = (r["operation"], r["data_size_name"], r["num_ranks"])
            if key not in ref_best or r["mean_time_us"] < ref_best[key]["mean_time_us"]:
                ref_best[key] = dict(r, backend=backend_dir.name)

    out = []
    for r in own:
        key = (r["operation"], r["data_size_name"], r["num_ranks"])
        ref = ref_best.get(key)
        if ref is None:
            continue
        speedup = ref["mean_time_us"] / r["mean_time_us"]
        out.append({
            "operation": key[0],
            "data_size_name": key[1],
            "num_ranks": key[2],
            "xla_dtype": r.get("dtype", ""),
            "ref_best_backend": ref["backend"],
            "ref_best_mean_us": round(ref["mean_time_us"], 3),
            "ref_best_bandwidth_gbps": (round(ref["bandwidth_gbps"], 4)
                                        if ref["bandwidth_gbps"] is not None else None),
            "xla_mean_us": round(r["mean_time_us"], 3),
            "xla_bandwidth_gbps": (round(r["bandwidth_gbps"], 4)
                                   if r["bandwidth_gbps"] is not None else None),
            "xla_bytes_on_wire": r.get("bytes_on_wire"),
            "speedup": round(speedup, 4),
            **_verdict_pair(speedup, r.get("backend")),
        })
    out.sort(key=lambda r: (r["operation"], r["num_ranks"], r["xla_dtype"],
                            r["xla_mean_us"]))
    return out


def compare_3d(ref_results_root: Path, own_results_dir: Path,
               impl: str = DEFAULT_IMPL) -> list[dict[str, Any]]:
    """Join per (operation, ranks, batch, seq, hidden).  Every reference
    directory (the backends and the tuning variants) competes for best."""
    own = _rows_3d(own_results_dir, impl)
    if not own or not Path(ref_results_root).is_dir():
        return []
    ref_best: dict[tuple, dict] = {}
    for backend_dir in sorted(Path(ref_results_root).iterdir()):
        if not backend_dir.is_dir():
            continue
        for r in _rows_3d(backend_dir, backend_dir.name):
            key = (r["operation"], r["num_ranks"], r["batch"], r["seq_len"],
                   r["hidden_dim"])
            if key not in ref_best or r["mean_time_ms"] < ref_best[key]["mean_time_ms"]:
                ref_best[key] = r

    out = []
    for r in own:
        key = (r["operation"], r["num_ranks"], r["batch"], r["seq_len"], r["hidden_dim"])
        ref = ref_best.get(key)
        if ref is None:
            continue
        speedup = ref["mean_time_ms"] / r["mean_time_ms"]
        out.append({
            "operation": key[0], "num_ranks": key[1], "batch": key[2],
            "seq_len": key[3], "hidden_dim": key[4],
            "tensor_size_mb": r["tensor_size_mb"],
            "ref_best_backend": ref["backend"],
            "ref_best_mean_ms": round(ref["mean_time_ms"], 4),
            "xla_mean_ms": round(r["mean_time_ms"], 4),
            "speedup": round(speedup, 4),
            **_verdict_pair(speedup, r.get("measured_backend")),
        })
    out.sort(key=lambda r: (r["operation"], r["num_ranks"], r["hidden_dim"],
                            r["seq_len"], r["batch"]))
    return out


def _baseline_shape(base: dict) -> Optional[tuple]:
    cfg = base.get("config") or {}
    keys = ("hidden_size", "num_layers", "ffn_intermediate", "batch_size",
            "seq_length", "dtype")
    return tuple(cfg.get(k) for k in keys) if all(k in cfg for k in keys) else None


def _e2e_shape(r: dict) -> tuple:
    from dlbb_tpu_torch.models.configs import ModelConfig

    cfg = r.get("config") or {}
    model = ModelConfig.from_dict(cfg.get("model", {}))
    inp = cfg.get("input", {})
    return (model.hidden_size, model.num_layers, model.ffn_intermediate,
            inp.get("batch_size"), inp.get("sequence_length"), model.dtype)


def _e2e_rows(e2e_dir: Optional[Path], baseline_json: Optional[Path]) -> list[dict[str, Any]]:
    """The port's E2E tokens/s against the reference-stack CPU baseline:
    one row per ``run_e2e`` result JSON of the port (``backend``
    "torch_cuda") in ``e2e_dir``.  A speedup is claimed only on the card,
    at world 1, at the baseline's own model and shape."""
    base = None
    if baseline_json is not None and Path(baseline_json).exists():
        base = json.loads(Path(baseline_json).read_text())
    base_tps = base["tokens_per_second"] if base else None
    base_shape = _baseline_shape(base) if base else None
    rows: list[dict[str, Any]] = []
    if e2e_dir is None or not Path(e2e_dir).is_dir():
        return rows
    for f in sorted(Path(e2e_dir).glob("*.json")):
        try:
            r = json.loads(f.read_text())
        except Exception:  # noqa: BLE001
            continue
        if not isinstance(r, dict) or r.get("backend") != "torch_cuda" \
                or "tokens_per_second" not in r:
            continue  # not a run_e2e result of the port
        sysinfo = r.get("system_info") or {}
        on_cpu = sysinfo.get("backend") == "cpu"
        name = (r.get("experiment") or {}).get("name", f.stem)
        world1 = all(v == 1 for v in (r.get("mesh") or {}).values())
        comparable = (base_tps is not None and not on_cpu and world1
                      and base_shape is not None and _e2e_shape(r) == base_shape)
        tps = r["tokens_per_second"]
        rows.append({
            "config": f"{name} ({f.name})",
            "device": (f"{sysinfo.get('device_kind', '?')} x "
                       f"{sysinfo.get('num_devices', '?')}"
                       + (" (CPU)" if on_cpu else "")),
            "reference_cpu_stack_tokens_per_s": round(base_tps, 1) if comparable else None,
            "tokens_per_s": round(tps, 1),
            "speedup": round(tps / base_tps, 2) if comparable else None,
            "verdict": (_raw_verdict(tps / base_tps) if comparable
                        else "(CPU run — not a card number)" if on_cpu
                        else "(no reference number)"),
        })
    return rows


def _counts(rows: list[dict]) -> dict[str, Any]:
    """beat/match/lose over the comparable rows; the CPU rows count under
    ``not_comparable_simulated``, with their raw verdicts."""
    c: dict[str, Any] = {"beat": 0, "match": 0, "lose": 0,
                         "not_comparable_simulated": 0}
    raw = {"beat": 0, "match": 0, "lose": 0}
    for r in rows:
        if r["verdict"] == NOT_COMPARABLE:
            c["not_comparable_simulated"] += 1
            raw[r["raw_verdict"]] += 1
        elif r["verdict"] in c:
            c[r["verdict"]] += 1
    if c["not_comparable_simulated"]:
        c["not_comparable_raw_verdicts"] = raw
    return c


def md_table(rows: list[dict], columns: list[str]) -> list[str]:
    """Markdown table lines (None cells blank), shared by every report."""
    lines = ["| " + " | ".join(columns) + " |", "|" + "---|" * len(columns)]
    for r in rows:
        lines.append("| " + " | ".join("" if r.get(c) is None else str(r[c])
                                       for c in columns) + " |")
    return lines


def write_csv(rows: list[dict], columns: list[str], path: Path) -> None:
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=columns)
    w.writeheader()
    for r in rows:
        w.writerow({k: r.get(k) for k in columns})
    atomic_write_text(buf.getvalue(), path, newline="")


def _distinct_configs(rows: list[dict]) -> int:
    """Distinct reference configs covered (a point measured in several
    dtypes is one config)."""
    keys = set()
    for r in rows:
        if "data_size_name" in r:
            keys.add((r["operation"], r["data_size_name"], r["num_ranks"]))
        else:
            keys.add((r["operation"], r["num_ranks"], r["batch"], r["seq_len"],
                      r["hidden_dim"]))
    return len(keys)


def _summary_line(dim: str, rows: list[dict], c: dict) -> str:
    line = (f"- **{dim}** ({_distinct_configs(rows)} configs, {len(rows)} rows): "
            f"{c['beat']} beat, {c['match']} match, {c['lose']} lose")
    if c["not_comparable_simulated"]:
        raw = c["not_comparable_raw_verdicts"]
        line += (f", {c['not_comparable_simulated']} not_comparable"
                 f"(simulated) [raw: {raw['beat']} beat / {raw['match']} "
                 f"match / {raw['lose']} lose]")
    return line


def write_comparison(ref_root: Path, own_1d: Path, own_3d: Path, out_dir: Path,
                     impl: str = DEFAULT_IMPL, own_e2e: Optional[Path] = None,
                     baseline_json: Optional[Path] = None) -> dict[str, Any]:
    """``comparison_{1d,3d}.csv``, ``COMPARISON.md`` and
    ``comparison_summary.json`` in ``out_dir``; returns the summary.
    ``own_e2e`` holds the port's ``run_e2e`` result JSONs and
    ``baseline_json`` the reference-stack CPU baseline, for the E2E
    section."""
    ref_root, out_dir = Path(ref_root), Path(out_dir)
    rows_1d = compare_1d(ref_root / "collectives" / "1d" / "results", own_1d)
    rows_3d = compare_3d(ref_root / "collectives" / "3d" / "results", own_3d, impl)
    e2e = _e2e_rows(own_e2e, baseline_json)

    write_csv(rows_1d, COLUMNS_1D, out_dir / "comparison_1d.csv")
    write_csv(rows_3d, COLUMNS_3D, out_dir / "comparison_3d.csv")

    c1, c3 = _counts(rows_1d), _counts(rows_3d)
    summary = {
        "implementation": impl,
        "1d": {"configs": _distinct_configs(rows_1d), "rows": len(rows_1d), **c1},
        "3d": {"configs": _distinct_configs(rows_3d), "rows": len(rows_3d), **c3},
        "e2e": e2e,
        "thresholds": {"beat": BEAT, "lose": LOSE},
    }

    md = [
        f"# Reference vs {impl} — head-to-head comparison",
        "",
        "Per-config join of the reference's baseline corpus "
        f"(`{ref_root}/collectives/{{1d,3d}}/results/`) against the port's "
        "own `results/{1d,3d}` corpus, both processed by the port's stats "
        "(`dlbb_tpu_torch/stats`).  `ref_best_*` is the fastest reference "
        "backend (incl. the tuning-variant directories) at that config; "
        f"`speedup` = ref_best_mean / xla_mean (>1 = {impl} faster; the "
        "`xla_*` columns are the own side, under the JAX package's column "
        f"names); verdict thresholds: beat >= {BEAT}x, lose <= {LOSE}x.",
        "",
        "**Caveats** (see `dlbb_tpu_torch/stats/compare.py`): the reference "
        "corpus ran real MPI/oneCCL ranks on a 56-core node.  The port's "
        "rows measured on the CPU (gloo ranks) carry "
        "`not_comparable(simulated)`; rows measured on the card compare "
        "NCCL on the GPU against MPI on that node, stack against stack.  "
        "The join covers the rank counts both corpora measured: the card "
        "gives one rank per call, which the reference never measured.  "
        "fp32 rows move twice the reference's bytes at the same size label.  "
        "E2E rows are the port's own `run_e2e` results against the "
        "re-measured reference-stack torch-CPU baseline.",
        "",
        "## Summary",
        "",
        "beat/match/lose count comparable rows only; rows measured on the "
        "CPU carry the structural verdict `not_comparable(simulated)` (raw "
        "numbers and the speedup-only `raw_verdict` kept per row).",
        "",
        _summary_line("1D", rows_1d, c1),
        _summary_line("3D", rows_3d, c3),
        "",
    ]
    if e2e:
        md += [f"## E2E forward throughput ({impl} port, per-row device column)", ""]
        md += md_table(e2e, E2E_COLUMNS)
        md.append("")
    md += ["## 1D collectives (full table)", ""]
    md += md_table(rows_1d, COLUMNS_1D)
    md += ["", "## 3D collectives (per op x ranks aggregate; "
           "full detail in comparison_3d.csv)", ""]
    agg_rows = []
    for op, ranks in sorted({(r["operation"], r["num_ranks"]) for r in rows_3d}):
        sub = [r for r in rows_3d if r["operation"] == op and r["num_ranks"] == ranks]
        cs = _counts(sub)
        agg_rows.append({
            "operation": op, "num_ranks": ranks, "configs": len(sub),
            "beat": cs["beat"], "match": cs["match"], "lose": cs["lose"],
            "not_comparable": cs["not_comparable_simulated"],
            "median_speedup": round(float(np.median([r["speedup"] for r in sub])), 3),
        })
    md += md_table(agg_rows, ["operation", "num_ranks", "configs", "beat", "match",
                              "lose", "not_comparable", "median_speedup"])
    md.append("")

    atomic_write_text("\n".join(md), out_dir / "COMPARISON.md")
    atomic_write_text(json.dumps(summary, indent=2) + "\n",
                      out_dir / "comparison_summary.json")
    return summary
