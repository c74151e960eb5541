"""Span-level time attribution (``cli obs attribute``; counterpart of
``dlbb_tpu/obs/attribution.py``, JAX's partition, prices and files).

The span tracer (PR 8) records *when* every harness phase ran; the
fitted cost model (cm2) predicts *how long* the device work should
take.  This module joins the two into a "where did the time go"
breakdown for one run directory — per phase (queue-wait / compile /
prefill / decode / execute / write / idle), per sweep config, and per
serving request — with the cm2 prediction decomposed into its
dispatch-overhead / collective-wire / compute terms next to the
measured number, emitted as MD + CSV under
``stats/torch/analysis/attribution/``.

Inputs, in preference order:

- a **span trace** (Chrome trace-event JSON written via
  ``--span-trace``/``DLBB_SPANS``): the main track's timeline is
  partitioned exactly — every instant of the wall belongs to the
  innermost phase-mapped span covering it, to ``host`` (inside an
  unmapped span, e.g. the per-config glue), or to ``idle`` (no span
  open).  Phase times therefore sum to the track's wall time by
  construction.
- a **journal** (``sweep_journal.jsonl``) when no trace exists — the
  committed serving run's case: the last session's event stream is
  segmented and each inter-event interval is attributed to the phase
  the *ending* event closes (``request-admitted`` closes queue-wait,
  ``request-prefill`` a prefill, ``request-completed`` decode work,
  ...).  Coarser than spans, still a complete partition.

Predictions come from the port's ``analysis/costmodel.py`` (``--model
cm1|cm2``): cm1 through ``resolve_tier``, cm2 through the tier's fit alone
(``load_fitted_tier``): where the tier has no fit (the card's ``cuda`` tier
at world 1), a cm2 attribution fails closed with ``FitMissingError``, where
JAX's ``resolve_tier`` falls back to cm1 with a warning.  Sweep configs
re-use the corpus feature extractor (:mod:`dlbb_tpu_torch.obs.corpus`) on
each artifact — per timed
iteration ``γ + α·collectives + wire/β + FLOPs/peak`` — and serving
runs price their recorded dispatch counts (``decode_units``, admitted
prefills) with per-layer tp-collective counts and an analytic
dense-forward FLOPs estimate from the report's model record.  The
per-request table is measured-only (a decode dispatch serves the whole
batch, so charging it to one request would double-count); the
predicted-vs-measured comparison lives at the phase level where
dispatch counts are exact.

The device column reads a run's gated captures through the port's
``obs/devtrace.py``: on the card Kineto's traces of every rank, merged, on
the CPU the gloo ranks' host-op timelines.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

from dlbb_tpu_torch.analysis.costmodel import (
    CM2_VERSION,
    COST_MODEL_VERSION,
    CostTier,
    load_fitted_tier,
    resolve_tier,
)
from dlbb_tpu_torch.obs.devtrace import _fmt_us

ATTRIBUTION_SCHEMA = "dlbb_attribution_v1"
DEFAULT_ATTRIBUTION_DIR = Path("stats/torch/analysis/attribution")

# ordered phase vocabulary of the partition (every measured second of
# the wall lands in exactly one)
PHASES = ("queue-wait", "plan", "compile", "payload", "prefill",
          "decode", "execute", "write", "capture", "host", "idle")

# span name -> phase (innermost mapped span wins; prefix match for the
# dynamic names)
_SPAN_PHASE = {
    "plan": "plan",
    "compile": "compile",
    "compile+warmup": "compile",
    "compile-wait": "compile",
    "payload": "payload",
    "measure": "execute",
    "train_step": "execute",
    "device-capture": "capture",
    "write": "write",
    "serve-admission": "queue-wait",
    "serve-prefill": "prefill",
    "serve-prefill-chunk": "prefill",
    "serve-decode": "decode",
}
_SPAN_PHASE_PREFIX = (("calibrate:", "execute"),)

# journal event -> phase of the interval ENDING at that event
_JOURNAL_PHASE = {
    "request-admitted": "queue-wait",
    "request-rejected": "queue-wait",
    "request-infeasible": "queue-wait",
    "request-prefill": "prefill",
    "request-completed": "decode",
    "request-failed": "decode",
    "request-preempted": "decode",
    "completed": "execute",
    "failed": "execute",
    "retry": "execute",
}

CSV_COLUMNS = (
    "kind", "name", "measured_us", "queue_wait_us", "prefill_us",
    "decode_us", "compile_us", "execute_us", "device_us",
    "predicted_execute_us",
    "predicted_dispatch_overhead_us", "predicted_wire_us",
    "predicted_compute_us", "dispatches", "iterations", "tokens",
    "error_factor", "outcome",
)


def _capture_device_us(meta: dict[str, Any],
                       input_dir: Path) -> Optional[float]:
    """Device-measured busy time of ONE execution from a config's
    gated capture (``obs/devtrace.py``): each device's summed device-op
    event time, median across devices, amortised per profile rep.  A
    capture of a mesh is every rank's trace, merged (each rank a device).
    None when the capture is absent, failed, or unparseable — the
    device column stays honest-blank rather than guessed."""
    from dlbb_tpu_torch.obs.devtrace import (
        CaptureError,
        _resolve_capture_paths,
        device_comm_samples,
        merge_timelines,
        parse_capture,
    )

    if not isinstance(meta, dict) or "error" in meta:
        return None
    paths = _resolve_capture_paths(meta, input_dir)
    if not paths:
        return None
    try:
        timeline = merge_timelines([parse_capture(p) for p in paths])
    except CaptureError:
        return None
    agg = device_comm_samples(timeline,
                              int(meta.get("profile_reps", 1)),
                              buckets=None)
    return agg["measured_device_us"] if agg else None


def _infer_tier(input_dir: Path) -> str:
    """Cost-model tier from the run's artifacts (they record the backend
    they measured on — ``corpus.tier_of_result``); ``cpu-sim`` when
    nothing under the directory records one."""
    from dlbb_tpu_torch.obs.corpus import tier_of_result

    for path in sorted(Path(input_dir).glob("*.json")):
        try:
            data = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(data, dict) and isinstance(
                data.get("system_info"), dict):
            return tier_of_result(data)
    return "cpu-sim"


def _fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit, div in (("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10)):
        if n >= div:
            return f"{n / div:.1f} {unit}"
    return f"{int(n)} B"


def _span_phase(name: str) -> Optional[str]:
    phase = _SPAN_PHASE.get(name)
    if phase:
        return phase
    for prefix, p in _SPAN_PHASE_PREFIX:
        if name.startswith(prefix):
            return p
    return None


# ---------------------------------------------------------------------------
# measured partition
# ---------------------------------------------------------------------------


def partition_trace(events: list[dict[str, Any]]
                    ) -> tuple[dict[str, float], float, dict]:
    """Partition the busiest track's timeline into phase micro-seconds.
    Returns ``(phase_us, wall_us, per_name_us)``; phases + idle sum to
    ``wall_us`` exactly."""
    # pick the track (pid, tid) carrying the most B/E span time
    totals: dict[tuple, float] = {}
    opens: dict[tuple, dict[str, list[float]]] = {}
    for ev in events:
        if ev.get("ph") not in ("B", "E"):
            continue
        key = (ev.get("pid"), ev.get("tid"))
        stack = opens.setdefault(key, {})
        if ev["ph"] == "B":
            stack.setdefault(ev["name"], []).append(ev["ts"])
        else:
            starts = stack.get(ev["name"])
            if starts:
                totals[key] = totals.get(key, 0.0) + ev["ts"] - starts.pop()
    if not totals:
        return {}, 0.0, {}
    track = max(totals, key=lambda k: totals[k])

    track_events = sorted(
        (ev for ev in events
         if ev.get("ph") in ("B", "E")
         and (ev.get("pid"), ev.get("tid")) == track),
        key=lambda ev: ev["ts"],
    )
    phase_us: dict[str, float] = {}
    per_name: dict[str, float] = {}
    stack: list[str] = []
    prev_ts = track_events[0]["ts"]
    for ev in track_events:
        ts = ev["ts"]
        if ts > prev_ts:
            phase = "idle"
            for name in reversed(stack):
                mapped = _span_phase(name)
                if mapped:
                    phase = mapped
                    break
            else:
                if stack:
                    phase = "host"
            phase_us[phase] = phase_us.get(phase, 0.0) + ts - prev_ts
            if stack:
                per_name[stack[-1]] = per_name.get(stack[-1], 0.0) \
                    + ts - prev_ts
        prev_ts = ts
        if ev["ph"] == "B":
            stack.append(ev["name"])
        elif stack and stack[-1] == ev["name"]:
            stack.pop()
        elif ev["name"] in stack:  # tolerate mild misnesting
            stack.remove(ev["name"])
    wall = track_events[-1]["ts"] - track_events[0]["ts"]
    return phase_us, wall, per_name


def last_session(records: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Journals are append-only across runs; attribute the LAST session
    only (request ids repeat across sessions)."""
    start = 0
    for i, rec in enumerate(records):
        if rec.get("event") == "sweep-start":
            start = i
    return records[start:]


def partition_journal(records: list[dict[str, Any]]
                      ) -> tuple[dict[str, float], float]:
    """Segment the journal's event stream: each inter-event interval is
    attributed to the phase its ending event closes (unknown enders →
    idle).  Phases sum to the stream's wall time exactly."""
    recs = [r for r in records if "ts" in r]
    recs.sort(key=lambda r: float(r["ts"]))
    phase_us: dict[str, float] = {}
    prev = None
    for rec in recs:
        ts = float(rec["ts"])
        if prev is not None and ts > prev:
            phase = _JOURNAL_PHASE.get(rec.get("event"), "idle")
            phase_us[phase] = phase_us.get(phase, 0.0) + (ts - prev) * 1e6
        prev = ts
    wall = (float(recs[-1]["ts"]) - float(recs[0]["ts"])) * 1e6 \
        if len(recs) > 1 else 0.0
    return phase_us, wall


# ---------------------------------------------------------------------------
# predictions
# ---------------------------------------------------------------------------


def predict_iteration_us(sample: dict[str, Any], tier: CostTier
                         ) -> dict[str, float]:
    """cm-priced decomposition of ONE timed iteration of a corpus-shaped
    sample: {dispatch, wire, compute, total} in µs."""
    dispatch = sample.get("dispatches", 1.0) * tier.gamma_dispatch_us
    wire = (sample.get("collectives", 1.0) * tier.alpha_us
            + sample["wire_bytes"] / tier.beta_bytes_per_us)
    compute = sample.get("flops", 0) / tier.peak_flops_per_us
    return {"dispatch": dispatch, "wire": wire, "compute": compute,
            "total": dispatch + wire + compute}


def _serving_dispatch_features(report: dict[str, Any]
                               ) -> dict[str, dict[str, float]]:
    """Analytic per-dispatch features of the serving engine's two jit
    families, from the report's model/mesh/serving records: decode = one
    token per active slot through the stack (≈ 24·L·h² FLOPs/token, two
    tp psums per layer when tp > 1), prefill = one bucket of prompt
    tokens.  Approximations — the attribution is about magnitudes, the
    audit targets pin the exact inventories."""
    model = report.get("model", {})
    mesh = report.get("mesh", {})
    serving = report.get("serving", {})
    h = int(model.get("hidden_size", 0) or 0)
    layers = int(model.get("num_layers", 0) or 0)
    tp = int(mesh.get("tp", 1) or 1)
    max_batch = int(serving.get("max_batch", 1) or 1)
    dtype_bytes = 4 if "32" in str(model.get("dtype", "")) else 2
    flops_token = 24 * layers * h * h
    coll = (2 * layers) if tp > 1 else 0
    # per-token activation psum: [1, h] partial per layer
    wire_token = (2 * (tp - 1) / tp * h * dtype_bytes * coll
                  if tp > 1 else 0)
    buckets = serving.get("prefill_buckets") or [serving.get("max_seq", 0)]
    mean_bucket = sum(buckets) / max(len(buckets), 1)
    return {
        "decode": {"collectives": float(coll),
                   "wire_bytes": float(wire_token * max_batch),
                   "flops": float(flops_token * max_batch),
                   "dispatches": 1.0},
        "prefill": {"collectives": float(coll),
                    "wire_bytes": float(wire_token * mean_bucket),
                    "flops": float(flops_token * mean_bucket),
                    "dispatches": 1.0},
    }


def _serving_peak_bytes(report: dict[str, Any]) -> dict[str, int]:
    """Static per-device peak-memory prediction per serving phase, from
    the report's model/serving/mesh records — the memory-audit twin of
    the time prediction: tp-sharded weights (~12·L·H² magnitude
    estimate) + the dp/tp-sharded KV cache (priced by the ONE formula,
    ``models.configs.kv_cache_bytes_raw`` — the same number the HBM
    budget gate and the static cache cross-check use) + phase
    activations.  Empty (the column stays honest-blank) when the run
    records no model/serving geometry — sweep runs, legacy reports."""
    from dlbb_tpu_torch.models.configs import kv_cache_bytes_raw

    model = report.get("model", {})
    mesh = report.get("mesh", {})
    serving = report.get("serving", {})
    h = int(model.get("hidden_size", 0) or 0)
    layers = int(model.get("num_layers", 0) or 0)
    heads = int(model.get("num_heads", 0) or 0)
    max_batch = int(serving.get("max_batch", 0) or 0)
    max_seq = int(serving.get("max_seq", 0) or 0)
    if not (h and layers and heads and max_batch and max_seq):
        return {}
    kvh = int(model.get("kv_heads", heads) or heads)
    tp = max(1, int(mesh.get("tp", 1) or 1))
    dp = max(1, int(mesh.get("dp", 1) or 1))
    dtype = str(model.get("dtype", "bfloat16"))
    dtype_bytes = 4 if "32" in dtype else 2
    params_bytes = 12 * layers * h * h * dtype_bytes
    cache_dev = kv_cache_bytes_raw(
        layers, max_batch, max_seq, kvh, h // heads, dtype) // (dp * tp)
    resident = params_bytes // tp + cache_dev
    buckets = serving.get("prefill_buckets") or [max_seq]
    mean_bucket = int(sum(buckets) / max(len(buckets), 1))
    return {
        "decode": resident + 8 * max_batch * 3 * h * dtype_bytes,
        "prefill": resident + 8 * mean_bucket * 3 * h * dtype_bytes,
    }


# ---------------------------------------------------------------------------
# the attribute run
# ---------------------------------------------------------------------------


def _find_span_trace(directory: Path,
                     trace: "Optional[str | Path]") -> Optional[dict]:
    from dlbb_tpu_torch.obs.spans import SPAN_SCHEMA

    candidates = [Path(trace)] if trace else sorted(directory.glob("*.json"))
    for path in candidates:
        try:
            data = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError) as e:
            if trace:
                # an EXPLICIT --span-trace-file must fail loudly — a
                # silent fallback to the coarser journal partition would
                # hide that the named trace was never read
                raise FileNotFoundError(
                    f"--span-trace-file {path}: unreadable ({e})"
                ) from e
            continue
        # a journal-RECONSTRUCTED trace (``obs trace`` output, often
        # sitting in the same directory) carries the span schema but only
        # M/i/X events — partitioning it would yield an empty wall=0
        # report; only a real span trace (B/E pairs) qualifies
        if (isinstance(data, dict)
                and data.get("otherData", {}).get("schema") == SPAN_SCHEMA
                and any(ev.get("ph") in ("B", "E")
                        for ev in data.get("traceEvents", ())
                        if isinstance(ev, dict))):
            return data
        if trace:
            raise ValueError(
                f"--span-trace-file {path} is not a span trace "
                "(wrong/missing otherData.schema, or no B/E span events "
                "— a journal-reconstructed `obs trace` output does not "
                "qualify)"
            )
    return None


def run_attribution(
    input_dir: "str | Path",
    out_dir: "Optional[str | Path]" = None,
    trace: "Optional[str | Path]" = None,
    model: str = COST_MODEL_VERSION,
    tier: Optional[str] = None,
    fit_dir: "Optional[str | Path]" = None,
    name: Optional[str] = None,
    verbose: bool = True,
) -> dict[str, Any]:
    """Attribute one run directory; writes ``<name>.md`` + ``<name>.csv``
    under ``out_dir`` (default ``stats/torch/analysis/attribution/``) and
    returns the attribution record.  ``model="cm2"`` prices with the
    tier's fit or raises ``FitMissingError`` (module docstring)."""
    from dlbb_tpu_torch.resilience.journal import read_journal

    input_dir = Path(input_dir)
    out_dir = Path(out_dir or DEFAULT_ATTRIBUTION_DIR)
    name = name or input_dir.resolve().name
    if tier is None:
        # file processing must stay backend-free: infer the tier from
        # the artifacts (they record their backend), default cpu-sim
        tier = _infer_tier(input_dir)
    if model == CM2_VERSION:
        cost_tier = load_fitted_tier(tier, fit_dir)
    else:
        cost_tier = resolve_tier(tier, model=model, fit_dir=fit_dir)

    records, torn = read_journal(input_dir)
    session = last_session(records)
    trace_data = _find_span_trace(input_dir, trace)
    if trace_data is not None:
        phase_us, wall_us, _names = partition_trace(
            trace_data["traceEvents"])
        source = "span-trace"
    elif session:
        phase_us, wall_us = partition_journal(session)
        source = "journal"
    else:
        raise FileNotFoundError(
            f"{input_dir} holds neither a span trace nor a parseable "
            "journal — nothing to attribute (run with --span-trace, or "
            "point --input at a sweep/serving output directory)"
        )

    serving = any(str(r.get("event", "")).startswith("request-")
                  for r in session)
    peak_bytes: dict[str, int] = {}
    if serving:
        report = _serving_report(input_dir) or {}
        entities, predicted, device_us = _serving_entities(
            input_dir, session, cost_tier, report)
        peak_bytes = _serving_peak_bytes(report)
    else:
        entities, predicted, device_us = _sweep_entities(
            input_dir, session, cost_tier)

    record = {
        "schema": ATTRIBUTION_SCHEMA,
        "name": name,
        "input_dir": str(input_dir),
        "source": source,
        "kind": "serving" if serving else "sweep",
        "tier": cost_tier.name,
        "cost_model_version": cost_tier.version,
        "fit_version": (cost_tier.fit or {}).get("fit_version"),
        "wall_us": wall_us,
        "phases_us": {p: phase_us.get(p, 0.0) for p in PHASES
                      if phase_us.get(p)},
        "predicted_us": predicted,
        # device-measured phase totals from the run's gated captures
        # (one captured execution x the recorded execution count);
        # empty when the run was uncaptured
        "device_us": device_us,
        # static per-phase peak-memory prediction (what was RESIDENT
        # while the time went) — serving phases only; phases without a
        # memory model stay honest-blank (docs/memory_audit.md)
        "peak_bytes": peak_bytes,
        "entities": entities,
        "torn_journal_lines": torn,
    }
    md_path, csv_path = write_attribution(record, out_dir)
    record["md_path"], record["csv_path"] = str(md_path), str(csv_path)
    if verbose:
        total = sum(record["phases_us"].values())
        print(f"[obs] attribution ({record['kind']}, {source}, "
              f"{cost_tier.version}): wall {wall_us / 1e6:.2f}s, "
              f"phases cover {total / max(wall_us, 1e-9) * 100:.1f}% "
              f"-> {md_path}")
    return record


def _sweep_entities(input_dir: Path, session: list[dict],
                    tier: CostTier) -> tuple[list[dict], dict]:
    """Per-config rows: journal lifecycle joined with each artifact's
    corpus features, priced per iteration."""
    from dlbb_tpu_torch.obs.corpus import ingest_result

    started: dict[str, float] = {}
    done: dict[str, tuple[float, str]] = {}
    for rec in session:
        cfg, ev = rec.get("config"), rec.get("event")
        if not cfg:
            continue
        if ev == "started":
            started[cfg] = float(rec["ts"])
        elif ev in ("completed", "failed"):
            done[cfg] = (float(rec["ts"]), ev)

    entities: list[dict] = []
    pred_totals = {"dispatch": 0.0, "wire": 0.0, "compute": 0.0,
                   "total": 0.0}
    device_execute = 0.0
    configs = sorted(set(started) | set(done)) or sorted(
        p.name for p in input_dir.glob("*.json")
        if p.name != "sweep_manifest.json"
    )
    for cfg in configs:
        path = input_dir / cfg
        row: dict[str, Any] = {"kind": "config", "name": cfg}
        if cfg in started and cfg in done:
            row["measured_us"] = (done[cfg][0] - started[cfg]) * 1e6
            row["outcome"] = done[cfg][1]
        sample = None
        data = None
        if path.exists():
            try:
                data = json.loads(path.read_text())
                sample, _ = ingest_result(path, data)
                if sample is not None:
                    row["compile_us"] = float(
                        data.get("compile_seconds", 0.0)) * 1e6
            except (OSError, json.JSONDecodeError):
                pass
        if isinstance(data, dict):
            # the device column: one captured execution's device-op
            # busy time (median across devices), measured by the gated
            # capture — side by side with the host-span numbers
            dev = _capture_device_us(data.get("device_trace"), input_dir)
            if dev is not None:
                row["device_us"] = dev
                if sample is not None:
                    device_execute += dev * sample["iterations"]
        if sample is not None:
            iters = sample["iterations"]
            per_iter = predict_iteration_us(sample, tier)
            row.update(
                iterations=iters,
                dispatches=iters * sample.get("dispatches", 1.0),
                execute_us=sample["measured_median_us"] * iters,
                predicted_execute_us=per_iter["total"] * iters,
                predicted_dispatch_overhead_us=per_iter["dispatch"] * iters,
                predicted_wire_us=per_iter["wire"] * iters,
                predicted_compute_us=per_iter["compute"] * iters,
            )
            if row["predicted_execute_us"] > 0 and row["execute_us"] > 0:
                m, p = row["execute_us"], row["predicted_execute_us"]
                row["error_factor"] = max(m, p) / min(m, p)
            for k, kk in (("dispatch", "predicted_dispatch_overhead_us"),
                          ("wire", "predicted_wire_us"),
                          ("compute", "predicted_compute_us"),
                          ("total", "predicted_execute_us")):
                pred_totals[k] += row[kk]
        entities.append(row)
    predicted = {
        "execute": pred_totals["total"],
        "dispatch-overhead": pred_totals["dispatch"],
        "collective-wire": pred_totals["wire"],
        "compute": pred_totals["compute"],
    }
    # device-measured execute: one captured execution's device busy
    # time x the iteration count each config timed (empty when the run
    # carried no captures — the column stays honest-blank)
    device_us = {"execute": device_execute} if device_execute > 0 else {}
    return entities, predicted, device_us


def _serving_report(input_dir: Path) -> Optional[dict[str, Any]]:
    """The run's serving report JSON, or None when the directory holds
    only a journal (the crashed-run case)."""
    for path in sorted(Path(input_dir).glob("serving_*.json")):
        if path.name in ("serving_manifest.json", "serving_resume.json"):
            continue
        try:
            data = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(data, dict) and data.get("schema", "").startswith(
                "dlbb_serving_report"):
            return data
    return None


def _serving_entities(input_dir: Path, session: list[dict],
                      tier: CostTier,
                      report: Optional[dict[str, Any]] = None
                      ) -> tuple[list[dict], dict, dict]:
    """Per-request measured rows (queue-wait / prefill / decode from the
    journal lifecycle) + phase-level predictions from the run report's
    exact dispatch counts + device-measured phase totals from the run's
    capture metas (one captured dispatch per phase x the dispatch
    count)."""
    if report is None:
        report = _serving_report(input_dir) or {}

    marks: dict[str, dict[str, float]] = {}
    for rec in session:
        rid, ev = rec.get("config"), rec.get("event")
        if not rid or not str(ev).startswith("request-"):
            continue
        m = marks.setdefault(rid, {})
        m[ev[len("request-"):]] = float(rec["ts"])
        if ev == "request-completed" and "output_tokens" in rec:
            m["tokens"] = float(rec["output_tokens"])

    entities: list[dict] = []
    for rid in sorted(marks, key=lambda r: marks[r].get("arrived", 0.0)):
        m = marks[rid]
        row: dict[str, Any] = {"kind": "request", "name": rid}
        arr = m.get("arrived")
        adm = m.get("admitted")
        pre = m.get("prefill")
        end = next((m[k] for k in ("completed", "failed", "preempted",
                                   "rejected", "infeasible") if k in m),
                   None)
        if arr is not None and adm is not None:
            row["queue_wait_us"] = (adm - arr) * 1e6
        elif arr is not None and "rejected" in m:
            row["queue_wait_us"] = (m["rejected"] - arr) * 1e6
        if adm is not None and pre is not None:
            row["prefill_us"] = (pre - adm) * 1e6
        if pre is not None and end is not None:
            row["decode_us"] = (end - pre) * 1e6
        if arr is not None and end is not None:
            row["measured_us"] = (end - arr) * 1e6
        if "tokens" in m:
            row["tokens"] = int(m["tokens"])
        row["outcome"] = next(
            (k for k in ("completed", "failed", "preempted", "rejected",
                         "infeasible") if k in m), "in-flight")
        entities.append(row)

    predicted: dict[str, float] = {}
    device_us: dict[str, float] = {}
    if report:
        feats = _serving_dispatch_features(report)
        decode_units = float(report.get("decode_units",
                                        report.get("decode_steps", 0)))
        prefills = float(report.get("requests", {}).get("admitted", 0))
        chunks = float(
            (report.get("fast_path") or {}).get("prefill_chunks") or 0)
        if chunks:
            prefills = chunks
        dec = predict_iteration_us(feats["decode"], tier)
        pre = predict_iteration_us(feats["prefill"], tier)
        predicted = {
            "decode": dec["total"] * decode_units,
            "prefill": pre["total"] * prefills,
            "dispatch-overhead": (dec["dispatch"] * decode_units
                                  + pre["dispatch"] * prefills),
            "collective-wire": (dec["wire"] * decode_units
                                + pre["wire"] * prefills),
            "compute": (dec["compute"] * decode_units
                        + pre["compute"] * prefills),
            "decode_units": decode_units,
            "prefill_dispatches": prefills,
        }
        # the device column: each phase's captured per-dispatch device
        # busy time x the same dispatch counts the predictions price
        for meta in (report.get("observability") or {}).get(
                "device_captures", ()):
            dev = _capture_device_us(meta, input_dir)
            if dev is None:
                continue
            phase = meta.get("phase")
            if phase == "prefill" and prefills:
                device_us["prefill"] = dev * prefills
            elif phase == "decode" and decode_units:
                # the captured scan ran a fixed k token steps while the
                # run's scans vary k per dispatch — normalise the
                # captured time per STEP and scale by the run's total
                # decode steps, never by dispatch count
                k_cap = max(1, int(meta.get("decode_steps_per_scan", 1)))
                steps = float(report.get("decode_steps", decode_units))
                device_us["decode"] = dev / k_cap * steps
    return entities, predicted, device_us


# ---------------------------------------------------------------------------
# output (MD + CSV via atomic_write_text)
# ---------------------------------------------------------------------------


def write_attribution(record: dict[str, Any],
                      out_dir: "str | Path") -> tuple[Path, Path]:
    import csv
    import io

    from dlbb_tpu_torch.utils.config import atomic_write_text

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = record["name"]
    wall = record["wall_us"]
    phases = record["phases_us"]
    predicted = record["predicted_us"]

    lines = [
        f"# Time attribution — {name}",
        "",
        f"- schema: `{ATTRIBUTION_SCHEMA}`",
        f"- kind: {record['kind']} (measured from {record['source']})",
        f"- cost model: {record['cost_model_version']}"
        + (f" (fit v{record['fit_version']})"
           if record.get("fit_version") else "")
        + f" / tier {record['tier']}",
        f"- wall time: {_fmt_us(wall)}",
        "",
        "## Where the wall time went",
        "",
        "Measured phases partition the "
        + ("main span track" if record["source"] == "span-trace"
           else "journal event stream")
        + " — they sum to the wall time.  Predicted columns decompose "
          "the device-work phases with the "
        + record["cost_model_version"]
        + " model (γ·dispatches + α·collectives + wire/β + FLOPs/peak)."
        + ("  The device column is measured from the run's gated "
           "captures: one captured execution's device-op busy time x "
           "the recorded execution count (obs devtrace parses the "
           "same captures per op)." if record.get("device_us") else "")
        + ("  The peak column is the STATIC per-device memory "
           "prediction for the phase's resident set (sharded weights + "
           "KV cache + activations — docs/memory_audit.md); phases "
           "without a memory model stay blank."
           if record.get("peak_bytes") else ""),
        "",
        "| phase | measured | share | device (captured) | predicted "
        "| peak (static) |",
        "|---|---:|---:|---:|---:|---:|",
    ]
    device_us = record.get("device_us") or {}
    peak_bytes = record.get("peak_bytes") or {}
    for phase in PHASES:
        us = phases.get(phase)
        if not us:
            continue
        share = us / wall * 100 if wall else 0.0
        pred = predicted.get(phase)
        dev = device_us.get(phase)
        peak = peak_bytes.get(phase)
        lines.append(f"| {phase} | {_fmt_us(us)} | {share:.1f}% | "
                     f"{_fmt_us(dev) if dev else '-'} | "
                     f"{_fmt_us(pred) if pred else '-'} | "
                     f"{_fmt_bytes(peak) if peak else '-'} |")
    covered = sum(phases.values())
    lines.append(f"| **total** | {_fmt_us(covered)} | "
                 f"{covered / wall * 100 if wall else 0:.1f}% | | | |")
    lines += [
        "",
        "## Predicted device-work decomposition",
        "",
        "| term | predicted |",
        "|---|---:|",
    ]
    for term in ("dispatch-overhead", "collective-wire", "compute"):
        if term in predicted:
            lines.append(f"| {term} | {_fmt_us(predicted[term])} |")
    ent_label = ("request" if record["kind"] == "serving" else "config")
    measured_ents = [e for e in record["entities"]
                     if e.get("measured_us") is not None]
    top = sorted(measured_ents, key=lambda e: -e["measured_us"])[:20]
    lines += [
        "",
        f"## Top {ent_label}s by measured time "
        f"({len(record['entities'])} total; full table in the CSV)",
        "",
    ]
    if record["kind"] == "serving":
        lines += [
            "| request | total | queue-wait | prefill | decode | tokens "
            "| outcome |",
            "|---|---:|---:|---:|---:|---:|---|",
        ]
        for e in top:
            lines.append(
                f"| {e['name']} | {_fmt_us(e.get('measured_us'))} | "
                f"{_fmt_us(e.get('queue_wait_us'))} | "
                f"{_fmt_us(e.get('prefill_us'))} | "
                f"{_fmt_us(e.get('decode_us'))} | "
                f"{e.get('tokens', '-')} | {e.get('outcome', '-')} |")
    else:
        lines += [
            "| config | wall | execute (measured) | device (1 rep) "
            "| execute (predicted) "
            "| of which dispatch | wire | compute | err |",
            "|---|---:|---:|---:|---:|---:|---:|---:|---:|",
        ]
        for e in top:
            err = e.get("error_factor")
            lines.append(
                f"| {e['name']} | {_fmt_us(e.get('measured_us'))} | "
                f"{_fmt_us(e.get('execute_us'))} | "
                f"{_fmt_us(e.get('device_us'))} | "
                f"{_fmt_us(e.get('predicted_execute_us'))} | "
                f"{_fmt_us(e.get('predicted_dispatch_overhead_us'))} | "
                f"{_fmt_us(e.get('predicted_wire_us'))} | "
                f"{_fmt_us(e.get('predicted_compute_us'))} | "
                f"{f'{err:.2f}x' if err else '-'} |")
    lines.append("")
    md_path = atomic_write_text("\n".join(lines), out_dir / f"{name}.md")

    buf = io.StringIO()
    writer = csv.DictWriter(buf, fieldnames=list(CSV_COLUMNS),
                            extrasaction="ignore")
    writer.writeheader()
    for e in record["entities"]:
        writer.writerow(e)
    csv_path = atomic_write_text(buf.getvalue(), out_dir / f"{name}.csv",
                                 newline="")
    return md_path, csv_path


def validate_attribution(record: dict[str, Any],
                         tolerance: float = 0.05) -> list[str]:
    """Schema/consistency check (the acceptance contract): required
    keys, known phases only, and the measured phase partition summing to
    the wall time within ``tolerance``.  Returns problems (empty =
    valid)."""
    problems: list[str] = []
    for key in ("schema", "name", "kind", "wall_us", "phases_us",
                "entities", "cost_model_version"):
        if key not in record:
            problems.append(f"missing key {key!r}")
    if record.get("schema") != ATTRIBUTION_SCHEMA:
        problems.append(f"schema {record.get('schema')!r} != "
                        f"{ATTRIBUTION_SCHEMA!r}")
    unknown = set(record.get("phases_us", {})) - set(PHASES)
    if unknown:
        problems.append(f"unknown phase(s) {sorted(unknown)}")
    wall = record.get("wall_us") or 0.0
    covered = sum(record.get("phases_us", {}).values())
    if wall <= 0:
        # an empty partition must never validate — it means the input
        # trace carried no measurable span time at all
        problems.append("wall_us is zero — nothing was attributed")
    elif abs(covered - wall) > tolerance * wall:
        problems.append(
            f"phases cover {covered:.0f}us of {wall:.0f}us wall "
            f"({covered / wall * 100:.1f}%, tolerance {tolerance:.0%})"
        )
    return problems
