"""Trace-driven serving benchmark harness (``cli serve``; counterpart of
``dlbb_tpu/serve/bench.py``).

Composes the serving level out of the machinery every other level uses:
``parallel/plan.py`` resolves and validates the ``(dp, tp)`` mesh, the
resilience journal records request lifecycle events (fsync'd), spans wrap
the admission/prefill/decode phases, and every artifact is an atomic
write, JAX's set under JAX's names and schemas:

- ``serving_<name>.json``   — the full report (``docs/serving.md``);
- ``trace_<name>.json``     — the exact trace served, replayable;
- ``serving_manifest.json`` — run summary + topology record;
- ``metrics.prom``          — Prometheus textfile
  (``obs.export.serving_metrics``);
- ``sweep_journal.jsonl``   — request lifecycle audit trail.

Graceful drain + resume: a SIGTERM mid-trace (or the ``serve-preempt``
site) stops admission, drains the in-flight window, and writes
``serving_resume.json`` (the remaining rids and the partial report with
its raw samples) next to the replayable trace, instead of the result.
:func:`resume_serving` replays the remaining requests and merges both
sessions into the artifact set of an uninterrupted run: the same names,
the same report schema, and the same outcome for every request that was
not preempted.

One process runs each rank of the mesh (:func:`run_serve_from_config`
launches them through ``bench/launch.py``); every rank serves the same
trace, and rank 0 alone writes the journal, the artifacts and the resume
checkpoint.  A resume relaunches the same world.  A ``fleet:`` section or
``replicas`` above 1 routes the run to ``serve/fleet.py::run_fleet``, whose
``parallelism:`` plan is each replica's.  ``device_trace`` (else
``DLBB_DEVICE_TRACE``) captures one prefill and one decode scan after the
trace is served, on every rank of the mesh
(``ServingEngine.capture_device_traces``), recorded in the report's
``observability`` section, as JAX does; a fleet takes none, as in JAX.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import replace
from pathlib import Path
from typing import Any, Optional

import torch
import torch.distributed as dist

from dlbb_tpu_torch.models.configs import ModelConfig, kv_cache_bytes_per_device
from dlbb_tpu_torch.serve.engine import ServingConfig, ServingEngine
from dlbb_tpu_torch.serve.traffic import TRACE_KINDS, TrafficTrace, generate_trace
from dlbb_tpu_torch.utils.sysinfo import resolve_device, topology_record

SERVING_MANIFEST_SCHEMA = "dlbb_serving_manifest_v1"
SERVING_RESUME_SCHEMA = "dlbb_serving_resume_v1"
RESUME_CHECKPOINT = "serving_resume.json"

# The CLI's default model when no --config YAML is given (JAX's): small
# enough that a 100-request trace serves in seconds on CPU ranks, GQA so the
# grouped cache path is the one exercised, exact attention as serving needs.
DEFAULT_SERVE_MODEL = dict(
    hidden_size=128, num_layers=4, num_heads=8, num_kv_heads=4,
    ffn_intermediate=256, dtype="float32", attention="full",
)


def _hbm_record(model_cfg: ModelConfig, serving_cfg: ServingConfig, plan) -> dict:
    """The memory envelope a run was admitted under: the per-device cache
    footprint ``validate_serving`` priced, next to the configured budget
    (JAX's record, in the result and the manifest)."""
    cache_dev = kv_cache_bytes_per_device(
        model_cfg, serving_cfg.max_batch, serving_cfg.max_seq,
        dp=plan.dp, tp=plan.tp,
        kv_quantization=serving_cfg.kv_quantization,
        block_size=serving_cfg.block_size)
    budget = (None if serving_cfg.hbm_budget_gb is None
              else int(serving_cfg.hbm_budget_gb * 2**30))
    return {
        "kv_cache_bytes_per_device": cache_dev,
        "budget_bytes": budget,
        "headroom_bytes": (None if budget is None else budget - cache_dev),
    }


def default_parallelism(n_devices: int, kv_heads: int,
                        max_batch: int) -> tuple[int, int]:
    """Auto (dp, tp) for ``n_devices``: the largest tp in {4, 2, 1} that
    divides the device count AND the kv-head count, then the largest dp
    that divides ``max_batch`` within the remaining devices."""
    for tp in (4, 2, 1):
        if n_devices % tp or kv_heads % tp:
            continue
        for dp in range(n_devices // tp, 0, -1):
            if max_batch % dp == 0:
                return dp, tp
    return 1, 1


def resolve_trace(
    trace: str,
    num_requests: int = 100,
    seed: int = 42,
    rate: Optional[float] = None,
    serving: Optional[ServingConfig] = None,
    deadline_s: Optional[float] = None,
    **params: Any,
) -> TrafficTrace:
    """``--trace`` semantics: a known kind generates a seeded trace
    (lengths bounded to fit the serving envelope); anything else is a
    path to a saved trace JSON."""
    if trace not in TRACE_KINDS:
        return TrafficTrace.load(trace)
    kw: dict[str, Any] = dict(params)
    if rate is not None:
        kw["rate"] = rate
    if deadline_s is not None:
        kw["deadline_s"] = deadline_s
    if serving is not None and "prompt_range" not in kw:
        # every request fits the envelope by construction: the prompt
        # within the largest bucket, max_prompt + max_out <= max_seq
        max_prompt = min(serving.prefill_buckets[-1], max(1, serving.max_seq // 2))
        max_out = serving.max_seq - max_prompt
        if max_out < 1:
            raise ValueError(
                f"serving.max_seq={serving.max_seq} leaves no room for "
                "output tokens; raise max_seq or pass explicit "
                "prompt_range/output_range"
            )
        kw["prompt_range"] = (min(8, max_prompt), max_prompt)
        kw["output_range"] = (min(4, max_out), min(48, max_out))
    return generate_trace(trace, num_requests, seed=seed, **kw)


def _lead() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _stamp(report: dict[str, Any], config: dict[str, Any], model_cfg: ModelConfig,
           serving_cfg: ServingConfig, plan, device: torch.device) -> None:
    from dlbb_tpu_torch.utils.sysinfo import collect_system_info

    report["experiment"] = config.get("experiment", {})
    report["backend"] = f"torch_{device.type}"
    report["mesh"] = plan.mesh_dict()
    report["system_info"] = collect_system_info(device)
    report["timestamp"] = time.time()
    report["hbm"] = _hbm_record(model_cfg, serving_cfg, plan)


def _write_result(out: Path, name: str, report: dict[str, Any], engine: ServingEngine,
                  trace_file: str, topology: dict[str, Any], journal_name: Optional[str],
                  fault_domains: bool) -> Path:
    """The result, ``metrics.prom`` and the manifest (JAX's keys)."""
    from dlbb_tpu_torch.obs.export import serving_metrics
    from dlbb_tpu_torch.utils.config import save_json

    result_path = save_json(report, out / f"serving_{name}.json")
    registry = serving_metrics(report, registry=engine.registry)
    prom_path = registry.write_textfile(out / "metrics.prom")
    manifest = {
        "schema": SERVING_MANIFEST_SCHEMA,
        "name": name,
        "result": result_path.name,
        "trace_file": trace_file,
        "metrics": prom_path.name,
        "requests": report["requests"],
        "goodput_tokens_per_s": report["goodput_tokens_per_s"],
        "wall_seconds": report["wall_seconds"],
        "compile_time_s": report["compile_time_s"],
        "decode_steps": report["decode_steps"],
        "mesh": report["mesh"],
        "hbm": report.get("hbm"),
        "topology": topology,
    }
    if fault_domains:
        # None marks a single-replica run (a fleet's manifest maps replica
        # ids to devices)
        manifest["fault_domains"] = topology.get("fault_domains")
    manifest["journal"] = journal_name
    save_json(manifest, out / "serving_manifest.json")
    return result_path


def run_serving(
    config: dict[str, Any],
    trace: TrafficTrace,
    output_dir: Optional[str] = None,
    journal: bool = True,
    verbose: bool = True,
    fault_plan: Optional[str] = None,
    collect_raw: bool = False,
    device_trace: Optional[str] = None,
    capture_tokens: bool = False,
    device=None,
) -> dict[str, Any]:
    """Run one trace-driven serving benchmark on this rank.

    ``config`` follows the experiment-YAML schema with a ``serving:``
    section next to ``model:`` and ``parallelism:`` (``world_size`` = tp,
    ``data_parallel`` = dp); every rank of the world calls this with the
    same arguments.  Returns the report dict; rank 0 writes the artifact
    set of the module docstring when ``output_dir`` is set.

    ``fault_plan`` activates the chaos harness for the run (an explicit
    plan wins; else an already-active plan is left alone; else
    ``DLBB_FAULT_PLAN``).  A SIGTERM mid-trace (or the ``serve-preempt``
    site) drains gracefully and writes the ``serving_resume.json``
    checkpoint instead of the result: see :func:`resume_serving`.
    ``device`` is ``cuda`` unless the caller names ``cpu``."""
    from dlbb_tpu_torch.obs import capture as obs_capture
    from dlbb_tpu_torch.obs import spans
    from dlbb_tpu_torch.resilience import inject
    from dlbb_tpu_torch.resilience.journal import SweepJournal
    from dlbb_tpu_torch.resilience.preempt import PreemptionGuard
    from dlbb_tpu_torch.utils.config import save_json

    dev = resolve_device(device)
    model_cfg = ModelConfig.from_dict(config.get("model", DEFAULT_SERVE_MODEL))
    serving_cfg = ServingConfig.from_dict(config.get("serving", {}))
    plan = _serving_plan(config, model_cfg)

    fault_spec = fault_plan
    if fault_spec is None and inject.active() is None:
        fault_spec = os.environ.get(inject.ENV_VAR, "").strip() or None

    name = config.get("experiment", {}).get("name") or (
        f"{trace.kind}_{len(trace)}req_seed{trace.seed}")
    out = Path(output_dir) if output_dir is not None and _lead() else None
    jrn = None
    if out is not None and journal:
        jrn = SweepJournal(
            out,
            meta={"mode": "serve", "name": name, "trace_kind": trace.kind,
                  "num_requests": len(trace), "fault_plan": fault_spec},
            sink=spans.journal_sink,
        )
    topology = topology_record(dev)
    try:
        with inject.plan_scope(fault_spec), PreemptionGuard() as guard:
            engine = ServingEngine(
                model_cfg, serving_cfg, plan.mesh, journal=jrn,
                seed=config.get("input", {}).get("seed", 0),
                verbose=verbose and _lead(), capture_tokens=capture_tokens, device=dev)
            if jrn is not None:
                jrn.event("topology", **topology)
            engine.registry.inc("serve_degraded", 0,
                                help="runs on a degraded (fallback) backend")
            report = engine.run_trace(trace, guard=guard, collect_raw=collect_raw)
    finally:
        if jrn is not None:
            jrn.close()
    _stamp(report, config, model_cfg, serving_cfg, plan, dev)

    # the gated device capture runs after the trace is served, never inside
    # a timed region, on fresh state, on every rank of the mesh
    capture_dir = device_trace or obs_capture.default_capture_dir()
    if capture_dir and not report.get("preempted"):
        with spans.span("device-capture", cat="capture", label="serve"):
            metas = engine.capture_device_traces(capture_dir)
        for m in metas:
            if "error" in m:
                engine.registry.inc(
                    "obs_device_capture_failures", reason=m.get("error_kind", "unknown"),
                    help="contained device-capture failures (error recorded in the "
                         "capture metadata)")
        report["observability"] = {"device_trace_dir": str(capture_dir),
                                   "device_captures": metas}
        if verbose and _lead():
            ok = sum(1 for m in metas if "error" not in m)
            print(f"[serve] device capture: {ok}/{len(metas)} phase capture(s) under "
                  f"{capture_dir}")

    if out is not None:
        trace_path = trace.save(out / f"trace_{name}.json")
        if report["preempted"]:
            # the drain's checkpoint, never the result: an incomplete
            # session must not pass for a run
            save_json({
                "schema": SERVING_RESUME_SCHEMA,
                "name": name,
                "trace_file": trace_path.name,
                "config": config,
                "remaining_rids": report["remaining_rids"],
                "partial": report,
            }, out / RESUME_CHECKPOINT)
            if verbose:
                print(f"[serve] preempted — checkpoint written to "
                      f"{out / RESUME_CHECKPOINT}; finish with "
                      f"`cli serve --resume --output {out}`")
        else:
            result_path = _write_result(out, name, report, engine, trace_path.name,
                                        topology, None if jrn is None else jrn.path.name,
                                        fault_domains=True)
            if verbose:
                print(f"[serve] report written to {result_path}")
    _written()
    return report


def _written() -> None:
    """Every rank waits until rank 0's artifacts are written."""
    if dist.is_initialized():
        dist.barrier()


def _serving_plan(config: dict[str, Any], model_cfg: ModelConfig):
    from dlbb_tpu_torch.parallel.plan import ParallelismPlan

    plan = ParallelismPlan.from_config(config, model_cfg)
    if plan.sp > 1 or plan.pp > 1 or plan.ep > 1:
        raise ValueError(
            f"serving supports (dp, tp) meshes only (got sp={plan.sp}, "
            f"pp={plan.pp}, ep={plan.ep}); the decode step's length-1 "
            "sequence cannot shard over sp/pp, and MoE is outside the "
            "serving envelope"
        )
    return plan


def merge_reports(partial: dict[str, Any], resumed: dict[str, Any]) -> dict[str, Any]:
    """Merge a preempted session's partial report with its resumed session
    into one report equivalent (names + schema + per-request outcomes for
    non-preempted requests) to an uninterrupted run (JAX's merge).

    Counters sum across sessions (``requests.sessions`` counts them);
    latency summaries are summarised again over both sessions' raw
    samples; the resumed session's outcome for a rid overrides the partial
    one."""
    from dlbb_tpu_torch.utils.metrics import summarize

    merged = dict(resumed)
    merged["trace"] = partial["trace"]  # the FULL trace identity
    req_a = partial["requests"]
    req_b = resumed["requests"]
    req: dict[str, Any] = {
        k: req_a.get(k, 0) + req_b.get(k, 0)
        for k in ("arrived", "admitted", "rejected", "completed",
                  "failed", "preempted", "canceled", "deadline_shed",
                  "completed_past_deadline")
    }
    req["rejected_detail"] = (list(req_a.get("rejected_detail", []))
                              + list(req_b.get("rejected_detail", [])))
    req["rejected_rids"] = [d["rid"] for d in req["rejected_detail"]]
    outcomes = dict(req_a.get("outcomes", {}))
    outcomes.update(req_b.get("outcomes", {}))
    req["outcomes"] = {k: outcomes[k] for k in sorted(outcomes, key=int)}
    arrived = req["arrived"]
    queue_full = sum(1 for d in req["rejected_detail"]
                     if d.get("reason") == "queue-full")
    req["shed_rate"] = (queue_full / arrived) if arrived else 0.0
    req["sessions"] = req_a.get("sessions", 1) + req_b.get("sessions", 1)
    merged["requests"] = req

    raw: dict[str, list] = {}
    for key in ("ttft_s", "per_token_s", "prefill_s", "decode_step_s", "e2e_latency_s"):
        raw[key] = (list(partial.get("raw_samples", {}).get(key, []))
                    + list(resumed.get("raw_samples", {}).get(key, [])))
    merged["ttft"] = summarize(raw["ttft_s"])
    merged["per_token_latency"] = summarize(raw["per_token_s"])
    merged["e2e_latency"] = summarize(raw["e2e_latency_s"])
    merged["prefill_time"] = summarize(raw["prefill_s"])
    merged["decode_step_time"] = summarize(raw["decode_step_s"])

    for key in ("completed_output_tokens", "generated_tokens", "decode_steps",
                "decode_units", "wall_seconds", "compile_time_s"):
        merged[key] = partial.get(key, 0) + resumed.get(key, 0)
    wall = merged["wall_seconds"]
    merged["goodput_tokens_per_s"] = (
        merged["completed_output_tokens"] / wall if wall > 0 else 0.0)
    merged["throughput_tokens_per_s"] = (
        merged["generated_tokens"] / wall if wall > 0 else 0.0)

    fast = dict(resumed.get("fast_path", {}))
    for key in ("fused_scans", "fused_steps", "single_steps", "prefill_chunks",
                "compacted_scans"):
        fast[key] = (partial.get("fast_path", {}).get(key, 0)
                     + resumed.get("fast_path", {}).get(key, 0))
    merged["fast_path"] = fast

    res_a = partial.get("resilience", {})
    res_b = resumed.get("resilience", {})
    merged["resilience"] = {
        "retries": res_a.get("retries", 0) + res_b.get("retries", 0),
        "hung_dispatches": res_a.get("hung_dispatches", 0) + res_b.get("hung_dispatches", 0),
        "failed_requests": res_a.get("failed_requests", 0) + res_b.get("failed_requests", 0),
        "failed": list(res_a.get("failed", [])) + list(res_b.get("failed", [])),
    }

    cache = dict(resumed.get("cache", {}))
    for key in ("peak_blocks_reserved", "peak_blocks_in_use", "peak_shared_blocks"):
        cache[key] = max(partial.get("cache", {}).get(key, 0),
                         resumed.get("cache", {}).get(key, 0))
    cache["cow_blocks"] = (partial.get("cache", {}).get("cow_blocks", 0)
                           + resumed.get("cache", {}).get("cow_blocks", 0))
    merged["cache"] = cache

    if "prefix" in partial or "prefix" in resumed:
        pre_a = partial.get("prefix", {})
        pre_b = resumed.get("prefix", {})
        prefix = dict(pre_b) or dict(pre_a)
        for key in ("hits", "tokens_reused", "cow_blocks"):
            prefix[key] = pre_a.get(key, 0) + pre_b.get(key, 0)
        prefills = len(raw["prefill_s"])
        prefix["hit_rate"] = (prefix.get("hits", 0) / prefills if prefills else 0.0)
        merged["prefix"] = prefix

    # the resumed session started its own clock: its samples are offset by
    # the partial session's wall
    offset = partial.get("wall_seconds", 0.0)
    series_a = partial.get("timeseries", {})
    series_b = resumed.get("timeseries", {})
    series = {}
    for key in series_a:
        vals_b = series_b.get(key, [])
        if key == "t_s":
            vals_b = [round(t + offset, 6) for t in vals_b]
        series[key] = list(series_a.get(key, [])) + list(vals_b)
    merged["timeseries"] = series

    # a resumed session preempted again keeps its raw samples for the next
    # resume; a completed merge drops them
    if resumed.get("preempted"):
        merged["raw_samples"] = raw
    else:
        merged.pop("raw_samples", None)
    if "completed_tokens" in partial or "completed_tokens" in resumed:
        toks = dict(partial.get("completed_tokens", {}))
        toks.update(resumed.get("completed_tokens", {}))
        merged["completed_tokens"] = toks
    return merged


def resume_serving(output_dir: str, verbose: bool = True, device=None) -> dict[str, Any]:
    """Finish a preempted serving run (``cli serve --resume``) on this rank.

    Loads ``serving_resume.json`` and the saved full trace, replays the
    remaining requests (arrivals rebased to the resume instant, their gaps
    kept), and on rank 0 merges both sessions and writes the final artifact
    set: the names and schema of an uninterrupted run, and its outcome for
    every request that was not preempted.  The checkpoint is deleted on
    success; a session preempted again rewrites it with the merged partial.
    Every rank of the checkpoint's world calls this."""
    from dlbb_tpu_torch.obs import spans
    from dlbb_tpu_torch.resilience.journal import SweepJournal
    from dlbb_tpu_torch.resilience.preempt import PreemptionGuard

    out = Path(output_dir)
    ckpt, sub = _load_checkpoint(out)
    if verbose and _lead():
        print(f"[serve] resuming {ckpt['name']}: {len(sub)} remaining request(s)")
    dev = resolve_device(device)
    config = ckpt["config"]
    name = ckpt["name"]
    model_cfg = ModelConfig.from_dict(config.get("model", DEFAULT_SERVE_MODEL))
    serving_cfg = ServingConfig.from_dict(config.get("serving", {}))
    plan = _serving_plan(config, model_cfg)
    # the journal is append-only across sessions: the resume appends a new
    # session marker and its own lifecycle after the preempted one's
    jrn = (SweepJournal(out, meta={"mode": "serve", "name": name, "resume": True,
                                   "remaining": len(sub)},
                        sink=spans.journal_sink)
           if _lead() else None)
    try:
        with PreemptionGuard() as guard:
            engine = ServingEngine(model_cfg, serving_cfg, plan.mesh, journal=jrn,
                                   seed=config.get("input", {}).get("seed", 0),
                                   verbose=verbose and _lead(), device=dev)
            resumed = engine.run_trace(sub, guard=guard, collect_raw=True)
    finally:
        if jrn is not None:
            jrn.close()
    _stamp(resumed, config, model_cfg, serving_cfg, plan, dev)
    merged = merge_reports(ckpt["partial"], resumed)
    if _lead():
        _write_merged(out, ckpt, merged, engine, jrn, dev, verbose)
    _written()
    return merged


def _write_merged(out: Path, ckpt: dict[str, Any], merged: dict[str, Any],
                  engine: ServingEngine, jrn, dev: torch.device, verbose: bool) -> None:
    """Rank 0's end of a resume: the refreshed checkpoint when preempted
    again, else the final artifact set, and the checkpoint deleted."""
    from dlbb_tpu_torch.utils.config import save_json

    ckpt_path = out / RESUME_CHECKPOINT
    name = ckpt["name"]
    if merged.get("preempted"):
        save_json({
            "schema": SERVING_RESUME_SCHEMA,
            "name": name,
            "trace_file": ckpt["trace_file"],
            "config": ckpt["config"],
            "remaining_rids": merged["remaining_rids"],
            "partial": merged,
        }, ckpt_path)
        if verbose:
            print("[serve] preempted again mid-resume — checkpoint refreshed")
        return
    result_path = _write_result(out, name, merged, engine, ckpt["trace_file"],
                                topology_record(dev), jrn.path.name, fault_domains=False)
    ckpt_path.unlink()
    if verbose:
        print(f"[serve] resumed run merged into {result_path}")


def _load_checkpoint(out: Path) -> tuple[dict[str, Any], TrafficTrace]:
    """The resume checkpoint under ``out`` and the sub-trace it names,
    arrivals rebased to 0 with their gaps kept."""
    ckpt_path = out / RESUME_CHECKPOINT
    if not ckpt_path.exists():
        raise FileNotFoundError(
            f"nothing to resume: no {RESUME_CHECKPOINT} under {out} "
            "(either the run completed, or it was never preempted)"
        )
    ckpt = json.loads(ckpt_path.read_text())
    if ckpt.get("schema") != SERVING_RESUME_SCHEMA:
        raise ValueError(
            f"{ckpt_path} is not a serving resume checkpoint "
            f"(schema={ckpt.get('schema')!r})"
        )
    full = TrafficTrace.load(out / ckpt["trace_file"])
    remaining = set(ckpt["remaining_rids"])
    reqs = [r for r in full if r.rid in remaining]
    if not reqs:
        raise ValueError(
            f"checkpoint names no servable remaining requests "
            f"({len(remaining)} rids, none found in {ckpt['trace_file']})"
        )
    t0 = min(r.arrival_s for r in reqs)
    sub = TrafficTrace(
        kind=full.kind, seed=full.seed,
        params={**full.params, "resumed_from": ckpt["name"]},
        requests=tuple(replace(r, arrival_s=r.arrival_s - t0)
                       for r in sorted(reqs, key=lambda r: (r.arrival_s, r.rid))),
    )
    return ckpt, sub


def serve_worker(config, trace, output_dir, verbose, fault_plan, device, span_trace=None,
                 device_trace=None, xplane_trace=None):
    """One rank of ``run_serve_from_config`` (launched by name); rank 0
    records the host span trace to ``span_trace`` when set, and each rank
    its share of the ``torch.profiler`` trace ``xplane_trace``."""
    from dlbb_tpu_torch.obs import spans
    from dlbb_tpu_torch.utils.profiling import maybe_trace, rank_trace_dir

    with spans.tracing(span_trace if _lead() else None, meta={"cmd": "serve"}), \
            maybe_trace(rank_trace_dir(xplane_trace), device):
        return run_serving(config, trace, output_dir=output_dir, verbose=verbose,
                           fault_plan=fault_plan, device=device, device_trace=device_trace)


def resume_worker(output_dir, verbose, device):
    """One rank of a resume (launched by name)."""
    return resume_serving(output_dir, verbose=verbose, device=device)


def _world(config: dict[str, Any]) -> int:
    par = config.get("parallelism", {}) or {}
    return math.prod((par.get("data_parallel", 1), par.get("sequence_parallel", 1),
                      par.get("pipeline_parallel", 1), par.get("expert_parallel", 1),
                      par.get("world_size", 1)))


def _launched(worker, world: int, device, args: tuple) -> dict[str, Any]:
    """``worker(*args)`` in this process at world 1 (or under torchrun),
    else on ``world`` launched ranks; rank 0's result."""
    from dlbb_tpu_torch.bench.launch import launch

    if world == 1 and "WORLD_SIZE" not in os.environ:
        return worker(*args)
    return launch(worker, world, device, args=args)[0]


def run_serve_from_config(
    config_path: Optional[str],
    trace: str = "poisson",
    num_requests: int = 100,
    seed: int = 42,
    rate: Optional[float] = None,
    output_dir: Optional[str] = None,
    overrides: Optional[dict[str, Any]] = None,
    verbose: bool = True,
    resume: bool = False,
    fault_plan: Optional[str] = None,
    slo: Optional[float] = None,
    device_trace: Optional[str] = None,
    prefix_groups: Optional[int] = None,
    prefix_len: Optional[int] = None,
    replicas: Optional[int] = None,
    world: Optional[int] = None,
    device=None,
    span_trace: Optional[str] = None,
    xplane_trace: Optional[str] = None,
) -> dict[str, Any]:
    """CLI entry: an optional experiment YAML and flag overrides (the fast
    path, speculation, prefix and resilience knobs, ``docs/serving.md``).
    ``resume`` finishes a preempted run from its ``serving_resume.json``
    on the checkpoint's world; ``slo`` stamps generated requests with a
    per-request deadline; ``fault_plan`` activates the chaos harness;
    ``prefix_groups``/``prefix_len`` generate a shared-prefix trace.

    Without a ``parallelism:`` section, ``world`` ranks (default 1) are
    auto-planned into ``(dp, tp)`` as JAX plans its devices; with one, the
    world is its mesh (``world``, when given, must match).  The ranks run
    through ``bench/launch.py`` (NCCL, one GPU per rank, on ``cuda``; gloo
    on ``cpu``).  The default output is ``results/torch/serving``.
    ``span_trace`` names rank 0's host span trace (Chrome trace-event JSON).

    ``replicas`` above 1 (or a ``fleet:`` section) serves the trace through
    the replica fleet instead (``serve/fleet.py::run_fleet``): the
    ``parallelism:`` section, or the auto-plan over ``world / replicas``
    ranks, is then ONE replica's mesh, and the world is replicas x that
    mesh (``world``, when given, must match).  ``device_trace`` captures
    the served run's prefill and decode (:func:`run_serving`; a fleet takes
    none, as in JAX), and ``xplane_trace`` (else ``DLBB_TRACE_DIR``) writes
    each rank's ``torch.profiler`` trace of a single-mesh run under it
    (``cli serve --xplane-trace``); a fleet or a resume is refused one
    (``DLBB_TRACE_DIR`` traces neither)."""
    from dlbb_tpu_torch.utils.config import load_config

    resolve_device(device)
    refused = ValueError("--xplane-trace traces one mesh's ranks: a fleet or a resume "
                         "takes none")
    if resume:
        if xplane_trace:
            raise refused
        out = output_dir or "results/torch/serving"
        ckpt, _sub = _load_checkpoint(Path(out))
        return _launched(resume_worker, _world(ckpt["config"]), device,
                         (out, verbose, device))
    config = load_config(config_path) if config_path is not None else {
        "model": dict(DEFAULT_SERVE_MODEL)}
    config.setdefault("serving", {})
    for key, value in sorted((overrides or {}).items()):
        if value is not None:
            config["serving"][key] = value
    serving_cfg = ServingConfig.from_dict(config["serving"])
    if replicas is not None and replicas > 1:
        config.setdefault("fleet", {})["replicas"] = replicas
    fleet = bool(config.get("fleet"))
    if fleet and xplane_trace:
        raise refused
    n_replicas = max(1, int(config["fleet"].get("replicas", 2))) if fleet else 1
    if "parallelism" not in config:
        model_cfg = ModelConfig.from_dict(config.get("model", DEFAULT_SERVE_MODEL))
        # a fleet's parallelism is PER REPLICA: planned within one failure
        # domain's share of the ranks
        per_replica = max(1, (world or n_replicas) // n_replicas)
        dp, tp = default_parallelism(per_replica, model_cfg.kv_heads, serving_cfg.max_batch)
        config["parallelism"] = {"data_parallel": dp, "world_size": tp}
    n = _world(config) * n_replicas
    if world is not None and world != n:
        raise ValueError(f"--world {world}: the config's mesh has {n} ranks"
                         + (f" ({n_replicas} replicas)" if fleet else ""))
    trace_kw: dict[str, Any] = {}
    if prefix_groups is not None:
        trace_kw["prefix_groups"] = prefix_groups
    if prefix_len is not None:
        trace_kw["prefix_len"] = prefix_len
    resolved = resolve_trace(trace, num_requests=num_requests, seed=seed, rate=rate,
                             serving=serving_cfg, deadline_s=slo, **trace_kw)
    out = output_dir or config.get("experiment", {}).get("output_dir", "results/torch/serving")
    if fleet:
        from dlbb_tpu_torch.serve.fleet import run_fleet

        return run_fleet(config, resolved, output_dir=out, verbose=verbose,
                         fault_plan=fault_plan, device=device)
    return _launched(serve_worker, n, device,
                     (config, resolved, out, verbose, fault_plan, device, span_trace,
                      device_trace, xplane_trace))
