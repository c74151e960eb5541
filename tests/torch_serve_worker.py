"""Rank bodies of ``tests/test_torch_serve.py``,
``tests/test_torch_serve_fastpath.py``, ``tests/test_torch_spec.py``,
``tests/test_torch_serve_resilience.py`` and ``tests/test_torch_fleet.py``:
the port's serving programs, engine, harness and fleet on a gloo group of
host processes.  It imports torch and the port
only, since ``bench.launch`` imports it by name in every spawned rank."""

import tempfile

import torch

from dlbb_tpu_torch.comm import build_parallelism_mesh
from dlbb_tpu_torch.models import ModelConfig, forward, params_from_jax
from dlbb_tpu_torch.models.sharding import shard_params
from dlbb_tpu_torch.models.transformer import DTYPES
from dlbb_tpu_torch.serve.engine import (
    ServingConfig,
    ServingEngine,
    _inject_token,
    build_decode_step,
    build_prefill,
)
from dlbb_tpu_torch.resilience.journal import SweepJournal, read_journal
from dlbb_tpu_torch.serve.kvcache import create_kv_cache, shard_cache
from dlbb_tpu_torch.serve.traffic import TrafficTrace


def _rank_params(weights, cfg, mesh):
    return shard_params(params_from_jax(weights, cfg), cfg, mesh.coords["tp"],
                        mesh.shape["tp"])


def _f32(t):
    return t.detach().float().numpy().copy()


def equivalence_case(fields, weights, x_full, prompt, slot, mesh):
    """``tests/test_serve.py``'s equivalence case on this rank: prefill
    ``prompt`` tokens into ``slot``, then decode the rest feeding the true
    next inputs.  Returns the slot owner's outputs (``y_last`` and each
    decode step's row, ``[seq - prompt + 1, H]`` float32; None on the
    other dp ranks), the port's own forward on the same mesh, and the
    final lengths and planes' emptiness."""
    cfg = ModelConfig(**fields)
    dtype = DTYPES[cfg.dtype]
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    params = _rank_params(weights, cfg, mesh)
    x = torch.from_numpy(x_full).to(dtype)
    seq = x.shape[1]
    y_full = forward(params, x, cfg, mesh=mesh)

    sv = ServingConfig(max_batch=4, block_size=8, max_seq=32, hbm_budget_gb=None)
    sv.validate(cfg, dp=dp, tp=tp)
    cache = shard_cache(create_kv_cache(cfg, sv.max_batch, sv.num_blocks, sv.block_size,
                                        device="cpu"),
                        mesh.coords["dp"], dp, mesh.coords["tp"], tp)
    prefill = build_prefill(cfg, mesh)
    decode = build_decode_step(cfg, mesh)
    bucket = sv.bucket_for(prompt)
    xp = torch.zeros((1, bucket, cfg.hidden_size), dtype=dtype)
    xp[:, :prompt] = x[:, :prompt]
    cache, y_last = prefill(cache, params, xp, slot, prompt)
    owner = y_last is not None
    rows = [y_last] if owner else []
    first = mesh.coords["dp"] * (sv.max_batch // dp)
    carry = (cache, torch.zeros((sv.max_batch // dp, 1, cfg.hidden_size), dtype=dtype))
    active = torch.zeros(sv.max_batch, dtype=torch.bool)
    active[slot] = True
    for i in range(prompt, seq):
        carry = _inject_token(carry, slot, x[0, i], mesh)
        carry, y = decode(carry, params, active)
        if owner:
            rows.append(y[slot - first, 0])
    cache = carry[0]
    others = [s for s in range(cache.max_batch) if s != slot - first or not owner]
    return {
        "owner": owner,
        "outputs": _f32(torch.stack(rows)) if owner else None,
        "forward": _f32(y_full[0, prompt - 1:]),
        "lengths": cache.lengths.numpy().copy(),
        "others_zero": all(bool((p[:, s] == 0).all()) for p in (cache.k, cache.v)
                           for s in others),
    }


def _engine_run(fields, serving, weights, trace_dict, mesh, mode, capture=True):
    cfg = ModelConfig(**fields)
    sv = ServingConfig.from_dict({**serving, "speculation": mode})
    engine = ServingEngine(cfg, sv, mesh=mesh, params=_rank_params(weights, cfg, mesh),
                           verbose=False, capture_tokens=capture, device="cpu")
    report = engine.run_trace(TrafficTrace.from_dict(trace_dict))
    return {k: report[k] for k in ("requests", "completed_tokens", "cache",
                                   "decode_steps", "generated_tokens",
                                   "completed_output_tokens")}


def run_world8(cases, engine_case):
    """On 8 ranks, a dp=2 x tp=4 mesh: each equivalence case, then one
    greedy engine run."""
    torch.set_num_threads(1)
    mesh = build_parallelism_mesh(data_parallel=2, tensor_parallel=4)
    out = {name: equivalence_case(*case, mesh) for name, case in cases.items()}
    out["engine"] = _engine_run(*engine_case, mesh, "greedy")
    return out


def run_world2(gqa_case, engine_case, modes):
    """On 2 ranks: the equivalence case at tp=2 with GQA, then the engine
    at dp=2 on a trace whose admission depends on time, once per mode."""
    torch.set_num_threads(1)
    tp2 = build_parallelism_mesh(tensor_parallel=2)
    dp2 = build_parallelism_mesh(data_parallel=2)
    out = {"gqa_tp2": equivalence_case(*gqa_case, tp2)}
    for mode in modes:
        out[f"dp2/{mode}"] = _engine_run(*engine_case, dp2, mode)
    return out



SPEC_COUNTERS = (("serve_decode_steps", {}), ("serve_fused_scan_steps", {}),
                 ("serve_spec_proposed_total", {"drafter": "ngram"}),
                 ("serve_spec_proposed_total", {"drafter": "draft-model"}),
                 ("serve_spec_accepted_total", {"drafter": "ngram"}),
                 ("serve_spec_accepted_total", {"drafter": "draft-model"}),
                 ("serve_sampled_tokens", {}))


def spec_counters(registry):
    """The registry's decode and speculation counters, by name and label
    (JAX's registry and the port's alike)."""
    return {f"{name}{sorted(labels.items())}": registry.get(name, **labels)
            for name, labels in SPEC_COUNTERS}


def _journaled_run(fields, serving, weights, trace_dict, mesh, draft_weights=None):
    """One engine run on this rank with its own journal: the report's
    comparable sections, the decode and speculation counters, and the
    journal's (event, rid) sequence.  ``draft_weights`` are the draft
    model's under ``speculation="draft-model"``."""
    cfg = ModelConfig(**fields)
    sv = ServingConfig.from_dict(serving)
    draft = (None if draft_weights is None
             else _rank_params(draft_weights, sv.draft_model_config(cfg), mesh))
    engine = ServingEngine(cfg, sv, mesh=mesh, params=_rank_params(weights, cfg, mesh),
                           verbose=False, capture_tokens=True, device="cpu",
                           draft_params=draft)
    with tempfile.TemporaryDirectory() as tmp:
        engine.journal = SweepJournal(tmp)
        report = engine.run_trace(TrafficTrace.from_dict(trace_dict))
        engine.journal.close()
        events, _ = read_journal(tmp)
    out = {k: report[k] for k in ("requests", "completed_tokens", "cache", "decode_steps",
                                  "decode_units", "generated_tokens", "fast_path", "prefix",
                                  "speculation")}
    out["journal"] = [(e["event"], e["config"]) for e in events
                      if e["event"].startswith(("request-", "prefix-", "spec-"))]
    out["counters"] = spec_counters(engine.registry)
    return out


def run_engines(runs):
    """Each named run ``(dp, tp, fields, serving, weights, trace[,
    draft_weights])`` on its own (dp, tp) mesh of this world."""
    torch.set_num_threads(1)
    out = {}
    for name, (dp, tp, *case) in runs.items():
        mesh = build_parallelism_mesh(data_parallel=dp, tensor_parallel=tp)
        out[name] = _journaled_run(*case[:4], mesh, *case[4:])
    return out


class SteppedClock:
    """An engine clock (``engine._now``) that reads 0.0 once, then 1.0:
    the first admission wave meets a deadline of 1e-9 s, everything later
    misses it, whatever the host's speed.  JAX's engine and the port's read
    their first time at the same place, the top of the scheduler loop."""

    def __init__(self):
        self.reads = 0

    def __call__(self):
        self.reads += 1
        return 0.0 if self.reads == 1 else 1.0


RESILIENCE_COUNTERS = (
    ("serve_request_retries", {"phase": "prefill"}),
    ("serve_request_retries", {"phase": "decode"}),
    ("serve_request_retries", {"phase": "bookkeeping"}),
    ("serve_hung_dispatches", {}),
    ("serve_deadline_exceeded", {"reason": "shed-queued"}),
    ("serve_deadline_exceeded", {"reason": "completed-late"}),
    ("serve_rejections", {"reason": "deadline"}),
    ("serve_requests", {"outcome": "failed"}),
    ("serve_requests", {"outcome": "preempted"}),
    ("serve_requests", {"outcome": "completed"}),
)


def resilience_counters(registry):
    """The registry's resilience counters, by name and label (JAX's
    registry and the port's alike)."""
    return {f"{name}{sorted(labels.items())}": registry.get(name, **labels)
            for name, labels in RESILIENCE_COUNTERS}


def journal_lines(events):
    """The journal's lifecycle in order: (event, request, phase or reason)."""
    keep = ("request-", "dispatch-retry", "preempted")
    return [(e["event"], e.get("config"), e.get("phase") or e.get("reason"))
            for e in events if e["event"].startswith(keep)]


REPORT_SECTIONS = ("requests", "completed_tokens", "cache", "resilience", "preempted",
                   "remaining_rids", "decode_steps", "generated_tokens")


def faulted_run(engine, trace, plan, clock=False, inject=None):
    """One ``run_trace`` of ``engine`` under the fault ``plan`` with its own
    journal: the report's comparable sections and keys, the resilience
    counters' deltas and the journal's lifecycle.  JAX's engine and the
    port's alike: the caller passes each its own trace type and, for JAX's,
    JAX's ``resilience.inject`` (the port's by default)."""
    if inject is None:
        from dlbb_tpu_torch.resilience import inject

    counters = resilience_counters(engine.registry)
    if clock:
        engine._now = SteppedClock()
    with tempfile.TemporaryDirectory() as tmp:
        engine.journal = SweepJournal(tmp)
        try:
            with inject.plan_scope(plan):
                report = engine.run_trace(trace)
        finally:
            engine.journal.close()
            engine.journal = None
            if clock:
                del engine._now
        events, _ = read_journal(tmp)
    out = {k: report[k] for k in REPORT_SECTIONS}
    out["resilience"] = {k: v for k, v in report["resilience"].items() if k != "failed"}
    out["failed"] = [(f["reason"], f["rids"], f["error"]) for f in report["resilience"]["failed"]]
    out["keys"] = {k: sorted(v) if isinstance(v, dict) else None for k, v in report.items()}
    after = resilience_counters(engine.registry)
    out["counters"] = {k: after[k] - counters[k] for k in after}
    out["journal"] = journal_lines(events)
    return out


def run_faults(runs, serve_case, out_dir):
    """On 8 ranks: each named engine ``(dp, tp, fields, serving, weights,
    scenarios)`` on its own (dp, tp) mesh of this world, run once per
    scenario ``{name: (trace, plan, serving overrides, clock)}``; then
    ``serve_case`` ``(config, trace, plan)`` through ``serve/bench.py``:
    ``run_serving`` under the plan, then ``resume_serving``, rank 0 writing
    to ``out_dir``."""
    import dataclasses

    from dlbb_tpu_torch.serve.bench import resume_serving, run_serving

    torch.set_num_threads(1)
    out = {}
    for name, (dp, tp, fields, serving, weights, scenarios) in runs.items():
        mesh = build_parallelism_mesh(data_parallel=dp, tensor_parallel=tp)
        if mesh is None:
            continue
        cfg = ModelConfig(**fields)
        sv = ServingConfig.from_dict(serving)
        engine = ServingEngine(cfg, sv, mesh=mesh, params=_rank_params(weights, cfg, mesh),
                               verbose=False, capture_tokens=True, device="cpu")
        for scenario, (trace_dict, plan, knobs, clock) in scenarios.items():
            engine.serving = dataclasses.replace(sv, **knobs)
            out[f"{name}/{scenario}"] = faulted_run(
                engine, TrafficTrace.from_dict(trace_dict), plan, clock)
    config, trace_dict, plan = serve_case
    trace = TrafficTrace.from_dict(trace_dict)
    first = run_serving(config, trace, output_dir=out_dir, verbose=False, fault_plan=plan,
                        device="cpu")
    merged = resume_serving(out_dir, verbose=False, device="cpu")
    out["serve"] = {k: first[k] for k in ("preempted", "remaining_rids", "requests",
                                          "resilience")}
    out["resume"] = {k: merged[k] for k in ("preempted", "requests", "resilience")}
    return out


def serve_oracle(config, trace, weights):
    """``tests/test_torch_fleet.py``'s single-engine oracle on this rank: one
    engine on the config's (dp, tp) mesh with JAX's ``weights``, its tokens
    captured."""
    par = config["parallelism"]
    cfg = ModelConfig(**config["model"])
    mesh = build_parallelism_mesh(par["data_parallel"], tensor_parallel=par["world_size"])
    engine = ServingEngine(cfg, ServingConfig.from_dict(config["serving"]), mesh=mesh,
                           params=_rank_params(weights, cfg, mesh), verbose=False,
                           capture_tokens=True, device="cpu")
    return engine.run_trace(trace)


# every collective of torch.distributed that takes a group
COLLECTIVES = ("broadcast", "all_reduce", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "broadcast_object_list", "barrier", "gather",
               "scatter", "all_gather_object", "reduce", "all_to_all_single", "send", "recv")


def fleet_rank_watched(*args):
    """``serve/fleet.py::fleet_rank`` with every collective it reaches
    recorded: the rank's result gains ``collectives`` (how many ran) and
    ``world_collectives`` (the names of those that ran on the world group,
    or on no group, which is the world's)."""
    import torch.distributed as dist

    from dlbb_tpu_torch.serve.fleet import fleet_rank

    seen = []

    def watched(name, fn):
        def call(*a, **k):
            group = k.get("group")
            seen.append((name, group is None or group is dist.group.WORLD))
            return fn(*a, **k)
        return call

    originals = {name: getattr(dist, name) for name in COLLECTIVES}
    for name, fn in originals.items():
        setattr(dist, name, watched(name, fn))
    try:
        out = fleet_rank(*args)
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)
    out["collectives"] = len(seen)
    out["world_collectives"] = [name for name, world in seen if world]
    return out
