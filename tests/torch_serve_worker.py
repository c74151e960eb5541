"""Rank bodies of ``tests/test_torch_serve.py``,
``tests/test_torch_serve_fastpath.py`` and ``tests/test_torch_spec.py``:
the port's serving programs and
engine on a gloo group of host processes.  It imports torch and the port
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
