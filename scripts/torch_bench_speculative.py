#!/usr/bin/env python3
"""Speculative-decoding evidence for the PyTorch port: draft-and-verify vs
the fused scan (the port of ``scripts/bench_speculative.py``).

    python3 scripts/torch_bench_speculative.py [--requests N] [--reps R] [--device cpu]
                                               [--output results/torch/BENCH_spec.json]
                                               [--stats stats/torch/serving]

Replays JAX's repeating-structure seeded trace (motif prompts of period 4,
96-128 output tokens) through the serving engine's settings and writes
``BENCH_spec.json`` (schema ``dlbb_bench_spec_v1``, the JAX script's keys)
under ``results/torch/`` and ``SPECULATIVE.md`` under
``stats/torch/serving/``, never the repository root's ``BENCH_spec.json``
(the JAX package's runs):

- **equivalence gate**: every token-feedback setting (greedy, ngram,
  draft-model) replays the trace with token capture on and must give the
  per-step greedy oracle's completed tokens; a mismatch exits 1 and writes
  nothing.  The "off" rows are the continuous-feedback engine, baselines
  and not identity subjects (JAX's note);
- **throughput grid**: {off, greedy, ngram at gamma 2/4/8 (16 fused),
  draft-model at gamma 4} x {per-step, fused K16}, settings interleaved
  within each repetition; completed output tokens per wall second of each
  replay, medians with min/max, TTFT and per-token p50, acceptance, mean
  accepted length and draft overhead.  Each speedup is regime-matched:
  per-step rows against ``off_per_step``, fused rows against
  ``off_fused16``.  The bar (ngram gamma 16 fused at 1.2x ``off_fused16``,
  ``ACCEPTANCE``) is recorded as met or not, not an abort.

The serving sizes are JAX's (``SERVE``: 8 slots of 160 tokens in blocks of
8), which hold the trace.  On the card (the default) the model is the 1B of
``dlbb_tpu_torch/configs/serve_1b.yaml`` at full width and depth, its draft
the same at one layer, on one rank; a CUDA engine with speculation on warns
that its verify costs more than the steps it saves there (the warning is
left to print).  ``--device cpu`` runs JAX's model (hidden 64, 2 layers, 4
heads) on JAX's dp=2 x tp=4 mesh over 8 gloo ranks.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from _torch_serve_bench import (  # noqa: E402
    SMALL_MODEL,
    bench_model,
    card_mesh,
    device_record,
    median,
    serve_settings,
    spread,
)

SERVE = dict(max_batch=8, block_size=8, max_seq=160, queue_capacity=64)
MESH = (2, 4)
FUSED = dict(decode_horizon=16)
# name -> ServingConfig fields (JAX's table): "off" is the continuous-feedback
# engine, "greedy" token feedback without drafting, whose per-step row is the
# token-identity oracle of every speculative setting
SETTINGS = {
    "off_per_step": dict(speculation="off"),
    "off_fused16": dict(speculation="off", **FUSED),
    "greedy_per_step": dict(speculation="greedy"),
    "greedy_fused16": dict(speculation="greedy", **FUSED),
    "ngram_g2_per_step": dict(speculation="ngram", spec_gamma=2),
    "ngram_g2_fused16": dict(speculation="ngram", spec_gamma=2, **FUSED),
    "ngram_g4_per_step": dict(speculation="ngram", spec_gamma=4),
    "ngram_g4_fused16": dict(speculation="ngram", spec_gamma=4, **FUSED),
    "ngram_g8_per_step": dict(speculation="ngram", spec_gamma=8),
    "ngram_g8_fused16": dict(speculation="ngram", spec_gamma=8, **FUSED),
    "ngram_g16_fused16": dict(speculation="ngram", spec_gamma=16, **FUSED),
    "draft_g4_per_step": dict(speculation="draft-model", spec_gamma=4, spec_draft_layers=1),
    "draft_g4_fused16": dict(speculation="draft-model", spec_gamma=4, spec_draft_layers=1,
                             **FUSED),
}
ORACLE = "greedy_per_step"
BASELINE = "off_fused16"
ACCEPTANCE = {"setting": "ngram_g16_fused16", "baseline": BASELINE, "min_speedup": 1.2}


def _trace(num_requests: int):
    from dlbb_tpu_torch.serve.traffic import generate_trace

    return generate_trace("poisson", num_requests, seed=7, rate=500.0,
                          prompt_range=(8, 16), output_range=(96, 128), prompt_period=4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=16,
                    help="requests in the replayed trace (default 16 = two admission "
                         "waves)")
    ap.add_argument("--reps", type=int, default=3,
                    help="interleaved repetitions per setting (default 3)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--output", default=str(REPO / "results" / "torch" / "BENCH_spec.json"))
    ap.add_argument("--stats", default=str(REPO / "stats" / "torch" / "serving"),
                    help="directory of SPECULATIVE.md")
    args = ap.parse_args(argv)

    from dlbb_tpu_torch.stats.serving_report import write_speculative_report
    from dlbb_tpu_torch.utils.config import atomic_write_text
    from dlbb_tpu_torch.utils.sysinfo import gpu_name_and_power_limit, resolve_device

    dev = resolve_device(args.device)
    gpu = gpu_name_and_power_limit() if dev.type == "cuda" else None
    if gpu:
        print(gpu)
    model, seed = bench_model(dev.type, SMALL_MODEL)
    mesh = card_mesh(*MESH, dev.type)
    trace = _trace(args.requests)
    subjects = [n for n, extra in SETTINGS.items()
                if extra["speculation"] != "off" and n != ORACLE]
    runs = [{"name": f"gate/{name}", "mesh": "m", "trace": "t",
             "serving": dict(SERVE, **SETTINGS[name]), "capture": True}
            for name in [ORACLE] + subjects]
    runs += [{"name": name, "mesh": "m", "trace": "t", "serving": dict(SERVE, **extra),
              "capture": False} for name, extra in SETTINGS.items()]
    res = serve_settings(model, seed, {"m": mesh}, runs, {"t": trace}, args.reps, dev)

    oracle = res["captures"][f"gate/{ORACLE}"]
    identity = {name: res["captures"][f"gate/{name}"] == oracle for name in subjects}
    if not all(identity.values()):
        bad = sorted(n for n, ok in identity.items() if not ok)
        print("equivalence gate FAILED: speculative decode produced different completed-"
              f"token sequences than the per-step greedy oracle for {bad}; refusing to "
              "publish throughput for a wrong result", file=sys.stderr)
        return 1
    n_tok = sum(len(v) for v in oracle.values())
    print(f"[equivalence] {len(identity)} settings == {ORACLE} over {n_tok} tokens: OK")

    settings_out = {}
    for name, extra in SETTINGS.items():
        reps = res["timed"][name]
        spec = [r.get("speculation", {}) for r in reps]

        def med(key, nd):
            vals = [s[key] for s in spec if s.get(key) is not None]
            return round(median(vals), nd) if vals else None

        settings_out[name] = {
            "speculation": extra.get("speculation", "off"),
            "spec_gamma": extra.get("spec_gamma"),
            "decode_horizon": extra.get("decode_horizon", 1),
            "output_tokens_per_s": spread([r["completed_output_tokens"] / r["wall_s"]
                                           for r in reps]),
            "ttft_p50_ms": round(median([r["ttft"]["median"] for r in reps]) * 1e3, 3),
            "per_token_p50_ms": round(median([r["per_token_latency"]["median"]
                                              for r in reps]) * 1e3, 3),
            "decode_units": median([r["decode_units"] for r in reps]),
            "verify_units": median([s.get("verify_units", 0) for s in spec]),
            "fallback_units": median([s.get("fallback_units", 0) for s in spec]),
            "acceptance_rate": med("acceptance_rate", 4),
            "mean_accepted_len": med("mean_accepted_len", 3),
            "draft_overhead_s": med("draft_overhead_s", 4),
            "token_identical": identity.get(name),
        }
    for name, extra in SETTINGS.items():
        base_name = "off_fused16" if extra.get("decode_horizon") else "off_per_step"
        base_med = settings_out[base_name]["output_tokens_per_s"]["median"]
        settings_out[name]["baseline"] = base_name
        settings_out[name]["speedup_vs_baseline"] = round(
            settings_out[name]["output_tokens_per_s"]["median"] / base_med, 3)
    acc = settings_out[ACCEPTANCE["setting"]]["speedup_vs_baseline"]
    acceptance = {**ACCEPTANCE, "measured_speedup": acc,
                  "passed": acc >= ACCEPTANCE["min_speedup"]}

    payload = {
        "harness": "scripts/torch_bench_speculative.py",
        "schema": "dlbb_bench_spec_v1",
        "model": model,
        "seed": seed,
        "serving": dict(SERVE),
        "mesh": {"dp": mesh[0], "tp": mesh[1]},
        "trace": {"kind": trace.kind, "requests": len(trace), "seed": trace.seed,
                  "params": dict(trace.params)},
        "repetitions": args.reps,
        "baseline": BASELINE,
        "oracle": ORACLE,
        "methodology": (
            "identical repeating-structure seeded trace replayed through every engine; "
            "settings interleaved within each repetition; medians of per-rep completed-"
            "output-token throughput with min/max spread; greedy token-identity gate "
            "(every token-feedback setting == the per-step greedy oracle) read before "
            "anything is written"),
        **device_record(dev, gpu, mesh[0] * mesh[1]),
        "equivalence": {
            "checked": True, "oracle": ORACLE, "identical": dict(sorted(identity.items())),
            "tokens": n_tok,
            "note": ("off rows are the continuous-feedback engine: different sequences by "
                     "design, so they are baselines, not identity subjects")},
        "settings": settings_out,
        "acceptance": acceptance,
        "claim": (
            "card run: the verify runs each of its gamma+1 positions in the decode step's "
            "own calls (its rows are the step's bits), each reading the layer's fp32 K/V "
            "copy again, so a verify unit costs about gamma+1 steps until a decode-"
            "attention kernel reads the cache once for all of them"
            if dev.type == "cuda" else
            "CPU ranks over gloo: every verify unit pays a host sync the fused scan "
            "amortises; acceptance and accepted length are regime-independent; not a "
            "device measurement"),
    }
    out = Path(args.output)
    atomic_write_text(json.dumps(payload, indent=1) + "\n", out)
    write_speculative_report(out, Path(args.stats))
    for name, s in settings_out.items():
        tps = s["output_tokens_per_s"]
        acc_s = "-" if s["acceptance_rate"] is None else f"{s['acceptance_rate']:.3f}"
        print(f"[{name:20s}] {tps['median']:8.1f} tok/s ({tps['min']:.1f}..{tps['max']:.1f})  "
              f"x{s['speedup_vs_baseline']:.3f} vs {s['baseline']}, acc={acc_s}, "
              f"{s['verify_units']} verify units, TTFT p50 {s['ttft_p50_ms']} ms")
    print(f"[acceptance] {ACCEPTANCE['setting']} >= {ACCEPTANCE['min_speedup']}x vs "
          f"{BASELINE}: {'PASS' if acceptance['passed'] else 'FAIL'} ({acc:.3f}x)")
    print(f"BENCH_spec.json -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
