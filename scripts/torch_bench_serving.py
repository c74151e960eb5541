#!/usr/bin/env python3
"""Decode fast-path evidence for the PyTorch port: per-step vs fused-K x
compaction (the port of ``scripts/bench_serving.py``).

    python3 scripts/torch_bench_serving.py [--requests N] [--reps R] [--device cpu]
                                           [--output results/torch/BENCH_serve.json]
                                           [--stats stats/torch/serving]

Replays JAX's seeded traces through the serving engine's settings and
writes ``BENCH_serve.json`` (schema ``dlbb_bench_serve_v1``, the JAX
script's keys, so either package's ``write_fastpath_report`` reads it)
under ``results/torch/`` and ``FASTPATH.md`` under ``stats/torch/serving/``,
never the repository root's ``BENCH_serve.json`` (the JAX package's runs):

- **equivalence gate**: per-step and fused-K16 engines replay a smoke trace
  with token capture on and must give identical completed-token sequences;
  a mismatch exits 1 and writes nothing;
- **throughput grid**: the "uniform" trace (one admission wave, 240 output
  tokens each) through the per-step engine and the fused scan at K in {4,
  16, 64}, and the "staggered" trace through the tp4 rows (per-step, fused
  K16, fused K16 with compaction), settings interleaved within each
  repetition; medians of per-rep goodput with min/max.  The bar (fused K16
  at 1.5x per-step, ``ACCEPTANCE``) is recorded as met or not, not an abort.

The serving sizes are JAX's (``SERVE``: 8 slots of 256 tokens in blocks of
16, a queue of 64), which hold the traces.  On the card (the default) the
model is the 1B of ``dlbb_tpu_torch/configs/serve_1b.yaml`` at full width
and depth, and every mesh is one rank: the K grid's dp8 mesh has no
collective in its decode step (a dp-only mesh), so one rank holding all 8
slots is the same dispatch-bound regime; the tp4 rows, whose point is the
tp-only geometry, need 4 ranks and are written as skipped, with the
reason.  ``--device cpu`` runs JAX's model (hidden 128, 2 layers, 8 heads)
on JAX's meshes, dp=8 and tp=4, over 8 gloo ranks.
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

SERVE = dict(max_batch=8, block_size=16, max_seq=256, queue_capacity=64)
BENCH_MODEL = dict(SMALL_MODEL, hidden_size=128, num_heads=8, num_kv_heads=8,
                   ffn_intermediate=256)
MESHES = {"dp8": (8, 1), "tp4": (1, 4)}
# name -> (mesh key, trace key, ServingConfig fast-path fields); K=1 is the
# per-step engine (JAX's table)
SETTINGS = {
    "per_step": ("dp8", "uniform", {}),
    "fused_k4": ("dp8", "uniform", dict(decode_horizon=4, inflight_window=2)),
    "fused_k16": ("dp8", "uniform", dict(decode_horizon=16, inflight_window=2)),
    "fused_k64": ("dp8", "uniform", dict(decode_horizon=64, inflight_window=2)),
    "tp4_per_step": ("tp4", "staggered", {}),
    "tp4_fused_k16": ("tp4", "staggered", dict(decode_horizon=16, inflight_window=2)),
    "tp4_fused_k16_compact": ("tp4", "staggered",
                              dict(decode_horizon=16, inflight_window=2,
                                   compact_threshold=0.5)),
}
BASELINE = "per_step"
ACCEPTANCE = {"setting": "fused_k16", "min_speedup": 1.5}
GATE = ("per_step", "fused_k16")


def _traces(num_requests: int) -> dict:
    from dlbb_tpu_torch.serve.traffic import generate_trace

    return {
        "uniform": generate_trace("poisson", num_requests, seed=11, rate=1e5,
                                  prompt_range=(8, 16), output_range=(240, 240)),
        "staggered": generate_trace("poisson", num_requests, seed=12, rate=1e5,
                                    prompt_range=(8, 16), output_range=(32, 240)),
        "smoke": generate_trace("poisson", 16, seed=3, rate=2000.0,
                                prompt_range=(8, 32), output_range=(8, 24)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=8,
                    help="requests in the replayed trace (default 8 = one full admission "
                         "wave)")
    ap.add_argument("--reps", type=int, default=3,
                    help="interleaved repetitions per setting (default 3)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--output", default=str(REPO / "results" / "torch" / "BENCH_serve.json"))
    ap.add_argument("--stats", default=str(REPO / "stats" / "torch" / "serving"),
                    help="directory of FASTPATH.md")
    args = ap.parse_args(argv)

    from dlbb_tpu_torch.stats.serving_report import write_fastpath_report
    from dlbb_tpu_torch.utils.config import atomic_write_text
    from dlbb_tpu_torch.utils.sysinfo import gpu_name_and_power_limit, resolve_device

    dev = resolve_device(args.device)
    gpu = gpu_name_and_power_limit() if dev.type == "cuda" else None
    if gpu:
        print(gpu)
    model, seed = bench_model(dev.type, BENCH_MODEL)
    meshes = {k: card_mesh(*m, dev.type) for k, m in MESHES.items()}
    skipped = {name: f"the {mesh} mesh needs {MESHES[mesh][0] * MESHES[mesh][1]} ranks; "
                     "one card holds one NCCL rank"
               for name, (mesh, _t, _e) in SETTINGS.items()
               if dev.type == "cuda" and mesh == "tp4"}
    traces = _traces(args.requests)
    runs = [{"name": f"gate/{name}", "mesh": SETTINGS[name][0], "trace": "smoke",
             "serving": dict(SERVE, **SETTINGS[name][2]), "capture": True} for name in GATE]
    runs += [{"name": name, "mesh": mesh, "trace": trace, "serving": dict(SERVE, **extra),
              "capture": False}
             for name, (mesh, trace, extra) in SETTINGS.items() if name not in skipped]
    res = serve_settings(model, seed, meshes, runs, traces, args.reps, dev)

    tokens = {name: res["captures"][f"gate/{name}"] for name in GATE}
    if tokens["per_step"] != tokens["fused_k16"]:
        print("equivalence gate FAILED: fused-K decode produced different completed-token "
              "sequences than the per-step engine; refusing to publish throughput for a "
              "wrong result", file=sys.stderr)
        return 1
    equivalence = {"checked": True, "identical": True, "requests": len(tokens["per_step"]),
                   "tokens": sum(len(v) for v in tokens["per_step"].values())}
    print(f"[equivalence] per-step == fused_k16 over {equivalence['tokens']} tokens: OK")

    settings_out = {}
    for name, (mesh, trace, extra) in SETTINGS.items():
        # the mesh the setting ran on: JAX's on CPU ranks, one rank on the card
        row = {"mesh": mesh if dev.type == "cpu" or name in skipped else "1",
               "trace": trace,
               "decode_horizon": extra.get("decode_horizon", 1),
               "inflight_window": extra.get("inflight_window", 1),
               "compact_threshold": extra.get("compact_threshold")}
        if name in skipped:
            settings_out[name] = {**row, "status": "skipped", "reason": skipped[name],
                                  "output_tokens_per_s": {}}
            continue
        reps = res["timed"][name]
        settings_out[name] = {
            **row,
            "output_tokens_per_s": spread([r["goodput_tokens_per_s"] for r in reps]),
            "per_token_p50_ms": round(median([r["per_token_latency"]["median"]
                                              for r in reps]) * 1e3, 3),
            "decode_units": median([r["decode_units"] for r in reps]),
            "decode_steps": median([r["decode_steps"] for r in reps]),
            "fused_steps": median([r["fast_path"]["fused_steps"] for r in reps]),
            "compacted_scans": median([r["fast_path"]["compacted_scans"] for r in reps]),
        }
    # speedups are within-mesh, within-trace (JAX's): the K grid against
    # per_step, the tp4 rows against tp4_per_step
    for name, (mesh, _t, _e) in SETTINGS.items():
        if name in skipped:
            continue
        base_name = "tp4_per_step" if mesh == "tp4" else BASELINE
        base_med = settings_out[base_name]["output_tokens_per_s"]["median"]
        settings_out[name]["baseline"] = base_name
        settings_out[name]["speedup_vs_per_step"] = round(
            settings_out[name]["output_tokens_per_s"]["median"] / base_med, 3)
    acc = settings_out[ACCEPTANCE["setting"]]["speedup_vs_per_step"]
    acceptance = {**ACCEPTANCE, "measured_speedup": acc,
                  "passed": acc >= ACCEPTANCE["min_speedup"]}

    payload = {
        "harness": "scripts/torch_bench_serving.py",
        "schema": "dlbb_bench_serve_v1",
        "model": model,
        "seed": seed,
        "serving": dict(SERVE),
        "traces": {key: {"kind": t.kind, "requests": len(t), "seed": t.seed,
                         "params": dict(t.params)}
                   for key, t in traces.items() if key != "smoke"},
        "repetitions": args.reps,
        "baseline": BASELINE,
        "methodology": (
            "identical seeded trace replayed through every engine; settings interleaved "
            "within each repetition; medians of per-rep goodput with min/max spread; "
            "equivalence gate (identical argmax-token sequences) read before anything "
            "is written"),
        **device_record(dev, gpu, max(m[0] * m[1] for m in meshes.values())),
        "equivalence": equivalence,
        "settings": settings_out,
        "acceptance": acceptance,
        "claim": (
            "card run: one rank holds every slot; a per-step engine pays one host dispatch "
            "of the eager decode per step, which the fused scan issues K at a time"
            if dev.type == "cuda" else
            "CPU ranks over gloo: host dispatch dominates the small model's steps, which "
            "is the overhead the fused scan removes; not a device measurement"),
    }
    out = Path(args.output)
    atomic_write_text(json.dumps(payload, indent=1) + "\n", out)
    write_fastpath_report(out, Path(args.stats))
    for name, s in settings_out.items():
        if name in skipped:
            print(f"[{name:22s}] skipped: {s['reason']}")
            continue
        tps = s["output_tokens_per_s"]
        print(f"[{name:22s}] {tps['median']:8.1f} tok/s ({tps['min']:.1f}..{tps['max']:.1f})  "
              f"x{s['speedup_vs_per_step']:.3f} vs {s['baseline']}, {s['decode_units']} "
              f"dispatches, per-token p50 {s['per_token_p50_ms']} ms")
    print(f"[acceptance] {ACCEPTANCE['setting']} >= {ACCEPTANCE['min_speedup']}x: "
          f"{'PASS' if acceptance['passed'] else 'FAIL'} ({acc:.3f}x)")
    print(f"BENCH_serve.json -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
