#!/usr/bin/env python3
"""Shared-prefix and quantized-KV evidence for the PyTorch port: the prefix
cache against full prefill (the port of ``scripts/bench_prefix.py``).

    python3 scripts/torch_bench_prefix.py [--requests N] [--reps R] [--device cpu]
                                          [--output results/torch/BENCH_prefix.json]
                                          [--stats stats/torch/serving]

Replays JAX's two seeded shared-prefix traces (``share80``: 64 of 65-96
prompt tokens shared in 2 groups; ``share60``: 48) through {prefix off,
prefix on} x {fp, int8 KV} and writes ``BENCH_prefix.json`` (schema
``dlbb_bench_prefix_v1``, the JAX script's keys) under ``results/torch/``
and ``PREFIX.md`` under ``stats/torch/serving/``, never the repository
root's ``BENCH_prefix.json`` (the JAX package's runs):

- **equivalence gate**: every prefix-cached and int8 setting replays its
  trace with token capture on against the no-sharing fp engine on the same
  trace: fp prefix attach must be exact, int8 must keep at least
  ``INT8_MIN_IDENTICAL`` of the requests token-identical; a failure exits 1
  and writes nothing;
- **TTFT and goodput grid**: settings interleaved within each repetition,
  completed output tokens per wall second of each replay (medians with
  min/max), TTFT and per-token p50, prefix hits and reused tokens; each
  speedup is against the prefix-off fp engine on the same trace;
- **static capacity**: resident requests of each KV layout under one
  budget, priced by ``kv_cache_bytes_per_device`` (the formula the
  engine's budget gate uses).

The bars (prefix-on TTFT p50 at 1.3x prefix-off on ``share60``; int8 at
1.8x the fp resident requests) are recorded as met or not, not aborts.
The serving sizes are JAX's (``SERVE``: 8 slots of 160 tokens in blocks of
8, 16-token prefill chunks, no budget gate), which hold the traces.  On the
card (the default) the model is the 1B of
``dlbb_tpu_torch/configs/serve_1b.yaml`` at full width and depth on one
rank, and the capacity budget is ``CARD_CAPACITY_BUDGET_GB``: JAX's 0.001
GB holds no 1B request (one 160-token slot of its bf16 cache is 30 MiB),
and the ratio does not depend on the budget.  ``--device cpu`` runs JAX's
model (hidden 64, 2 layers, 4 heads) on JAX's tp=4 mesh over 4 gloo ranks,
at JAX's budget.
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

# prefix attach requires dp=1; tp=4 is JAX's geometry
MESH = (1, 4)
SERVE = dict(max_batch=8, block_size=8, max_seq=160, queue_capacity=64, prefill_chunk=16,
             hbm_budget_gb=None)
TRACES = {
    "share80": dict(seed=11, prefix_groups=2, prefix_len=64),
    "share60": dict(seed=13, prefix_groups=2, prefix_len=48),
}
PROMPTS = (65, 96)
OUTPUTS = (16, 32)
MODES = {
    "off_none": dict(prefix_caching=False, kv_quantization="none"),
    "on_none": dict(prefix_caching=True, kv_quantization="none"),
    "on_int8": dict(prefix_caching=True, kv_quantization="int8"),
}
BASELINE_MODE = "off_none"
INT8_MIN_IDENTICAL = 0.7
CAPACITY_BUDGET_GB = 0.001
CARD_CAPACITY_BUDGET_GB = 1.0
ACCEPT_TTFT = {"setting": "share60/on_none", "baseline": "share60/off_none",
               "min_speedup": 1.3}
ACCEPT_CAPACITY = {"min_ratio": 1.8}


def _traces(num_requests: int) -> dict:
    from dlbb_tpu_torch.serve.traffic import generate_trace

    return {name: generate_trace("poisson", num_requests, seed=kw["seed"], rate=500.0,
                                 prompt_range=PROMPTS, output_range=OUTPUTS,
                                 prefix_groups=kw["prefix_groups"],
                                 prefix_len=kw["prefix_len"])
            for name, kw in TRACES.items()}


def _shared_share(trace) -> float:
    total = sum(r.prompt_len for r in trace.requests)
    shared = sum(r.prefix_len or 0 for r in trace.requests)
    return shared / total if total else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=16,
                    help="requests per replayed trace (default 16 = two admission waves "
                         "at max_batch=8)")
    ap.add_argument("--reps", type=int, default=3,
                    help="interleaved repetitions per setting (default 3)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--output", default=str(REPO / "results" / "torch" / "BENCH_prefix.json"))
    ap.add_argument("--stats", default=str(REPO / "stats" / "torch" / "serving"),
                    help="directory of PREFIX.md")
    args = ap.parse_args(argv)

    from dlbb_tpu_torch.models.configs import ModelConfig, kv_cache_bytes_per_device
    from dlbb_tpu_torch.stats.serving_report import write_prefix_report
    from dlbb_tpu_torch.utils.config import atomic_write_text
    from dlbb_tpu_torch.utils.sysinfo import gpu_name_and_power_limit, resolve_device

    dev = resolve_device(args.device)
    gpu = gpu_name_and_power_limit() if dev.type == "cuda" else None
    if gpu:
        print(gpu)
    model, seed = bench_model(dev.type, SMALL_MODEL)
    mesh = card_mesh(*MESH, dev.type)
    traces = _traces(args.requests)
    runs = [{"name": f"gate/{t}/{m}", "mesh": "m", "trace": t,
             "serving": dict(SERVE, **extra), "capture": True}
            for t in traces for m, extra in MODES.items()]
    runs += [{"name": f"{t}/{m}", "mesh": "m", "trace": t, "serving": dict(SERVE, **extra),
              "capture": False} for t in traces for m, extra in MODES.items()]
    res = serve_settings(model, seed, {"m": mesh}, runs, traces, args.reps, dev)

    identity = {}
    n_tok = 0
    for tname in traces:
        oracle = res["captures"][f"gate/{tname}/{BASELINE_MODE}"]
        n_tok += sum(len(v) for v in oracle.values())
        for mname, extra in MODES.items():
            if mname == BASELINE_MODE:
                continue
            got = res["captures"][f"gate/{tname}/{mname}"]
            same = sum(1 for rid in oracle if got.get(rid) == oracle[rid])
            frac = same / len(oracle) if oracle else 1.0
            exact_required = extra["kv_quantization"] == "none"
            identity[f"{tname}/{mname}"] = {
                "exact": got == oracle, "identical_requests": same,
                "requests": len(oracle), "fraction": round(frac, 4),
                "gate": "exact" if exact_required else f">={INT8_MIN_IDENTICAL}",
                "passed": got == oracle if exact_required else frac >= INT8_MIN_IDENTICAL,
            }
    if not all(v["passed"] for v in identity.values()):
        bad = {n: f"{v['identical_requests']}/{v['requests']}"
               for n, v in sorted(identity.items()) if not v["passed"]}
        print("equivalence gate FAILED: prefix-cached/int8 serving diverged from the "
              f"no-sharing fp engine beyond its gate for {bad} (fp must be exact; int8 "
              f"needs >= {INT8_MIN_IDENTICAL} of requests identical); refusing to publish "
              "throughput for a wrong result", file=sys.stderr)
        return 1
    for name, v in sorted(identity.items()):
        print(f"[equivalence] {name}: {v['identical_requests']}/{v['requests']} requests "
              f"identical (gate {v['gate']}): OK")

    settings_out = {}
    for tname in traces:
        for mname, extra in MODES.items():
            name = f"{tname}/{mname}"
            reps = res["timed"][name]
            pre = [r.get("prefix", {}) for r in reps]
            hr = [p["hit_rate"] for p in pre if p.get("hit_rate") is not None]
            ident = identity.get(name)
            settings_out[name] = {
                "trace": tname,
                "prefix_caching": extra["prefix_caching"],
                "kv_quantization": extra["kv_quantization"],
                "output_tokens_per_s": spread([r["completed_output_tokens"] / r["wall_s"]
                                               for r in reps]),
                "ttft_p50_ms": round(median([r["ttft"]["median"] for r in reps]) * 1e3, 3),
                "per_token_p50_ms": round(median([r["per_token_latency"]["median"]
                                                  for r in reps]) * 1e3, 3),
                "prefix_hits": median([p.get("hits", 0) for p in pre]),
                "prefix_hit_rate": round(median(hr), 4) if hr else None,
                "tokens_reused": median([p.get("tokens_reused", 0) for p in pre]),
                "token_identical": None if ident is None else ident["exact"],
                "token_identity_fraction": None if ident is None else ident["fraction"],
            }
    for name, s in settings_out.items():
        base_name = f"{s['trace']}/{BASELINE_MODE}"
        base = settings_out[base_name]
        s["baseline"] = base_name
        s["ttft_speedup_vs_baseline"] = round(base["ttft_p50_ms"] / s["ttft_p50_ms"], 3)
        s["goodput_speedup_vs_baseline"] = round(
            s["output_tokens_per_s"]["median"] / base["output_tokens_per_s"]["median"], 3)

    # static capacity: one request is a max_batch=1 slice (bytes are linear
    # in max_batch), priced under one budget
    budget_gb = CAPACITY_BUDGET_GB if dev.type == "cpu" else CARD_CAPACITY_BUDGET_GB
    cfg = ModelConfig.from_dict(model)
    per_req = {kv: kv_cache_bytes_per_device(cfg, 1, SERVE["max_seq"], dp=mesh[0],
                                             tp=mesh[1], kv_quantization=kv,
                                             block_size=SERVE["block_size"])
               for kv in ("none", "int8")}
    resident = {kv: int(budget_gb * 2**30) // b for kv, b in per_req.items()}
    cap_ratio = round(resident["int8"] / resident["none"], 3)
    capacity = {
        "hbm_budget_gb": budget_gb, "max_seq": SERVE["max_seq"],
        "block_size": SERVE["block_size"], "dp": mesh[0], "tp": mesh[1],
        "per_request_bytes_per_device": per_req, "resident_requests": resident,
        "capacity_ratio": cap_ratio, "min_ratio": ACCEPT_CAPACITY["min_ratio"],
        "passed": cap_ratio >= ACCEPT_CAPACITY["min_ratio"],
    }
    ttft_row = settings_out[ACCEPT_TTFT["setting"]]
    acceptance = {
        "ttft": {**ACCEPT_TTFT, "measured_speedup": ttft_row["ttft_speedup_vs_baseline"],
                 "passed": ttft_row["ttft_speedup_vs_baseline"] >= ACCEPT_TTFT["min_speedup"]},
        "capacity": {**ACCEPT_CAPACITY, "measured_ratio": cap_ratio,
                     "passed": capacity["passed"]},
    }

    payload = {
        "harness": "scripts/torch_bench_prefix.py",
        "schema": "dlbb_bench_prefix_v1",
        "model": model,
        "seed": seed,
        "serving": dict(SERVE),
        "mesh": {"dp": mesh[0], "tp": mesh[1]},
        "traces": {name: {"kind": t.kind, "requests": len(t), "seed": t.seed,
                          "prefix_groups": TRACES[name]["prefix_groups"],
                          "prefix_len": TRACES[name]["prefix_len"],
                          "prompt_range": list(PROMPTS), "output_range": list(OUTPUTS),
                          "shared_token_share": round(_shared_share(t), 4)}
                   for name, t in traces.items()},
        "repetitions": args.reps,
        "baseline": BASELINE_MODE,
        "methodology": (
            "identical seeded shared-prefix traces replayed through every engine; settings "
            "interleaved within each repetition; medians of per-rep completed-output-token "
            "throughput with min/max spread; completed-token identity gate (every "
            "prefix-cached / int8 setting == the no-sharing fp engine on the same trace) "
            "read before anything is written; capacity is static arithmetic over "
            "kv_cache_bytes_per_device"),
        **device_record(dev, gpu, mesh[0] * mesh[1]),
        "equivalence": {"checked": True, "oracle": f"{BASELINE_MODE} (per trace)",
                        "int8_min_identical": INT8_MIN_IDENTICAL,
                        "identical": dict(sorted(identity.items())), "tokens": n_tok},
        "settings": settings_out,
        "capacity": capacity,
        "acceptance": acceptance,
        "claim": (
            "card run: an attached request computes only its unmatched suffix; the int8 "
            "rows pay the dequantise and the touched-block requantise in eager torch"
            if dev.type == "cuda" else
            "CPU ranks over gloo: every skipped prefill chunk saves a host dispatch; int8 "
            "pays its dequantise/requantise at CPU cost; the capacity ratio is static; "
            "not a device measurement"),
    }
    out = Path(args.output)
    atomic_write_text(json.dumps(payload, indent=1) + "\n", out)
    write_prefix_report(out, Path(args.stats))
    for name, s in settings_out.items():
        tps = s["output_tokens_per_s"]
        hit = "-" if s["prefix_hit_rate"] is None else f"{s['prefix_hit_rate']:.3f}"
        print(f"[{name:16s}] {tps['median']:8.1f} tok/s ({tps['min']:.1f}..{tps['max']:.1f})  "
              f"TTFT p50 {s['ttft_p50_ms']:9.3f} ms x{s['ttft_speedup_vs_baseline']:.3f}, "
              f"hit={hit}")
    ttft_acc = acceptance["ttft"]
    print(f"[acceptance] TTFT {ttft_acc['setting']} >= {ttft_acc['min_speedup']}x vs "
          f"{ttft_acc['baseline']}: {'PASS' if ttft_acc['passed'] else 'FAIL'} "
          f"({ttft_acc['measured_speedup']:.3f}x)")
    print(f"[acceptance] int8 capacity >= {ACCEPT_CAPACITY['min_ratio']}x residents: "
          f"{'PASS' if capacity['passed'] else 'FAIL'} ({cap_ratio:.3f}x: {resident['none']} "
          f"fp -> {resident['int8']} int8 under {budget_gb} GB/device)")
    print(f"BENCH_prefix.json -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
