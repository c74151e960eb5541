#!/usr/bin/env python3
"""Fleet fault-tolerance evidence for the PyTorch port: the measured cost of
a failover (the port of ``scripts/bench_fleet.py``).

    python3 scripts/torch_bench_fleet.py [--config YAML] [--requests N] [--rate R]
                                         [--reps R] [--kill PLAN] [--device cpu] [--journal]
                                         [--output results/torch/BENCH_fleet.json]
                                         [--stats stats/torch/serving]

Serves one seeded Poisson trace through ``serve/fleet.py`` and writes
``BENCH_fleet.json`` (schema ``dlbb_bench_fleet_v1``, the JAX script's keys)
under ``results/torch/`` and ``FLEET.md`` under ``stats/torch/serving/``,
never the repository root's ``BENCH_fleet.json`` (the JAX package's runs):

- **single**: one engine on one replica's serving section, in this process
  (the token oracle and the clean-TTFT reference; a replica's mesh must be
  one rank);
- **fleet_one**: the same trace through a fleet of one replica: the
  supervisor, its thread beside the replica's engine and the mailbox, with
  no second process on the card, so against single it is what the control
  plane alone costs;
- **fleet_clean**: the same trace through the config's fleet with no
  faults: what supervision and sharing the card cost;
- **fleet_kill**: the same with ``--kill`` (``serve-replica-kill`` at the
  fleet's Nth loop boundary): one replica fenced, its residents
  re-prefilled on a survivor.  The headline is the **failover TTFT
  penalty**, failed-over minus clean requests' mean TTFT in the same run
  (the report's ``failover_ttft_penalty_s``), and the goodput kept against
  the unfaulted fleet.

**Token-identity gate**: greedy tokens depend only on (params seed,
request) at one slot count, so every fleet run, clean AND killed, must give
the oracle's completed tokens before anything is written; a mismatch, an
incomplete run, or a kill that fenced nothing aborts with exit code 1 and
writes nothing.  Settings are interleaved within each repetition, and
medians of the repetitions are reported with their min/max.  Goodput comes
from each report's own wall, so process start-up and compiles are outside
it.  Each setting also keeps its engines' decode-step median and the share
of each engine's wall its decode steps and prefills took (dispatch to the
device's completion), averaged over the run's engines: a step median near
single's with a low share puts lost goodput on the host, a step median
above single's on the card.  ``--journal`` has every fleet run write its
journal and artifact set (into a temporary directory), as ``cli serve
--replicas`` does; without it the fleets run with neither, as single
does.  The default config is the 1B fleet on one card
(``dlbb_tpu_torch/configs/serve_1b_fleet.yaml``); ``--device cpu`` with a
small config runs on CPU ranks.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

DEFAULT_CONFIG = "dlbb_tpu_torch/configs/serve_1b_fleet.yaml"
DEFAULT_KILL = "serve-replica-kill:@100"


def _median(vals):
    vals = sorted(vals)
    return vals[len(vals) // 2]


def _spread(vals) -> dict:
    return {"median": _median(vals), "min": min(vals), "max": max(vals), "reps": list(vals)}


def _engines(report: dict) -> list[dict]:
    """The engine reports of one run: single's own, or each fleet replica's
    that ended with one (a killed replica has none)."""
    if "replicas" not in report:
        return [report]
    return [r["report"] for r in report["replicas"] if r["report"] is not None]


def _engine_time(report: dict) -> tuple[float, float]:
    """(decode-step median in ms, share of the wall in steps and prefills),
    each averaged over the run's engines."""
    steps, shares = [], []
    for eng in _engines(report):
        d, p = eng["decode_step_time"], eng["prefill_time"]
        steps.append(d["median"] * 1e3)
        shares.append(sum(x["mean"] * x["count"] for x in (d, p) if x["count"])
                      / eng["wall_seconds"])
    return sum(steps) / len(steps), sum(shares) / len(shares)


def _gate_tokens(got: dict, oracle: dict, what: str) -> None:
    if got != oracle:
        bad = [r for r in oracle if got.get(r) != oracle[r]]
        raise SystemExit(
            f"token-identity gate FAILED ({what}): requests {bad} diverged from the "
            "single-engine oracle; refusing to publish fault-tolerance numbers for a "
            "wrong result")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=DEFAULT_CONFIG,
                    help="experiment YAML with serving: and fleet: sections")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--rate", type=float, default=24.0, help="Poisson arrivals per second")
    ap.add_argument("--prompt-range", type=int, nargs=2, default=(128, 512))
    ap.add_argument("--output-range", type=int, nargs=2, default=(32, 96))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=3,
                    help="interleaved repetitions per setting (default 3)")
    ap.add_argument("--kill", default=DEFAULT_KILL, help="fault plan of fleet_kill")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--journal", action="store_true",
                    help="fleet runs write their journal and artifacts (to a temp dir)")
    ap.add_argument("--output", default=str(REPO / "results" / "torch" / "BENCH_fleet.json"))
    ap.add_argument("--stats", default=str(REPO / "stats" / "torch" / "serving"),
                    help="directory of FLEET.md")
    args = ap.parse_args()

    import tempfile

    import torch

    from dlbb_tpu_torch.models import ModelConfig
    from dlbb_tpu_torch.serve.bench import run_serving
    from dlbb_tpu_torch.serve.fleet import FleetConfig, run_fleet
    from dlbb_tpu_torch.serve.traffic import generate_trace
    from dlbb_tpu_torch.stats.serving_report import write_fleet_report
    from dlbb_tpu_torch.utils.config import atomic_write_text, load_config
    from dlbb_tpu_torch.utils.sysinfo import gpu_name_and_power_limit, resolve_device

    dev = resolve_device(args.device)
    config = load_config(args.config)
    fleet_cfg = FleetConfig.from_dict(config.get("fleet", {}))
    par = config.get("parallelism", {}) or {}
    per_replica = {"dp": int(par.get("data_parallel", 1)), "tp": int(par.get("world_size", 1))}
    if per_replica["dp"] * per_replica["tp"] != 1:
        raise SystemExit("the oracle runs one replica in this process: the config's "
                         "parallelism must be one rank per replica")
    single_cfg = {k: v for k, v in config.items() if k != "fleet"}
    trace = generate_trace("poisson", args.requests, seed=args.seed, rate=args.rate,
                           prompt_range=tuple(args.prompt_range),
                           output_range=tuple(args.output_range))
    gpu = gpu_name_and_power_limit() if dev.type == "cuda" else None
    if gpu:
        print(gpu)

    one_cfg = {**config, "fleet": {**config.get("fleet", {}), "replicas": 1}}
    per_rep: dict[str, list[dict]] = {"single": [], "fleet_one": [], "fleet_clean": [],
                                      "fleet_kill": []}
    penalties: list[float] = []
    failovers: list[int] = []
    def fleet(cfg, plan=None):
        with tempfile.TemporaryDirectory(prefix="bench_fleet_") as tmp:
            return run_fleet(cfg, trace, output_dir=tmp if args.journal else None,
                             journal=args.journal, verbose=False, capture_tokens=True,
                             device=dev.type, fault_plan=plan)

    for rep_i in range(args.reps):
        runs = {
            "single": run_serving(single_cfg, trace, journal=False, verbose=False,
                                  capture_tokens=True, device=dev.type),
            "fleet_one": fleet(one_cfg),
            "fleet_clean": fleet(config),
            "fleet_kill": fleet(config, args.kill),
        }
        oracle = runs["single"]["completed_tokens"]
        _gate_tokens(runs["fleet_one"]["completed_tokens"], oracle, f"fleet_one rep {rep_i}")
        _gate_tokens(runs["fleet_clean"]["completed_tokens"], oracle,
                     f"fleet_clean rep {rep_i}")
        _gate_tokens(runs["fleet_kill"]["completed_tokens"], oracle, f"fleet_kill rep {rep_i}")
        kill = runs["fleet_kill"]
        if not any(r["fence_reason"] == "replica-killed" for r in kill["replicas"]):
            raise SystemExit("the kill plan never fenced a replica: the penalty column "
                             "would measure nothing")
        if kill["failover_ttft_penalty_s"] is None:
            raise SystemExit("the kill rep failed nothing over: no TTFT penalty to measure")
        penalties.append(kill["failover_ttft_penalty_s"])
        failovers.append(kill["failovers"]["total"])
        for name, r in runs.items():
            out = r["requests"]["outcomes"]
            if any(v != "completed" for v in out.values()):
                raise SystemExit(f"{name} rep {rep_i}: not every request completed: {out}")
            step_ms, share = _engine_time(r)
            per_rep[name].append({
                "tok_s": r["goodput_tokens_per_s"],
                "ttft_p50_s": r["ttft"]["median"],
                "ttft_p99_s": r["ttft"]["p99"],
                "wall_s": r["wall_seconds"],
                "step_ms": step_ms,
                "busy": share,
            })
            print(f"[rep {rep_i} {name}] {r['goodput_tokens_per_s']:.1f} tok/s; decode step "
                  f"median {step_ms:.3f} ms; steps and prefills {share:.3f} of the wall "
                  f"(mean over {len(_engines(r))} engine(s))")

    settings_out = {}
    for name, reps in per_rep.items():
        settings_out[name] = {
            "goodput_tokens_per_s": _spread([r["tok_s"] for r in reps]),
            "ttft_p50_ms": round(_median([r["ttft_p50_s"] for r in reps]) * 1e3, 3),
            "ttft_p99_ms": round(_median([r["ttft_p99_s"] for r in reps]) * 1e3, 3),
            "wall_seconds": round(_median([r["wall_s"] for r in reps]), 3),
            "decode_step_ms": round(_median([r["step_ms"] for r in reps]), 3),
            "engine_busy_share": round(_median([r["busy"] for r in reps]), 3),
            "token_identical": True,
        }
    settings_out["fleet_kill"]["failovers"] = _spread(failovers)
    clean_med = settings_out["fleet_clean"]["goodput_tokens_per_s"]["median"]
    kill_med = settings_out["fleet_kill"]["goodput_tokens_per_s"]["median"]
    model = ModelConfig.from_dict(config["model"])

    payload = {
        "harness": "scripts/torch_bench_fleet.py",
        "schema": "dlbb_bench_fleet_v1",
        "model": {"hidden_size": model.hidden_size, "num_layers": model.num_layers,
                  "num_heads": model.num_heads, "kv_heads": model.kv_heads,
                  "dtype": model.dtype, "attention": model.attention},
        "serving": dict(config.get("serving", {})),
        "fleet": {"replicas": fleet_cfg.replicas, "parallelism_per_replica": per_replica},
        "trace": {"kind": trace.kind, "requests": len(trace), "seed": trace.seed,
                  "params": dict(trace.params)},
        "repetitions": args.reps,
        "fault_plan": args.kill,
        "fleet_journal": args.journal,
        "methodology": (
            "identical seeded trace through every setting, settings interleaved within "
            "each repetition; medians with min/max spread; token-identity gate (fleet == "
            "single-engine oracle, clean AND killed) enforced every rep before "
            "publishing; the TTFT penalty is failed-over minus clean requests WITHIN the "
            "kill run, so queueing drift between runs cancels"),
        "backend": f"torch_{dev.type}",
        "device": gpu or dev.type,
        "torch_version": torch.__version__,
        "host_cpu_count": os.cpu_count(),
        "timestamp": time.time(),
        "settings": settings_out,
        "failover": {
            "ttft_penalty_ms": _spread([round(p * 1e3, 3) for p in penalties]),
            "failovers_per_run": _spread(failovers),
            "goodput_retained_vs_clean_fleet": round(kill_med / clean_med, 3),
        },
    }
    out = Path(args.output)
    atomic_write_text(json.dumps(payload, indent=1) + "\n", out)
    write_fleet_report(out, Path(args.stats))
    for name, s in settings_out.items():
        tps = s["goodput_tokens_per_s"]
        print(f"[{name:12s}] {tps['median']:8.1f} tok/s ({tps['min']:.1f}..{tps['max']:.1f})  "
              f"TTFT p50 {s['ttft_p50_ms']:.1f} ms, p99 {s['ttft_p99_ms']:.1f} ms; decode "
              f"step {s['decode_step_ms']:.3f} ms, busy {s['engine_busy_share']:.3f}")
    pen = payload["failover"]["ttft_penalty_ms"]
    print(f"[failover] TTFT penalty {pen['median']:.1f} ms ({pen['min']:.1f}..{pen['max']:.1f}) "
          f"over {_median(failovers)} failover(s)/run; goodput kept "
          f"{payload['failover']['goodput_retained_vs_clean_fleet']:.2f}x the unfaulted fleet's")
    print(f"BENCH_fleet.json -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
