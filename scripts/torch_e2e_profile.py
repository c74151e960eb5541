#!/usr/bin/env python3
"""Where the time of the port's 1B forward goes on one NVIDIA GPU.

    python3 scripts/torch_e2e_profile.py --out DIR [--batch 8] [--seq 512]
                                         [--reps 3]

Builds the 1B decoder of ``dlbb_tpu_torch`` at full width (bf16,
``attention="full"``, random weights from seed 42), runs a few warm
forwards, then traces ``--reps`` forwards with ``torch.profiler`` and reads
the Chrome trace it exports: device time by kernel class (the flash kernel,
matrix products, copies, other elementwise and reductions), the top kernels
by name, and the device's idle share over the traced window (1 - the union
of kernel intervals / the window from the first forward's start to the last
kernel's end).  Also times the same forwards with CUDA events and no
profiler.  Prints one JSON line as its last line and writes the trace and
that JSON under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CLASSES = (
    ("flash_fwd", ("flash_fwd",)),
    ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas", "sm90_")),
    ("copy", ("copy",)),
    ("reduce", ("reduce",)),
)


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "elementwise_other"


def union_length(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True,
                   help="directory for the trace and the JSON summary")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("torch_e2e_profile: no CUDA device", file=sys.stderr)
        return 1
    from dlbb_tpu_torch.data import SyntheticEmbeddingDataset
    from dlbb_tpu_torch.models import MODEL_CONFIGS, forward, init_params
    from dlbb_tpu_torch.ops import flash_attention as fa
    from dlbb_tpu_torch.utils.config import save_json
    from dlbb_tpu_torch.utils.sysinfo import gpu_name_and_power_limit

    cfg = MODEL_CONFIGS["1B"].with_(attention="full")
    params = init_params(cfg, 42, "cuda")
    x = SyntheticEmbeddingDataset(args.batch, args.seq, cfg.hidden_size,
                                  seed=42, device="cuda").get_batch()

    @torch.inference_mode()
    def step():
        return forward(params, x, cfg)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.reps):
        step()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / args.reps

    launches0 = fa.flash_fwd_launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(args.reps):
            with record_function(f"forward_{i}"):
                step()
        torch.cuda.synchronize()
    launches = fa.flash_fwd_launches - launches0

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace_path = out / "trace_1b_forward.json"
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())
    events = events.get("traceEvents", events)
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    marks = [e for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("forward_")]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    t0 = min(e["ts"] for e in marks) if marks else min(e["ts"] for e in kernels)
    t1 = max(e["ts"] + e["dur"] for e in kernels)
    window_us = t1 - t0
    busy_us = union_length([(e["ts"], e["ts"] + e["dur"]) for e in kernels])

    by_class: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        cls = classify(e["name"])
        by_class[cls] = by_class.get(cls, 0.0) + e["dur"]
        rec = by_name.setdefault(e["name"][:120], [0.0, 0, cls])
        rec[0] += e["dur"]
        rec[1] += 1
    reps = args.reps
    kernel_total_ms = sum(by_class.values()) / 1e3 / reps
    result = {
        "gpu": gpu_name_and_power_limit(),
        "shape": {"model": "1B", "batch": args.batch, "seq": args.seq,
                  "dtype": "bfloat16", "attention": "full"},
        "forward_ms_cuda_events": event_ms,
        "traced_window_ms_per_forward": window_us / 1e3 / reps,
        "device_busy_ms_per_forward": busy_us / 1e3 / reps,
        "device_idle_share": 1.0 - busy_us / window_us,
        "kernel_ms_per_forward": kernel_total_ms,
        "kernels_per_forward": len(kernels) / reps,
        "flash_fwd_launches_per_forward": launches / reps,
        "ms_per_forward_by_class": {k: v / 1e3 / reps for k, v in
                                    sorted(by_class.items(), key=lambda kv: -kv[1])},
        "share_by_class": {k: v / 1e3 / reps / kernel_total_ms for k, v in
                           sorted(by_class.items(), key=lambda kv: -kv[1])},
        "top_kernels": [
            {"name": n, "class": c, "ms_per_forward": t / 1e3 / reps,
             "calls_per_forward": k / reps}
            for n, (t, k, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        ],
    }
    for row in result["top_kernels"]:
        print(f"{row['ms_per_forward']:9.3f} ms  x{row['calls_per_forward']:6.1f}  "
              f"[{row['class']}] {row['name']}")
    save_json(result, out / "profile_1b_forward.json")
    if trace_path.stat().st_size > 48 * 2**20:  # keep what is brought back small
        os.remove(trace_path)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
