#!/usr/bin/env python3
"""Where the time of the port's 1B train step goes at each ZeRO stage, on
one NVIDIA GPU, inside a process group of one rank.

    python3 scripts/torch_zero_profile.py --out DIR [--steps 5] [--num-threads N]

Builds the train step of ``dlbb_tpu_torch/configs/train_1b_adam_bf16m.yaml``
(the 1B decoder at full width, bf16, B=8, S=512, remat "dots", Adam with
bf16 moments, random weights from seed 42) through ``make_train_step``,
first with no process group, then on the mesh of a one-rank NCCL group at
ZeRO stages 0, 1, 2 and 3 (``train/zero.py``).  For each it times
``--steps`` steps two ways with CUDA events: back to back, the host running
ahead (``run_train``'s timing with no process group), and with a
synchronize after each step (its timing in a process group, less the
barrier); times the host's enqueue of a step (``time.perf_counter`` from the
call to its return, the device idle at the start); and traces two steps with
``torch.profiler``: device busy time, idle share, kernel time by class, and
the collective calls (the dispatcher's ``c10d::`` ops) and the host's time
inside them.
``--num-threads`` sets ``torch.set_num_threads`` first, as ``bench/launch.py``
does in its ranks (1).  Prints one line per variant and, as its last line,
one JSON object, which it also writes under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from torch_e2e_profile import classify, union_length  # noqa: E402

CONFIG = Path(__file__).resolve().parents[1] / "dlbb_tpu_torch" / "configs" / \
    "train_1b_adam_bf16m.yaml"


def _events_ms(torch, fn, steps, sync_each):
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(steps)]
    torch.cuda.synchronize()
    for start, end in pairs:
        start.record()
        fn()
        end.record()
        if sync_each:
            # comm-lint: disable=host-transfer-in-loop  the sync-each-step timing mode
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def _profile(torch, fn, reps, out, name):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            with record_function(f"step_{i}"):
                fn()
        torch.cuda.synchronize()
    path = out / f"trace_{name}.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events)
    os.remove(path)
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    marks = [e for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("step_")]
    t0 = min(e["ts"] for e in marks)
    window = max(e["ts"] + e["dur"] for e in kernels) - t0
    busy = union_length([(e["ts"], e["ts"] + e["dur"]) for e in kernels])
    by_class: dict[str, float] = {}
    for e in kernels:
        cls = classify(e["name"])
        by_class[cls] = by_class.get(cls, 0.0) + e["dur"] / 1e3 / reps
    # the host's time inside the collectives: the dispatcher's c10d ops
    # (each holds its ProcessGroupNCCL call), on any thread
    calls = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
             and str(e.get("name", "")).startswith("c10d::")]
    return {"window_ms": window / 1e3 / reps, "device_busy_ms": busy / 1e3 / reps,
            "device_idle_share": 1.0 - busy / window,
            "kernels_per_step": len(kernels) / reps,
            "kernel_ms_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
            "collective_calls_per_step": len(calls) / reps,
            "host_ms_in_collectives_per_step": sum(e["dur"] for e in calls) / 1e3 / reps}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True, help="directory for the JSON summary")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--num-threads", type=int, default=None)
    args = p.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_zero_profile: no CUDA device", file=sys.stderr)
        return 1
    if args.num_threads is not None:
        torch.set_num_threads(args.num_threads)
    from dlbb_tpu_torch import comm
    from dlbb_tpu_torch.data import create_dataset_from_config
    from dlbb_tpu_torch.models import ModelConfig, init_params
    from dlbb_tpu_torch.parallel import ParallelismPlan
    from dlbb_tpu_torch.train.loop import make_train_step
    from dlbb_tpu_torch.train.optim import build_optimizer
    from dlbb_tpu_torch.utils.config import load_config, save_json
    from dlbb_tpu_torch.utils.sysinfo import gpu_name_and_power_limit

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    config = load_config(CONFIG)
    cfg = ModelConfig.from_dict(config["model"])
    batch, targets = (create_dataset_from_config(
        config, dtype=torch.bfloat16, device="cuda", hidden_size=cfg.hidden_size,
        seed_offset=off).get_batch() for off in (0, 1))
    torch.cuda.set_device(0)
    result = {"gpu": gpu_name_and_power_limit(), "torch_num_threads": torch.get_num_threads(),
              "steps": args.steps, "variants": {}}
    with tempfile.TemporaryDirectory(prefix="zero_profile_") as tmp:
        comm.initialize_distributed("nccl", 0, 1, os.path.join(tmp, "store"))
        try:
            mesh = ParallelismPlan.from_config(config, cfg).mesh
            for name, stage in (("no_group", None), ("zero0", 0), ("zero1", 1),
                                ("zero2", 2), ("zero3", 3)):
                step_fn, state = make_train_step(
                    cfg, build_optimizer(config["training"]), init_params(cfg, 42, "cuda"),
                    mesh=None if stage is None else mesh, zero_stage=stage or 0,
                    batch_size=config["input"]["batch_size"])
                holder = [state]

                def step():
                    holder[0], loss = step_fn(holder[0], batch, targets)
                    return loss

                for _ in range(2):
                    step()
                ahead = _events_ms(torch, step, args.steps, sync_each=False)
                synced = _events_ms(torch, step, args.steps, sync_each=True)
                host = []
                for _ in range(args.steps):
                    # comm-lint: disable=host-transfer-in-loop  brackets each host-enqueue rep
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step()
                    host.append((time.perf_counter() - t0) * 1e3)
                    # comm-lint: disable=host-transfer-in-loop  brackets each host-enqueue rep
                    torch.cuda.synchronize()
                row = {"events_ms_host_ahead": float(np.median(ahead)),
                       "events_ms_sync_each_step": float(np.median(synced)),
                       "host_enqueue_ms": float(np.median(host)),
                       **_profile(torch, step, 2, out, name)}
                result["variants"][name] = row
                print(f"[{name}] events {row['events_ms_host_ahead']:.2f} ms (host ahead), "
                      f"{row['events_ms_sync_each_step']:.2f} ms (sync each step); host "
                      f"enqueue {row['host_enqueue_ms']:.2f} ms; device busy "
                      f"{row['device_busy_ms']:.2f} ms, idle {row['device_idle_share']:.1%}; "
                      f"{row['collective_calls_per_step']:.0f} collective calls, "
                      f"{row['host_ms_in_collectives_per_step']:.2f} ms of host time in them; "
                      f"kernels {row['kernels_per_step']:.0f}; by class "
                      + ", ".join(f"{k} {v:.2f}" for k, v in row["kernel_ms_by_class"].items()),
                      flush=True)
                del holder, state, step_fn
                torch.cuda.empty_cache()
        finally:
            comm.destroy_distributed()
    save_json(result, out / f"zero_profile_threads{result['torch_num_threads']}.json")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
