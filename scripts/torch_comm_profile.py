#!/usr/bin/env python3
"""What the timed interval of a one-rank collective holds on one NVIDIA GPU.

    python3 scripts/torch_comm_profile.py --out DIR [--ops allreduce ...]
                                          [--iters 20]

Joins a one-rank NCCL process group and, for each op and each payload
(8 MiB and 1 GiB of bf16 per rank, the sweep's 16MB label and its largest
3D shape), runs ``utils.timing.time_collective`` as the sweep does, under
``torch.profiler`` with CPU and CUDA activities.  It prints the timed
median, then, from the profiler: the device time by kernel or memcpy name,
and the host time of the CUDA runtime and NCCL calls, by name, both per
timed iteration.  Writes each Chrome trace and one JSON of it all under
``--out``; the JSON is also the last line printed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PAYLOADS = {"16MB": (4194304,), "1GiB": (16, 8192, 4096)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--ops", nargs="+", default=["allreduce", "broadcast", "reduce",
                                                     "allgather"])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dlbb_tpu_torch import comm
    from dlbb_tpu_torch.utils.config import atomic_write_text
    from dlbb_tpu_torch.utils.sysinfo import gpu_name_and_power_limit
    from dlbb_tpu_torch.utils.timing import time_collective

    if not torch.cuda.is_available():
        print("torch_comm_profile: no CUDA device", file=sys.stderr)
        return 1
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    gpu = gpu_name_and_power_limit()
    print(gpu)
    torch.cuda.set_device(0)
    report = {"device": gpu, "iters": args.iters, "runs": []}
    with tempfile.TemporaryDirectory(prefix="comm_profile_") as tmp:
        comm.initialize_distributed("nccl", 0, 1, os.path.join(tmp, "store"))
        try:
            mesh = comm.get_mesh(comm.MeshSpec.ring(1))
            for label, shape in PAYLOADS.items():
                for name in args.ops:
                    op = comm.get_op(name)
                    x = comm.make_payload(op, 0, 1, 0, shape=shape, device="cuda")
                    fn = op.build(mesh)
                    time_collective(fn, x, mesh.group, warmup=5, iterations=5, device="cuda")
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        samples, _ = time_collective(fn, x, mesh.group, warmup=0,
                                                     iterations=args.iters, device="cuda")
                    prof.export_chrome_trace(str(out / f"{name}_{label}.json"))
                    device, host = {}, {}
                    for e in prof.key_averages():
                        if e.device_time_total > 0 and e.self_device_time_total > 0:
                            device[e.key] = e.self_device_time_total / args.iters
                        if e.key.startswith(("cuda", "cu", "nccl")) and e.cpu_time_total > 0:
                            host[e.key] = (e.cpu_time_total / args.iters, e.count / args.iters)
                    median = sorted(samples)[len(samples) // 2] * 1e6
                    run = {"op": name, "payload": label, "median_us": median,
                           "device_us_per_iter": device, "host_us_and_calls_per_iter": host}
                    report["runs"].append(run)
                    print(f"{name} {label}: timed median {median:.2f} us; device per "
                          "iteration: " + ", ".join(f"{k} {v:.2f} us" for k, v in sorted(
                              device.items(), key=lambda kv: -kv[1])[:6])
                          + "; host per iteration: " + ", ".join(
                              f"{k} {t:.2f} us x{c:g}" for k, (t, c) in sorted(
                                  host.items(), key=lambda kv: -kv[1][0])[:8]))
                    del x
                    torch.cuda.empty_cache()
        finally:
            comm.destroy_distributed()
    atomic_write_text(json.dumps(report, indent=1), out / "comm_profile.json")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
