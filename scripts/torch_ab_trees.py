#!/usr/bin/env python3
"""Two trees of the port, run in turns on one NVIDIA GPU: the 1B train step
and the 1B forward of each, so that a change is read against its parent
inside one call on one card.

    python3 scripts/torch_ab_trees.py --tree parent=DIR --tree change=DIR
        [--order parent,change,change,parent,parent,change] --out DIR

For each entry of ``--order`` it runs, from that tree's root and in fresh
processes: ``scripts/torch_e2e_profile.py --train`` (the step's device time
by kernel class and its time by CUDA events), ``python -m dlbb_tpu_torch.cli
train`` on ``dlbb_tpu_torch/configs/train_1b_adam_bf16m.yaml`` (the step's
wall time, mean of the timed steps) and ``scripts/torch_e2e_profile.py``
(the forward's device time by class and its time by CUDA events).  Each
tree builds its own kernels (``ops/_build`` under its root) in its first
process.  Prints a table and, as its last line, one JSON object with every
run's numbers by tree and order; writes the same under ``--out`` (the
profiler's traces are deleted once read).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

TRAIN_CONFIG = "dlbb_tpu_torch/configs/train_1b_adam_bf16m.yaml"


def _last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def _run(cmd, cwd: Path, log: Path) -> str:
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    log.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} in {cwd} exited {proc.returncode}; see {log}")
    return proc.stdout


def run_tree(name: str, root: Path, out: Path) -> dict:
    out.mkdir(parents=True, exist_ok=True)
    py = sys.executable
    step = _last_json(_run([py, "scripts/torch_e2e_profile.py", "--train", "--out",
                            str(out / "train")], root, out / "profile_train.log"))
    cli = _run([py, "-m", "dlbb_tpu_torch.cli", "train", "--config", TRAIN_CONFIG,
                "--output", str(out / "cli")], root, out / "cli_train.log")
    fwd = _last_json(_run([py, "scripts/torch_e2e_profile.py", "--out", str(out / "fwd")],
                          root, out / "profile_fwd.log"))
    for trace in out.glob("*/trace_*.json"):  # read already; keep what is brought back small
        trace.unlink()
    by_class = step["ms_per_step_by_class"]
    return {
        "tree": name,
        "gpu": step["gpu"],
        "step_kernel_ms": step["kernel_ms_per_step"],
        "step_flash_bwd_dq_ms": by_class.get("flash_bwd_dq", 0.0),
        "step_flash_bwd_dkv_ms": by_class.get("flash_bwd_dkv", 0.0),
        "step_flash_fwd_ms": by_class.get("flash_fwd", 0.0),
        "step_ms_cuda_events": step["step_ms_cuda_events"],
        "step_idle_share": step["device_idle_share"],
        "cli_step_mean_ms": float(re.search(r"step mean ([\d.]+) ms", cli).group(1)),
        "forward_kernel_ms": fwd["kernel_ms_per_forward"],
        "forward_flash_fwd_ms": fwd["ms_per_forward_by_class"].get("flash_fwd", 0.0),
        "forward_ms_cuda_events": fwd["forward_ms_cuda_events"],
        "step_ms_by_class": by_class,
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", required=True, metavar="NAME=DIR")
    p.add_argument("--order", default="parent,change,change,parent,parent,change")
    p.add_argument("--out", required=True)
    args = p.parse_args()
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",")
    if not set(order) <= set(trees):
        p.error(f"--order names {sorted(set(order) - set(trees))}, not given by --tree")
    out = Path(args.out).resolve()
    runs = []
    for i, name in enumerate(order):
        runs.append(run_tree(name, Path(trees[name]).resolve(), out / f"{i}_{name}"))
        r = runs[-1]
        print(f"[ab] {i} {name}: step kernels {r['step_kernel_ms']:.3f} ms (dq "
              f"{r['step_flash_bwd_dq_ms']:.3f}, dk/dv {r['step_flash_bwd_dkv_ms']:.3f}, "
              f"flash fwd {r['step_flash_fwd_ms']:.3f}), step {r['step_ms_cuda_events']:.3f} "
              f"ms by events, cli step mean {r['cli_step_mean_ms']:.3f} ms; forward "
              f"kernels {r['forward_kernel_ms']:.3f} ms (flash fwd "
              f"{r['forward_flash_fwd_ms']:.3f}), forward {r['forward_ms_cuda_events']:.3f} "
              f"ms by events; {r['gpu']}", flush=True)
    from dlbb_tpu_torch.utils.config import save_json

    result = {"order": order, "trees": trees, "runs": runs}
    save_json(result, out / "ab.json")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
