#!/usr/bin/env python3
"""Two trees of the port, run in turns on one NVIDIA GPU: the 1B train step,
the 1B forward and the 1B serving decode step of each, so that a change is
read against its parent inside one call on one card.

    python3 scripts/torch_ab_trees.py --tree parent=DIR --tree change=DIR
        [--order parent,change,change,parent,parent,change]
        [--parts train,forward,decode] --out DIR

For each entry of ``--order`` it runs, from that tree's root and in fresh
processes, the parts named by ``--parts`` (default ``train,forward``):
``train`` is ``scripts/torch_e2e_profile.py --train`` (the step's device
time by kernel class and its time by CUDA events) and ``python -m
dlbb_tpu_torch.cli train`` on ``dlbb_tpu_torch/configs/
train_1b_adam_bf16m.yaml`` (the step's wall time, mean of the timed steps);
``forward`` is ``scripts/torch_e2e_profile.py`` (the forward's device time
by class and its time by CUDA events); ``decode`` is
``scripts/torch_e2e_profile.py --decode`` and ``--decode --int8`` (the
per-step decode's device time, kernels per step and time by CUDA events, on
the bf16 and the int8 cache).  Each
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


PARTS = ("train", "forward", "decode")


def run_tree(name: str, root: Path, out: Path, parts=("train", "forward")) -> dict:
    out.mkdir(parents=True, exist_ok=True)
    py = sys.executable
    run: dict = {"tree": name}

    def profile(flags, label):
        return _last_json(_run([py, "scripts/torch_e2e_profile.py", *flags, "--out",
                                str(out / label)], root, out / f"profile_{label}.log"))

    if "train" in parts:
        step = profile(["--train"], "train")
        cli = _run([py, "-m", "dlbb_tpu_torch.cli", "train", "--config", TRAIN_CONFIG,
                    "--output", str(out / "cli")], root, out / "cli_train.log")
        by_class = step["ms_per_step_by_class"]
        run.update({
            "gpu": step["gpu"],
            "step_kernel_ms": step["kernel_ms_per_step"],
            "step_flash_bwd_dq_ms": by_class.get("flash_bwd_dq", 0.0),
            "step_flash_bwd_dkv_ms": by_class.get("flash_bwd_dkv", 0.0),
            "step_flash_fwd_ms": by_class.get("flash_fwd", 0.0),
            "step_ms_cuda_events": step["step_ms_cuda_events"],
            "step_idle_share": step["device_idle_share"],
            "cli_step_mean_ms": float(re.search(r"step mean ([\d.]+) ms", cli).group(1)),
            "step_ms_by_class": by_class,
        })
    if "forward" in parts:
        fwd = profile([], "fwd")
        run.update({
            "gpu": fwd["gpu"],
            "forward_kernel_ms": fwd["kernel_ms_per_forward"],
            "forward_flash_fwd_ms": fwd["ms_per_forward_by_class"].get("flash_fwd", 0.0),
            "forward_ms_cuda_events": fwd["forward_ms_cuda_events"],
        })
    if "decode" in parts:
        for flags, what in ((["--decode"], "decode_step"),
                            (["--decode", "--int8"], "decode_step_int8")):
            dec = profile(flags, what)
            run.update({
                "gpu": dec["gpu"],
                f"{what}_kernel_ms": dec[f"kernel_ms_per_{what}"],
                f"{what}_kernels": dec[f"kernels_per_{what}"],
                f"{what}_ms_cuda_events": dec[f"{what}_ms_cuda_events"],
                f"{what}_idle_share": dec["device_idle_share"],
                f"{what}_ms_by_class": dec[f"ms_per_{what}_by_class"],
            })
    for trace in out.glob("*/trace_*.json"):  # read already; keep what is brought back small
        trace.unlink()
    return run


def _line(i: int, r: dict) -> str:
    parts = []
    if "step_kernel_ms" in r:
        parts.append(
            f"step kernels {r['step_kernel_ms']:.3f} ms (dq {r['step_flash_bwd_dq_ms']:.3f}, "
            f"dk/dv {r['step_flash_bwd_dkv_ms']:.3f}, flash fwd {r['step_flash_fwd_ms']:.3f}), "
            f"step {r['step_ms_cuda_events']:.3f} ms by events, cli step mean "
            f"{r['cli_step_mean_ms']:.3f} ms")
    if "forward_kernel_ms" in r:
        parts.append(f"forward kernels {r['forward_kernel_ms']:.3f} ms (flash fwd "
                     f"{r['forward_flash_fwd_ms']:.3f}), forward "
                     f"{r['forward_ms_cuda_events']:.3f} ms by events")
    for what in ("decode_step", "decode_step_int8"):
        if f"{what}_kernel_ms" in r:
            parts.append(f"{what} kernels {r[f'{what}_kernel_ms']:.3f} ms "
                         f"({r[f'{what}_kernels']:.1f} per step), "
                         f"{r[f'{what}_ms_cuda_events']:.3f} ms by events")
    return f"[ab] {i} {r['tree']}: " + "; ".join(parts) + f"; {r.get('gpu')}"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", required=True, metavar="NAME=DIR")
    p.add_argument("--order", default="parent,change,change,parent,parent,change")
    p.add_argument("--parts", default="train,forward",
                   help=f"comma list of {', '.join(PARTS)} (default train,forward)")
    p.add_argument("--out", required=True)
    args = p.parse_args()
    parts = args.parts.split(",")
    if not parts or not set(parts) <= set(PARTS):
        p.error(f"--parts takes a comma list of {', '.join(PARTS)}")
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",")
    if not set(order) <= set(trees):
        p.error(f"--order names {sorted(set(order) - set(trees))}, not given by --tree")
    out = Path(args.out).resolve()
    runs = []
    for i, name in enumerate(order):
        runs.append(run_tree(name, Path(trees[name]).resolve(), out / f"{i}_{name}", parts))
        print(_line(i, runs[-1]), flush=True)
    from dlbb_tpu_torch.utils.config import save_json

    result = {"order": order, "parts": parts, "trees": trees, "runs": runs}
    save_json(result, out / "ab.json")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
