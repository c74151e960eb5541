"""Command line (counterpart of ``dlbb_tpu/cli.py``): the ``e2e`` and
``train`` subcommands.

    python -m dlbb_tpu_torch.cli e2e --config CONFIG.yaml [--output DIR]
                                     [--device cuda|cpu]
    python -m dlbb_tpu_torch.cli train --config CONFIG.yaml [--output DIR]
                                       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dlbb_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    e2 = sub.add_parser("e2e", help="end-to-end transformer forward benchmark")
    e2.add_argument("--config", required=True, help="YAML experiment config")
    e2.add_argument("--output", default=None)
    e2.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; without a CUDA device "
                         "only an explicit cpu runs")
    tr = sub.add_parser("train", help="single-device training step benchmark")
    tr.add_argument("--config", required=True, help="YAML experiment config")
    tr.add_argument("--output", default=None)
    tr.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; without a CUDA device "
                         "only an explicit cpu runs")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "e2e":
        from dlbb_tpu_torch.bench.e2e import run_e2e_from_config

        result = run_e2e_from_config(args.config, output_dir=args.output,
                                     device=args.device)
        print(f"forward mean {result['forward_time']['mean'] * 1e3:.3f} ms")
        return 0
    if args.cmd == "train":
        from dlbb_tpu_torch.train.loop import run_train_from_config

        result = run_train_from_config(args.config, output_dir=args.output,
                                       device=args.device)
        print(f"step mean {result['step_time']['mean'] * 1e3:.3f} ms")
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
