"""Command line (counterpart of ``dlbb_tpu/cli.py``).

    python -m dlbb_tpu_torch.cli e2e --config CONFIG.yaml [--output DIR]
                                     [--world N] [--device cuda|cpu]
                                     [--tp-overlap off|ring|bidir]
    python -m dlbb_tpu_torch.cli train --config CONFIG.yaml [--output DIR]
                                       [--world N] [--zero STAGE | --zero1]
                                       [--device cuda|cpu]
                                       [--tp-overlap off|ring|bidir]
    python -m dlbb_tpu_torch.cli bench1d [--ops ...] [--sizes ...] [--ranks ...]
                                         [--world N] [--device cuda|cpu] ...
    python -m dlbb_tpu_torch.cli bench3d [--ops ...] [--batch ...] [--seq ...]
                                         [--hidden ...] [--ranks ...] ...
    python -m dlbb_tpu_torch.cli stats1d --input DIR --output DIR
    python -m dlbb_tpu_torch.cli stats3d --input DIR --output DIR [--impl NAME]

The sweeps launch ``--world`` ranks (default: the largest of ``--ranks``)
through ``bench/launch.py``: NCCL with one GPU per rank on ``cuda``, gloo
on ``cpu``.  ``e2e`` does the same with ``--world`` ranks (default: the
config's mesh, dp x tp x sp x pp x ep), and so does ``train``; at world 1
they run in this process with no process group.  Under ``torchrun`` they
run in place as their rank.  ``--tp-overlap`` overrides the config's
``model.tp_overlap``, so one YAML sweeps fused against ring and bidir.
The YAML's ``parallelism:`` section sets every axis of the JAX package's
mesh, ``pipeline_parallel`` (with ``num_microbatches``) and
``expert_parallel`` included; ``model.num_experts``, ``moe_top_k`` and
``moe_dispatch`` select the MoE FFN, and ``training.pipeline_schedule``
("gpipe" or "1f1b") and ``training.moe_aux_loss_weight`` the pipeline's
training schedule and the load-balancing loss.
"""

from __future__ import annotations

import argparse
import sys

_DEVICE_HELP = "cuda (the default) or cpu; without a CUDA device only an explicit cpu runs"
_OVERLAP_HELP = ("override model.tp_overlap: ring-decomposed overlapped "
                 "tensor-parallel projections (needs tp > 1)")


def _add_sweep_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--variant", default="default", help="named tuning variant")
    p.add_argument("--ranks", type=int, nargs="+", default=None,
                   help="rank counts to sweep")
    p.add_argument("--world", type=int, default=None,
                   help="ranks to launch (default: the largest of --ranks)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float16", "float32"])
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--output", default=None, help="output directory for result JSONs")
    p.add_argument("--max-config-seconds", type=float, default=None,
                   help="wall-time cap per config (iteration counts scale down)")
    p.add_argument("--max-global-bytes", type=int, default=None,
                   help="skip configs whose global input+output exceeds this")
    p.add_argument("--resume", action="store_true",
                   help="skip configs whose result JSON already exists and validates")
    p.add_argument("--device", default=None, help=_DEVICE_HELP)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dlbb_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    e2 = sub.add_parser("e2e", help="end-to-end transformer forward benchmark")
    e2.add_argument("--config", required=True, help="YAML experiment config")
    e2.add_argument("--output", default=None)
    e2.add_argument("--world", type=int, default=None,
                    help="ranks to launch (default: the config's mesh size)")
    e2.add_argument("--device", default=None, help=_DEVICE_HELP)
    e2.add_argument("--tp-overlap", choices=("off", "ring", "bidir"), default=None,
                    help=_OVERLAP_HELP)
    tr = sub.add_parser("train", help="DDP/ZeRO-{1,2,3} training-loop benchmark")
    tr.add_argument("--config", required=True, help="YAML experiment config")
    tr.add_argument("--zero1", action="store_true", help="shard optimizer state (ZeRO-1)")
    tr.add_argument("--zero", type=int, default=None, choices=(0, 1, 2, 3),
                    metavar="STAGE", dest="zero_stage",
                    help="ZeRO stage: 0=DDP, 1=opt-state sharding, "
                         "2=+grad reduce-scatter, 3=FSDP param sharding")
    tr.add_argument("--output", default=None)
    tr.add_argument("--world", type=int, default=None,
                    help="ranks to launch (default: the config's mesh size)")
    tr.add_argument("--device", default=None, help=_DEVICE_HELP)
    tr.add_argument("--tp-overlap", choices=("off", "ring", "bidir"), default=None,
                    help=_OVERLAP_HELP)

    b1 = sub.add_parser("bench1d", help="1D collective microbenchmark sweep")
    _add_sweep_args(b1)
    b1.add_argument("--ops", nargs="+", default=None, help="collectives to benchmark")
    b1.add_argument("--sizes", nargs="+", default=None,
                    help="size labels (1KB 64KB 1MB 16MB 64MB 256MB 1GB) or 'extended'")
    b3 = sub.add_parser("bench3d", help="3D (batch, seq, hidden) tensor collective sweep")
    _add_sweep_args(b3)
    b3.add_argument("--ops", nargs="+", default=None)
    b3.add_argument("--batch", type=int, nargs="+", default=None)
    b3.add_argument("--seq", type=int, nargs="+", default=None)
    b3.add_argument("--hidden", type=int, nargs="+", default=None)

    s1 = sub.add_parser("stats1d", help="process 1D result JSONs to stats + CSV")
    s1.add_argument("--input", required=True)
    s1.add_argument("--output", required=True)
    s1.add_argument("--algorithm-bandwidth", action="store_true",
                    help="per-op bus-bandwidth factors instead of the "
                         "reference's uniform formula")
    s3 = sub.add_parser("stats3d", help="process 3D result JSONs to standard+transposed CSVs")
    s3.add_argument("--input", required=True)
    s3.add_argument("--output", required=True)
    s3.add_argument("--impl", default="torch_nccl", help="names the CSV files")
    return p


def _sweep(args):
    from dlbb_tpu_torch.bench import runner

    common = dict(
        variant=args.variant, dtype=args.dtype, warmup_iterations=args.warmup,
        measurement_iterations=args.iters, max_config_seconds=args.max_config_seconds,
        max_global_bytes=args.max_global_bytes, resume=args.resume)
    if args.ranks:
        common["rank_counts"] = tuple(args.ranks)
    if args.ops:
        common["operations"] = tuple(args.ops)
    if args.cmd == "bench3d":
        for flag, name in (("batch", "batch_sizes"), ("seq", "seq_lengths"),
                           ("hidden", "hidden_dims")):
            if getattr(args, flag):
                common[name] = tuple(getattr(args, flag))
        return runner.Sweep3D(output_dir=args.output or "results/3d", **common)
    if args.sizes == ["extended"]:
        common["data_sizes"] = tuple(runner.EXTENDED_DATA_SIZES_1D.items())
    elif args.sizes:
        table = runner.EXTENDED_DATA_SIZES_1D
        unknown = [s for s in args.sizes if s not in table]
        if unknown:
            raise SystemExit(f"unknown size labels {unknown}; known: {list(table)}")
        common["data_sizes"] = tuple((s, table[s]) for s in args.sizes)
    return runner.Sweep1D(output_dir=args.output or "results/1d", **common)


def e2e_worker(config, output_dir, device):
    """One rank of ``e2e`` (launched by name)."""
    from dlbb_tpu_torch.bench.e2e import run_e2e

    return run_e2e(config, device=device, output_dir=output_dir)


def train_worker(config, output_dir, device, zero1, zero_stage):
    """One rank of ``train`` (launched by name)."""
    from dlbb_tpu_torch.train.loop import run_train

    return run_train(config, zero1=zero1, zero_stage=zero_stage, device=device,
                     output_dir=output_dir)


def _launched(args, worker, *extra):
    """``worker`` on ``--world`` ranks (default: the config's mesh size), or
    in this process at world 1; rank 0's result."""
    import math
    import os

    from dlbb_tpu_torch.bench.launch import launch
    from dlbb_tpu_torch.parallel.plan import degrees
    from dlbb_tpu_torch.utils.config import load_config

    config = load_config(args.config)
    if args.tp_overlap is not None:
        config.setdefault("model", {})["tp_overlap"] = args.tp_overlap
    output_dir = args.output or config.get("experiment", {}).get("output_dir")
    world = args.world or math.prod(degrees(config))
    worker_args = (config, output_dir, args.device, *extra)
    if world == 1 and "WORLD_SIZE" not in os.environ:
        return worker(*worker_args)
    return launch(worker, world, args.device, args=worker_args)[0]


def sweep_worker(sweep, device):
    """One rank of ``bench1d``/``bench3d`` (launched by name)."""
    from dlbb_tpu_torch.bench.runner import run_sweep

    return run_sweep(sweep, device=device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "e2e":
        result = _launched(args, e2e_worker)
        print(f"forward mean {result['forward_time']['mean'] * 1e3:.3f} ms "
              f"over {len(result['per_host_means_s'])} rank(s)")
        return 0
    if args.cmd == "train":
        result = _launched(args, train_worker, args.zero1, args.zero_stage)
        if result.get("preempted") and "step_time" not in result:
            print(f"preempted at step {result['preempted_at_step']}; "
                  "checkpoint saved — resume to continue")
            return 0
        print(f"step mean {result['step_time']['mean'] * 1e3:.3f} ms over "
              f"{len(result['per_host_means_s'])} rank(s)")
        return 0
    if args.cmd in ("bench1d", "bench3d"):
        from dlbb_tpu_torch.bench.launch import launch

        sweep = _sweep(args)
        world = args.world or max(sweep.rank_counts)
        results = launch(sweep_worker, world, args.device, args=(sweep, args.device))
        failed = [f for r in results for f in r.failed]
        print(f"{len(results[0].written)} result artifacts in {sweep.output_dir}; "
              f"{len(failed)} failed config(s) over {world} rank(s)")
        for f in failed:
            print(f"  failed: {f['config']}: {f['error']}")
        return 1 if failed else 0
    if args.cmd == "stats1d":
        from dlbb_tpu_torch.stats import process_1d_results

        results = process_1d_results(args.input, args.output,
                                     algorithm_bandwidth=args.algorithm_bandwidth)
        print(f"processed {len(results)} result files")
        return 0
    if args.cmd == "stats3d":
        from dlbb_tpu_torch.stats import process_3d_results

        results = process_3d_results(args.input, args.output, args.impl)
        print(f"processed {len(results)} result files")
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
