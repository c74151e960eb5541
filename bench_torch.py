#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port (counterpart of ``bench.py``):
prints ONE JSON line, ``{"metric": ..., "value": N, "unit": ...,
"vs_baseline": N}``, and on one GPU an ``"extras"`` key with ``bench.py``'s
secondary lines under its names.

    python3 bench_torch.py

Two regimes, chosen by the number of CUDA devices, as ``bench.py`` chooses
by its accelerator devices:

- **>= 2 GPUs**: the reference's headline, 1D allreduce bus bandwidth at
  the "16MB" label (4,194,304 bf16 elements = 8 MiB) on one NCCL rank per
  GPU (``bench/launch.py``), the slowest iteration of the slowest rank;
  ``vs_baseline`` is against DeepSpeed+oneCCL's 23.29 GB/s at 16 ranks
  (BASELINE.md).
- **1 GPU**: the 1B decoder's forward, "simplified" attention, bf16, B=8,
  S=512, through ``dlbb_tpu_torch.bench.e2e.run_e2e`` (3 warmup, 10 timed
  forwards), in tokens/s.  ``vs_baseline`` divides by the reference
  stack's torch-CPU forward cached in ``bench_baseline_cpu.json`` (measured
  on the JAX package's host, not on the card).  The extras are
  ``bench.py``'s: the 7B and the 1B at S=512 under several attentions, the
  full/dense pair at S=1024, flash at S=8192, and the 1B Adam train step
  (``dlbb_tpu_torch/configs/train_1b_adam_bf16m.yaml``).

An extra that fails is recorded under ``"failed"`` (``{key: "Type:
message"}``); the line is still printed, and the script exits 1.  With no
CUDA device it prints the reason on stderr, no line, and exits 1: the port
has no CPU fallback.  Everything but the JSON line goes to stderr.
"""

from __future__ import annotations

import json
import sys
import traceback
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parent
CPU_BASELINE_CACHE = REPO / "bench_baseline_cpu.json"
TRAIN_CONFIG = REPO / "dlbb_tpu_torch" / "configs" / "train_1b_adam_bf16m.yaml"

# DeepSpeed+oneCCL allreduce "16MB" @ 16 ranks (BASELINE.md)
ONECCL_BASELINE_GBPS = 23.29

E2E_BATCH, E2E_SEQ = 8, 512

# bench.py's extras, in its order: (model size, attention, sequence length)
EXTRAS = (
    ("7B", "simplified", E2E_SEQ), ("7B", "full", E2E_SEQ),
    ("1B", "full", E2E_SEQ), ("1B", "dense", E2E_SEQ),
    ("1B", "full", 1024), ("1B", "dense", 1024),
    ("1B", "flash", 8192),
)
TRAIN_EXTRA = "1B_train_adam_bf16m"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def extra_key(size: str, attention: str, seq: int) -> str:
    """An extra's name in the line, as ``bench.py`` forms it."""
    return f"{size}_{attention}" if seq == E2E_SEQ else f"{size}_{attention}_s{seq}"


def _allreduce_rank(num_elements: int, warmup: int, iterations: int, device):
    """One rank of ``bench_allreduce_multichip``: this rank's timings of
    the allreduce over the whole world, and their metadata."""
    import torch
    import torch.distributed as dist

    from dlbb_tpu_torch.comm import MeshSpec, get_mesh, get_op, make_payload
    from dlbb_tpu_torch.utils.sysinfo import resolve_device
    from dlbb_tpu_torch.utils.timing import time_collective

    dev = resolve_device(device)
    world = dist.get_world_size()
    mesh = get_mesh(MeshSpec.ring(world))
    op = get_op("allreduce")
    x = make_payload(op, mesh.rank, world, num_elements, dtype=torch.bfloat16,
                     device=dev)
    return time_collective(op.build(mesh, 0), x, mesh.group, warmup=warmup,
                           iterations=iterations, device=dev)


def bench_allreduce_multichip(
    n: int,
    num_elements: int = 4_194_304,  # the reference's "16MB" label
    warmup: int = 10,
    iterations: int = 100,
    device=None,
) -> dict:
    from dlbb_tpu_torch.bench.launch import launch
    from dlbb_tpu_torch.stats.stats1d import calculate_bandwidth

    ranks = launch(_allreduce_rank, n, device,
                   args=(num_elements, warmup, iterations, device))
    max_t = max(max(timings) for timings, _ in ranks)
    meta = ranks[0][1]
    bw = calculate_bandwidth(num_elements, "bfloat16", max_t, "allreduce", n)
    # the reference's 2x-off size label ("16MB" = 4,194,304 elements = 8 MiB)
    label = f"{num_elements * 4 / 2**20:g}MB"
    log(f"allreduce {label} x{n} ranks: max {max_t * 1e3:.3f} ms, "
        f"{bw:.2f} GB/s ({meta['timing_mode']})")
    return {
        "metric": f"1d_allreduce_{label}_bus_bandwidth_{n}ranks",
        "value": round(bw, 3),
        "unit": "GB/s",
        # from the published (rounded) value, as bench.py
        "vs_baseline": round(round(bw, 3) / ONECCL_BASELINE_GBPS, 3),
        "timing_mode": meta["timing_mode"],
        "timing_granularity": meta["timing_granularity"],
        "num_elements": num_elements,
        "max_time_s": max_t,
    }


def _cpu_baseline() -> dict:
    """The reference stack's torch-CPU 1B forward, as ``bench.py`` cached it.
    Its measurer (``dlbb_tpu/bench/torch_baseline.py``) is not ported, by
    decision, so a missing cache is an error, never a new measurement."""
    if not CPU_BASELINE_CACHE.exists():
        raise FileNotFoundError(
            f"{CPU_BASELINE_CACHE} is missing: the headline's baseline is the "
            "JAX package's cached torch-CPU measurement, which the port does "
            "not re-measure")
    cached = json.loads(CPU_BASELINE_CACHE.read_text())
    log(f"cpu baseline (cached): {cached['tokens_per_second']:.0f} tok/s")
    return cached


def _e2e(size: str, attention: str, iters: int = 10, seq: Optional[int] = None,
         device=None) -> dict:
    from dlbb_tpu_torch.bench.e2e import run_e2e

    seq = E2E_SEQ if seq is None else seq
    config = {
        "experiment": {"name": f"bench_{size.lower()}_{attention}_s{seq}"
                               "_world1"},
        "model": {"size": size, "attention": attention},
        "parallelism": {"world_size": 1, "data_parallel": 1},
        "input": {"batch_size": E2E_BATCH, "sequence_length": seq,
                  "seed": 42},
        "execution": {"warmup_iterations": 3, "benchmark_iterations": iters},
    }
    result = run_e2e(config, device=device, verbose=False)
    log(f"{result['system_info']['device_kind']} {size}/{attention} S={seq} "
        f"forward: {result['forward_time']['mean'] * 1e3:.2f} ms, "
        f"{result['tokens_per_second']:.0f} tok/s, "
        f"{result['achieved_tflops_per_second']:.1f} TFLOP/s "
        f"({result['timing_mode']})")
    return result


def _free_device_memory(device) -> None:
    """Return the last extra's freed weights to the card before the next
    one allocates (two 7B models do not sit beside each other)."""
    import torch

    if device is None or str(device).startswith("cuda"):
        torch.cuda.empty_cache()


def bench_e2e_single_chip(device=None) -> dict:
    baseline = _cpu_baseline()
    result = _e2e("1B", "simplified", device=device)
    tps = result["tokens_per_second"]
    out = {
        "metric": "e2e_1B_forward_throughput_vs_reference_cpu_stack",
        "value": round(tps, 1),
        "unit": "tokens/s",
        # published-value consistency, as in bench_allreduce_multichip
        "vs_baseline": round(
            round(tps, 1) / baseline["tokens_per_second"], 3),
    }
    del result
    _free_device_memory(device)
    extras, failed = {}, {}
    for size, attention, seq in EXTRAS:
        key = extra_key(size, attention, seq)
        try:
            r = _e2e(size, attention, iters=10, seq=seq, device=device)
            extras[key] = {
                "tokens_per_second": round(r["tokens_per_second"], 1),
                "achieved_tflops_per_second":
                    round(r["achieved_tflops_per_second"], 2),
                "forward_mean_ms":
                    round(r["forward_time"]["mean"] * 1e3, 3),
            }
        except Exception as e:  # noqa: BLE001 — recorded in the line, exit 1
            failed[key] = f"{type(e).__name__}: {e}"
            log(f"extra bench {key} failed: {failed[key]}")
            traceback.print_exc()
        _free_device_memory(device)
    try:
        r = _train_step_bench(device)
        extras[TRAIN_EXTRA] = {
            "tokens_per_second": round(r["tokens_per_second"], 1),
            "achieved_tflops_per_second":
                round(r["achieved_tflops_per_second"], 2),
            "achieved_tflops_per_second_incl_recompute":
                round(r["achieved_tflops_per_second_incl_recompute"], 2),
            "step_mean_ms": round(r["step_time"]["mean"] * 1e3, 3),
            "remat_policy": r["remat_policy"],
        }
    except Exception as e:  # noqa: BLE001 — recorded in the line, exit 1
        failed[TRAIN_EXTRA] = f"{type(e).__name__}: {e}"
        log(f"train bench failed: {failed[TRAIN_EXTRA]}")
        traceback.print_exc()
    if extras:
        out["extras"] = extras
    if failed:
        out["failed"] = failed
    return out


def _train_step_bench(device=None) -> dict:
    from dlbb_tpu_torch.train.loop import run_train
    from dlbb_tpu_torch.utils.config import load_config

    r = run_train(load_config(TRAIN_CONFIG), zero_stage=0, device=device,
                  verbose=False)
    log(f"{r['system_info']['device_kind']} 1B train step (adam/bf16m, "
        f"remat={r['remat_policy']}): {r['step_time']['mean'] * 1e3:.2f} ms, "
        f"{r['tokens_per_second']:.0f} tok/s, "
        f"{r['achieved_tflops_per_second']:.1f} TFLOP/s model "
        f"({r['achieved_tflops_per_second_incl_recompute']:.1f} incl "
        "recompute)")
    return r


def main(device=None) -> int:
    """The benchmark on ``device`` (the card unless the caller names
    ``"cpu"``); returns the exit code."""
    import torch

    if device is None and not torch.cuda.is_available():
        log("bench_torch: no CUDA device; the port measures on the card only, "
            "and nothing was run")
        return 1
    n = torch.cuda.device_count() if device is None else 1
    if device is None:
        log(f"devices: {n} x {torch.cuda.get_device_name(0)}")
    if n >= 2:
        out = bench_allreduce_multichip(n, device=device)
    else:
        out = bench_e2e_single_chip(device)
    print(json.dumps(out), flush=True)
    return 1 if out.get("failed") else 0


if __name__ == "__main__":
    sys.exit(main())
