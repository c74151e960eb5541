"""End-to-end forward benchmark at world size 1 (counterpart of
``dlbb_tpu/bench/e2e.py``).

YAML config in, decoder + fixed synthetic batch, warmup + timed forward
passes, metrics JSON out, in the JAX harness's result schema with
``backend: "torch_cuda"``.  The first forward is timed on its own as
``compile_time_s``: here it holds the kernel build (at a process's first
launch) and the libraries' first-call set-up, not an XLA compile.  The
result also records ``flash_launches``, the flash kernel launches of the
timed forwards.  Multi-device configs are refused: meshes are a later slice.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from dlbb_tpu_torch.data.synthetic import create_dataset_from_config
from dlbb_tpu_torch.models.configs import ModelConfig
from dlbb_tpu_torch.models.transformer import (
    DTYPES,
    forward,
    forward_flops,
    init_params,
    num_parameters,
)
from dlbb_tpu_torch.ops import flash_attention as flash_mod
from dlbb_tpu_torch.utils.config import load_config, save_json
from dlbb_tpu_torch.utils.metrics import Timer, summarize
from dlbb_tpu_torch.utils.sysinfo import collect_system_info, resolve_device
from dlbb_tpu_torch.utils.timing import time_fn_per_iter


def check_world_one(config: dict[str, Any]) -> None:
    """Refuse configs that need more than one device (a later slice)."""
    par = config.get("parallelism", {}) or {}
    for key in ("world_size", "data_parallel", "sequence_parallel",
                "pipeline_parallel", "expert_parallel"):
        if int(par.get(key, 1)) > 1:
            raise NotImplementedError(
                f"parallelism.{key}={par[key]}: dlbb_tpu_torch runs on one "
                "device so far (multi-device is a later slice)")


def run_e2e(config: dict[str, Any], device=None,
            output_dir: Optional[str] = None,
            verbose: bool = True) -> dict[str, Any]:
    """Run the benchmark described by ``config`` on ``device`` (``cuda``
    unless the caller passes another; raises without CUDA)."""
    device = resolve_device(device)
    check_world_one(config)
    inp = config["input"]
    with Timer(sync=device) as t_init:
        model_cfg = ModelConfig.from_dict(config["model"])
        params = init_params(model_cfg, inp.get("seed", 42), device)
        dataset = create_dataset_from_config(
            config, dtype=DTYPES[model_cfg.dtype], device=device,
            hidden_size=model_cfg.hidden_size)
        batch = dataset.get_batch()
    init_time = t_init.elapsed

    execution = config.get("execution", {})
    warmup = execution.get("warmup_iterations", 5)
    iters = execution.get("benchmark_iterations", 10)

    @torch.inference_mode()
    def step():
        return forward(params, batch, model_cfg)

    with Timer(sync=device) as t_first:
        out = step()
    compile_time = t_first.elapsed
    if not bool(torch.isfinite(out).all()):
        raise FloatingPointError("the forward produced non-finite values")

    for _ in range(warmup - 1):
        step()
    launches_before = flash_mod.flash_fwd_launches
    forward_times = time_fn_per_iter(step, iterations=iters, device=device)
    timed_launches = flash_mod.flash_fwd_launches - launches_before

    local_mean = float(np.mean(forward_times))
    tokens = inp["batch_size"] * inp["sequence_length"]
    flops = forward_flops(model_cfg, inp["batch_size"], inp["sequence_length"])
    on_cuda = device.type == "cuda"
    result = {
        "experiment": config.get("experiment", {}),
        "backend": "torch_cuda",
        "device": str(device),
        "config": config,
        "model": {
            "num_parameters": num_parameters(model_cfg),
            "attention": model_cfg.attention,
            "dtype": model_cfg.dtype,
            "tp_overlap": model_cfg.tp_overlap,
        },
        "mesh": {"dp": 1, "sp": 1, "pp": 1, "ep": 1, "tp": 1},
        "init_time_s": init_time,
        "compiler_options": None,
        "compile_time_s": compile_time,
        "forward_time": summarize(forward_times),
        "timing_mode": "per_iter",
        "timing_method": ("torch.cuda.Event pairs per iteration" if on_cuda
                          else "time.perf_counter() per iteration (CPU)"),
        "per_host_means_s": [local_mean],
        "cross_host_variance": 0.0,
        "cross_host_cv": 0.0,
        "tokens_per_second": tokens / local_mean,
        "model_flops_per_forward": flops,
        "achieved_tflops_per_second": flops / local_mean / 1e12,
        "flash_launches": timed_launches,
        "timings": [forward_times],
        "system_info": collect_system_info(device),
        "timestamp": time.time(),
    }

    if verbose:
        ft = result["forward_time"]
        print(
            f"[e2e] {config.get('experiment', {}).get('name', 'experiment')} "
            f"on {result['system_info']['device_kind']}: forward mean "
            f"{ft['mean'] * 1e3:.3f} ms (p95 {ft['p95'] * 1e3:.3f} ms), "
            f"first call {compile_time:.2f} s, "
            f"{result['tokens_per_second']:.0f} tok/s"
        )

    if output_dir is not None:
        name = config.get("experiment", {}).get("name", "experiment")
        save_json(result, Path(output_dir) / f"torch_cuda_{name}.json")
    return result


def run_e2e_from_config(config_path: str, output_dir: Optional[str] = None,
                        device=None) -> dict[str, Any]:
    config = load_config(config_path)
    out = output_dir or config.get("experiment", {}).get("output_dir")
    return run_e2e(config, device=device, output_dir=out)
