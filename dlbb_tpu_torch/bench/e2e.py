"""End-to-end forward benchmark (counterpart of ``dlbb_tpu/bench/e2e.py``).

YAML config in, decoder + fixed synthetic batch, warmup + timed forward
passes, metrics JSON out, in the JAX harness's result schema with
``backend: "torch_cuda"``.  The first forward is timed on its own as
``compile_time_s``: here it holds the kernel build (at a process's first
launch) and the libraries' first-call set-up, not an XLA compile.  The
result also records ``flash_launches``, this rank's flash kernel launches
in the timed forwards.

Without a process group it runs on one device, with no
``torch.distributed`` at all.  Inside one (``bench/launch.py``, as ``cli
e2e --world N`` starts it), ``parallel/plan.py::ParallelismPlan`` checks
the config against the world and builds the (dp[, sp][, pp][, ep], tp)
mesh: each rank draws its part of the model (``init_params``: its stage's
layers, its experts, its tensor-parallel shards) and its dp rows and sp
slice of the batch (``sharding.batch_spec``, of each microbatch over pp;
the batch is whole over pp and ep), and runs the tensor-parallel forward, overlapped under
``model.tp_overlap``, with ring or Ulysses attention over sp, pipelined in
the plan's ``num_microbatches`` over pp, and its experts over ep.  ``transport`` says how its ring hops
moved (``transformer.ring_transport``), None where it made none.  Each timed
iteration is a barrier on the world group and then the forward, and its
time is the slowest rank's, since the JAX number is one SPMD step;
``per_host_means_s`` holds each rank's own mean, and the cross-host
variance and CV are over ranks (the reference's cross-rank CV,
``run_mpi.py:199-212``).  World rank 0 writes the result.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from dlbb_tpu_torch.data.synthetic import create_dataset_from_config
from dlbb_tpu_torch.models.configs import ModelConfig
from dlbb_tpu_torch.models.sharding import batch_spec
from dlbb_tpu_torch.models.transformer import (
    DTYPES,
    forward,
    forward_flops,
    init_params,
    num_parameters,
    ring_transport,
)
from dlbb_tpu_torch.ops import flash_attention as flash_mod
from dlbb_tpu_torch.parallel.plan import ParallelismPlan
from dlbb_tpu_torch.utils.config import save_json
from dlbb_tpu_torch.utils.metrics import Timer, summarize
from dlbb_tpu_torch.utils.sysinfo import collect_system_info, resolve_device
from dlbb_tpu_torch.utils.timing import time_fn_per_iter, time_fn_per_iter_spmd


def run_e2e(config: dict[str, Any], device=None,
            output_dir: Optional[str] = None,
            verbose: bool = True) -> dict[str, Any]:
    """Run the benchmark described by ``config`` on ``device`` (``cuda``
    unless the caller passes another; raises without CUDA), on this rank of
    the process group if there is one (module docstring)."""
    device = resolve_device(device)
    inp = config["input"]
    with Timer(sync=device) as t_init:
        model_cfg = ModelConfig.from_dict(config["model"])
        plan = ParallelismPlan.from_config(config, model_cfg)
        mesh = plan.mesh
        params = init_params(model_cfg, inp.get("seed", 42), device, **plan.coords())
        dataset = create_dataset_from_config(
            config, dtype=DTYPES[model_cfg.dtype], device=device,
            hidden_size=model_cfg.hidden_size,
            **batch_spec(mesh, plan.num_microbatches or 1))
        batch = dataset.get_batch()
    init_time = t_init.elapsed
    lead = mesh is None or dist.get_rank() == 0

    execution = config.get("execution", {})
    warmup = execution.get("warmup_iterations", 5)
    iters = execution.get("benchmark_iterations", 10)

    @torch.inference_mode()
    def step():
        return forward(params, batch, model_cfg, mesh=mesh,
                       num_microbatches=plan.num_microbatches)

    with Timer(sync=device) as t_first:
        out = step()
    compile_time = t_first.elapsed
    if not bool(torch.isfinite(out).all()):
        raise FloatingPointError("the forward produced non-finite values")

    for _ in range(warmup - 1):
        step()
    launches_before = flash_mod.flash_fwd_launches
    on_cuda = device.type == "cuda"
    if mesh is None:
        forward_times = time_fn_per_iter(step, iterations=iters, device=device)
        host_means = np.asarray([np.mean(forward_times)])
        timing_method = ("torch.cuda.Event pairs per iteration" if on_cuda
                         else "time.perf_counter() per iteration (CPU)")
    else:
        forward_times, local = time_fn_per_iter_spmd(
            step, iterations=iters, device=device, group=dist.group.WORLD)
        means: list[Any] = [None] * dist.get_world_size()
        dist.all_gather_object(means, float(np.mean(local)))
        host_means = np.asarray(means)
        timing_method = (
            "barrier on the world group, then "
            + ("a torch.cuda.Event pair around the forward, synchronize"
               if on_cuda else "time.perf_counter() around the forward (CPU)")
            + "; each iteration's time is the slowest rank's")
    timed_launches = flash_mod.flash_fwd_launches - launches_before

    step_mean = float(np.mean(forward_times))
    tokens = inp["batch_size"] * inp["sequence_length"]
    flops = forward_flops(model_cfg, inp["batch_size"], inp["sequence_length"])
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
        "mesh": plan.mesh_dict(),
        "transport": ring_transport(model_cfg, mesh, device),
        "init_time_s": init_time,
        "compiler_options": None,
        "compile_time_s": compile_time,
        "forward_time": summarize(forward_times),
        "timing_mode": "per_iter",
        "timing_method": timing_method,
        "per_host_means_s": host_means.tolist(),
        "cross_host_variance": float(host_means.var()),
        "cross_host_cv": float(host_means.std() / host_means.mean()),
        "tokens_per_second": tokens / step_mean,
        "model_flops_per_forward": flops,
        "achieved_tflops_per_second": flops / step_mean / 1e12,
        "flash_launches": timed_launches,
        "timings": [forward_times],
        "system_info": collect_system_info(device),
        "timestamp": time.time(),
    }

    if verbose and lead:
        ft = result["forward_time"]
        print(
            f"[e2e] {config.get('experiment', {}).get('name', 'experiment')} "
            f"on {result['system_info']['device_kind']}: forward mean "
            f"{ft['mean'] * 1e3:.3f} ms (p95 {ft['p95'] * 1e3:.3f} ms), "
            f"first call {compile_time:.2f} s, "
            f"{result['tokens_per_second']:.0f} tok/s"
        )

    if output_dir is not None and lead:
        name = config.get("experiment", {}).get("name", "experiment")
        save_json(result, Path(output_dir) / f"torch_cuda_{name}.json")
    return result

