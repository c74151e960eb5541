"""Single-device training step and benchmark (counterpart of
``dlbb_tpu/train/loop.py``).

``make_train_step`` returns a step function and its initial ``TrainState``;
``step(state, batch, targets) -> (new_state, loss)`` takes the MSE loss
against a fixed target batch (``mse_loss``, the reference's
``test/ccl.py:110``), its gradients by autograd through ``forward`` (the
flash kernels' ``torch.autograd.Function`` and remat included), and one
optimizer update (``train/optim.py``).  ``run_train`` is the config-driven
benchmark: warmup, timed steps by CUDA events (``time_fn_per_iter``), and the
JAX harness's result schema with ``backend: "torch_cuda"``, plus the flash
kernels' launches per step.

Only ZeRO stage 0 at world size 1 with ``grad_accum=1`` is ported: the
sharded stages, gradient accumulation, checkpointing, preemption, gradient
compression and the MoE aux loss wait for later slices (ROADMAP.md, Queue 1,
Slices C and D) and are refused, never ignored.  The JAX package's chained
timing regime exists for a remotely attached TPU and is not ported.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from dlbb_tpu_torch.data.synthetic import create_dataset_from_config
from dlbb_tpu_torch.models.configs import ModelConfig
from dlbb_tpu_torch.models.transformer import DTYPES, forward, forward_flops, init_params
from dlbb_tpu_torch.ops import flash_attention as flash_mod
from dlbb_tpu_torch.train.optim import (
    GradientTransformation,
    apply_updates,
    build_optimizer,
    learning_rate,
    moments_dtype,
    resolve_names,
    tree_leaves,
    tree_map,
)
from dlbb_tpu_torch.utils.config import load_config, save_json
from dlbb_tpu_torch.utils.metrics import Timer, summarize
from dlbb_tpu_torch.utils.sysinfo import collect_system_info, resolve_device
from dlbb_tpu_torch.utils.timing import time_fn_per_iter

MODE_NAMES = {0: "ddp", 1: "zero1", 2: "zero2", 3: "zero3"}

# Approximate per-parameter update FLOPs for the utilisation accounting
# (the JAX package's table)
OPTIMIZER_FLOPS_PER_PARAM = {"adam": 18, "adamw": 22, "sgd": 6,
                             "adafactor": 14}

_LATER = "is not ported to dlbb_tpu_torch yet (a later slice: ROADMAP.md, Queue 1"


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def mse_loss(params, batch, targets, config: ModelConfig) -> torch.Tensor:
    """MSE of the forward against the target batch, in fp32."""
    pred = forward(params, batch, config)
    return torch.mean((pred.float() - targets.float()) ** 2)


def resolve_zero_stage(zero1: bool = False,
                       zero_stage: Optional[int] = None) -> int:
    """Collapse the legacy ``zero1`` flag and ``zero_stage`` into 0-3."""
    if zero_stage is not None:
        if zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0-3, got {zero_stage}")
        return zero_stage
    return 1 if zero1 else 0


def _check_stage_zero(stage: int) -> None:
    if stage != 0:
        raise NotImplementedError(
            f"ZeRO stage {stage} ({MODE_NAMES[stage]}) shards state over a "
            f"data-parallel mesh and {_LATER}, Slice D)")


def make_train_step(config: ModelConfig, optimizer: GradientTransformation,
                    params, zero1: bool = False,
                    zero_stage: Optional[int] = None, grad_accum: int = 1):
    """(step fn, initial ``TrainState``) at ZeRO stage 0 on one device.

    The step is functional, as the JAX one is: it returns new parameter and
    optimizer-state tensors and leaves the old ones to the caller (who drops
    them by rebinding the state)."""
    _check_stage_zero(resolve_zero_stage(zero1, zero_stage))
    if grad_accum != 1:
        raise NotImplementedError(f"gradient accumulation {_LATER}, Slice D)")
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    state = TrainState(params, optimizer.init(params), 0)

    def step(state: TrainState, batch, targets):
        leaves = tree_leaves(state.params)
        loss = mse_loss(state.params, batch, targets, config)
        grads = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _: next(grads), state.params)
        with torch.no_grad():
            updates, new_opt = optimizer.update(grads, state.opt_state, state.params)
            new_params = apply_updates(state.params, updates)
        new_params = tree_map(lambda p: p.requires_grad_(True), new_params)
        return TrainState(new_params, new_opt, state.step + 1), loss.detach()

    return step, state


def _refuse_unported(train_cfg: dict[str, Any], execution: dict[str, Any]) -> None:
    """Config keys whose features wait for later slices raise here."""
    if "checkpoint" in train_cfg:
        raise NotImplementedError(f"training.checkpoint {_LATER}, Slice D)")
    if str(train_cfg.get("grad_compression", "none")) != "none":
        raise NotImplementedError(
            f"training.grad_compression {train_cfg['grad_compression']!r} "
            f"{_LATER}, Slice C)")
    if str(train_cfg.get("compression_accum_dtype", "float32")) != "float32":
        raise NotImplementedError(f"training.compression_accum_dtype {_LATER}, Slice C)")
    if float(train_cfg.get("moe_aux_loss_weight", 0.0)) != 0.0:
        raise NotImplementedError(f"training.moe_aux_loss_weight (MoE) {_LATER}, Slice D)")
    if int(train_cfg.get("gradient_accumulation", 1)) != 1:
        raise NotImplementedError(
            f"training.gradient_accumulation {_LATER}, Slice D)")
    if "pipeline_schedule" in train_cfg:
        raise NotImplementedError(f"training.pipeline_schedule {_LATER}, Slice D)")
    if execution.get("compiler_options"):
        raise NotImplementedError(
            "execution.compiler_options are XLA compiler options; the port "
            "has no XLA compilation to pass them to")


def check_world_one(config: dict[str, Any]) -> None:
    """Refuse configs that train on more than one device (ROADMAP Queue 1,
    Slice D, item 2)."""
    par = config.get("parallelism", {}) or {}
    for key in ("world_size", "data_parallel", "sequence_parallel",
                "pipeline_parallel", "expert_parallel"):
        if int(par.get(key, 1)) > 1:
            raise NotImplementedError(
                f"parallelism.{key}={par[key]}: dlbb_tpu_torch trains on one "
                "device so far (multi-device training is ROADMAP Queue 1, "
                "Slice D, item 2)")


def _launch_counts() -> dict[str, int]:
    return {"flash_fwd": flash_mod.flash_fwd_launches,
            "flash_bwd_dq": flash_mod.flash_bwd_dq_launches,
            "flash_bwd_dkv": flash_mod.flash_bwd_dkv_launches}


def run_train(config: dict[str, Any], zero1: bool = False,
              zero_stage: Optional[int] = None, device=None,
              output_dir: Optional[str] = None,
              verbose: bool = True) -> dict[str, Any]:
    """Config-driven training benchmark on ``device`` (``cuda`` unless the
    caller passes another; raises without CUDA)."""
    device = resolve_device(device)
    check_world_one(config)
    train_cfg = config.get("training", {}) or {}
    execution = config.get("execution", {}) or {}
    _refuse_unported(train_cfg, execution)
    if zero_stage is None and not zero1 and "zero_stage" in train_cfg:
        zero_stage = train_cfg["zero_stage"]
    stage = resolve_zero_stage(zero1, zero_stage)
    _check_stage_zero(stage)

    inp = config["input"]
    model_cfg = ModelConfig.from_dict(config["model"])
    dtype = DTYPES[model_cfg.dtype]
    batch = create_dataset_from_config(
        config, dtype=dtype, device=device,
        hidden_size=model_cfg.hidden_size).get_batch()
    targets = create_dataset_from_config(
        config, dtype=dtype, device=device, hidden_size=model_cfg.hidden_size,
        seed_offset=1).get_batch()

    lr = learning_rate(train_cfg)
    optimizer = build_optimizer(train_cfg)
    opt_name, sched_name = resolve_names(train_cfg)
    params = init_params(model_cfg, inp.get("seed", 42), device)
    step_fn, state = make_train_step(model_cfg, optimizer, params, zero_stage=stage)
    del params

    warmup = execution.get("warmup_iterations", 2)
    iters = execution.get("benchmark_iterations", 10)

    # the first step alone: on the card it holds the kernels' build (at a
    # process's first launch) and the libraries' first-call set-up
    with Timer(sync=device) as t_first:
        state, loss = step_fn(state, batch, targets)
        float(loss)
    compile_time = t_first.elapsed
    for _ in range(max(0, warmup - 1)):
        state, loss = step_fn(state, batch, targets)
        float(loss)

    holder = [state]
    loss_tensors = []

    def timed_step():
        holder[0], loss = step_fn(holder[0], batch, targets)
        loss_tensors.append(loss)

    before = _launch_counts()
    step_times = time_fn_per_iter(timed_step, iterations=iters, device=device)
    after = _launch_counts()
    state = holder[0]
    losses = [float(x) for x in loss_tensors]
    if not all(np.isfinite(losses)):
        raise FloatingPointError(f"the train step produced non-finite losses {losses}")

    # Utilisation accounting, the JAX package's: backward ~ 2x forward plus
    # the per-parameter optimizer update; full remat re-runs one forward of
    # matmuls (the device-work rate), "dots" recomputes elementwise only.
    tokens = inp["batch_size"] * inp["sequence_length"]
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    fwd_flops = forward_flops(model_cfg, inp["batch_size"], inp["sequence_length"])
    step_flops = 3 * fwd_flops + OPTIMIZER_FLOPS_PER_PARAM.get(opt_name, 18) * n_params
    recompute_flops = (fwd_flops if (model_cfg.remat and model_cfg.remat_policy == "full")
                       else 0)
    mean_step = float(np.mean(step_times))
    on_cuda = device.type == "cuda"

    result = {
        "experiment": config.get("experiment", {}),
        "backend": "torch_cuda",
        "device": str(device),
        "config": config,
        "mode": MODE_NAMES[stage],
        "zero_stage": stage,
        "resumed_from_step": None,
        "grad_compression": "none",
        "compression_accum_dtype": None,
        "preempted": False,
        "preempted_at_step": None,
        "mesh": {"dp": 1, "sp": 1, "pp": 1, "ep": 1, "tp": 1},
        "learning_rate": lr,
        "optimizer": opt_name,
        "moments_dtype": moments_dtype(train_cfg),
        "schedule": sched_name,
        "gradient_accumulation": 1,
        "pipeline_schedule": None,
        "remat": model_cfg.remat,
        "remat_policy": model_cfg.remat_policy if model_cfg.remat else None,
        "tp_overlap": model_cfg.tp_overlap,
        "compiler_options": None,
        "compile_time_s": compile_time,
        "step_time": summarize(step_times),
        "num_params": n_params,
        "tokens_per_second": tokens / mean_step,
        "model_flops_per_step": step_flops,
        "forward_flops": fwd_flops,
        "recompute_flops_per_step": recompute_flops,
        "recompute_note": (
            "achieved_tflops_per_second counts MODEL flops; with "
            "remat_policy=full the device additionally re-runs ~1 forward "
            "of matmuls per step (see *_incl_recompute)"
            if recompute_flops else None),
        "achieved_tflops_per_second": step_flops / mean_step / 1e12,
        "achieved_tflops_per_second_incl_recompute": (
            (step_flops + recompute_flops) / mean_step / 1e12),
        "timing_mode": "per_iter",
        "timing_method": ("torch.cuda.Event pairs per iteration" if on_cuda
                          else "time.perf_counter() per iteration (CPU)"),
        "kernel_launches_per_step": {k: (after[k] - before[k]) / iters for k in after},
        "losses": losses,
        "final_step": state.step,
        "system_info": collect_system_info(device),
        "timestamp": time.time(),
    }
    if verbose:
        st = result["step_time"]
        print(f"[train/{result['mode']}] "
              f"{config.get('experiment', {}).get('name', 'experiment')} on "
              f"{result['system_info']['device_kind']}: step mean "
              f"{st['mean'] * 1e3:.2f} ms, {result['tokens_per_second']:.0f} tok/s, "
              f"{result['achieved_tflops_per_second']:.2f} TFLOP/s, "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if output_dir is not None:
        name = config.get("experiment", {}).get("name", "experiment")
        save_json(result, Path(output_dir) / f"train_{result['mode']}_{name}.json")
    return result


def run_train_from_config(config_path: str, zero_stage: Optional[int] = None,
                          output_dir: Optional[str] = None,
                          device=None) -> dict[str, Any]:
    config = load_config(config_path)
    out = output_dir or config.get("experiment", {}).get("output_dir")
    return run_train(config, zero_stage=zero_stage, device=device, output_dir=out)
