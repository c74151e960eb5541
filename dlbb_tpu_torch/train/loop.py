"""DDP / ZeRO-{1,2,3} and tensor-parallel training step and benchmark
(counterpart of ``dlbb_tpu/train/loop.py``).

``make_train_step`` returns a step function and its initial ``TrainState``;
``step(state, batch, targets) -> (new_state, loss)`` takes the MSE loss
against a fixed target batch (``mse_loss``, the reference's
``test/ccl.py:110``), its gradients by autograd through ``forward`` (the
flash kernels' ``torch.autograd.Function``, remat and the tensor-parallel
conjugate pair included), the gradient reduction of the ZeRO stage and one
optimizer update (``train/optim.py``).  The reference's training is a
DeepSpeed ZeRO smoke (``test/ccl.py:59-117``); the JAX package declares each
stage as a sharding under GSPMD; the port runs the collectives of each
stage itself over the mesh's dp group, in ``train/zero.py``, where the
layout and the stages are described.

With a mesh (``ParallelismPlan.mesh``, a (dp[, sp], tp) grid of process
groups) each rank holds its tp shards (``models/sharding.py``) and its dp
rows and sp slice of the sequence (``sharding.batch_spec``): under gradient
accumulation and a pipeline its part of each of the global batch's
micro-batches (``data.batch_slice`` with ``step_chunks``), as JAX splits
the global batch first and GSPMD lays each micro-batch over dp.  A
micro-batch that dp does not divide gives the first ranks one row more (a
rank may get none: it runs the step on an empty batch, joins every
collective and adds zero); JAX warns of it under "full" and "simplified"
and refuses it under "flash", "ring" and "ulysses" (``check_accumulation``).
Each rank's loss is its share of the batch mean (``sharding.share_mean``:
its rows times dp over the batch's), so the dp reduction, a sum divided by
dp at every ZeRO stage, gives JAX's mean over the micro-batch.  The loss is
JAX's MSE over the whole batch: where the sequence is cut over sp, and over
tp under ``tp_overlap`` (whose forward returns the rank's chunk, against
the same chunk of the targets), each rank backpropagates its chunk's mean
over the ``seq_shards`` equal chunks of its dp rows, the ranks' losses are
summed over those axes, and so are the gradients (``_reduce_seq_shards``):
every parameter is replicated over sp, and under ``tp_overlap`` the
LayerNorms and row-parallel biases act on each tp rank's own chunk.  The
sum happens once, before ``Zero`` reduces over dp; the tp-sharded leaves'
gradients are whole on their rank already (the collective matmuls'
backward rings carry the other chunks' parts).  Gradient accumulation runs
the rank's rows of each of the ``grad_accum`` micro-batches in turn and
accumulates their gradients in fp32; the result is their mean, cast to the
param dtype (``dlbb_tpu/train/loop.py:405-436``).  Stages 0 and 1 reduce the accumulated gradient once; stage 2
reduce-scatters each micro-step's gradient and accumulates the shard; at
stage 3 each micro-step's gradient arrives reduce-scattered.  Where a rank
holds copies of kv columns (GQA with tp not dividing ``kv_heads``), each
copy's gradient becomes the full gradient of its source column
(``sharding.sum_kv_copies``).

A mesh with a pp axis above 1 pipelines the forward
(``parallel/pipeline.py``): ``pipeline_schedule`` "gpipe" differentiates
through the GPipe forward, "1f1b" runs ``pipeline_1f1b_grads``, JAX's
dispatch (``dlbb_tpu/train/loop.py:354-367``); the layer leaves are the
stage's, ``ln_f``'s gradient is whole on every stage.  On a MoE model
``moe_aux_weight`` adds the load-balancing loss (``mse_loss``), its means
taken over each global micro-batch's tokens on every dp rank
(``sharding.token_mean``); an ep axis cuts the experts, whose gradients
stay on their rank.

``run_train`` is the config-driven benchmark: the plan and mesh from the
config (``check_plan``), the sharded init and
the rank's slice of the batch and targets, warmup, timed steps, checkpoint
and resume (``train/checkpoint.py``) and graceful preemption
(``resilience/preempt.py``), in the JAX harness's result schema with
``backend: "torch_cuda"`` and the flash kernels' launches per step.  At
world 1 without a process group each step is timed by a CUDA event pair;
inside a process group each timed step runs between world barriers and
takes the slowest rank's time (``time_fn_per_iter_spmd``), as
``bench/e2e.py`` does.  The result's ``transport`` says how the ring hops
moved (``transformer.ring_transport``, or the compressed ring's over dp),
None where none ran.  The JAX package's chained timing regime exists for a
remotely attached TPU and is not ported.

``grad_compression`` ("int8"/"fp8") replaces the dp reduction by the
quantised ring of ``comm/compression.py``, JAX's compressed step
(``dlbb_tpu/train/loop.py:438-500``): each rank takes its local loss and
gradients with no dp reduction, flattens the gradients in JAX's flatten
order (``optim.flatten_params``), adds its error-feedback residual in fp32,
reduces with ``psum_compressed`` in the ``compression_accum`` dtype and
divides by dp; the new residual is the local quantiser's error
``quantization_error(c)``; the loss is the dp mean.  The residual rides in
the optimizer state, ``(inner state, GradCompressionState)``, stored in
``residual_dtype``.  Under ZeRO-2 each rank cuts its shard out of the
reduced gradient and updates it as stage 2 does.  JAX's envelope, with its
messages: a pure dp mesh with dp above 1, ZeRO 0 or 2, no accumulation, no
MoE aux loss, a dense attention.
"""

from __future__ import annotations

import math
import os
import signal
import time
import warnings
from pathlib import Path
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from dlbb_tpu_torch.comm.compression import psum_compressed, quantization_error
from dlbb_tpu_torch.data.synthetic import create_dataset_from_config, dp_rows
from dlbb_tpu_torch.models.configs import ModelConfig
from dlbb_tpu_torch.models.sharding import (
    all_reduce_sum,
    batch_spec,
    kv_copy_sources,
    share_mean,
    sum_kv_copies,
    tp_dim,
)
from dlbb_tpu_torch.models.transformer import (
    DTYPES,
    forward,
    forward_flops,
    init_params,
    num_parameters,
    ring_transport,
    use_tp_overlap,
)
from dlbb_tpu_torch.obs import spans
from dlbb_tpu_torch.ops import flash_attention as flash_mod
from dlbb_tpu_torch.parallel.collective_matmul import seq_chunk
from dlbb_tpu_torch.parallel.pipeline import (
    pipeline_1f1b_grads,
    split_rows,
    validate_pipeline,
)
from dlbb_tpu_torch.parallel.plan import ParallelismPlan
from dlbb_tpu_torch.parallel.ring import hop_transport
from dlbb_tpu_torch.resilience import PreemptionGuard, inject
from dlbb_tpu_torch.train.optim import (
    GRAD_COMPRESSIONS,
    GradientTransformation,
    build_optimizer,
    compression_accum_dtype,
    flatten_params,
    init_error_feedback,
    learning_rate,
    moments_dtype,
    resolve_grad_compression,
    resolve_names,
    tree_leaves,
    tree_map,
    unflatten_params,
)
from dlbb_tpu_torch.train.zero import Zero, shard_along
from dlbb_tpu_torch.utils.config import save_json
from dlbb_tpu_torch.utils.metrics import Timer, summarize
from dlbb_tpu_torch.utils.profiling import annotate, step_annotation
from dlbb_tpu_torch.utils.sysinfo import collect_system_info, resolve_device
from dlbb_tpu_torch.utils.timing import time_fn_per_iter_spmd

MODE_NAMES = {0: "ddp", 1: "zero1", 2: "zero2", 3: "zero3"}

# Approximate per-parameter update FLOPs for the utilisation accounting
# (the JAX package's table)
OPTIMIZER_FLOPS_PER_PARAM = {"adam": 18, "adamw": 22, "sgd": 6,
                             "adafactor": 14}

class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def mse_loss(params, batch, targets, config: ModelConfig, mesh=None,
             dp_axes=None, num_microbatches: Optional[int] = None,
             moe_aux_weight: float = 0.0, share: float = 1.0) -> torch.Tensor:
    """MSE of the forward against the target batch, in fp32: on a mesh,
    over this rank's slice (``forward``'s ``mesh``, ``dp_axes`` and
    ``num_microbatches``), under ``tp_overlap`` its chunk of the sequence,
    times its ``share`` of the batch's rows (``sharding.share_mean``); plus
    ``moe_aux_weight`` times the MoE load-balancing loss where the weight
    is above 0 (``training.moe_aux_loss_weight``)."""
    aux = 0.0
    if moe_aux_weight > 0.0:
        pred, aux = forward(params, batch, config, mesh=mesh, dp_axes=dp_axes,
                            num_microbatches=num_microbatches, with_aux=True)
    else:
        pred = forward(params, batch, config, mesh=mesh, dp_axes=dp_axes,
                       num_microbatches=num_microbatches)
    if use_tp_overlap(config, mesh):
        targets = seq_chunk(targets, mesh)
    mse = share_mean((pred.float() - targets.float()) ** 2, share)
    return mse + moe_aux_weight * aux


def _seq_shard_axes(config: ModelConfig, mesh) -> tuple[str, ...]:
    """The mesh axes that cut each dp slice's sequence into chunks of the
    loss: sp, and tp under ``tp_overlap``."""
    if mesh is None:
        return ()
    return tuple(a for a, on in (("sp", mesh.shape.get("sp", 1) > 1),
                                 ("tp", use_tp_overlap(config, mesh))) if on)


def _reduce_seq_shards(loss, grads, axes, mesh):
    """The sums over ``axes`` (``_seq_shard_axes``) of this rank's loss and
    gradients: every leaf over sp, the leaves replicated over tp (LayerNorms,
    row-parallel biases, ``ln_f``) over tp."""
    for axis in axes:
        group = mesh.axis_groups[axis]
        loss = all_reduce_sum(loss, group)
        layers = {name: {leaf: (all_reduce_sum(g, group)
                                if axis == "sp" or tp_dim(name, leaf) is None else g)
                         for leaf, g in sub.items()}
                  for name, sub in grads["layers"].items()}
        grads = {"layers": layers,
                 "ln_f": {leaf: all_reduce_sum(g, group) for leaf, g in grads["ln_f"].items()}}
    return loss, grads


def resolve_zero_stage(zero1: bool = False,
                       zero_stage: Optional[int] = None) -> int:
    """Collapse the legacy ``zero1`` flag and ``zero_stage`` into 0-3."""
    if zero_stage is not None:
        if zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0-3, got {zero_stage}")
        return zero_stage
    return 1 if zero1 else 0


def check_accumulation(batch_size: int, grad_accum: int, dp: int,
                       attention: str) -> None:
    """JAX's rule for the global batch under ``grad_accum`` micro-batches
    (``dlbb_tpu/train/loop.py:372-404``), with its messages: the batch must
    split into them; a micro-batch that dp does not divide is resharded
    under "full" and "simplified", with JAX's warning, and refused under
    the attention modes that lay the batch over dp themselves."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if batch_size % grad_accum != 0:
        raise ValueError(f"batch_size={batch_size} not divisible by "
                         f"gradient_accumulation={grad_accum}")
    b = batch_size
    if grad_accum == 1 or (b // grad_accum) % dp == 0:
        return
    if attention in ("full", "simplified"):
        warnings.warn(
            f"micro-batch size {b // grad_accum} (batch_size={b} / "
            f"grad_accum={grad_accum}) not divisible by "
            f"dp={dp}; each micro-step reshards the batch "
            "instead of keeping the dp layout (correct but "
            "slower — measured pair: results/torch/parallelism/"
            "train_ddp_ga2_{divisible_b16,reshard_b20}.json, "
            "per-token throughput in "
            "stats/torch/parallelism/PARALLELISM.md)",
            stacklevel=2,
        )
        return
    raise ValueError(
        f"micro-batch size {b // grad_accum} (batch_size={b} / "
        f"grad_accum={grad_accum}) not divisible by "
        f"dp={dp}: attention={attention!r} "
        "partitions the batch over dp inside shard_map and "
        "cannot reshard a smaller micro-batch"
    )


def step_chunks(grad_accum: int, num_microbatches: Optional[int]) -> int:
    """The global micro-batches a train step cuts its batch into: each
    accumulation micro-batch's pipeline microbatches (``batch_slice``'s
    ``chunks``; ``num_microbatches`` None without a pipeline)."""
    return grad_accum * (num_microbatches or 1)


def check_moe_aux(moe_aux_weight: float, config: ModelConfig) -> None:
    """JAX's check of the aux weight: a MoE model."""
    if moe_aux_weight > 0.0 and not config.is_moe:
        raise ValueError(
            "training.moe_aux_loss_weight requires a MoE model "
            "(model.num_experts > 0)"
        )


def check_pipeline_schedule(pipeline_schedule: str, pp: int) -> None:
    """JAX's checks of ``training.pipeline_schedule``."""
    if pipeline_schedule not in ("gpipe", "1f1b"):
        raise ValueError(
            f"unknown pipeline_schedule {pipeline_schedule!r} "
            "(expected 'gpipe' or '1f1b')"
        )
    if pipeline_schedule == "1f1b" and pp <= 1:
        raise ValueError(
            "pipeline_schedule='1f1b' requires parallelism.pipeline_parallel"
            " > 1 (it is a pipeline training schedule)"
        )


def check_grad_compression(grad_compression: str, config: ModelConfig, mesh,
                           stage: int, grad_accum: int, moe_aux_weight: float) -> None:
    """JAX's envelope of the compressed step, checked in its order and with
    its messages (``dlbb_tpu/train/loop.py:259-315``)."""
    if grad_compression not in GRAD_COMPRESSIONS:
        raise ValueError(
            f"unknown grad_compression {grad_compression!r}; known: "
            f"{GRAD_COMPRESSIONS}"
        )
    if grad_compression == "none":
        return
    other = [] if mesh is None else [a for a in mesh.axis_names
                                     if a != "dp" and mesh.shape[a] > 1]
    if other:
        raise ValueError(
            "training.grad_compression requires a pure data-parallel "
            f"mesh; axes {other} have size > 1 (compose compression "
            "with tp/sp/pp is future work — docs/compression.md)"
        )
    if mesh is None or mesh.shape["dp"] <= 1:
        raise ValueError(
            "training.grad_compression with data_parallel=1 has no "
            "gradient reduction to compress: the ring is an identity, "
            "so the error-feedback residual would subtract a "
            "quantisation error that was never incurred — run "
            "uncompressed, or use a dp>1 mesh"
        )
    if stage not in (0, 2):
        raise ValueError(
            "training.grad_compression supports ZeRO stages 0 (DDP) "
            f"and 2 (grad sharding), not stage {stage}: stages 1/3 "
            "shard the optimizer update itself, which the compressed "
            "replicated-update path does not compose with"
        )
    if grad_accum != 1:
        raise ValueError(
            "training.grad_compression does not compose with "
            "gradient_accumulation yet (accumulate locally before "
            "one compressed reduction is future work)"
        )
    if moe_aux_weight != 0.0:
        raise ValueError(
            "training.grad_compression does not support the MoE aux "
            "loss (expert-parallel compression is future work)"
        )
    if config.attention not in ("full", "simplified", "dense"):
        raise ValueError(
            f"training.grad_compression requires a dense attention "
            f"mode (full/simplified/dense), got "
            f"{config.attention!r}: shard_map attention modes nest "
            "their own manual meshes"
        )


def make_train_step(config: ModelConfig, optimizer: GradientTransformation,
                    params, mesh=None, zero1: bool = False,
                    zero_stage: Optional[int] = None, grad_accum: int = 1,
                    num_microbatches: Optional[int] = None,
                    moe_aux_weight: float = 0.0, pipeline_schedule: str = "gpipe",
                    grad_compression: str = "none", compression_accum: str = "float32",
                    residual_dtype: Optional[str] = None, *, batch_size: int):
    """(step fn, initial ``TrainState``) for ZeRO stage ``zero_stage`` (0
    DDP, 1 sharded optimizer state, 2 and sharded gradients, 3 sharded
    parameters) on ``mesh`` (None: one device, no process group).
    ``params`` are this rank's full tp shards (its stage's layers and its
    experts on a pp or ep mesh); the state holds its ZeRO shards.
    ``grad_accum`` micro-steps feed one update; a pp mesh pipelines each in
    ``num_microbatches`` microbatches under ``pipeline_schedule``;
    ``moe_aux_weight`` weights the MoE load-balancing loss (module
    docstring).  ``grad_compression`` reduces over dp on the quantised ring,
    accumulating in ``compression_accum``, with the error-feedback residual
    stored in ``residual_dtype`` (module docstring).  ``batch_size`` is the
    global batch's rows: the accumulation and the pipeline's microbatches
    are checked against it as JAX checks them (``check_accumulation``,
    ``validate_pipeline``), and the step takes this rank's rows of it, its
    part of each of the ``step_chunks`` global micro-batches
    (``data.batch_slice`` with the mesh's ``sharding.batch_spec``), each
    rank's loss carrying its share of the rows; it refuses a batch of
    another row count.
    ``step.grads(state, batch, targets) -> (loss, grads)`` is the step
    without its update: the global loss and the reduced mean gradients, in
    the layout the optimizer updates (``step.zero``, a ``train/zero.py::
    Zero``, holds that layout).

    The step updates its state in place, as JAX's donated step does: the
    optimizer writes its moments and the parameters into their own tensors
    (``train/optim.py``, ``Zero.apply``), so the state it returns holds the
    tensors of the state it was given, now with the new values, and no
    second state is made.  The initial state holds ``params``' own tensors
    (at ZeRO 0, and at 1 and 2) or this rank's shards of them (at 3), as
    JAX's step takes its donated parameters: a caller that reuses
    ``params`` after a step passes a copy."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    pp = 1 if mesh is None else mesh.shape.get("pp", 1)
    check_pipeline_schedule(pipeline_schedule, pp)
    stage = resolve_zero_stage(zero1, zero_stage)
    dp = 1 if mesh is None else mesh.shape["dp"]
    check_moe_aux(moe_aux_weight, config)
    check_accumulation(batch_size, grad_accum, dp, config.attention)
    # each micro-step pipelines batch / grad_accum rows: the microbatch
    # schedule must divide them (JAX's training-only check)
    m = (validate_pipeline(config, pp, batch_size // grad_accum, num_microbatches)
         if pp > 1 else None)
    chunks = step_chunks(grad_accum, m)
    rows = chunks * dp_rows(batch_size // chunks, batch_spec(mesh)["dp_rank"], dp)[1]
    # this rank's rows times dp over the batch's: exactly 1.0 for an equal share
    share = rows * dp / batch_size
    check_grad_compression(grad_compression, config, mesh, stage, grad_accum,
                           moe_aux_weight)
    zero = Zero(stage, optimizer, params, mesh)
    own, opt_state = zero.init(params)
    state = TrainState(tree_map(lambda p: p.detach().requires_grad_(True), own),
                       opt_state, 0)
    dp_axes = zero.param_axes if stage == 3 else None
    tp = 1 if mesh is None else mesh.shape["tp"]
    tp_rank = 0 if mesh is None else mesh.coords["tp"]
    kv_copies = kv_copy_sources(config, tp_rank, tp) is not None
    seq_axes = _seq_shard_axes(config, mesh)
    seq_shards = math.prod(mesh.shape[a] for a in seq_axes)

    def loss_and_grads(params, batch, targets):
        if pipeline_schedule == "1f1b":
            loss, grads = pipeline_1f1b_grads(
                params, batch, targets, config, mesh, num_microbatches=num_microbatches,
                moe_aux_weight=moe_aux_weight, dp_axes=dp_axes, share=share)
            return loss.detach(), grads
        leaves = tree_leaves(params)
        loss = mse_loss(params, batch, targets, config, mesh=mesh, dp_axes=dp_axes,
                        num_microbatches=num_microbatches, moe_aux_weight=moe_aux_weight,
                        share=share)
        if seq_shards > 1:  # this chunk's share of the dp slice's mean
            loss = loss / seq_shards
        grads = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _: next(grads), params)
        loss = loss.detach()
        if seq_axes:
            loss, grads = _reduce_seq_shards(loss, grads, seq_axes, mesh)
        return loss, grads

    def accumulate(params, batch, targets):
        total = loss_sum = None
        for x, t in zip(split_rows(batch, grad_accum), split_rows(targets, grad_accum)):
            loss, g = loss_and_grads(params, x, t)
            if stage == 2:
                g = zero.reduce(g)
            # accumulate in fp32 whatever the params' dtype
            g = tree_map(lambda a: a.float(), g)
            total = g if total is None else tree_map(torch.add, total, g)
            loss_sum = loss if loss_sum is None else loss_sum + loss
        inv = 1.0 / grad_accum
        grads = tree_map(lambda a, p: (a * inv).to(p.dtype), total, params)
        return loss_sum * inv, grads if stage == 2 else zero.reduce(grads)

    def reduced_grads(state: TrainState, batch, targets):
        if batch.shape[0] != rows:
            raise ValueError(
                f"this rank's batch has {batch.shape[0]} rows; its part of a global "
                f"batch of {batch_size} in {chunks} micro-batches over dp={dp} has "
                f"{rows} (data.batch_slice with step_chunks)")
        if grad_accum == 1:
            loss, grads = loss_and_grads(state.params, batch, targets)
            grads = zero.reduce(grads)
        else:
            loss, grads = accumulate(state.params, batch, targets)
        if kv_copies:
            qkv = {leaf: sum_kv_copies(g, config, tp_rank, tp, mesh.axis_groups["tp"])
                   for leaf, g in grads["layers"]["qkv"].items()}
            grads = {"layers": {**grads["layers"], "qkv": qkv}, "ln_f": grads["ln_f"]}
        return zero.mean_loss(loss), zero.mean(grads)

    def step(state: TrainState, batch, targets):
        loss, grads = reduced_grads(state, batch, targets)
        params, opt_state = zero.apply(state.params, grads, state.opt_state)
        return TrainState(params, opt_state, state.step + 1), loss

    if grad_compression != "none":
        return _compressed_step(config, zero, state, mesh, grad_compression,
                                compression_accum, residual_dtype)
    step.grads = reduced_grads
    step.zero = zero
    return step, state


def _compressed_step(config: ModelConfig, zero: Zero, state: TrainState, mesh,
                     compression: str, accum: str, residual_dtype: Optional[str]):
    """(step fn, initial state) of the compressed step (module docstring);
    ``state`` is the uncompressed step's, whose optimizer state becomes
    the inner part of ``(inner, GradCompressionState)``."""
    group, dp = mesh.axis_groups["dp"], zero.dp
    residual = init_error_feedback(state.params, residual_dtype or torch.float32)
    state = TrainState(state.params, (state.opt_state, residual), state.step)

    def compressed_grads(state: TrainState, batch, targets):
        # local loss and gradients: the only dp reduction is the ring below
        loss = mse_loss(state.params, batch, targets, config)
        leaves = tree_leaves(state.params)
        grads = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _: next(grads), state.params)
        res = state.opt_state[1].residual
        with torch.no_grad():
            flat_g = flatten_params(grads)
            c = flat_g.float() + res.float()
            reduced = psum_compressed(c, group, compression=compression,
                                      accum_dtype=accum) / dp
            grads = unflatten_params(reduced.to(flat_g.dtype), state.params)
        # ZeRO-2: this rank's shard of each sharded leaf, a local cut
        grads = tree_map(lambda g, ax: g if ax is None
                         else shard_along(g, ax, zero.rank, dp).contiguous(),
                         grads, zero.opt_axes)
        return zero.mean_loss(loss.detach()), grads, c

    def step(state: TrainState, batch, targets):
        loss, grads, c = compressed_grads(state, batch, targets)
        with torch.no_grad():
            # error feedback: the local quantiser's error, not the ring's,
            # written into the residual in place
            quantization_error(c, compression, out=state.opt_state[1].residual)
        del c
        params, inner = zero.apply(state.params, grads, state.opt_state[0])
        return TrainState(params, (inner, state.opt_state[1]), state.step + 1), loss

    step.grads = lambda state, batch, targets: compressed_grads(state, batch, targets)[:2]
    step.zero = zero
    return step, state


def _refuse_unported(execution: dict[str, Any]) -> None:
    """Config keys that have no target in the port raise here."""
    if execution.get("compiler_options"):
        raise NotImplementedError(
            "execution.compiler_options are XLA compiler options: the port "
            "compiles no XLA program, so they have no target here, and eager "
            "torch.distributed issues every collective on its own (ROADMAP "
            "Queue 1, Slice C remainder, item 8)")


def _launch_counts() -> dict[str, int]:
    return {"flash_fwd": flash_mod.flash_fwd_launches,
            "flash_bwd_dq": flash_mod.flash_bwd_dq_launches,
            "flash_bwd_dkv": flash_mod.flash_bwd_dkv_launches}


def _any_rank(flag: bool, mesh, device) -> bool:
    """Whether ``flag`` holds on any rank of the world (an all-reduce MAX;
    ``flag`` itself without a process group)."""
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def run_train(config: dict[str, Any], zero1: bool = False,
              zero_stage: Optional[int] = None, device=None,
              output_dir: Optional[str] = None,
              verbose: bool = True) -> dict[str, Any]:
    """Config-driven training benchmark on ``device`` (``cuda`` unless the
    caller passes another; raises without CUDA), on this rank of the
    process group if there is one (module docstring).  A fault plan in
    ``DLBB_FAULT_PLAN`` is active for the run unless the caller activated
    one (``resilience/inject.py``)."""
    device = resolve_device(device)
    spec = None if inject.active() is not None else inject.from_env()
    with inject.plan_scope(spec):
        return _run_train(config, zero1, zero_stage, device, output_dir, verbose)


def _run_train(config, zero1, zero_stage, device, output_dir, verbose):
    train_cfg = config.get("training", {}) or {}
    execution = config.get("execution", {}) or {}
    _refuse_unported(execution)
    # explicit caller args (zero_stage or legacy zero1) win over the config
    if zero_stage is None and not zero1 and "zero_stage" in train_cfg:
        zero_stage = train_cfg["zero_stage"]
    stage = resolve_zero_stage(zero1, zero_stage)

    inp = config["input"]
    model_cfg = ModelConfig.from_dict(config["model"])
    plan = ParallelismPlan.from_config(config, model_cfg)
    mesh = plan.mesh
    lead = mesh is None or dist.get_rank() == 0
    moe_aux_weight = float(train_cfg.get("moe_aux_loss_weight", 0.0))
    grad_accum = int(train_cfg.get("gradient_accumulation", 1))
    pipeline_schedule = str(train_cfg.get("pipeline_schedule", "gpipe"))
    check_pipeline_schedule(pipeline_schedule, plan.pp)
    check_moe_aux(moe_aux_weight, model_cfg)

    lr = learning_rate(train_cfg)
    optimizer = build_optimizer(train_cfg)
    opt_name, sched_name = resolve_names(train_cfg)
    grad_compression = resolve_grad_compression(train_cfg)
    comp_accum = compression_accum_dtype(train_cfg)
    # refused before the model is drawn (make_train_step checks it again)
    check_grad_compression(grad_compression, model_cfg, mesh, stage, grad_accum,
                           moe_aux_weight)
    params = init_params(model_cfg, inp.get("seed", 42), device, **plan.coords())
    # the accumulation's checks and warning (check_accumulation) come with the step
    step_fn, state = make_train_step(model_cfg, optimizer, params, mesh=mesh,
                                     zero_stage=stage, grad_accum=grad_accum,
                                     num_microbatches=plan.num_microbatches,
                                     moe_aux_weight=moe_aux_weight,
                                     pipeline_schedule=pipeline_schedule,
                                     grad_compression=grad_compression,
                                     compression_accum=comp_accum,
                                     # the residual follows the moments'
                                     # storage dtype, as in JAX
                                     residual_dtype=moments_dtype(train_cfg),
                                     batch_size=inp["batch_size"])
    dtype = DTYPES[model_cfg.dtype]
    batch, targets = (create_dataset_from_config(
        config, dtype=dtype, device=device, hidden_size=model_cfg.hidden_size,
        seed_offset=offset,
        **batch_spec(mesh, step_chunks(grad_accum, plan.num_microbatches))).get_batch()
        for offset in (0, 1))
    del params

    # checkpoint / resume before warmup, so that the restored step counter
    # carries through the run
    ckpt = resumed_from = None
    if "checkpoint" in train_cfg and train_cfg["checkpoint"].get("enabled", True):
        from dlbb_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer

        ckpt = Checkpointer(
            CheckpointConfig.from_dict(train_cfg["checkpoint"]),
            layout={"mesh": plan.mesh_dict(), "zero_stage": stage,
                    "world_size": 1 if mesh is None else dist.get_world_size()},
            group=None if mesh is None else dist.group.WORLD, device=device)
        resumed_from = ckpt.latest_step()
        state = ckpt.restore_or(state)

    warmup = execution.get("warmup_iterations", 2)
    iters = execution.get("benchmark_iterations", 10)

    with spans.span("compile+warmup", cat="train"), annotate("compile+warmup"):
        # the first step alone: on the card it holds the kernels' build (at
        # a process's first launch) and the libraries' first-call set-up
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

    on_cuda = device.type == "cuda"
    events, step_times, local_times = [], [], []
    preempted_at: Optional[int] = None
    before = _launch_counts()
    # graceful preemption: a SIGTERM between steps ends the loop on every
    # rank at the same step and falls through to the forced final save.
    # The spans and annotations are JAX's (``compile+warmup``, one
    # ``train_step`` per timed step, ``measure`` around the measured
    # region, here the per-iteration loop and its events' completion); each
    # wraps the timing from the outside and adds no host sync to a step
    with spans.span("measure", cat="train"), annotate("measure"), \
            PreemptionGuard() as guard:
        for i in range(iters):
            if inject.fire("preempt"):
                os.kill(os.getpid(), signal.SIGTERM)
            if _any_rank(guard.requested, mesh, device):
                preempted_at = holder[0].step
                break
            with spans.span("train_step", cat="train", step=i), \
                    step_annotation("train_step", i):
                if mesh is not None:
                    slowest, local = time_fn_per_iter_spmd(
                        timed_step, iterations=1, device=device, group=dist.group.WORLD)
                    step_times += slowest
                    local_times += local
                elif on_cuda:  # event pairs, read after the loop: the host runs ahead
                    pair = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                    pair[0].record()
                    timed_step()
                    pair[1].record()
                    events.append(pair)
                else:
                    t0 = time.perf_counter()
                    timed_step()
                    step_times.append(time.perf_counter() - t0)
            if ckpt is not None:
                ckpt.maybe_save(holder[0])
        after = _launch_counts()
        if events:
            torch.cuda.synchronize(device)
            step_times = [start.elapsed_time(end) / 1e3 for start, end in events]
    if mesh is None:
        local_times = step_times
    state = holder[0]
    losses = [float(x) for x in loss_tensors]
    if not all(np.isfinite(losses)):
        raise FloatingPointError(f"the train step produced non-finite losses {losses}")

    if ckpt is not None:
        # forced final save: on the preemption path the resume point
        ckpt.maybe_save(state, force=True)
        ckpt.close()

    if preempted_at is not None and not step_times:
        # preempted before any timed step: no benchmark to publish, only
        # the resume point
        result = {
            "preempted": True,
            "preempted_at_step": preempted_at,
            "mode": MODE_NAMES[stage],
            "zero_stage": stage,
            "resumed_from_step": resumed_from,
            "final_step": state.step,
            "checkpoint_saved": ckpt is not None,
            "losses": losses,
            "timestamp": time.time(),
        }
        if verbose and lead:
            print(f"[train/{result['mode']}] preempted at step {preempted_at}; "
                  f"checkpoint {'saved' if ckpt is not None else 'DISABLED'} — "
                  "no benchmark artifact written")
        return result

    if mesh is None:
        host_means = np.asarray([np.mean(local_times)])
        timing_method = ("torch.cuda.Event pairs per iteration" if on_cuda
                         else "time.perf_counter() per iteration (CPU)")
    else:
        means: list[Any] = [None] * dist.get_world_size()
        dist.all_gather_object(means, float(np.mean(local_times)))
        host_means = np.asarray(means)
        timing_method = (
            "barrier on the world group, then "
            + ("a torch.cuda.Event pair around the step, synchronize" if on_cuda
               else "time.perf_counter() around the step (CPU)")
            + "; each iteration's time is the slowest rank's")

    # Utilisation accounting, the JAX package's: backward ~ 2x forward plus
    # the per-parameter optimizer update; full remat re-runs one forward of
    # matmuls (the device-work rate), "dots" recomputes elementwise only.
    # The tokens of a step are the global batch's, whatever the accumulation.
    tokens = inp["batch_size"] * inp["sequence_length"]
    n_params = num_parameters(model_cfg)
    fwd_flops = forward_flops(model_cfg, inp["batch_size"], inp["sequence_length"])
    step_flops = 3 * fwd_flops + OPTIMIZER_FLOPS_PER_PARAM.get(opt_name, 18) * n_params
    recompute_flops = (fwd_flops if (model_cfg.remat and model_cfg.remat_policy == "full")
                       else 0)
    mean_step = float(np.mean(step_times))
    n_timed = len(step_times)

    result = {
        "experiment": config.get("experiment", {}),
        "backend": "torch_cuda",
        "device": str(device),
        "config": config,
        "mode": MODE_NAMES[stage],
        "zero_stage": stage,
        "resumed_from_step": resumed_from,
        "grad_compression": grad_compression,
        "compression_accum_dtype": comp_accum if grad_compression != "none" else None,
        "preempted": preempted_at is not None,
        "preempted_at_step": preempted_at,
        "mesh": plan.mesh_dict(),
        "learning_rate": lr,
        "optimizer": opt_name,
        "moments_dtype": moments_dtype(train_cfg),
        "schedule": sched_name,
        "gradient_accumulation": grad_accum,
        "pipeline_schedule": pipeline_schedule if plan.pp > 1 else None,
        "remat": model_cfg.remat,
        "remat_policy": model_cfg.remat_policy if model_cfg.remat else None,
        "tp_overlap": model_cfg.tp_overlap,
        "transport": (hop_transport(mesh.axis_groups["dp"], device)
                      if grad_compression != "none"
                      else ring_transport(model_cfg, mesh, device)),
        "compiler_options": None,
        "compile_time_s": compile_time,
        "step_time": summarize(step_times),
        "per_host_means_s": host_means.tolist(),
        "cross_host_variance": float(host_means.var()),
        "cross_host_cv": float(host_means.std() / host_means.mean()),
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
        "timing_method": timing_method,
        "kernel_launches_per_step": {k: (after[k] - before[k]) / n_timed for k in after},
        "losses": losses,
        "final_step": state.step,
        "system_info": collect_system_info(device),
        "timestamp": time.time(),
    }
    if verbose and lead:
        st = result["step_time"]
        print(f"[train/{result['mode']}] "
              f"{config.get('experiment', {}).get('name', 'experiment')} on "
              f"{result['system_info']['device_kind']}: step mean "
              f"{st['mean'] * 1e3:.2f} ms, {result['tokens_per_second']:.0f} tok/s, "
              f"{result['achieved_tflops_per_second']:.2f} TFLOP/s, "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if output_dir is not None and lead:
        name = config.get("experiment", {}).get("name", "experiment")
        save_json(result, Path(output_dir) / f"train_{result['mode']}_{name}.json")
    return result
