"""Megatron tensor-parallel shards, made explicit (counterpart of
``dlbb_tpu/models/sharding.py``).

The JAX package declares the layout as ``PartitionSpec``s over a ``tp``
mesh axis and lets GSPMD place each device's shard and insert the two
all-reduces per layer.  Here each rank holds its shard as a tensor of its
own (``shard_params``), as the reference does (``models.py:19-100``), and
``models/transformer.py`` runs the all-reduces:

- column shards (output features): the QKV kernel and bias, the FFN-up
  kernel and bias;
- row shards (input features): the out-proj and FFN-down kernels;
- replicated: the LayerNorms, the out-proj and FFN-down biases (added once,
  after the all-reduce) and ``ln_f``.

The fused QKV is ``[q | k | v]``, so a contiguous cut of its columns would
give rank 0 all of q and part of k.  Rank r takes the q columns of its
heads ``[r n/tp, (r+1) n/tp)``, the k and v columns of their kv heads, and
concatenates them as its own ``[q | k | v]``; the out-proj rows follow the
same q heads.  When ``tp`` divides ``kv_heads`` those are the kv heads
``[r kvh/tp, (r+1) kvh/tp)``, and the group ``b // g`` stays as it is.  When
it does not, each local q head takes a copy of its kv head's columns, so
the rank runs ``n/tp`` kv heads with g = 1: the JAX package broadcasts k/v
to ``num_heads`` in that case (``transformer.py:229-233``).

Uneven shards are refused (``configs.validate_tp_shards``): GSPMD pads
them, explicit shards cannot.

With gradients, the two all-reduces per layer become Megatron's conjugate
pair of autograd Functions: ``copy_to_tp`` (identity forward, all-reduce of
the gradient) on the LayerNorm output that feeds a column-parallel product,
and ``reduce_from_tp`` (all-reduce forward, identity backward) on a
row-parallel product.  Both run out of place: no collective writes into a
tensor that autograd or a selective checkpoint has saved.  Where a rank
holds copies of kv columns, ``sum_kv_copies`` gives every copy the full
gradient of its source column, so the copies stay equal after each update.
``gather_dp`` is ZeRO-3's per-use parameter all-gather over the dp group
(its gradient is reduce-scattered back to the shard).

The collectives themselves (``all_reduce_sum``, ``all_gather_along``,
``reduce_scatter_along``) work on any dimension and take the tensor where
it is, on either backend: gloo on torch 2.11 reduce-scatters, all-gathers
and all-reduces CUDA tensors in bf16 as well as CPU ones, so the one-card,
two-process gloo check (``chip_smoke.py`` phase ``dtrain``) needs no host
copy.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from dlbb_tpu_torch.models.configs import ModelConfig

# the tp-sharded dimension of each stacked [L, ...] leaf, by (group, leaf):
# column shards (qkv and ffn_up) on their output features, row shards (out
# and ffn_down kernels) on their input features; every other leaf is
# replicated
_TP_DIM = {("qkv", "kernel"): 2, ("qkv", "bias"): 1,
           ("ffn_up", "kernel"): 2, ("ffn_up", "bias"): 1,
           ("out", "kernel"): 1, ("ffn_down", "kernel"): 1}


def tp_dim(group: str, leaf: str) -> Optional[int]:
    """The dimension of the stacked leaf ``group.leaf`` that tp shards
    (the ``tp`` entry of its JAX ``PartitionSpec``), or None where the leaf
    is replicated over tp."""
    return _TP_DIM.get((group, leaf))


def local_kv_heads(config: ModelConfig, tp: int) -> int:
    """K/V heads on each rank: ``kv_heads/tp`` when tp divides them, else one
    copy per local q head (``num_heads/tp``)."""
    kvh = config.kv_heads
    return kvh // tp if kvh % tp == 0 else config.num_heads // tp


def local_config(config: ModelConfig, tp: int) -> ModelConfig:
    """What one rank's shards compute: ``num_heads/tp`` heads of the same
    head_dim (``hidden_size/tp`` is the attention width), its K/V heads
    (``local_kv_heads``) and ``ffn_intermediate/tp``.  The residual stream
    keeps the full hidden size, which the shards' shapes carry."""
    if tp == 1:
        return config
    kv = local_kv_heads(config, tp)
    return config.with_(hidden_size=config.hidden_size // tp,
                        num_heads=config.num_heads // tp,
                        num_kv_heads=None if config.num_kv_heads is None else kv,
                        ffn_intermediate=config.ffn_intermediate // tp)


def qkv_columns(config: ModelConfig, tp_rank: int, tp: int) -> torch.Tensor:
    """Columns of the fused ``[q | k | v]`` projection that rank ``tp_rank``
    holds, in its own ``[q | k | v]`` order."""
    h, d, n, kvh = (config.hidden_size, config.head_dim, config.num_heads,
                    config.kv_heads)
    heads = range(tp_rank * n // tp, (tp_rank + 1) * n // tp)
    if kvh % tp == 0:
        kv = range(tp_rank * kvh // tp, (tp_rank + 1) * kvh // tp)
    else:
        g = n // kvh
        kv = [j // g for j in heads]

    def cols(base, hs):
        return [base + i * d + c for i in hs for c in range(d)]

    return torch.tensor(cols(0, heads) + cols(h, kv) + cols(h + kvh * d, kv),
                        dtype=torch.long)


def shard_leaf(group: str, leaf: str, t: torch.Tensor, config: ModelConfig,
               tp_rank: int, tp: int) -> torch.Tensor:
    """Rank ``tp_rank``'s shard of the stacked layer leaf ``group.leaf`` (a
    new tensor, so the full one can be freed), or ``t`` itself where it is
    replicated or ``tp`` is 1."""
    if tp == 1:
        return t
    if group == "qkv":
        return t.index_select(t.dim() - 1,
                              qkv_columns(config, tp_rank, tp).to(t.device))
    dim = tp_dim(group, leaf)
    if dim is None:
        return t
    size = t.shape[dim] // tp
    return t.narrow(dim, tp_rank * size, size).clone(
        memory_format=torch.contiguous_format)


def shard_params(params: dict[str, Any], config: ModelConfig, tp_rank: int,
                 tp: int) -> dict[str, Any]:
    """Rank ``tp_rank``'s shards of the full parameters (the layout of
    ``transformer.init_params``)."""
    layers = {group: {leaf: shard_leaf(group, leaf, t, config, tp_rank, tp)
                      for leaf, t in sub.items()}
              for group, sub in params["layers"].items()}
    return {"layers": layers, "ln_f": dict(params["ln_f"])}


def unshard_params(shards: list[dict[str, Any]], config: ModelConfig) -> dict[str, Any]:
    """The full parameters from every tp rank's shards, by tp rank (the
    inverse of ``shard_params``).  A kv column that ranks hold in copies is
    taken from the last copy written; the copies are equal."""
    tp = len(shards)
    if tp == 1:
        return shards[0]
    ref = shards[0]
    layers = {}
    for group, sub in ref["layers"].items():
        layers[group] = {}
        for leaf, t in sub.items():
            dim = tp_dim(group, leaf)
            parts = [s["layers"][group][leaf] for s in shards]
            if dim is None:
                layers[group][leaf] = t
            elif group == "qkv":
                full = t.new_empty(t.shape[:-1] + (config.qkv_width,))
                for r, part in enumerate(parts):
                    full.index_copy_(full.dim() - 1,
                                     qkv_columns(config, r, tp).to(t.device), part)
                layers[group][leaf] = full
            else:
                layers[group][leaf] = torch.cat(parts, dim)
    return {"layers": layers, "ln_f": dict(ref["ln_f"])}


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the sum of ``t`` over the ranks of ``group``."""
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def all_gather_along(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim``, in rank order."""
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((dist.get_world_size(group) * src.shape[0],) + src.shape[1:])
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_along(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's part, along ``dim``, of the sum of ``t`` over ``group``:
    rank r of n gets the r-th of n equal slices."""
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // dist.get_world_size(group),) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_along(shard, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_along(grad, ctx.dim, ctx.group), None, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient is summed over the tp ``group`` (the
    input of a column-parallel product feeds every rank's columns)."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partial products over the tp ``group``; the
    gradient passes through (each rank's partial sum gets all of it)."""
    return _ReduceFromTP.apply(x, group)


def gather_dp(shard: torch.Tensor, dim: int, group) -> torch.Tensor:
    """ZeRO-3: the full tensor from the dp ranks' shards along ``dim``; its
    gradient is summed over ``group`` and cut back to this rank's shard."""
    return _GatherDP.apply(shard, dim, group)


def kv_copy_sources(config: ModelConfig, tp_rank: int, tp: int) -> Optional[torch.Tensor]:
    """For each k and v column of rank ``tp_rank``'s ``[q | k | v]`` (after
    its ``hidden_size/tp`` q columns), its column in the full ``[k | v]``
    block; None when tp divides ``kv_heads`` and no column is a copy."""
    if tp == 1 or config.kv_heads % tp == 0:
        return None
    cols = qkv_columns(config, tp_rank, tp)
    return cols[config.hidden_size // tp:] - config.hidden_size


def sum_kv_copies(grad: torch.Tensor, config: ModelConfig, tp_rank: int, tp: int,
                  group) -> torch.Tensor:
    """The gradient of rank ``tp_rank``'s qkv kernel or bias with every kv
    copy's gradient replaced by the full gradient of its source column:
    the copies' gradients, summed in fp32 into the full ``[k | v]`` block
    and over the tp ``group``, then read back at each copy.  The JAX
    package's counterpart is its broadcast of k/v to ``num_heads``, whose
    gradient sums the heads of a group."""
    src = kv_copy_sources(config, tp_rank, tp)
    if src is None:
        return grad
    q_width = config.hidden_size // tp
    src = src.to(grad.device)
    kv = grad[..., q_width:].float()
    full = kv.new_zeros(kv.shape[:-1] + (2 * config.kv_heads * config.head_dim,))
    full.index_add_(full.dim() - 1, src, kv)
    full = all_reduce_sum(full, group)
    out = grad.clone()
    out[..., q_width:] = full.index_select(full.dim() - 1, src).to(grad.dtype)
    return out
