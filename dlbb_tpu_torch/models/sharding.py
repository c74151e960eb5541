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
"""

from __future__ import annotations

from typing import Any

import torch

from dlbb_tpu_torch.models.configs import ModelConfig

# the sharded dimension of each stacked [L, ...] leaf, by (group, leaf);
# every other leaf is replicated
_COLUMN = {("ffn_up", "kernel"): 2, ("ffn_up", "bias"): 1}
_ROW = {("out", "kernel"): 1, ("ffn_down", "kernel"): 1}


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
    dim = _COLUMN.get((group, leaf), _ROW.get((group, leaf)))
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
