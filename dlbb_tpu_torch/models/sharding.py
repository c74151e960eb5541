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
give rank 0 all of q and part of k.  Where tp divides ``num_heads``, rank r
takes the q columns of its heads ``[r n/tp, (r+1) n/tp)``, the k and v
columns of their kv heads, and concatenates them as its own ``[q | k |
v]``; the out-proj rows follow the same q heads.  When ``tp`` divides
``kv_heads`` those are the kv heads ``[r kvh/tp, (r+1) kvh/tp)``, and the
group ``b // g`` stays as it is.  When it does not, each local q head takes
a copy of its kv head's columns, so the rank runs ``n/tp`` kv heads with
g = 1: the JAX package broadcasts k/v to ``num_heads`` in that case
(``transformer.py:229-233``).

Where tp does not divide ``num_heads`` (``uneven_heads``) but every sharded
parameter dimension (``hidden_size``, ``qkv_width``, ``ffn_intermediate``)
divides, rank r holds the contiguous ``[r W/tp, (r+1) W/tp)`` of the fused
columns and ``[r H/tp, (r+1) H/tp)`` of the out-proj rows, as JAX's
``PartitionSpec``s lay them out; the model then gathers the qkv activations
over tp (``gather_parts``) to attend (``transformer._uneven_attention``).
A parameter dimension that tp does not divide is refused as JAX's pjit
refuses it (``configs.validate_tp_shards``): GSPMD pads no parameter.

With gradients, the two all-reduces per layer become Megatron's conjugate
pair of autograd Functions: ``copy_to_tp`` (identity forward, all-reduce of
the gradient) on the LayerNorm output that feeds a column-parallel product,
and ``reduce_from_tp`` (all-reduce forward, identity backward) on a
row-parallel product.  Both run out of place: no collective writes into a
tensor that autograd or a selective checkpoint has saved.  Where a rank
holds copies of kv columns, ``sum_kv_copies`` gives every copy the full
gradient of its source column, so the copies stay equal after each update.
``gather_parts`` is ZeRO-3's per-use parameter all-gather over the dp group
(its gradient is reduce-scattered back to the shard).

The MoE layout follows ``dlbb_tpu/models/sharding.py:40-50``: each expert
keeps the column/row split on its features (the ``ffn_up`` kernel
``[E, H, F]`` and bias ``[E, F]`` on F, the ``ffn_down`` kernel ``[E, F, H]``
on F); the ``ffn_down`` bias and the router stay whole over tp.  Over an ep
axis each rank holds the contiguous slice ``[r E/ep, (r+1) E/ep)`` of the
expert dimension of the four expert leaves, and over a pp axis each stage
the slice ``[r L/pp, (r+1) L/pp)`` of every stacked layer leaf
(``shard_params``' ``pp_rank``/``ep_rank``); ``ln_f`` stays whole.
``copy_to_ep`` and ``reduce_from_ep`` are the conjugate pair over the ep
group: the tokens are replicated over ep and each rank computes only its
experts, so the combine is a sum over ep and the inputs' gradients are
summed over it.  ``token_mean`` is the mean of a per-token statistic over
the ranks that cut the tokens of a batch (dp, sp), for the MoE
load-balancing loss; the ranks may hold unequal shares of the tokens (a
micro-batch that dp does not divide, ``data.batch_slice``), and
``share_mean`` is the rank's share of a batch mean (the MSE).

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
# the same for the MoE layers, whose expert leaves carry the expert dim 1
_MOE_TP_DIM = {**_TP_DIM, ("ffn_up", "kernel"): 3, ("ffn_up", "bias"): 2,
               ("ffn_down", "kernel"): 2}
# the expert dimension of the stacked MoE expert leaves, which ep slices
_EP_DIM = {("ffn_up", "kernel"): 1, ("ffn_up", "bias"): 1,
           ("ffn_down", "kernel"): 1, ("ffn_down", "bias"): 1}
# pp slices every stacked layer leaf on its layer dimension
PP_DIM = 0


def tp_dim(group: str, leaf: str, moe: bool = False) -> Optional[int]:
    """The dimension of the stacked leaf ``group.leaf`` that tp shards
    (the ``tp`` entry of its JAX ``PartitionSpec``), or None where the leaf
    is replicated over tp; ``moe`` for the expert-stacked MoE layers."""
    return (_MOE_TP_DIM if moe else _TP_DIM).get((group, leaf))


def ep_dim(group: str, leaf: str, moe: bool = True) -> Optional[int]:
    """The expert dimension of the stacked MoE leaf ``group.leaf`` (the
    ``ep`` entry of its JAX ``PartitionSpec``), None for the other leaves
    and for a dense model."""
    return _EP_DIM.get((group, leaf)) if moe else None


def is_moe_tree(params: dict[str, Any]) -> bool:
    """Whether ``params`` hold MoE layers (the JAX package's test: a
    ``router`` group)."""
    return "router" in params["layers"]


def local_kv_heads(config: ModelConfig, tp: int) -> int:
    """K/V heads on each rank: ``kv_heads/tp`` when tp divides them, else one
    copy per local q head (``num_heads/tp``)."""
    kvh = config.kv_heads
    return kvh // tp if kvh % tp == 0 else config.num_heads // tp


def uneven_heads(config: ModelConfig, tp: int) -> bool:
    """Whether tp cuts the heads unevenly: the rank then holds a contiguous
    1/tp of the fused qkv columns, not whole heads (module docstring)."""
    return tp > 1 and config.num_heads % tp != 0


def local_config(config: ModelConfig, tp: int) -> ModelConfig:
    """What one rank's shards compute: ``num_heads/tp`` heads of the same
    head_dim (``hidden_size/tp`` is the attention width), its K/V heads
    (``local_kv_heads``) and ``ffn_intermediate/tp``.  The residual stream
    keeps the full hidden size, which the shards' shapes carry.  Where tp
    does not divide the heads (``uneven_heads``) only the FFN is cut: the
    attention runs on heads gathered over tp."""
    if tp == 1:
        return config
    if uneven_heads(config, tp):
        return config.with_(ffn_intermediate=config.ffn_intermediate // tp)
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


def _slice(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


def shard_leaf(group: str, leaf: str, t: torch.Tensor, config: ModelConfig,
               tp_rank: int, tp: int, pp_rank: int = 0, pp: int = 1,
               ep_rank: int = 0, ep: int = 1) -> torch.Tensor:
    """Rank ``(pp_rank, ep_rank, tp_rank)``'s part of the stacked layer leaf
    ``group.leaf``: its stage's layers, its experts and its tp shard (a new
    tensor, so the full one can be freed), or ``t`` itself where nothing is
    cut."""
    cut = t
    if pp > 1:
        cut = _slice(cut, PP_DIM, pp_rank, pp)
    edim = ep_dim(group, leaf, config.is_moe)
    if ep > 1 and edim is not None:
        cut = _slice(cut, edim, ep_rank, ep)
    if tp > 1 and group == "qkv" and not uneven_heads(config, tp):
        return cut.index_select(cut.dim() - 1,
                                qkv_columns(config, tp_rank, tp).to(t.device))
    dim = tp_dim(group, leaf, config.is_moe)
    if tp > 1 and dim is not None:
        cut = _slice(cut, dim, tp_rank, tp)
    if cut is t:
        return t
    return cut.clone(memory_format=torch.contiguous_format)


def shard_params(params: dict[str, Any], config: ModelConfig, tp_rank: int,
                 tp: int, pp_rank: int = 0, pp: int = 1, ep_rank: int = 0,
                 ep: int = 1) -> dict[str, Any]:
    """Rank ``(pp_rank, ep_rank, tp_rank)``'s part of the full parameters
    (the layout of ``transformer.init_params``)."""
    layers = {group: {leaf: shard_leaf(group, leaf, t, config, tp_rank, tp,
                                       pp_rank, pp, ep_rank, ep)
                      for leaf, t in sub.items()}
              for group, sub in params["layers"].items()}
    return {"layers": layers, "ln_f": dict(params["ln_f"])}


def _unshard_tp(shards: list[dict[str, Any]], config: ModelConfig) -> dict[str, Any]:
    tp = len(shards)
    if tp == 1:
        return shards[0]
    ref = shards[0]
    layers = {}
    for group, sub in ref["layers"].items():
        layers[group] = {}
        for leaf, t in sub.items():
            dim = tp_dim(group, leaf, config.is_moe)
            parts = [s["layers"][group][leaf] for s in shards]
            if dim is None:
                layers[group][leaf] = t
            elif group == "qkv" and not uneven_heads(config, tp):
                full = t.new_empty(t.shape[:-1] + (config.qkv_width,))
                for r, part in enumerate(parts):
                    full.index_copy_(full.dim() - 1,
                                     qkv_columns(config, r, tp).to(t.device), part)
                layers[group][leaf] = full
            else:
                layers[group][leaf] = torch.cat(parts, dim)
    return {"layers": layers, "ln_f": dict(ref["ln_f"])}


def unshard_params(shards: list[dict[str, Any]], config: ModelConfig,
                   pp: int = 1, ep: int = 1) -> dict[str, Any]:
    """The full parameters from every rank's parts (the inverse of
    ``shard_params``): ``shards`` in the row-major order of (pp, ep, tp),
    which with ``pp`` and ``ep`` 1 is the list by tp rank.  A kv column
    that ranks hold in copies is taken from the last copy written; the
    copies are equal."""
    tp = len(shards) // (pp * ep)
    stages = []
    for s in range(pp):
        by_ep = [_unshard_tp(shards[(s * ep + e) * tp:(s * ep + e + 1) * tp], config)
                 for e in range(ep)]
        ref = by_ep[0]
        layers = {group: {leaf: (torch.cat([b["layers"][group][leaf] for b in by_ep],
                                           ep_dim(group, leaf))
                                 if ep > 1 and ep_dim(group, leaf, config.is_moe) is not None
                                 else t)
                          for leaf, t in sub.items()}
                  for group, sub in ref["layers"].items()}
        stages.append({"layers": layers, "ln_f": ref["ln_f"]})
    if pp == 1:
        return stages[0]
    layers = {group: {leaf: torch.cat([st["layers"][group][leaf] for st in stages], PP_DIM)
                      for leaf in sub}
              for group, sub in stages[0]["layers"].items()}
    return {"layers": layers, "ln_f": dict(stages[0]["ln_f"])}


def batch_spec(mesh, chunks: int = 1) -> dict[str, int]:
    """This rank's part of the global batch on ``mesh`` (None: one device),
    as ``data.batch_slice``'s arguments: its dp rows of each of ``chunks``
    micro-batches and its sp slice of the sequence (JAX's ``batch_spec``,
    ``P(dp, sp, None)``, on each micro-batch)."""
    if mesh is None:
        return {"dp_rank": 0, "dp": 1, "sp_rank": 0, "sp": 1, "chunks": chunks}
    c, shape = mesh.coords, mesh.shape
    return {"dp_rank": c["dp"], "dp": shape["dp"], "sp_rank": c.get("sp", 0),
            "sp": shape.get("sp", 1), "chunks": chunks}


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the sum of ``t`` over the ranks of ``group``."""
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def all_gather_along(t: torch.Tensor, dim: int, group,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim``, in rank order; written
    into ``out`` (and ``out`` returned) where it is given.  ``t`` may be
    this rank's slice of ``out``."""
    src = t.movedim(dim, 0).contiguous()
    if out is not None and dim == 0 and out.is_contiguous():
        if src.untyped_storage().data_ptr() == out.untyped_storage().data_ptr():
            src = src.clone()  # no collective is handed an input inside its output
        dist.all_gather_into_tensor(out, src, group=group)
        return out
    full = src.new_empty((dist.get_world_size(group) * src.shape[0],) + src.shape[1:])
    dist.all_gather_into_tensor(full, src, group=group)
    if out is not None:
        return out.copy_(full.movedim(0, dim))
    return full.movedim(0, dim).contiguous()


def reduce_scatter_along(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's part, along ``dim``, of the sum of ``t`` over ``group``:
    rank r of n gets the r-th of n equal slices."""
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // dist.get_world_size(group),) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _MeanFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sums, count, groups):
        both = torch.cat([sums.reshape(-1), sums.new_full((1,), float(count))])
        ranks = 1
        for group in groups:
            both = all_reduce_sum(both, group)
            ranks *= dist.get_world_size(group)
        total = both[-1]
        ctx.scale = ranks / total
        return both[:-1].reshape(sums.shape) / total

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None, None


class _GatherParts(torch.autograd.Function):
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
    return _CopyTo.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partial products over the tp ``group``; the
    gradient passes through (each rank's partial sum gets all of it)."""
    return _ReduceFrom.apply(x, group)


def copy_to_ep(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient is summed over the ep ``group`` (the
    tokens and gates feed every rank's experts)."""
    return _CopyTo.apply(x, group)


def reduce_from_ep(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' expert outputs over the ep ``group``; the
    gradient passes through (each rank's experts get all of it)."""
    return _ReduceFrom.apply(x, group)


def token_mean(sums: torch.Tensor, count: int, groups) -> torch.Tensor:
    """The mean over all the tokens of ``groups`` (dp, sp) of a per-token
    statistic, from ``sums``, its sum over this rank's ``count`` tokens
    (none on a rank with no rows): the sums and the counts are summed over
    the groups.  Each rank's loss holds the replicated mean, and the train
    step divides each rank's gradients by the ranks of the groups (a mean
    over dp, each sp chunk's share): the gradient of ``sums`` is scaled by
    that number over the global count, so that every token's gradient
    carries its 1/n, n the global token count, whatever the shares."""
    return _MeanFrom.apply(sums, count, tuple(groups))


def share_mean(x: torch.Tensor, share: float) -> torch.Tensor:
    """``share`` times the mean of ``x`` over this rank's rows, where
    ``share`` is its rows times dp over the batch's (1 where dp divides the
    batch): summed over dp and divided by dp, the ranks' values give the
    batch's mean.  On a rank with no rows it is 0, with a zero gradient."""
    if x.numel() == 0:
        return x.sum()
    return torch.mean(x) * share


def gather_parts(part: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``part``s concatenated along ``dim`` over ``group``; the
    gradient is summed over the group and cut back to this rank's part, as
    GSPMD's gather transposes.  ZeRO-3 gathers its parameters so over dp;
    the model gathers heads so over tp where each rank needs heads others
    computed (Ulysses over heads sp does not divide per rank, heads that tp
    does not divide)."""
    return _GatherParts.apply(part, dim, group)


def kv_copy_sources(config: ModelConfig, tp_rank: int, tp: int) -> Optional[torch.Tensor]:
    """For each k and v column of rank ``tp_rank``'s ``[q | k | v]`` (after
    its ``hidden_size/tp`` q columns), its column in the full ``[k | v]``
    block; None when tp divides ``kv_heads`` and no column is a copy."""
    if tp == 1 or config.kv_heads % tp == 0 or uneven_heads(config, tp):
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
