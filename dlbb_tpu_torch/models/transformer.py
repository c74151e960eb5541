"""Decoder forward, dense or MoE (counterpart of
``dlbb_tpu/models/transformer.py``).

Pre-LN block: ln1 -> fused QKV -> attention -> out-proj -> residual;
ln2 -> FFN up -> gelu -> FFN down -> residual; final LN.  Parameters keep the
JAX package's stacked ``[L, ...]`` layout and its ``[in, out]`` kernels
(``y @ kernel + bias``), as a nested dict of tensors, so JAX weights carry
across without a transpose (``models/weights.py``).  A plain Python loop over
the layers takes the place of ``lax.scan``.  The large projection and FFN
products are ``torch.matmul``, as the JAX package leaves them to XLA.

``forward(..., mesh=plan.mesh)`` runs the Megatron tensor-parallel forward
(the reference paper's third level, ``models.py``/``run_mpi.py``) on this
rank's shards (``models/sharding.py``): each column-parallel product and
the attention run on the rank's heads and FFN columns, and each of the two
row-parallel products per layer is summed over the mesh's tp group
(``sharding.reduce_from_tp``), after which its bias and the residual are
added, once (the reference's ``models.py:95``; the all-reduces GSPMD
inserts in JAX).  With gradients, ``sharding.copy_to_tp`` on each
LayerNorm output that feeds a column-parallel product sums its gradient
over the tp group.  Where tp does not divide the heads, the rank's qkv
columns are a contiguous 1/tp of the fused ones, gathered over tp before
attention (``_uneven_attention``); where sp does not divide a rank's
heads under Ulysses, the heads are gathered over tp first.  Without a
mesh the forward is the single-device one.

``forward(..., dp_axes=...)`` is ZeRO-3's (``train/zero.py``): ``params``
are this rank's dp shards, each leaf cut along its ``dp_axes`` entry, and
every block all-gathers its layer's slices over the mesh's dp group on use
(``sharding.gather_parts``, whose gradient is reduce-scattered back to the
shard), inside the remat region, so that the recompute gathers again, as
XLA's FSDP gather does under ``jax.checkpoint``.  A stacked leaf cut along
its layer axis is gathered whole, once per forward; ``ln_f`` is gathered
where it is used.

``config.remat`` wraps each block in ``torch.utils.checkpoint`` when
gradients are being recorded: ``remat_policy="full"`` saves nothing of the
block, ``"dots"`` saves the outputs of the matrix products (``aten.mm``,
``addmm``, ``bmm``) and recomputes the rest, the counterpart of
``jax.checkpoint_policies.dots_saveable``.  Under either policy the flash
forward is recomputed in the backward, as in JAX, where a ``pallas_call``
output is not a dot.  Without gradients (the e2e path) the blocks run as
they are.

``config.tp_overlap`` ("ring" or "bidir", on a mesh whose tp is above 1)
routes the four tensor-parallel projections of each block through the
ring-decomposed collective matmuls (``parallel/collective_matmul.py``): the
residual stream is sequence-sharded over tp, ``forward`` takes this rank's
chunk of the sequence at entry (``seq_chunk``) and returns its chunk of the
output, each column-parallel projection gathers the sequence behind
partial products (``allgather_matmul``, its bias added to the gathered
output) and each row-parallel one reduce-scatters it back
(``matmul_reducescatter``, its bias added to the chunk).  The LayerNorms and
the row-parallel biases then act on each rank's own chunk, so their
gradients are partial sums over tp (``train/loop.py`` sums them).

With an ``sp`` axis (``attention`` "ring" or "ulysses") ``x`` is the rank's
sp slice of the sequence and attention runs over the mesh's sp group
(``parallel/ring_attention.py``, ``parallel/ulysses.py``) on the rank's tp
heads.  With sp above 1 "flash" raises JAX's message, and "full" and
"dense" raise the plan's (``configs.validate_attention_parallelism``): on
the rank's slice they would attend within it only, where GSPMD gathers the
sequence.

With ``num_experts`` above 0 the FFN is the top-k gated mixture of experts
(``_moe_ffn``: the router, ``router_probs_gates`` and ``moe_aux_loss`` in
fp32, then the dense or the capacity dispatch; the experts keep the dense
FFN's tanh gelu).  On a mesh each rank runs its ep slice of the experts on
its tp columns: the expert input and the gates pass ``copy_to_tp`` and
``copy_to_ep``, the experts' partial sums are summed over tp, the
``ffn_down`` bias term (whole over tp) is added once, and the combine is
summed over ep (``reduce_from_ep``).  The router runs whole on every rank.
``_block`` returns ``(x, aux)``, the layer's load-balancing loss where
``forward(with_aux=True)`` asks for it (its token means taken over the dp
and sp groups, ``sharding.token_mean``), else None; ``forward`` returns the
layer mean beside the output.  A mesh with a pp axis above 1 hands the
whole forward to the pipeline engine (``parallel/pipeline.py``).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from dlbb_tpu_torch.models.attention import dense_attention
from dlbb_tpu_torch.models.configs import (
    ModelConfig,
    param_shapes,
    validate_attention_parallelism,
)
from dlbb_tpu_torch.models.sharding import (
    all_gather_along,
    copy_to_ep,
    copy_to_tp,
    gather_parts,
    local_config,
    reduce_from_ep,
    reduce_from_tp,
    shard_leaf,
    token_mean,
)
from dlbb_tpu_torch.ops.flash_attention import flash_attention, kernel_accepts
from dlbb_tpu_torch.parallel.collective_matmul import (
    allgather_matmul,
    matmul_reducescatter,
    seq_chunk,
)
from dlbb_tpu_torch.parallel.ring import hop_transport
from dlbb_tpu_torch.parallel.ring_attention import ring_attention
from dlbb_tpu_torch.parallel.ulysses import ulysses_attention

Params = dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def init_params(config: ModelConfig, seed: int, device, tp_rank: int = 0,
                tp: int = 1, pp_rank: int = 0, pp: int = 1, ep_rank: int = 0,
                ep: int = 1) -> Params:
    """Stacked-layer parameters, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``: scaled-normal kernels
    (1/sqrt(fan_in)), zero biases, unit LN scales — the JAX init's
    distribution, not its numbers (the parity tests carry JAX weights across
    with ``params_from_jax`` instead).  A MoE model (``num_experts`` above 0)
    has the JAX tree's router ``[L, H, E]`` and experts ``ffn_up``
    ``[L, E, H, F]`` and ``ffn_down`` ``[L, E, F, H]``.

    On a mesh, rank ``(pp_rank, ep_rank, tp_rank)`` draws the same full
    leaves, one at a time, and keeps its part of each (``sharding.
    shard_leaf``: its stage's layers, its experts, its tp shard): the same
    seed gives the same model on every mesh, and the peak is one full
    leaf."""
    h, f, L = config.hidden_size, config.ffn_intermediate, config.num_layers
    dtype = DTYPES[config.dtype]
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def cut(group, leaf, t):
        return shard_leaf(group, leaf, t, config, tp_rank, tp, pp_rank, pp, ep_rank, ep)

    def kernel(group, shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return cut(group, "kernel", w.div_(math.sqrt(fan_in)))

    def zeros(group, *shape):
        return cut(group, "bias", torch.zeros(shape, device=device, dtype=dtype))

    def ones(group, *shape):
        return cut(group, "scale", torch.ones(shape, device=device, dtype=dtype))

    qkvw = config.qkv_width
    e = (config.num_experts,) if config.is_moe else ()
    # the kernels are drawn in this order: qkv, out, ffn_up, ffn_down and,
    # for MoE, the router
    layers = {
        "ln1": {"scale": ones("ln1", L, h), "bias": zeros("ln1", L, h)},
        "qkv": {"kernel": kernel("qkv", (L, h, qkvw), h), "bias": zeros("qkv", L, qkvw)},
        "out": {"kernel": kernel("out", (L, h, h), h), "bias": zeros("out", L, h)},
        "ln2": {"scale": ones("ln2", L, h), "bias": zeros("ln2", L, h)},
        "ffn_up": {"kernel": kernel("ffn_up", (L, *e, h, f), h),
                   "bias": zeros("ffn_up", L, *e, f)},
        "ffn_down": {"kernel": kernel("ffn_down", (L, *e, f, h), f),
                     "bias": zeros("ffn_down", L, *e, h)},
    }
    if config.is_moe:
        # router logits in the params dtype; the gating math runs in fp32
        layers["router"] = {"kernel": kernel("router", (L, h, config.num_experts), h)}
    return {"layers": layers,
            "ln_f": {"scale": torch.ones(h, device=device, dtype=dtype),
                     "bias": torch.zeros(h, device=device, dtype=dtype)}}


def meta_params(config: ModelConfig) -> Params:
    """``init_params``' tree as ``meta`` tensors of the global shapes
    (``configs.param_shapes``) and the config's dtype: the layout without
    the storage (a checkpoint restored onto another mesh cuts it,
    ``train/checkpoint.py``)."""
    dtype = DTYPES[config.dtype]

    def meta(node):
        if isinstance(node, dict):
            return {k: meta(v) for k, v in node.items()}
        return torch.empty(node, dtype=dtype, device="meta")

    return meta(param_shapes(config))


def _layernorm(x, scale, bias, out=None):
    # statistics in fp32, population variance, eps 1e-5, scale and bias
    # applied in fp32, result cast back (transformer.py:103-108 there);
    # ``out`` takes the result (the bias add rounds into it, as ``.to``)
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + 1e-5)
    if out is not None:
        return torch.add(y * scale.float(), bias.float(), out=out)
    return (y * scale.float() + bias.float()).to(x.dtype)


# "full" takes the kernel from this sequence length up, on lane-aligned S,
# the JAX package's rule.  Its threshold was set on another device; the
# H100's own crossover is not measured yet.
FLASH_ROUTE_MIN_SEQ = 512


def flash_route(q_shape, dtype: torch.dtype, device_type: str) -> bool:
    """Whether ``attention="full"`` runs the flash kernel for ``q`` of this
    shape, dtype and device type.  JAX routes to its kernel only on a TPU,
    so on the CPU "full" is dense in both packages."""
    return (device_type == "cuda"
            and kernel_accepts(q_shape, dtype)
            and q_shape[2] >= FLASH_ROUTE_MIN_SEQ
            and q_shape[2] % 128 == 0)


def _sp_size(mesh) -> int:
    return 1 if mesh is None else mesh.shape.get("sp", 1)


def _attend(q, k, v, config: ModelConfig, mesh=None):
    """``[B, n, S, d]`` q and ``[B, kvh, S, d]`` k, v -> ``[B, n, S, d]``
    by ``config.attention``'s route; the head counts are the tensors'."""
    n, kvh = q.shape[1], k.shape[1]
    sp = _sp_size(mesh)
    if config.attention in ("ring", "ulysses"):
        # sequence-parallel attention over the mesh's sp group, on this
        # rank's tp heads (parallel/ring_attention.py's docstring)
        if mesh is None or "sp" not in mesh.axis_names:
            raise ValueError(
                f"attention={config.attention!r} needs a mesh with a 'sp' "
                "axis passed to forward()"
            )
        if config.attention == "ring":
            return ring_attention(q, k, v, mesh, causal=config.causal)
        if kvh != n and kvh % sp != 0:
            # Ulysses all-to-alls the head dim over sp; kv heads that
            # sp does not divide cannot stay grouped (JAX's fallback)
            k = k.repeat_interleave(n // kvh, dim=1)
            v = v.repeat_interleave(n // kvh, dim=1)
        return ulysses_attention(q, k, v, mesh, causal=config.causal)
    if sp > 1:
        if config.attention == "flash":
            raise ValueError(
                "attention='flash' does not partition the sequence; use "
                "attention='ring' or 'ulysses' when sequence_parallel > 1"
            )
        validate_attention_parallelism(config, sp)
    if config.attention == "flash" or (
            config.attention == "full"
            and flash_route(q.shape, q.dtype, q.device.type)):
        # the kernel takes contiguous [B, N, S, D]
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=config.causal)
    return dense_attention(q, k, v, causal=config.causal)


def _uneven_attention(qkv, config: ModelConfig, mesh):
    """This rank's ``[B, S, H/tp]`` attention features where tp does not
    divide the heads: ``qkv`` is the rank's contiguous 1/tp of the fused
    columns (``sharding.uneven_heads``), ``config`` the model's.  The
    columns are gathered over tp, the heads that overlap the rank's
    features attend (widened to whole kv groups, so that a kv head serving
    several ranks' query heads is read whole; Ulysses takes every head, as
    it all-to-alls them over sp), and the rank's features are cut out."""
    tp, r = mesh.shape["tp"], mesh.coords["tp"]
    full = gather_parts(qkv, 2, mesh.axis_groups["tp"])  # [B, S, qkv_width]
    h, d, n, kvh = config.hidden_size, config.head_dim, config.num_heads, config.kv_heads
    lo, hi = r * h // tp, (r + 1) * h // tp
    if config.attention == "simplified":
        return full[:, :, lo:hi]
    b, s, _ = full.shape
    g = n // kvh
    if config.attention == "ulysses":
        h0, h1 = 0, n
    else:  # the first and last heads of the features, widened to kv groups
        h0, h1 = lo // d // g * g, ((hi - 1) // d // g + 1) * g
    k0, k1 = h0 // g, h1 // g

    def heads(c0, c1):  # columns [c0, c1) -> [B, (c1 - c0)/d, S, d]
        return full[:, :, c0:c1].reshape(b, s, (c1 - c0) // d, d).transpose(1, 2)

    o = _attend(heads(h0 * d, h1 * d), heads(h + k0 * d, h + k1 * d),
                heads(h + (kvh + k0) * d, h + (kvh + k1) * d), config, mesh)
    o = o.transpose(1, 2).reshape(b, s, (h1 - h0) * d)
    return o[:, :, lo - h0 * d:hi - h0 * d]


def _attention(qkv, config: ModelConfig, mesh=None):
    """qkv: [B, S, qkv_width] -> [B, S, H]: on a tp mesh the rank's
    columns and features, ``config`` its ``local_config``."""
    if qkv.shape[-1] != config.qkv_width:
        # a contiguous 1/tp of the columns: tp does not divide the heads
        return _uneven_attention(qkv, config, mesh)
    h = config.hidden_size
    if config.attention == "simplified":
        # the reference's benchmarking shortcut: the query projection is
        # the attention output
        return qkv[:, :, :h]
    b, s, _ = qkv.shape
    n, d, kvh = config.num_heads, config.head_dim, config.kv_heads

    def heads(t, nh):  # [B, S, nh*d] -> [B, nh, S, d]
        return t.reshape(b, s, nh, d).transpose(1, 2)

    q = heads(qkv[:, :, :h], n)
    k = heads(qkv[:, :, h:h + kvh * d], kvh)
    v = heads(qkv[:, :, h + kvh * d:], kvh)
    tp = 1 if mesh is None else mesh.shape["tp"]
    if config.attention == "ulysses" and tp > 1 and n % _sp_size(mesh) != 0:
        # sp does not divide the rank's heads: gather every head over tp,
        # as GSPMD does for JAX's shard_map, attend, keep the rank's own
        group, r = mesh.axis_groups["tp"], mesh.coords["tp"]
        q, k, v = (gather_parts(t, 1, group) for t in (q, k, v))
        o = _attend(q, k, v, config, mesh).narrow(1, r * n, n)
    else:
        o = _attend(q, k, v, config, mesh)
    return o.transpose(1, 2).reshape(b, s, n * d)


def router_probs_gates(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 softmax router distribution and the top-k routing weights
    (the k largest probabilities renormalised to sum 1): ``(probs, gates)``,
    both ``[..., E]``, gates with exactly k nonzeros.  Of equal
    probabilities the lower expert index wins, as in ``jax.lax.top_k``: a
    stable descending sort keeps equal values in index order, where
    ``torch.topk`` promises no order."""
    probs = torch.softmax(logits.float(), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    mask = torch.zeros_like(probs).scatter_(-1, top, 1.0)
    gated = probs * mask
    return probs, gated / gated.sum(dim=-1, keepdim=True)


def top_k_gates(logits: torch.Tensor, k: int) -> torch.Tensor:
    """The top-k routing weights of ``router_probs_gates``."""
    return router_probs_gates(logits, k)[1]


def moe_aux_loss(probs: torch.Tensor, gates: torch.Tensor, k: int,
                 groups=()) -> torch.Tensor:
    """Switch-Transformer load-balancing loss, generalised to top-k:
    ``E * sum_e f_e * P_e``, ``f_e`` the fraction of routing slots sent to
    expert e, ``P_e`` its mean router probability, both over the
    ``[B, S]`` tokens; 1.0 at perfect balance.  ``groups`` are the process
    groups that cut the batch's tokens (dp, sp): both means are taken over
    all of them, from the ranks' sums and token counts
    (``sharding.token_mean``), as GSPMD takes JAX's over the global batch."""
    num_experts = probs.shape[-1]
    if not groups:
        f = (gates > 0).float().mean(dim=(0, 1)) / k
        return num_experts * torch.sum(f * probs.mean(dim=(0, 1)))
    sums = torch.stack([(gates > 0).float().sum(dim=(0, 1)) / k, probs.sum(dim=(0, 1))])
    f, p = token_mean(sums, probs.shape[0] * probs.shape[1], groups).unbind(0)
    return num_experts * torch.sum(f * p)


def moe_capacity(config: ModelConfig, seq_len: int) -> int:
    """Per-expert capacity slots per sequence (the GShard formula:
    capacity_factor x tokens x k / E, at least 1 and at most seq_len)."""
    c = math.ceil(config.moe_capacity_factor * seq_len * config.moe_top_k
                  / config.num_experts)
    return max(1, min(c, seq_len))


def _expert_groups(mesh):
    """(tp group, ep group, ep rank) of a mesh; None, None, 0 without one
    (and None for an axis the mesh lacks)."""
    if mesh is None:
        return None, None, 0
    ep = mesh.axis_groups["ep"] if "ep" in mesh.axis_names else None
    return mesh.axis_groups["tp"], ep, mesh.coords.get("ep", 0)


def _earlier_chunk_claims(mask: torch.Tensor, mesh) -> torch.Tensor:
    """``[B, E]``: per row and expert, the routing slots of the sequence
    chunks before this sp rank's (an exclusive scan of ``mask`` [B, S/sp,
    E]'s counts over the sp group, whose ranks hold the chunks in order)."""
    counts = mask.sum(dim=1, dtype=torch.int32)
    every = all_gather_along(counts[None], 0, mesh.axis_groups["sp"])  # [sp, B, E]
    return every[:mesh.coords["sp"]].sum(dim=0, dtype=torch.int32)


def _moe_ffn(y, layer: Params, config: ModelConfig, mesh=None, aux_groups=None):
    """Route and dispatch ``y`` [B, S, H] -> ``(out, aux)``: the FFN output
    and, where ``aux_groups`` is given (a tuple of token groups), the
    layer's ``moe_aux_loss``, else None.  The routing is the same for both
    dispatches, on the full ``[B, S, E]`` gates on every rank:

    - dense (``_moe_ffn_dense`` there): every local expert runs on every
      token, the gates (zero outside the top k) weight the combination;
    - capacity (``_moe_ffn_capacity``): each sequence is a dispatch group,
      each expert has ``moe_capacity`` slots per group, and the (token,
      expert) routing slots claim them in sequence order by a per-expert
      cumulative count over the full gates, taken before the expert dim is
      cut to this rank's slice and, under sp, over the whole sequence (the
      capacity of the full length, the count offset by the earlier chunks'
      claims); a slot past the capacity is dropped (the
      token keeps its other experts at their unrenormalised weights, or
      only the residual).

    Module docstring: the conjugate pairs over tp and ep."""
    logits = y @ layer["router"]["kernel"]                       # [B, S, E]
    probs, gates = router_probs_gates(logits, config.moe_top_k)  # fp32
    aux = (None if aux_groups is None
           else moe_aux_loss(probs, gates, config.moe_top_k, aux_groups))
    tp_group, ep_group, ep_rank = _expert_groups(mesh)
    up_w, up_b = layer["ffn_up"]["kernel"], layer["ffn_up"]["bias"]
    down_w, down_b = layer["ffn_down"]["kernel"], layer["ffn_down"]["bias"]
    n_local = up_w.shape[0]
    experts = slice(ep_rank * n_local, (ep_rank + 1) * n_local)
    keep = None
    if config.moe_dispatch == "capacity":
        mask = gates > 0
        # the slot each routing slot would take in its expert's queue
        pos = torch.cumsum(mask.to(torch.int32), dim=1) - 1     # [B, S, E]
        seq_len = y.shape[1]
        if _sp_size(mesh) > 1:
            # y is this rank's chunk of the sequence: the queues run over
            # the whole sequence, behind the earlier chunks' claims
            pos = pos + _earlier_chunk_claims(mask, mesh)[:, None, :]
            seq_len *= _sp_size(mesh)
        cap = moe_capacity(config, seq_len)
        keep = (mask & (pos < cap))[..., experts]
        dispatch = ((pos[..., experts, None] == torch.arange(cap, device=y.device))
                    & keep[..., None]).to(y.dtype)              # [B, S, E_l, C]
    g = gates if ep_group is None else copy_to_ep(gates, ep_group)
    g = g[..., experts]
    x = y
    if tp_group is not None:
        x = copy_to_tp(x, tp_group)
    if ep_group is not None:
        x = copy_to_ep(x, ep_group)
    g_tp = g if tp_group is None else copy_to_tp(g, tp_group)
    if keep is None:
        up = torch.einsum("bsh,ehf->bsef", x, up_w) + up_b
        act = F.gelu(up, approximate="tanh")
        part = torch.einsum("bsef,efh->bseh", act, down_w)       # tp partial sums
        out = torch.einsum("bseh,bse->bsh", part, g_tp.to(y.dtype))
        w_bias = g
    else:
        expert_in = torch.einsum("bsec,bsh->bech", dispatch, x)  # [B, E_l, C, H]
        up = torch.einsum("bech,ehf->becf", expert_in, up_w) + up_b[None, :, None, :]
        act = F.gelu(up, approximate="tanh")
        part = torch.einsum("becf,efh->bech", act, down_w)
        combine = dispatch * g_tp.to(y.dtype)[..., None]         # [B, S, E_l, C]
        out = torch.einsum("bsec,bech->bsh", combine, part)
        w_bias = g * keep
    if tp_group is not None:
        out = reduce_from_tp(out, tp_group)
    # the ffn_down bias of each expert, at the weight of its kept slots
    out = out + torch.einsum("bse,eh->bsh", w_bias.to(y.dtype), down_b)
    if ep_group is not None:
        out = reduce_from_ep(out, ep_group)
    return out, aux


def use_tp_overlap(config: ModelConfig, mesh) -> bool:
    """Whether this (config, mesh) pair routes the tensor-parallel
    projections through the ring-decomposed collective matmuls.  The knob is
    inert without a tp axis above 1, so one device and tp=1 keep the
    ordinary path bit for bit."""
    return (config.tp_overlap != "off" and mesh is not None
            and "tp" in mesh.axis_names and mesh.shape["tp"] > 1)


def ring_transport(config: ModelConfig, mesh, device) -> Optional[str]:
    """How the ring hops of a forward on ``device`` move
    (``parallel/ring.py::hop_transport``, over the tp group under
    ``tp_overlap`` and the sp group under ring attention), None where it
    makes none."""
    if use_tp_overlap(config, mesh):
        return hop_transport(mesh.axis_groups["tp"], device)
    if config.attention == "ring" and _sp_size(mesh) > 1:
        return hop_transport(mesh.axis_groups["sp"], device)
    return None


def _projections(config: ModelConfig, mesh):
    """``(col, row)``: the column- and row-parallel products ``f(y, p)`` of
    a block, ``p`` holding the kernel and bias.

    - tp_overlap: ``allgather_matmul`` / ``matmul_reducescatter``;
    - a mesh: the column input is the same on every tp rank, so its
      gradient is summed over tp (``copy_to_tp``); the row product's partial
      sums are summed over tp (``reduce_from_tp``), then the bias, once;
    - one device: ``y @ kernel + bias``."""
    if use_tp_overlap(config, mesh):
        sched = config.tp_overlap

        def col(y, p):
            return allgather_matmul(y, p["kernel"], mesh, schedule=sched) + p["bias"]

        def row(y, p):
            return matmul_reducescatter(y, p["kernel"], mesh, schedule=sched) + p["bias"]
    elif mesh is not None:
        group = mesh.axis_groups["tp"]

        def col(y, p):
            return copy_to_tp(y, group) @ p["kernel"] + p["bias"]

        def row(y, p):
            return reduce_from_tp(y @ p["kernel"], group) + p["bias"]
    else:
        def col(y, p):
            return y @ p["kernel"] + p["bias"]

        def row(y, p):
            return y @ p["kernel"] + p["bias"]
    return col, row


def _gather_layer(layer: Params, fsdp) -> Params:
    """ZeRO-3: each leaf of this layer that is a dp shard, all-gathered
    along its axis over the dp group; ``fsdp`` is ``(dp group, axis per
    leaf)``, None where a leaf is whole."""
    group, axes = fsdp
    return {name: {p: (t if axes[name][p] is None
                       else gather_parts(t, axes[name][p], group))
                   for p, t in sub.items()}
            for name, sub in layer.items()}


def _block(x, layer: Params, config: ModelConfig, mesh=None, fsdp=None,
           aux_groups=None):
    """One block: ``(x, aux)``, aux the layer's MoE load-balancing loss
    where ``aux_groups`` asks for it (``_moe_ffn``), else None."""
    if fsdp is not None:
        layer = _gather_layer(layer, fsdp)
    col, row = _projections(config, mesh)
    residual = x
    y = _layernorm(x, layer["ln1"]["scale"], layer["ln1"]["bias"])
    qkv = col(y, layer["qkv"])
    attn = _attention(qkv, config, mesh)
    x = row(attn, layer["out"]) + residual

    residual = x
    y = _layernorm(x, layer["ln2"]["scale"], layer["ln2"]["bias"])
    if config.is_moe:
        out, aux = _moe_ffn(y, layer, config, mesh, aux_groups)
        return out + residual, aux
    y = col(y, layer["ffn_up"])
    # jax.nn.gelu defaults to approximate=True: the tanh form, not erf
    y = F.gelu(y, approximate="tanh")
    return row(y, layer["ffn_down"]) + residual, None


# the matrix products that remat_policy="dots" keeps
_DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default))


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_block(x, layer: Params, config: ModelConfig, mesh=None, fsdp=None,
                 aux_groups=None):
    if config.remat_policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _dots_saveable)
        return checkpoint(_block, x, layer, config, mesh, fsdp, aux_groups,
                          use_reentrant=False, context_fn=context_fn)
    return checkpoint(_block, x, layer, config, mesh, fsdp, aux_groups,
                      use_reentrant=False)


def token_groups(mesh) -> tuple:
    """The process groups that cut a batch's tokens on ``mesh`` (dp and sp,
    where above 1): the MoE load-balancing loss takes its means over them."""
    if mesh is None:
        return ()
    return tuple(mesh.axis_groups[a] for a in ("dp", "sp") if mesh.shape.get(a, 1) > 1)


def layer_list(stacked: Params, mesh=None, dp_axes=None) -> tuple[list, Any]:
    """``(layers, fsdp)``: the stacked ``[L, ...]`` leaves as one parameter
    dict per layer, and ZeRO-3's ``(dp group, axis per leaf)`` for the
    blocks' gathers (None without ``dp_axes``, the tree of each stacked
    leaf's dp axis).  A leaf cut along its layer axis is gathered whole,
    here, once; the others are gathered layer by layer inside the blocks.
    One unbind per stacked parameter: its gradient is one stack of the
    layers' gradients (indexing ``t[i]`` instead would add a zero-filled
    full-size ``[L, ...]`` gradient per layer)."""
    fsdp = None
    if dp_axes is not None:
        group = mesh.axis_groups["dp"]
        stacked = {name: {p: (gather_parts(t, 0, group) if dp_axes[name][p] == 0 else t)
                          for p, t in sub.items()}
                   for name, sub in stacked.items()}
        fsdp = (group, {name: {p: (None if ax in (None, 0) else ax - 1)
                               for p, ax in sub.items()}
                        for name, sub in dp_axes.items()})
    unbound = {name: {p: t.unbind(0) for p, t in sub.items()}
               for name, sub in stacked.items()}
    n = len(next(iter(next(iter(unbound.values())).values())))
    return [{name: {p: ts[i] for p, ts in sub.items()} for name, sub in unbound.items()}
            for i in range(n)], fsdp


def run_layers(x, layers: list, config: ModelConfig, mesh=None, fsdp=None,
               with_aux: bool = False):
    """The blocks of ``layers`` in order (remat per block where
    ``config.remat`` and gradients are recorded): ``(x, aux)``, aux the sum
    of the layers' load-balancing losses where ``with_aux`` on a MoE model,
    else None.  ``config`` is this rank's (``local_config``)."""
    block = _remat_block if config.remat and torch.is_grad_enabled() else _block
    groups = token_groups(mesh) if with_aux and config.is_moe else None
    total = None
    for layer in layers:
        x, aux = block(x, layer, config, mesh, fsdp, groups)
        if aux is not None:
            total = aux if total is None else total + aux
    return x, total


def final_norm(x, ln_f: Params, mesh=None, dp_axes=None):
    """``ln_f`` on ``x``, its ZeRO-3 shards gathered over dp first where
    ``dp_axes`` (its tree of dp axes) cuts them."""
    if dp_axes is not None:
        group = mesh.axis_groups["dp"]
        ln_f = {p: (t if dp_axes[p] is None else gather_parts(t, dp_axes[p], group))
                for p, t in ln_f.items()}
    return _layernorm(x, ln_f["scale"], ln_f["bias"])


def forward(params: Params, x: torch.Tensor, config: ModelConfig,
            mesh=None, dp_axes=None, num_microbatches: Optional[int] = None,
            with_aux: bool = False):
    """Full forward pass: the layers in order, then the final LN.

    ``mesh`` (a ``comm.Mesh`` with ``dp``, ``tp`` and maybe ``sp``, ``pp``
    and ``ep`` axes, ``ParallelismPlan.mesh``) runs the tensor-parallel
    forward over its tp group: ``params`` are this rank's parts and ``x``
    its dp rows and sp slice of the sequence (``sharding.batch_spec``),
    ``config`` the full model's.  With ``tp_overlap`` the output is this
    rank's chunk of the sequence (``collective_matmul.seq_chunk``).  A pp
    axis above 1 runs the GPipe engine (``pipeline.pipeline_forward``, in
    ``num_microbatches`` microbatches, by default one per stage).
    ``dp_axes`` (ZeRO-3, with a mesh) is the tree of each leaf's dp axis,
    None where a leaf is whole (module docstring).  ``with_aux`` returns
    ``(y, aux)``, aux the layer mean of the MoE load-balancing loss (0.0
    for a dense FFN)."""
    if mesh is not None and mesh.shape.get("pp", 1) > 1:
        from dlbb_tpu_torch.parallel.pipeline import pipeline_forward

        return pipeline_forward(params, x, config, mesh,
                                num_microbatches=num_microbatches,
                                with_aux=with_aux, dp_axes=dp_axes)
    if mesh is not None:
        if use_tp_overlap(config, mesh):
            x = seq_chunk(x, mesh)
        local = local_config(config, mesh.shape["tp"])
    else:
        local = config
    layers, fsdp = layer_list(params["layers"], mesh,
                              None if dp_axes is None else dp_axes["layers"])
    x, aux = run_layers(x, layers, local, mesh, fsdp, with_aux)
    y = final_norm(x, params["ln_f"], mesh, None if dp_axes is None else dp_axes["ln_f"])
    if not with_aux:
        return y
    if aux is None:
        return y, torch.zeros((), dtype=torch.float32, device=y.device)
    return y, aux / config.num_layers


def num_parameters(config: ModelConfig) -> int:
    """Total parameter count; a MoE model counts every expert and the
    router."""
    h, f, L = config.hidden_size, config.ffn_intermediate, config.num_layers
    if config.is_moe:
        E = config.num_experts
        ffn = h * E + E * (h * f + f) + E * (f * h + h)
    else:
        ffn = (h * f + f) + (f * h + h)
    qkvw = config.qkv_width
    per_layer = 2 * h + h * qkvw + qkvw + h * h + h + 2 * h + ffn
    return L * per_layer + 2 * h


def forward_flops(config: ModelConfig, batch_size: int, seq_len: int) -> int:
    """Analytic forward FLOPs (multiply-adds as 2; layernorm, gelu, softmax
    and gating omitted), the JAX package's count: a MoE FFN counts the
    router, the dispatch and combine einsums and the experts' products on
    every token (dense) or on their capacity slots."""
    h, f, L = config.hidden_size, config.ffn_intermediate, config.num_layers
    tokens = batch_size * seq_len
    qkv = 2 * tokens * h * config.qkv_width
    out = 2 * tokens * h * h
    attn = 0 if config.attention == "simplified" else 4 * batch_size * seq_len * seq_len * h
    if config.is_moe:
        E = config.num_experts
        router = 2 * tokens * h * E
        if config.moe_dispatch == "capacity":
            cap = moe_capacity(config, seq_len)
            slots = batch_size * E * cap
            dispatch = 2 * (2 * tokens * E * cap * h)
        else:
            slots = tokens * E
            dispatch = 2 * tokens * E * h
        ffn = router + dispatch + 2 * slots * h * f * 2
    else:
        ffn = 2 * tokens * h * f * 2
    return L * (qkv + attn + out + ffn)
