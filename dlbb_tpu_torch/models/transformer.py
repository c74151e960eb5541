"""Dense decoder forward (counterpart of ``dlbb_tpu/models/transformer.py``).

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
over the tp group.  Without a mesh the forward is the single-device one.

``forward(..., dp_axes=...)`` is ZeRO-3's (``train/zero.py``): ``params``
are this rank's dp shards, each leaf cut along its ``dp_axes`` entry, and
every block all-gathers its layer's slices over the mesh's dp group on use
(``sharding.gather_dp``, whose gradient is reduce-scattered back to the
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
from dlbb_tpu_torch.models.configs import ModelConfig, validate_attention_parallelism
from dlbb_tpu_torch.models.sharding import (
    copy_to_tp,
    gather_dp,
    local_config,
    reduce_from_tp,
    shard_leaf,
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
                tp: int = 1) -> Params:
    """Stacked-layer parameters, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``: scaled-normal kernels
    (1/sqrt(fan_in)), zero biases, unit LN scales — the JAX init's
    distribution, not its numbers (the parity tests carry JAX weights across
    with ``params_from_jax`` instead).

    With ``tp`` above 1, rank ``tp_rank`` draws the same full leaves, one at
    a time, and keeps its shard of each (``sharding.shard_leaf``): the same
    seed gives the same model at every tp, and the peak is one full leaf."""
    _check_dense_ffn(config)
    h, f, L = config.hidden_size, config.ffn_intermediate, config.num_layers
    dtype = DTYPES[config.dtype]
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def kernel(group, shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return shard_leaf(group, "kernel", w.div_(math.sqrt(fan_in)), config,
                          tp_rank, tp)

    def zeros(group, *shape):
        return shard_leaf(group, "bias", torch.zeros(shape, device=device, dtype=dtype),
                          config, tp_rank, tp)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    qkvw = config.qkv_width
    # the kernels are drawn in this order: qkv, out, ffn_up, ffn_down
    layers = {
        "ln1": {"scale": ones(L, h), "bias": zeros("ln1", L, h)},
        "qkv": {"kernel": kernel("qkv", (L, h, qkvw), h), "bias": zeros("qkv", L, qkvw)},
        "out": {"kernel": kernel("out", (L, h, h), h), "bias": zeros("out", L, h)},
        "ln2": {"scale": ones(L, h), "bias": zeros("ln2", L, h)},
        "ffn_up": {"kernel": kernel("ffn_up", (L, h, f), h),
                   "bias": zeros("ffn_up", L, f)},
        "ffn_down": {"kernel": kernel("ffn_down", (L, f, h), f),
                     "bias": zeros("ffn_down", L, h)},
    }
    return {"layers": layers,
            "ln_f": {"scale": ones(h), "bias": zeros("ln_f", h)}}


def _layernorm(x, scale, bias):
    # statistics in fp32, population variance, eps 1e-5, scale and bias
    # applied in fp32, result cast back (transformer.py:103-108 there)
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + 1e-5)
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


def _attention(qkv, config: ModelConfig, mesh=None):
    """qkv: [B, S, qkv_width] -> [B, S, H]."""
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
            o = ring_attention(q, k, v, mesh, causal=config.causal)
        else:
            if kvh != n and kvh % sp != 0:
                # Ulysses all-to-alls the head dim over sp; kv heads that
                # sp does not divide cannot stay grouped (JAX's fallback)
                k = k.repeat_interleave(n // kvh, dim=1)
                v = v.repeat_interleave(n // kvh, dim=1)
            o = ulysses_attention(q, k, v, mesh, causal=config.causal)
    elif sp > 1:
        if config.attention == "flash":
            raise ValueError(
                "attention='flash' does not partition the sequence; use "
                "attention='ring' or 'ulysses' when sequence_parallel > 1"
            )
        validate_attention_parallelism(config, sp)
    elif config.attention == "flash" or (
            config.attention == "full"
            and flash_route(q.shape, q.dtype, q.device.type)):
        # the kernel takes contiguous [B, N, S, D]
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=config.causal)
    else:
        o = dense_attention(q, k, v, causal=config.causal)
    return o.transpose(1, 2).reshape(b, s, n * d)


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
                       else gather_dp(t, axes[name][p], group))
                   for p, t in sub.items()}
            for name, sub in layer.items()}


def _block(x, layer: Params, config: ModelConfig, mesh=None, fsdp=None):
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
    y = col(y, layer["ffn_up"])
    # jax.nn.gelu defaults to approximate=True: the tanh form, not erf
    y = F.gelu(y, approximate="tanh")
    return row(y, layer["ffn_down"]) + residual


# the matrix products that remat_policy="dots" keeps
_DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default))


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_block(x, layer: Params, config: ModelConfig, mesh=None, fsdp=None):
    if config.remat_policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _dots_saveable)
        return checkpoint(_block, x, layer, config, mesh, fsdp,
                          use_reentrant=False, context_fn=context_fn)
    return checkpoint(_block, x, layer, config, mesh, fsdp, use_reentrant=False)


def forward(params: Params, x: torch.Tensor, config: ModelConfig,
            mesh=None, dp_axes=None) -> torch.Tensor:
    """Full forward pass: the layers in order, then the final LN.

    ``mesh`` (a ``comm.Mesh`` with ``dp``, ``tp`` and maybe ``sp`` axes,
    ``ParallelismPlan.mesh``) runs the tensor-parallel forward over its tp
    group: ``params`` are this rank's shards and ``x`` its dp rows and sp
    slice of the sequence (``sharding.batch_spec``), ``config`` the full
    model's.  With ``tp_overlap`` the output is this rank's chunk of the
    sequence (``collective_matmul.seq_chunk``).  ``dp_axes`` (ZeRO-3, with
    a mesh) is the tree of each leaf's dp axis, None where a leaf is whole
    (module docstring)."""
    _check_dense_ffn(config)
    fsdp = None
    if mesh is not None:
        if use_tp_overlap(config, mesh):
            x = seq_chunk(x, mesh)
        config = local_config(config, mesh.shape["tp"])
    stacked = params["layers"]
    ln_f = params["ln_f"]
    if dp_axes is not None:
        dp_group = mesh.axis_groups["dp"]
        # a leaf cut along its layer axis is gathered whole, here; the
        # others are gathered layer by layer inside the blocks
        stacked = {name: {p: (gather_dp(t, 0, dp_group) if dp_axes["layers"][name][p] == 0
                              else t) for p, t in sub.items()}
                   for name, sub in stacked.items()}
        fsdp = (dp_group, {name: {p: (None if ax in (None, 0) else ax - 1)
                                  for p, ax in sub.items()}
                           for name, sub in dp_axes["layers"].items()})
        ln_f = {p: (t if dp_axes["ln_f"][p] is None
                    else gather_dp(t, dp_axes["ln_f"][p], dp_group))
                for p, t in ln_f.items()}
    block = functools.partial(
        _remat_block if config.remat and torch.is_grad_enabled() else _block,
        mesh=mesh, fsdp=fsdp)
    # one unbind per stacked parameter: its gradient is one stack of the
    # layers' gradients (indexing t[i] instead would add a zero-filled
    # full-size [L, ...] gradient per layer)
    layers = {name: {p: t.unbind(0) for p, t in group.items()}
              for name, group in stacked.items()}
    for i in range(config.num_layers):
        layer = {name: {p: ts[i] for p, ts in group.items()}
                 for name, group in layers.items()}
        x = block(x, layer, config)
    return _layernorm(x, ln_f["scale"], ln_f["bias"])


def _check_dense_ffn(config: ModelConfig) -> None:
    if config.is_moe:
        raise NotImplementedError("MoE FFNs are not ported to dlbb_tpu_torch yet")


def num_parameters(config: ModelConfig) -> int:
    """Total parameter count of the dense decoder."""
    _check_dense_ffn(config)
    h, f, L = config.hidden_size, config.ffn_intermediate, config.num_layers
    qkvw = config.qkv_width
    per_layer = (2 * h + h * qkvw + qkvw + h * h + h + 2 * h
                 + (h * f + f) + (f * h + h))
    return L * per_layer + 2 * h


def forward_flops(config: ModelConfig, batch_size: int, seq_len: int) -> int:
    """Analytic forward FLOPs (multiply-adds as 2; layernorm, gelu and
    softmax omitted), the JAX package's count."""
    _check_dense_ffn(config)
    h, f, L = config.hidden_size, config.ffn_intermediate, config.num_layers
    tokens = batch_size * seq_len
    qkv = 2 * tokens * h * config.qkv_width
    out = 2 * tokens * h * h
    attn = 0 if config.attention == "simplified" else 4 * batch_size * seq_len * seq_len * h
    ffn = 2 * tokens * h * f * 2
    return L * (qkv + attn + out + ffn)
