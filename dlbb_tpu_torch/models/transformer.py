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
row-parallel products per layer is summed over the mesh's tp group by
``dist.all_reduce``, after which its bias and the residual are added, once
(the reference's ``models.py:95``; the all-reduces GSPMD inserts in JAX).
The tensor-parallel forward runs without gradients: TP training is ROADMAP
Queue 1, Slice D, item 2, and it raises while gradients are recorded.
Without a mesh the forward is the single-device one.

``config.remat`` wraps each block in ``torch.utils.checkpoint`` when
gradients are being recorded: ``remat_policy="full"`` saves nothing of the
block, ``"dots"`` saves the outputs of the matrix products (``aten.mm``,
``addmm``, ``bmm``) and recomputes the rest, the counterpart of
``jax.checkpoint_policies.dots_saveable``.  Under either policy the flash
forward is recomputed in the backward, as in JAX, where a ``pallas_call``
output is not a dot.  Without gradients (the e2e path) the blocks run as
they are.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from dlbb_tpu_torch.models.attention import dense_attention
from dlbb_tpu_torch.models.configs import ModelConfig
from dlbb_tpu_torch.models.sharding import local_config, shard_leaf
from dlbb_tpu_torch.ops.flash_attention import flash_attention, kernel_accepts

Params = dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def _check_ported(config: ModelConfig) -> None:
    _check_dense_ffn(config)
    if config.attention in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention={config.attention!r} (sequence parallel) is not "
            "ported to dlbb_tpu_torch yet")
    if config.tp_overlap != "off":
        raise NotImplementedError("tp_overlap needs a tp mesh, not ported yet")


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
    _check_ported(config)
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


def _attention(qkv, config: ModelConfig):
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
    if config.attention == "flash" or (
            config.attention == "full"
            and flash_route(q.shape, q.dtype, q.device.type)):
        # the kernel takes contiguous [B, N, S, D]
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=config.causal)
    else:
        o = dense_attention(q, k, v, causal=config.causal)
    return o.transpose(1, 2).reshape(b, s, n * d)


def _row(y, p: Params, tp_group):
    """Row-parallel product: this rank's partial sums over its input
    features, summed over the tp group, then the bias, once."""
    out = y @ p["kernel"]
    if tp_group is not None:
        dist.all_reduce(out, group=tp_group)
    return out + p["bias"]


def _block(x, layer: Params, config: ModelConfig, tp_group=None):
    residual = x
    y = _layernorm(x, layer["ln1"]["scale"], layer["ln1"]["bias"])
    qkv = y @ layer["qkv"]["kernel"] + layer["qkv"]["bias"]
    attn = _attention(qkv, config)
    x = _row(attn, layer["out"], tp_group) + residual

    residual = x
    y = _layernorm(x, layer["ln2"]["scale"], layer["ln2"]["bias"])
    y = y @ layer["ffn_up"]["kernel"] + layer["ffn_up"]["bias"]
    # jax.nn.gelu defaults to approximate=True: the tanh form, not erf
    y = F.gelu(y, approximate="tanh")
    return _row(y, layer["ffn_down"], tp_group) + residual


# the matrix products that remat_policy="dots" keeps
_DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default))


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_block(x, layer: Params, config: ModelConfig):
    if config.remat_policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _dots_saveable)
        return checkpoint(_block, x, layer, config, use_reentrant=False,
                          context_fn=context_fn)
    return checkpoint(_block, x, layer, config, use_reentrant=False)


def forward(params: Params, x: torch.Tensor, config: ModelConfig,
            mesh=None) -> torch.Tensor:
    """Full forward pass: the layers in order, then the final LN.

    ``mesh`` (a ``comm.Mesh`` with a ``tp`` axis, ``ParallelismPlan.mesh``)
    runs the tensor-parallel forward over its tp group: ``params`` are this
    rank's shards and ``x`` its dp slice of the batch, ``config`` the full
    model's (module docstring)."""
    _check_ported(config)
    tp_group = None
    if mesh is not None:
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "the tensor-parallel forward runs without gradients; TP "
                "training is ROADMAP Queue 1, Slice D, item 2")
        tp_group = mesh.axis_groups["tp"]
        config = local_config(config, mesh.shape["tp"])
    block = (_remat_block if config.remat and torch.is_grad_enabled()
             else functools.partial(_block, tp_group=tp_group))
    # one unbind per stacked parameter: its gradient is one stack of the
    # layers' gradients (indexing t[i] instead would add a zero-filled
    # full-size [L, ...] gradient per layer)
    layers = {name: {p: t.unbind(0) for p, t in group.items()}
              for name, group in params["layers"].items()}
    for i in range(config.num_layers):
        layer = {name: {p: ts[i] for p, ts in group.items()}
                 for name, group in layers.items()}
        x = block(x, layer, config)
    return _layernorm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])


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
