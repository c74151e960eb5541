"""Model size configurations (counterpart of ``dlbb_tpu/models/configs.py``).

The dataclass keeps every field of the JAX ``ModelConfig`` and the same
validation, so one config dict is accepted by both packages, and the model
code runs every field (the MoE FFN included).  The parallelism validators are the JAX
package's, with its messages; ``validate_tp_shards`` states the refusal of
JAX's pjit in the port's words.  The serving envelope
(``validate_serving``) and the KV-cache footprint formulas
(``kv_cache_bytes*``) are the JAX package's, with its messages; the HBM
budget is always the caller's (``hbm_budget_bytes``), never a default.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional


@dataclass(frozen=True)
class ModelConfig:
    hidden_size: int
    num_layers: int
    num_heads: int
    ffn_intermediate: int
    # "full" — exact attention, routed to the CUDA flash kernel where
    #   ``transformer.flash_route`` allows it, to ``dense_attention`` else;
    # "dense" — exact attention, ``dense_attention`` always;
    # "simplified" — the reference's shortcut (query third of the QKV
    #   projection is the attention output); "flash" — force the kernel;
    # "ring" | "ulysses" — sequence-parallel over the mesh's sp axis.
    attention: str = "full"
    dtype: str = "bfloat16"
    # Grouped-query attention: K/V heads (None = num_heads, 1 = MQA).
    num_kv_heads: int | None = None
    causal: bool = True
    num_experts: int = 0
    moe_top_k: int = 2
    moe_dispatch: str = "dense"
    moe_capacity_factor: float = 1.25
    remat: bool = False
    tp_overlap: str = "off"
    remat_policy: str = "full"

    def __post_init__(self) -> None:
        if self.hidden_size % self.num_heads != 0:
            raise ValueError(
                f"hidden_size {self.hidden_size} not divisible by "
                f"num_heads {self.num_heads}"
            )
        if self.attention not in ("full", "dense", "simplified", "flash",
                                  "ring", "ulysses"):
            raise ValueError(f"unknown attention mode {self.attention!r}")
        if self.num_experts < 0:
            raise ValueError(f"num_experts must be >= 0, got {self.num_experts}")
        if self.num_experts > 0 and not (
                1 <= self.moe_top_k <= self.num_experts):
            raise ValueError(
                f"moe_top_k={self.moe_top_k} must be in [1, "
                f"num_experts={self.num_experts}]"
            )
        if self.moe_dispatch not in ("dense", "capacity"):
            raise ValueError(
                f"unknown moe_dispatch {self.moe_dispatch!r} "
                "(expected 'dense' or 'capacity')"
            )
        if self.moe_capacity_factor <= 0:
            raise ValueError(
                f"moe_capacity_factor must be > 0, got "
                f"{self.moe_capacity_factor}"
            )
        if self.tp_overlap not in ("off", "ring", "bidir"):
            raise ValueError(
                f"unknown tp_overlap {self.tp_overlap!r} "
                "(expected 'off', 'ring', or 'bidir')"
            )
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r} "
                "(expected 'full' or 'dots')"
            )
        if self.num_kv_heads is not None:
            if not 1 <= self.num_kv_heads <= self.num_heads:
                raise ValueError(
                    f"num_kv_heads={self.num_kv_heads} must be in "
                    f"[1, num_heads={self.num_heads}]"
                )
            if self.num_heads % self.num_kv_heads != 0:
                raise ValueError(
                    f"num_heads={self.num_heads} not divisible by "
                    f"num_kv_heads={self.num_kv_heads}"
                )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        """Effective K/V head count (GQA; == num_heads for full MHA)."""
        return self.num_kv_heads or self.num_heads

    @property
    def qkv_width(self) -> int:
        """Fused QKV projection width: H + 2 * kv_heads * head_dim."""
        return self.hidden_size + 2 * self.kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ModelConfig":
        """Build from the YAML ``model:`` section.  A ``size:`` key selects
        a named config; explicit fields override it."""
        d = dict(d)
        size = d.pop("size", None)
        base = MODEL_CONFIGS[size] if size else None
        fields = {}
        for k in (
            "hidden_size", "num_layers", "num_heads", "ffn_intermediate",
            "attention", "dtype", "num_kv_heads", "causal",
            "num_experts", "moe_top_k",
            "moe_dispatch", "moe_capacity_factor", "tp_overlap",
            "remat", "remat_policy",
        ):
            if k in d:
                fields[k] = d[k]
            elif base is not None:
                fields[k] = getattr(base, k)
        return cls(**fields)


# Attention modes the serving engine's paged-cache path supports: the
# cache stores K/V at kv_heads width and decode attends over it with the
# exact dense kernel, so only the exact-MHA modes qualify ("simplified"
# has no K/V at all; ring/ulysses partition the sequence the cache owns).
SERVABLE_ATTENTION = ("full", "dense")

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}

# serving.kv_quantization values the paged cache supports: "int8"
# stores K/V blocks as int8 with one fp32 scale per (layer, slot,
# block, kv-head) as a side-channel plane (serve/kvcache.QuantKVCache).
KV_QUANTIZATION_MODES = ("none", "int8")


def kv_cache_bytes_raw(num_layers: int, max_batch: int, max_seq: int,
                       kv_heads: int, head_dim: int,
                       dtype: str = "bfloat16",
                       kv_quantization: str = "none",
                       block_size: Optional[int] = None) -> int:
    """The one KV-cache footprint formula, on raw geometry (for callers
    holding a serialized model record instead of a ModelConfig): K + V,
    every layer,
    every slot, ``max_seq`` tokens at GQA ``kv_heads`` width.

    ``kv_quantization="int8"`` prices the quantized layout instead:
    1 byte per K/V element plus the fp32 scale side-channel (one scale
    per block per kv-head, needing ``block_size``)."""
    if kv_quantization not in KV_QUANTIZATION_MODES:
        raise ValueError(
            f"kv_quantization={kv_quantization!r} not in "
            f"{KV_QUANTIZATION_MODES}"
        )
    elems = 2 * num_layers * max_batch * max_seq * kv_heads
    if kv_quantization == "int8":
        if block_size is None or block_size < 1 or max_seq % block_size:
            raise ValueError(
                "kv_quantization='int8' needs a positive block_size "
                f"dividing max_seq={max_seq} to price the per-block "
                f"scale plane (got block_size={block_size})"
            )
        # int8 data + fp32 scales [L, B, num_blocks, kvh] for K and V
        return elems * head_dim + (elems // block_size) * 4
    return elems * head_dim * _DTYPE_BYTES.get(dtype, 2)


def kv_cache_bytes(config: ModelConfig, max_batch: int,
                   max_seq: int, kv_quantization: str = "none",
                   block_size: Optional[int] = None) -> int:
    """Total (unsharded) KV-cache footprint of a serving config: K + V,
    every layer, every slot, ``max_seq`` tokens at GQA ``kv_heads``
    width, in the model dtype (or the int8 + fp32-scale layout when
    quantized)."""
    return kv_cache_bytes_raw(config.num_layers, max_batch, max_seq,
                              config.kv_heads, config.head_dim,
                              config.dtype,
                              kv_quantization=kv_quantization,
                              block_size=block_size)


def kv_cache_bytes_per_device(config: ModelConfig, max_batch: int,
                              max_seq: int, dp: int = 1,
                              tp: int = 1,
                              kv_quantization: str = "none",
                              block_size: Optional[int] = None) -> int:
    """Per-device KV-cache footprint under the serving sharding contract
    (slot dim over dp, kv-head dim over tp, ``serve/kvcache.py::
    shard_cache``): the number the build-time budget gate
    (``validate_serving``) prices.  The scale side-channel of the int8
    layout shards over the same dp × tp axes as the data it scales, so one
    divisor covers both."""
    shards = max(1, dp) * (tp if tp > 1 else 1)
    return kv_cache_bytes(config, max_batch, max_seq,
                          kv_quantization=kv_quantization,
                          block_size=block_size) // shards


def validate_serving(config: ModelConfig, max_batch: int, max_seq: int,
                     block_size: int, dp: int = 1, tp: int = 1,
                     hbm_budget_bytes: Optional[int] = None,
                     draft_config: Optional[ModelConfig] = None,
                     kv_quantization: str = "none") -> None:
    """Reject serving configurations the engine cannot run — at build
    time, with a clear error, never as an OOM (or a wrong answer) in the
    middle of a trace.

    Covers the model envelope (exact-MHA attention, dense FFN, no
    tp_overlap), the cache divisibility contract (blocks tile max_seq;
    dp tiles the slot dim; tp tiles kv_heads), and — when
    ``hbm_budget_bytes`` is set — the per-device KV-cache HBM footprint:
    ``max_batch x max_seq`` K/V at kv_heads width, divided by the dp x tp
    shards that actually partition it.

    ``draft_config`` is the speculative-decoding draft model
    (``serving.speculation="draft-model"``): it is validated against the
    SAME mesh and cache geometry (the draft plane is sharded by the same
    ``ParallelismPlan``, so e.g. its ``kv_heads % tp`` contract is
    identical), and its resident weights + second KV-cache plane are
    priced INTO the HBM budget alongside the target cache — an
    infeasible ``(spec, max_batch, gamma)`` combination fails here at
    build time, not as an OOM mid-trace.

    ``kv_quantization="int8"`` prices the quantized cache layout (int8
    data + fp32 per-block scales) against the budget — the capacity
    lever that admits more resident requests per HBM byte."""
    if kv_quantization not in KV_QUANTIZATION_MODES:
        raise ValueError(
            f"serving.kv_quantization={kv_quantization!r} not in "
            f"{KV_QUANTIZATION_MODES}"
        )
    if config.attention not in SERVABLE_ATTENTION:
        raise ValueError(
            f"serving requires attention in {SERVABLE_ATTENTION} "
            f"(attention={config.attention!r}: the paged KV-cache stores "
            "exact per-position K/V; simplified has none and ring/ulysses "
            "partition the sequence the cache owns)"
        )
    if config.is_moe:
        raise ValueError(
            "serving requires a dense FFN (model.num_experts == 0); the "
            "MoE dispatch path is not wired into the decode step"
        )
    if config.tp_overlap != "off":
        raise ValueError(
            f"serving requires model.tp_overlap='off' (got "
            f"{config.tp_overlap!r}): the ring schedules gather the "
            "sequence dim, which decode steps of length 1 cannot shard"
        )
    if max_batch < 1:
        raise ValueError(f"serving.max_batch must be >= 1, got {max_batch}")
    if block_size < 1 or max_seq % block_size != 0:
        raise ValueError(
            f"serving.max_seq={max_seq} must be a positive multiple of "
            f"serving.block_size={block_size} (the cache is paged in "
            "whole blocks)"
        )
    if dp > 1 and max_batch % dp != 0:
        raise ValueError(
            f"serving.max_batch={max_batch} not divisible by dp={dp} "
            "(decode slots shard over the dp axis)"
        )
    if tp > 1 and config.kv_heads % tp != 0:
        raise ValueError(
            f"kv_heads={config.kv_heads} not divisible by tp={tp}: the "
            "KV-cache shards its head dim over tp, so GQA configs need "
            "kv_heads % tp == 0 (pick a smaller tp or more kv heads)"
        )
    if draft_config is not None:
        try:
            validate_serving(draft_config, max_batch, max_seq, block_size,
                             dp=dp, tp=tp)
        except ValueError as e:
            raise ValueError(
                f"speculative draft model is not servable on the same "
                f"ParallelismPlan (dp={dp}, tp={tp}): {e}"
            ) from e
    if hbm_budget_bytes is not None:
        per_device = kv_cache_bytes_per_device(
            config, max_batch, max_seq, dp=dp, tp=tp,
            kv_quantization=kv_quantization, block_size=block_size)
        draft_bytes = 0
        if draft_config is not None:
            # the draft plane is resident for the whole trace: weights
            # (sharded over tp like the target's) + its own paged
            # KV-cache plane, priced against the SAME budget
            from dlbb_tpu_torch.models.transformer import num_parameters

            draft_bytes = (
                num_parameters(draft_config)
                * _DTYPE_BYTES.get(draft_config.dtype, 2)
                // (tp if tp > 1 else 1)
                + kv_cache_bytes_per_device(
                    draft_config, max_batch, max_seq, dp=dp, tp=tp)
            )
        if per_device + draft_bytes > hbm_budget_bytes:
            draft_note = (
                f" + speculative draft plane {draft_bytes / 2**30:.2f} "
                "GiB (weights + second KV-cache)" if draft_bytes else "")
            raise ValueError(
                f"serving KV-cache footprint {per_device / 2**30:.2f} GiB "
                f"per device (max_batch={max_batch} x max_seq={max_seq} "
                f"x {config.num_layers} layers x kv_heads="
                f"{config.kv_heads} x head_dim={config.head_dim} x 2 "
                "(K+V), "
                + (f"int8 + fp32 scales per {block_size}-token block"
                   if kv_quantization == "int8"
                   else f"{_DTYPE_BYTES[config.dtype]} B [{config.dtype}]")
                + f", sharded over dp={dp} x tp={tp})"
                f"{draft_note} "
                f"exceeds the HBM budget of "
                f"{hbm_budget_bytes / 2**30:.2f} GiB — shrink max_batch/"
                "max_seq or raise serving.hbm_budget_gb if the device "
                "really has the headroom"
            )


# Reference sizes (the same table as dlbb_tpu.models.configs.MODEL_CONFIGS).
MODEL_CONFIGS: dict[str, ModelConfig] = {
    "1B": ModelConfig(hidden_size=2048, num_layers=24, num_heads=16,
                      ffn_intermediate=8192),
    "7B": ModelConfig(hidden_size=4096, num_layers=32, num_heads=32,
                      ffn_intermediate=16384),
    "13B": ModelConfig(hidden_size=5120, num_layers=40, num_heads=40,
                       ffn_intermediate=20480),
}


# Attention modes that partition the sequence dimension over an sp mesh
# axis (the JAX package's SP_CAPABLE_ATTENTION).
SP_CAPABLE_ATTENTION = ("ring", "ulysses")


def validate_attention_parallelism(config: ModelConfig, sp: int) -> None:
    """Reject attention-mode / sequence-parallel combinations that would
    silently compute the wrong thing or replicate work per sp shard."""
    if config.attention in SP_CAPABLE_ATTENTION and sp <= 1:
        raise ValueError(
            f"attention={config.attention!r} requires "
            "parallelism.sequence_parallel > 1"
        )
    if sp > 1 and config.attention not in SP_CAPABLE_ATTENTION:
        raise ValueError(
            f"parallelism.sequence_parallel={sp} requires attention in "
            f"{SP_CAPABLE_ATTENTION} (attention={config.attention!r} does "
            "not partition the sequence; it would run replicated per sp "
            "shard)"
        )


def validate_tp_overlap(config: ModelConfig, tp: int, pp: int = 1,
                        seq_len: int = 0, sp: int = 1) -> None:
    """Reject tp_overlap combinations the decomposed schedule cannot run:
    it needs a real tp axis, an even sequence split, a dense FFN and no
    pipeline."""
    if config.tp_overlap == "off":
        return
    if tp <= 1:
        raise ValueError(
            f"model.tp_overlap={config.tp_overlap!r} requires "
            "parallelism.world_size (tp) > 1 — without a tp axis there is "
            "no collective to overlap"
        )
    if pp > 1:
        raise ValueError(
            f"model.tp_overlap={config.tp_overlap!r} is incompatible with "
            "pipeline_parallel > 1 (the pipeline engine owns the "
            "activation layout)"
        )
    if config.is_moe:
        raise ValueError(
            f"model.tp_overlap={config.tp_overlap!r} requires a dense FFN "
            "(the MoE expert dispatch is not ring-decomposed; run MoE "
            "models with tp_overlap='off')"
        )
    if seq_len and seq_len % (tp * max(1, sp)) != 0:
        raise ValueError(
            f"input.sequence_length={seq_len} not divisible by the "
            f"sequence-shard count {tp * max(1, sp)} (tp={tp}"
            f"{f' x sp={sp}' if sp > 1 else ''}) required by "
            f"tp_overlap={config.tp_overlap!r}"
        )


def validate_expert_parallelism(config: ModelConfig, ep: int) -> None:
    """Reject expert-parallel degrees that cannot shard the expert dim."""
    if ep <= 1:
        return
    if not config.is_moe:
        raise ValueError(
            f"parallelism.expert_parallel={ep} requires a MoE model "
            "(model.num_experts > 0)"
        )
    if config.num_experts % ep != 0:
        raise ValueError(
            f"num_experts={config.num_experts} not divisible by "
            f"expert_parallel={ep}"
        )


def param_shapes(config: ModelConfig) -> dict[str, Any]:
    """The global shape of every parameter leaf, in ``init_params``' tree
    (JAX's ``init_params`` layout)."""
    h, f, L, w = (config.hidden_size, config.ffn_intermediate, config.num_layers,
                  config.qkv_width)
    e = (config.num_experts,) if config.is_moe else ()
    layers = {"ln1": {"scale": (L, h), "bias": (L, h)},
              "qkv": {"kernel": (L, h, w), "bias": (L, w)},
              "out": {"kernel": (L, h, h), "bias": (L, h)},
              "ln2": {"scale": (L, h), "bias": (L, h)},
              "ffn_up": {"kernel": (L, *e, h, f), "bias": (L, *e, f)},
              "ffn_down": {"kernel": (L, *e, f, h), "bias": (L, *e, h)}}
    if config.is_moe:
        layers["router"] = {"kernel": (L, h, config.num_experts)}
    return {"layers": layers, "ln_f": {"scale": (h,), "bias": (h,)}}


def validate_tp_shards(config: ModelConfig, tp: int) -> None:
    """Refuse a tensor-parallel degree that does not divide a sharded
    parameter dimension, naming the first such leaf in JAX's order, as
    JAX's pjit does when ``init_params_sharded`` lays out the parameters
    (GSPMD pads no parameter).  The heads need not divide: the port then
    gathers the qkv activations over tp (``transformer._uneven_attention``),
    as JAX runs that case."""
    from dlbb_tpu_torch.models.sharding import tp_dim

    layers = param_shapes(config)["layers"]
    for group in sorted(layers):  # JAX's pytree order
        for leaf in sorted(layers[group]):
            dim, shape = tp_dim(group, leaf, config.is_moe), layers[group][leaf]
            if tp > 1 and dim is not None and shape[dim] % tp != 0:
                path = f"layers.{group}.{leaf}"
                raise ValueError(
                    f"{path} (global shape {shape}) is sharded over tp on its "
                    f"dimension {dim}, which implies that dimension {dim} should be "
                    f"divisible by the tensor-parallel degree {tp}, but it is equal "
                    f"to {shape[dim]} (JAX's pjit refuses the same layout)"
                )
