"""Model size configurations (counterpart of ``dlbb_tpu/models/configs.py``).

The dataclass keeps every field of the JAX ``ModelConfig`` and the same
validation, so one config dict is accepted by both packages.  The dense
forward (single device and tensor parallel) and its training (DDP, ZeRO
and tensor parallel) are ported, remat included: fields that select MoE or ``tp_overlap``
are accepted and validated here, and rejected by the model code that does
not run them yet.  The parallelism validators are the JAX package's, with
its messages; ``validate_tp_shards`` is the port's own.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any


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
    # "ring" | "ulysses" — sequence-parallel, not ported yet.
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


def validate_tp_shards(config: ModelConfig, tp: int) -> None:
    """Refuse a tensor-parallel degree that does not divide every sharded
    dimension.  The port's shards are explicit tensors, one per rank; GSPMD
    pads an uneven shard, explicit shards cannot."""
    for name in ("hidden_size", "num_heads", "ffn_intermediate"):
        if getattr(config, name) % tp != 0:
            raise ValueError(
                f"{name}={getattr(config, name)} not divisible by the "
                f"tensor-parallel degree {tp} (parallelism.world_size): the "
                "port shards it evenly over tp"
            )
