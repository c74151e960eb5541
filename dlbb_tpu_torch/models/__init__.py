"""The decoder, dense or MoE (counterpart of ``dlbb_tpu/models``), on one
device or as a rank's part of a (dp, sp, pp, ep, tp) mesh
(``models.sharding``)."""

from dlbb_tpu_torch.models.configs import MODEL_CONFIGS, ModelConfig
from dlbb_tpu_torch.models.transformer import (
    forward,
    forward_flops,
    init_params,
    num_parameters,
)
from dlbb_tpu_torch.models.weights import params_from_jax

__all__ = [
    "MODEL_CONFIGS",
    "ModelConfig",
    "forward",
    "forward_flops",
    "init_params",
    "num_parameters",
    "params_from_jax",
]
