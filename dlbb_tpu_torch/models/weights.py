"""Carry JAX parameters into the port.

``params_from_jax`` takes the pytree that
``dlbb_tpu.models.transformer.init_params`` returns, with every leaf
converted by ``np.asarray``, dense or MoE (router ``[L, H, E]``, experts
``[L, E, H, F]`` and ``[L, E, F, H]``).  The layout is the same on both
sides (stacked ``[L, ...]``, ``[in, out]`` kernels), so only the types
change.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from dlbb_tpu_torch.models.configs import ModelConfig
from dlbb_tpu_torch.models.transformer import DTYPES, Params


def _to_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    # torch.from_numpy rejects ml_dtypes.bfloat16; every bf16 value is
    # exact in float32, so the round trip through float32 is lossless
    host = np.asarray(a).astype(np.float32)
    return torch.from_numpy(host).to(device=device, dtype=dtype)


def params_from_jax(tree: dict[str, Any], config: ModelConfig,
                    device="cpu") -> Params:
    """The JAX parameter pytree (numpy leaves) as the port's parameters, in
    the model dtype, on ``device``."""
    dtype = DTYPES[config.dtype]

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _to_tensor(node, dtype, device)

    return convert(tree)
