"""Synthetic embedding batches (counterpart of ``dlbb_tpu/data/synthetic.py``).

One fixed, seeded ``[batch, seq_len, hidden]`` batch returned on every
``get_batch()``.  The draw is the JAX package's own
(``np.random.default_rng(seed).standard_normal(..., float32)``), rounded to
the model dtype the same way, so both packages see bit-identical inputs.
Under data and sequence parallelism the global batch is drawn the same
way and cut by ``batch_slice``: rank ``dp_rank`` of ``dp`` keeps rows
``[dp_rank B/dp, (dp_rank + 1) B/dp)`` and rank ``sp_rank`` of ``sp`` the
sequence positions ``[sp_rank S/sp, (sp_rank + 1) S/sp)``, the slice JAX's
``device_put`` gives it under ``batch_spec`` (``models/sharding.py::
batch_spec`` gives a mesh's ranks and sizes).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def batch_slice(a, dp_rank: int = 0, dp: int = 1, sp_rank: int = 0, sp: int = 1):
    """Rank ``(dp_rank, sp_rank)``'s rows and sequence positions of a global
    ``[B, S, ...]`` array or tensor (a view)."""
    b, s = a.shape[:2]
    if b % dp != 0:
        raise ValueError(f"input.batch_size={b} not divisible by data_parallel={dp}")
    if s % sp != 0:
        raise ValueError(f"sequence length {s} not divisible by sp={sp}")
    rows, cols = b // dp, s // sp
    return a[dp_rank * rows:(dp_rank + 1) * rows, sp_rank * cols:(sp_rank + 1) * cols]


class SyntheticEmbeddingDataset:
    def __init__(self, batch_size: int, seq_length: int, hidden_size: int,
                 seed: int = 42, dtype: torch.dtype = torch.bfloat16,
                 device="cpu", dp_rank: int = 0, dp: int = 1, sp_rank: int = 0,
                 sp: int = 1) -> None:
        self.batch_size = batch_size
        self.seq_length = seq_length
        self.hidden_size = hidden_size
        self.seed = seed
        host = np.random.default_rng(seed).standard_normal(
            (batch_size, seq_length, hidden_size), dtype=np.float32)
        host = np.ascontiguousarray(batch_slice(host, dp_rank, dp, sp_rank, sp))
        self._batch = torch.from_numpy(host).to(device=device, dtype=dtype)

    def get_batch(self) -> torch.Tensor:
        return self._batch


def create_dataset_from_config(config: dict[str, Any], dtype=torch.bfloat16,
                               device="cpu", hidden_size: Optional[int] = None,
                               seed_offset: int = 0, dp_rank: int = 0,
                               dp: int = 1, sp_rank: int = 0,
                               sp: int = 1) -> SyntheticEmbeddingDataset:
    """Build from the YAML ``input:`` + ``model:`` sections;
    ``seed_offset`` derives another batch from the same config (the
    training targets are seed + 1); ``dp_rank``/``dp`` and
    ``sp_rank``/``sp`` select a slice (``batch_slice``)."""
    if hidden_size is None:
        hidden_size = config["model"]["hidden_size"]
    return SyntheticEmbeddingDataset(
        batch_size=config["input"]["batch_size"],
        seq_length=config["input"]["sequence_length"],
        hidden_size=hidden_size,
        seed=config["input"].get("seed", 42) + seed_offset,
        dtype=dtype,
        device=device,
        dp_rank=dp_rank,
        dp=dp,
        sp_rank=sp_rank,
        sp=sp,
    )
