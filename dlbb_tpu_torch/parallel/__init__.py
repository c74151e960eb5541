"""Parallelism (counterpart of ``dlbb_tpu/parallel``): the plan, the
overlapped collective matmul and sequence-parallel attention."""

from dlbb_tpu_torch.parallel.collective_matmul import (
    allgather_matmul,
    matmul_reducescatter,
)
from dlbb_tpu_torch.parallel.plan import ParallelismPlan
from dlbb_tpu_torch.parallel.ring_attention import ring_attention
from dlbb_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "ParallelismPlan",
    "allgather_matmul",
    "matmul_reducescatter",
    "ring_attention",
    "ulysses_attention",
]
