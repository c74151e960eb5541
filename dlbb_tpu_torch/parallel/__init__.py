"""Parallelism (counterpart of ``dlbb_tpu/parallel``): the plan, the
overlapped collective matmul, sequence-parallel attention and the
pipeline engines."""

from dlbb_tpu_torch.parallel.collective_matmul import (
    allgather_matmul,
    matmul_reducescatter,
)
from dlbb_tpu_torch.parallel.pipeline import (
    pipeline_1f1b_grads,
    pipeline_forward,
    schedule_1f1b,
    validate_pipeline,
)
from dlbb_tpu_torch.parallel.plan import ParallelismPlan
from dlbb_tpu_torch.parallel.ring_attention import ring_attention
from dlbb_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "ParallelismPlan",
    "allgather_matmul",
    "matmul_reducescatter",
    "pipeline_1f1b_grads",
    "pipeline_forward",
    "ring_attention",
    "schedule_1f1b",
    "ulysses_attention",
    "validate_pipeline",
]
