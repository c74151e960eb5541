"""Parallelism plans (counterpart of ``dlbb_tpu/parallel``)."""

from dlbb_tpu_torch.parallel.plan import ParallelismPlan

__all__ = ["ParallelismPlan"]
