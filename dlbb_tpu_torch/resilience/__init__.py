"""Resilience (counterpart of ``dlbb_tpu/resilience``, host-only copies):
the failure taxonomy (``errors``), the fault-injection registry
(``inject``), graceful preemption (``preempt``), the append-only journal
(``journal``), artifact validation (``validate``) and the chaos gate
(``chaos``, ``cli chaos``), which drives the sweep, the checkpointer, the
serving harness and the fleet under each fault class (ROADMAP Queue 1,
Slice F, item 13)."""

from dlbb_tpu_torch.resilience.chaos import run_chaos
from dlbb_tpu_torch.resilience.errors import CheckpointCorruption
from dlbb_tpu_torch.resilience.journal import SweepJournal
from dlbb_tpu_torch.resilience.preempt import PreemptionGuard

__all__ = ["CheckpointCorruption", "PreemptionGuard", "SweepJournal", "run_chaos"]
