"""Resilience (counterpart of ``dlbb_tpu/resilience``, host-only copies):
the failure taxonomy (``errors``), the fault-injection registry
(``inject``), graceful preemption (``preempt``) and the append-only journal
(``journal``).  The sweep runner wires them (ROADMAP Queue 1, Slice F, item
13, parts 13a and 13b); the chaos gate comes with part 13c."""

from dlbb_tpu_torch.resilience.errors import CheckpointCorruption
from dlbb_tpu_torch.resilience.journal import SweepJournal
from dlbb_tpu_torch.resilience.preempt import PreemptionGuard

__all__ = ["CheckpointCorruption", "PreemptionGuard", "SweepJournal"]
