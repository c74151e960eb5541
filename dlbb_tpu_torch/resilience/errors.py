"""Failure taxonomy for the resilience subsystem (a host-only copy of
``dlbb_tpu/resilience/errors.py``; the port imports nothing of the JAX
package).

The port's checkpointer (``train/checkpoint.py``) raises
:class:`CheckpointCorruption`; the sweep runner's retry and quarantine
paths that classify the others come with ROADMAP Queue 1, Slice F, item
13.  In the JAX package every hardened execution path (``bench/runner``,
``bench/schedule``, ``train/checkpoint``) classifies exceptions against
these types:

- **transient** faults (:class:`TransientFault`, :class:`CorruptStats`)
  are retried with exponential backoff — the retry recomputes from
  scratch (fresh payload, fresh measurement) so a retried config's
  published stats contain nothing from the failed attempt;
- everything else is **permanent**: the config is quarantined (journaled
  ``failed`` with its exception chain in ``sweep_manifest.json``), never
  silently skipped.
"""

from __future__ import annotations

import traceback


class InjectedFault(RuntimeError):
    """Base class for faults raised by the injection registry
    (``dlbb_tpu_torch.resilience.inject``) — never raised in production runs."""


class TransientFault(InjectedFault):
    """An injected retryable runtime error (models a flaky runtime /
    transport hiccup a production fleet retries through)."""


class TornWrite(InjectedFault):
    """An injected torn artifact write: a truncated JSON was left at the
    FINAL path (modelling the legacy non-atomic writer dying mid-dump)
    and the process 'crashed' before completing the config."""


class CorruptStats(RuntimeError):
    """Measured timings contain NaN/Inf — whether injected
    (``stats-nan`` site) or real (device fault), the stats must never
    reach an artifact; classified transient so the config re-measures
    from scratch."""


class DeadlineExceeded(RuntimeError):
    """A work unit overran its wall-clock deadline (hung compile or hung
    measurement) and was abandoned by the watchdog."""

    def __init__(self, label: str, deadline_seconds: float,
                 phase: str = "measure") -> None:
        super().__init__(
            f"{phase} of {label} exceeded the {deadline_seconds:g}s "
            "unit deadline; abandoned and quarantined"
        )
        self.label = label
        self.deadline_seconds = deadline_seconds
        self.phase = phase


class CheckpointCorruption(RuntimeError):
    """A checkpoint failed its integrity manifest (checksum mismatch /
    missing file) — an explicit ``restore(step=...)`` refuses it;
    ``restore_or`` falls back to the newest intact step instead."""


_TRANSIENT_TYPES = (TransientFault, CorruptStats)


def is_transient(exc: BaseException) -> bool:
    """Whether the bounded-retry loop should re-attempt after ``exc``."""
    return isinstance(exc, _TRANSIENT_TYPES)


def exception_chain(exc: BaseException) -> dict:
    """JSON-able record of an exception and its ``__cause__``/
    ``__context__`` chain — what the quarantine record carries instead of
    a silent skip."""
    chain = []
    seen: set[int] = set()
    cur: BaseException | None = exc
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        chain.append({"type": type(cur).__name__, "message": str(cur)})
        cur = cur.__cause__ or cur.__context__
    return {
        "error": f"{type(exc).__name__}: {exc}",
        "chain": chain,
        "traceback": "".join(
            traceback.format_exception(type(exc), exc, exc.__traceback__)
        ),
    }
