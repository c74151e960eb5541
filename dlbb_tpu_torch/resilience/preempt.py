"""Graceful preemption (SIGTERM) handling (a host-only copy of
``dlbb_tpu/resilience/preempt.py``; the port imports nothing of the JAX
package).

Fleets preempt routinely (maintenance events, spot reclaims) and the
runtime's notice is a SIGTERM with a short grace window.  The default
Python behaviour — ``SIGTERM`` kills the process wherever it is — can
land mid-measurement or mid-checkpoint-save.  :class:`PreemptionGuard`
turns the signal into a *flag* the harness polls at safe points:

- ``run_train`` (``train/loop.py``) checks between steps → breaks the
  loop and falls through to the forced final checkpoint save (+ integrity
  manifest), so the restore after preemption starts from the last finished
  step.  A SIGTERM reaches one process, not the group: the ranks take the
  maximum of their flags over the world before each step, so every rank
  stops at the same step;
- the sweep runner (``bench/runner.py``) checks between configs; the
  mesh's ranks take the maximum of their flags before each config, and the
  world's at the end of each rank count (ROADMAP Queue 1, Slice F, item 13,
  part 13a).

Signal handlers can only be installed on the main thread; elsewhere
(e.g. a harness embedded in a worker thread) the guard degrades to an
inert flag that injection (``preempt`` site) and tests can still set.
"""

from __future__ import annotations

import signal
import threading
from typing import Any, Optional

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Scoped SIGTERM-to-flag handler (re-entrant safe, restores the
    previous handler on exit)::

        with PreemptionGuard() as guard:
            for config in plan:
                if guard.requested:
                    ...journal + flush + stop...
                    break
    """

    def __init__(self, signals: tuple[int, ...] = (signal.SIGTERM,)) -> None:
        self._signals = signals
        self._previous: dict[int, Any] = {}
        self._event = threading.Event()
        self.installed = False
        self.signal_received: Optional[int] = None

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self) -> None:
        """Set the flag programmatically (tests, embedding harnesses)."""
        self._event.set()

    def _handler(self, signum, frame) -> None:
        self.signal_received = signum
        self._event.set()

    def __enter__(self) -> "PreemptionGuard":
        try:
            for sig in self._signals:
                self._previous[sig] = signal.signal(sig, self._handler)
            self.installed = True
        except ValueError:
            # not the main thread: signal.signal refuses — degrade to an
            # inert flag (restore nothing on exit)
            self._previous.clear()
            self.installed = False
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._previous.clear()
        self.installed = False
