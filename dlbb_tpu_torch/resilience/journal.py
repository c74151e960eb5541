"""Append-only crash-safe journal (``sweep_journal.jsonl``; a copy of
``dlbb_tpu/resilience/journal.py``).

One JSON line per lifecycle event, fsync'd per line, so a process killed
at any instant leaves at most one torn trailing line (tolerated by
:func:`read_journal`).  The journal is append-only across runs: a resumed
run appends a new ``sweep-start`` session marker and its own events after
the crashed session's.

A pluggable ``sink`` (``sink(event, record)``) mirrors every event into
another observer, such as ``dlbb_tpu_torch.obs.spans.journal_sink``, so
each journal line doubles as a span-trace instant.  The sink fires even
when file journaling is disabled, and its exceptions are swallowed:
observability must never kill a run.  The serving engine (ROADMAP Queue
1, Slice E, item 11) and the sweep runner (Slice F, item 13, part 13a)
journal into it.  The same events give the JAX package's file byte for
byte.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Callable, Optional

JOURNAL_NAME = "sweep_journal.jsonl"
JOURNAL_SCHEMA = "dlbb_sweep_journal_v1"


class SweepJournal:
    """Append-only journal writer for one sweep session.

    Every :meth:`event` is one line: ``json.dumps`` + newline, flushed and
    fsync'd before returning — after a crash, every event the sweep
    *reported* is durably on disk.  Events never raise into the sweep
    (a full disk must not kill a measurement that already succeeded);
    write failures flip :attr:`degraded` and are reported once.
    """

    def __init__(self, out_dir: "str | Path", meta: Optional[dict] = None,
                 enabled: bool = True,
                 sink: Optional[Callable[[str, dict], None]] = None) -> None:
        self.path = Path(out_dir) / JOURNAL_NAME
        self.enabled = enabled
        self.degraded = False
        self._fh = None
        self._sink = sink
        if not enabled:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        try:
            # a crash mid-append leaves a torn tail WITHOUT a newline —
            # terminate it first so this session's events stay
            # line-delimited (the torn fragment stays visible to
            # read_journal as exactly one unparseable line)
            if self.path.exists():
                with open(self.path, "rb") as f:
                    f.seek(0, os.SEEK_END)
                    if f.tell() > 0:
                        f.seek(-1, os.SEEK_END)
                        needs_newline = f.read(1) != b"\n"
                    else:
                        needs_newline = False
            else:
                needs_newline = False
            self._fh = open(self.path, "a")
            if needs_newline:
                self._fh.write("\n")
        except OSError:
            self.degraded = True
            self._fh = None
            return
        self.event("sweep-start",
                   schema=JOURNAL_SCHEMA, pid=os.getpid(), **(meta or {}))

    def event(self, event: str, config: Optional[str] = None,
              **extra: Any) -> None:
        if self._fh is None and self._sink is None:
            return
        record = {"ts": time.time(), "event": event}
        if config is not None:
            record["config"] = config
        record.update(extra)
        if self._sink is not None:
            # the sink observes every event, file journaling enabled or
            # not (a non-coordinator pod host still traces locally); it
            # must never raise into the sweep
            try:
                self._sink(event, record)
            except Exception:  # noqa: BLE001 — observer isolation
                pass
        if self._fh is None:
            return
        try:
            self._fh.write(json.dumps(record, default=str) + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())
        except (OSError, ValueError):
            if not self.degraded:
                self.degraded = True
                print(f"[journal] WARNING: cannot append to {self.path}; "
                      "journaling disabled for this session")
            self.close()

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    def __enter__(self) -> "SweepJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_journal(out_dir: "str | Path") -> tuple[list[dict], int]:
    """Parse ``sweep_journal.jsonl`` under ``out_dir``.

    Returns ``(events, torn_lines)`` — a line that does not parse (the
    torn tail of a killed process) is counted, not fatal; a torn line
    anywhere else is counted the same way (it can only mean a crashed
    writer, and every parseable event remains trustworthy because each
    was fsync'd before the next was attempted)."""
    return read_journal_file(Path(out_dir) / JOURNAL_NAME)


def read_journal_file(path: "str | Path") -> tuple[list[dict], int]:
    """Parse one journal JSONL file (torn-line semantics of
    :func:`read_journal`; a missing/unreadable file is an empty
    journal, not an error — obs reads non-canonical ``*journal*.jsonl``
    names through this too)."""
    events: list[dict] = []
    torn = 0
    try:
        with open(path) as f:
            lines = list(f)
    except OSError:
        return events, torn
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            torn += 1
            continue
        if isinstance(rec, dict):
            events.append(rec)
        else:
            torn += 1
    return events, torn


def completed_configs(events: list[dict]) -> set[str]:
    """Config ids with a durable ``completed`` record."""
    return {e["config"] for e in events
            if e.get("event") == "completed" and "config" in e}


def started_not_completed(events: list[dict]) -> set[str]:
    """Config ids that started but never completed/failed — the set a
    crash interrupted (resume must re-validate, never trust)."""
    done = {e["config"] for e in events
            if e.get("event") in ("completed", "failed") and "config" in e}
    return {e["config"] for e in events
            if e.get("event") == "started" and "config" in e} - done
