"""Host-side span tracing in the Chrome trace-event JSON (a copy of
``dlbb_tpu/obs/spans.py``).

One process-wide :class:`SpanTracer` collects begin/end span pairs and
instant events, and every resilience-journal event through the journal's
sink (:func:`journal_sink`), so a run's timeline can be rebuilt from
either file (:func:`journal_to_trace`).  The output loads in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``.  In the JAX package the
sweep engine, the train loop and the serving engine emit into it; in the
port the serving engine (ROADMAP Queue 1, Slice E, item 11) and the sweep
runner (Slice F, item 13, part 13a) do.

With no tracer active, :func:`span` returns one shared ``nullcontext``
and :func:`instant` is a module-global load and an ``is None`` test, and
``utils/timing.py`` (the only module that brackets device work with
clocks) never imports this package.  Spans wrap timed regions from the
outside only.

Timestamps are ``time.perf_counter`` relative to the tracer's start, in
microseconds as the trace-event format requires; the wall-clock start
lives in the ``otherData`` block, outside every event.  Thread ids are
``threading.get_ident`` values.  The same events give the JAX package's
file byte for byte.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Iterator, Optional

SPAN_SCHEMA = "dlbb_span_trace_v1"

# shared disabled-path singleton: ``span()`` with no tracer active returns
# THIS object every time (one allocation for the whole process)
_NULL_SPAN = contextlib.nullcontext()

_TRACER: Optional["SpanTracer"] = None
_LOCK = threading.Lock()

ENV_VAR = "DLBB_SPANS"


def default_span_path() -> Optional[str]:
    """The env-switched default (``DLBB_SPANS=trace.json``), or None —
    the span-tracing analogue of ``DLBB_TRACE_DIR``."""
    return os.environ.get(ENV_VAR) or None


class SpanTracer:
    """Thread-safe in-memory trace-event collector for one session.

    Events are appended under a lock (µs-scale cost, only while tracing
    is on); :meth:`finish` writes the whole trace atomically
    (``utils/config.atomic_write_text``) so a crash mid-write can never
    leave a torn JSON behind.
    """

    def __init__(self, path: "str | Path",
                 meta: Optional[dict[str, Any]] = None) -> None:
        self.path = Path(path)
        self.meta = dict(meta or {})
        self._events: list[dict[str, Any]] = []
        self._elock = threading.Lock()
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        # wall-clock anchor for humans correlating with the journal;
        # lives in otherData, never in an event timestamp
        self.started_at = time.time()

    # -- event emission ----------------------------------------------------

    def _ts_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _emit(self, ev: dict[str, Any]) -> None:
        with self._elock:
            self._events.append(ev)

    def begin(self, name: str, cat: str = "harness",
              args: Optional[dict[str, Any]] = None) -> None:
        self._emit({"name": name, "cat": cat, "ph": "B",
                    "ts": self._ts_us(), "pid": self._pid,
                    "tid": threading.get_ident(),
                    **({"args": args} if args else {})})

    def end(self, name: str, cat: str = "harness") -> None:
        self._emit({"name": name, "cat": cat, "ph": "E",
                    "ts": self._ts_us(), "pid": self._pid,
                    "tid": threading.get_ident()})

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "harness",
             **args: Any) -> Iterator[None]:
        self.begin(name, cat, args=_jsonable(args))
        try:
            yield
        finally:
            self.end(name, cat)

    def instant(self, name: str, cat: str = "event",
                args: Optional[dict[str, Any]] = None) -> None:
        """A zero-duration marker (journal events, retries, preemptions).
        Scope "t" (thread) keeps concurrent instants on their own
        tracks."""
        self._emit({"name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": self._ts_us(), "pid": self._pid,
                    "tid": threading.get_ident(),
                    **({"args": _jsonable(args)} if args else {})})

    def events(self) -> list[dict[str, Any]]:
        with self._elock:
            return list(self._events)

    # -- output ------------------------------------------------------------

    def finish(self) -> Path:
        """Write the trace JSON atomically and return its path.  The
        tracer stays usable (a later finish rewrites with more events),
        so crash paths can checkpoint the trace early."""
        from dlbb_tpu_torch.utils.config import atomic_write_text

        payload = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {
                "schema": SPAN_SCHEMA,
                "pid": self._pid,
                "started_at": self.started_at,
                **self.meta,
            },
        }
        return atomic_write_text(json.dumps(payload), self.path)


def _jsonable(args: dict[str, Any]) -> dict[str, Any]:
    """Trace args must be JSON-serialisable; coerce the stragglers
    (paths, numpy scalars) to strings rather than crash the harness."""
    out: dict[str, Any] = {}
    for k, v in args.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = str(v)
    return out


# ---------------------------------------------------------------------------
# module-level (zero-overhead) surface
# ---------------------------------------------------------------------------


def active() -> Optional[SpanTracer]:
    return _TRACER


def start(path: "str | Path",
          meta: Optional[dict[str, Any]] = None) -> SpanTracer:
    """Install the process-wide tracer.  A tracer that is already active
    WINS (first-starter owns the output file): nested activations — the
    CLI wrapping ``run_sweep`` which opens its own tracing scope — merge
    their events into the outer trace instead of fighting over files."""
    global _TRACER
    with _LOCK:
        if _TRACER is None:
            _TRACER = SpanTracer(path, meta=meta)
        return _TRACER


def stop() -> Optional[Path]:
    """Finish + uninstall the process-wide tracer; returns the written
    path (None when no tracer was active)."""
    global _TRACER
    with _LOCK:
        tracer, _TRACER = _TRACER, None
    if tracer is None:
        return None
    return tracer.finish()


@contextlib.contextmanager
def tracing(path: "Optional[str | Path]",
            meta: Optional[dict[str, Any]] = None
            ) -> Iterator[Optional[SpanTracer]]:
    """Scope-based activation: no-op when ``path`` is falsy, and a pure
    pass-through (no second tracer, no double write) when a tracer is
    already active — the inner scope's events land in the outer trace."""
    if not path:
        yield _TRACER
        return
    if _TRACER is not None:
        yield _TRACER
        return
    tracer = start(path, meta=meta)
    try:
        yield tracer
    finally:
        stop()


def span(name: str, cat: str = "harness", **args: Any):
    """A context manager tracing one named region — THE instrumentation
    entry point.  Disabled = the shared nullcontext singleton (no
    allocation, no clock read)."""
    tracer = _TRACER
    if tracer is None:
        return _NULL_SPAN
    return tracer.span(name, cat, **args)


def instant(name: str, cat: str = "event", **args: Any) -> None:
    tracer = _TRACER
    if tracer is not None:
        tracer.instant(name, cat, args=args or None)


def journal_sink(event: str, record: dict[str, Any]) -> None:
    """The resilience-journal sink: forwards one journal record as a
    trace instant (``resilience/journal.py`` takes this as its ``sink``
    parameter — the journal module itself never imports obs).  No-op
    with no tracer active; never raises into the journal."""
    tracer = _TRACER
    if tracer is None:
        return
    try:
        args = {k: v for k, v in record.items() if k not in ("ts", "event")}
        tracer.instant(event, cat="journal", args=args or None)
    except Exception:  # noqa: BLE001 — observability must not kill sweeps
        pass


# ---------------------------------------------------------------------------
# trace validation + journal -> trace reconstruction
# ---------------------------------------------------------------------------

_REQUIRED_EVENT_KEYS = ("name", "ph", "ts", "pid", "tid")


def validate_trace_events(events: list[dict[str, Any]]) -> list[str]:
    """Schema check for a trace-event list: required keys present, known
    phases only, and B/E pairs properly nested per (pid, tid) — the
    invariant Perfetto needs to build flame graphs.  Returns problem
    descriptions (empty = valid)."""
    problems: list[str] = []
    stacks: dict[tuple, list[str]] = {}
    for n, ev in enumerate(events):
        missing = [k for k in _REQUIRED_EVENT_KEYS if k not in ev]
        if missing:
            problems.append(f"event {n}: missing keys {missing}")
            continue
        ph = ev["ph"]
        if ph not in ("B", "E", "X", "i", "I", "M", "C"):
            problems.append(f"event {n}: unknown phase {ph!r}")
            continue
        key = (ev["pid"], ev["tid"])
        if ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ph == "E":
            stack = stacks.setdefault(key, [])
            if not stack:
                problems.append(
                    f"event {n}: E {ev['name']!r} with empty stack on "
                    f"tid {ev['tid']}"
                )
            elif stack[-1] != ev["name"]:
                problems.append(
                    f"event {n}: E {ev['name']!r} does not close "
                    f"B {stack[-1]!r} on tid {ev['tid']} (misnested)"
                )
            else:
                stack.pop()
        elif ph == "X" and "dur" not in ev:
            problems.append(f"event {n}: X event without dur")
    for key, stack in sorted(stacks.items()):
        if stack:
            problems.append(f"tid {key[1]}: unclosed span(s) {stack}")
    return problems


def load_trace(path: "str | Path") -> dict[str, Any]:
    return json.loads(Path(path).read_text())


# the journal event streams a directory can hold (a sweep and a
# serving run may share an output dir — and one append-only journal
# file): each gets its own Perfetto track group (pid + process_name).
# Fleet runs (``serve/fleet.py``) add one track group PER REPLICA —
# every engine-side journal line carries ``replica=N`` through the
# replica journal proxy — plus a supervisor group for the fleet-level
# control events (failover, hedging, the degradation ladder), so a
# crashed fleet run reconstructs replica-by-replica from the journal
# alone (the PR-8 contract).
_SWEEP_PID, _SERVE_PID, _FLEET_PID = 1, 2, 3
_REPLICA_PID_BASE = 10

# supervisor-side fleet lifecycle events rendered as process-scoped
# instants (full-height markers): each one changes how every later
# request span on the affected tracks must be read
_FLEET_LIFECYCLE = ("replica-up", "replica-fenced", "replica-failed",
                    "request-failover", "request-hedged",
                    "degrade-transition", "failover-torn", "fleet-stall")


def _pid_name(pid: int) -> str:
    if pid >= _REPLICA_PID_BASE:
        return f"replica-{pid - _REPLICA_PID_BASE}"
    return {_SWEEP_PID: "sweep", _SERVE_PID: "serving",
            _FLEET_PID: "fleet"}[pid]


def _classify_stream(records: list[dict[str, Any]]) -> list[int]:
    """Per-record stream id: events carrying ``replica=N`` (a fleet
    replica's engine lifecycle) go to that replica's track group;
    other serving events (request lifecycle, and any event inside a
    ``mode: serve`` session) go to the serving track group; fleet
    supervisor events (inside a ``mode: fleet`` session) to the fleet
    group; everything else to the sweep one.  Session markers
    (``sweep-start``) switch the ambient mode for the events that
    follow them in file order — the streams interleaved in ONE
    append-only journal split cleanly, instead of the whole file being
    rendered as whichever kind came first."""
    pids: list[int] = []
    ambient = _SWEEP_PID
    for rec in records:
        ev = str(rec.get("event", ""))
        replica = rec.get("replica")
        if ev == "sweep-start":
            mode = rec.get("mode")
            ambient = (_SERVE_PID if mode == "serve"
                       else _FLEET_PID if mode == "fleet"
                       else _SWEEP_PID)
            pids.append(ambient)
        elif isinstance(replica, int):
            pids.append(_REPLICA_PID_BASE + replica)
        elif ev in _FLEET_LIFECYCLE or ambient == _FLEET_PID and (
                ev.startswith("request-") or ev.startswith("serve")
                or ev.startswith("spec-")):
            pids.append(_FLEET_PID)
        elif (ev.startswith("request-") or ev.startswith("serve")
              or ev.startswith("spec-")):
            pids.append(_SERVE_PID)
        else:
            pids.append(ambient)
    return pids


def journal_to_trace(journal_dir: "str | Path",
                     out_path: "str | Path") -> tuple[Path, int, int]:
    """Reconstruct a run timeline from the fsync'd journal(s) alone
    (``cli obs trace``): every journal event becomes a trace instant, and
    each config's ``started`` -> ``completed``/``failed`` pair becomes a
    complete ("X") span — so even a sweep that crashed before writing its
    span trace yields a loadable Perfetto timeline from the fsync'd
    journal.  Serving journals (``serve/engine.py``) pair the same way:
    ``request-arrived`` -> ``request-completed``/``request-rejected``/
    ``request-failed``/``request-preempted`` becomes each request's
    end-to-end span (queueing included) — failed and preempted
    lifecycles stay debuggable from the journal alone, exactly as
    completed ones do.

    A directory holding BOTH a sweep and a serving event stream —
    interleaved in the append-only ``sweep_journal.jsonl``, or split
    across ``*journal*.jsonl`` files — yields ONE merged timeline with
    two labelled track groups (``sweep`` / ``serving``), config and
    request spans each pairing within their own stream.
    Returns ``(path, events_converted, torn_lines)``."""
    from dlbb_tpu_torch.resilience.journal import read_journal_file
    from dlbb_tpu_torch.utils.config import atomic_write_text

    journal_dir = Path(journal_dir)
    records: list[dict[str, Any]] = []
    torn = 0
    sources: list[str] = []
    if journal_dir.is_dir():
        files = sorted(journal_dir.glob("*journal*.jsonl"))
    else:
        files = [journal_dir]
    for path in files:
        recs, t = read_journal_file(path)
        if recs:
            records.extend(recs)
            sources.append(path.name)
        torn += t
    if not records:
        raise FileNotFoundError(
            f"no parseable journal events under {journal_dir} "
            "(is this a sweep output directory?)"
        )
    pids = _classify_stream(records)
    order = sorted(range(len(records)),
                   key=lambda i: float(records[i].get("ts", 0.0)))
    t0 = min(float(r["ts"]) for r in records if "ts" in r)
    events: list[dict[str, Any]] = []
    seen_pids = sorted(set(pids))
    for pid in seen_pids:
        events.append({
            "name": "process_name", "ph": "M", "ts": 0.0,
            "pid": pid, "tid": 0,
            "args": {"name": _pid_name(pid)},
        })
    open_configs: dict[tuple[int, str], float] = {}
    for i in order:
        rec, pid = records[i], pids[i]
        ts_us = (float(rec.get("ts", t0)) - t0) * 1e6
        name = rec.get("event", "?")
        config = rec.get("config")
        args = {k: v for k, v in rec.items() if k != "ts"}
        if name in ("started", "request-arrived") and config:
            open_configs[(pid, config)] = ts_us
        elif (name in ("completed", "failed", "request-completed",
                       "request-rejected", "request-infeasible",
                       "request-failed", "request-preempted",
                       "request-canceled")
              and (pid, config) in open_configs):
            start_us = open_configs.pop((pid, config))
            kind = name[len("request-"):] if name.startswith(
                "request-") else name
            events.append({
                "name": config, "cat": f"config-{kind}", "ph": "X",
                "ts": start_us, "dur": max(ts_us - start_us, 0.0),
                "pid": pid, "tid": 1, "args": _jsonable(args),
            })
        if name in _FLEET_LIFECYCLE:
            # fleet lifecycle: full-height, own category — a fence or a
            # ladder transition recolours every later request span on
            # the affected tracks, so it must not drown among the
            # per-request ticks
            label = name
            if isinstance(rec.get("replica"), int):
                label = f"{name}[replica-{rec['replica']}]"
            elif config:
                label = f"{name}[{config}]"
            events.append({
                "name": label, "cat": "fleet", "ph": "i", "s": "p",
                "ts": ts_us, "pid": pid, "tid": 1,
                "args": _jsonable(args),
            })
            continue
        if name == "degraded":
            # a degraded-probe fallback changes how EVERY later
            # number in the run must be read — render it as a labelled,
            # process-scoped instant (full-height marker in Perfetto)
            # instead of a thread-local tick lost among the lifecycle
            # events
            reason = rec.get("reason") or "unknown"
            events.append({
                "name": f"degraded[{reason}]", "cat": "degraded",
                "ph": "i", "s": "p", "ts": ts_us, "pid": pid, "tid": 1,
                "args": _jsonable(args),
            })
            continue
        if name in ("prefix-attach", "prefix-cow"):
            # the prefix-cache pair: an attach instant labelled with its
            # donor/reuse (the TTFT story of that admission) and its CoW
            # sibling when the trie matched past the attach cap — own
            # category so a Perfetto query can line hit rate up against
            # the prefill spans
            label = f"{name}[{config}]" if config else name
            events.append({
                "name": label, "cat": "prefix-cache", "ph": "i",
                "s": "p", "ts": ts_us, "pid": pid, "tid": 1,
                "args": _jsonable(args),
            })
            continue
        events.append({
            "name": name, "cat": "journal", "ph": "i", "s": "t",
            "ts": ts_us, "pid": pid, "tid": 1, "args": _jsonable(args),
        })
    payload = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "schema": SPAN_SCHEMA,
            "source": ",".join(sources),
            "journal_dir": str(journal_dir),
            "wall_t0": t0,
            "torn_lines": torn,
            "streams": {str(pid): _pid_name(pid)
                        for pid in seen_pids},
        },
    }
    path = atomic_write_text(json.dumps(payload), Path(out_path))
    return path, len(events), torn
