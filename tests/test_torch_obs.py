"""The port's host-side observability copies against the JAX package: the
span tracer (``obs/spans.py``), the journal (``resilience/journal.py``) and
the metrics registry (``obs/export.py``).  The same events in the same
order must give byte-equal files: the span trace, the journal, the trace
rebuilt from the journal, and ``metrics.prom``.

The files carry three things that differ between two runs: the monotonic
clock (``time.perf_counter``, the span timestamps), the wall clock
(``time.time``: the journal's ``ts`` and the trace's ``started_at``) and
thread ids (``threading.get_ident``).  The tests fix all three with
``monkeypatch`` (each run restarts the same fake clocks); the process id is
the test process's in both runs.
"""

import itertools
import shutil
import threading
import time
from pathlib import Path

import pytest

from dlbb_tpu.obs import export as jax_export
from dlbb_tpu.obs import spans as jax_spans
from dlbb_tpu.resilience import journal as jax_journal
from dlbb_tpu_torch.obs import export as pt_export
from dlbb_tpu_torch.obs import spans as pt_spans
from dlbb_tpu_torch.resilience import journal as pt_journal

PACKAGES = {"jax": (jax_spans, jax_journal, jax_export),
            "port": (pt_spans, pt_journal, pt_export)}


@pytest.fixture
def fixed_clocks(monkeypatch):
    """Returns ``restart()``, which sets the monotonic clock, the wall clock
    and the thread id back to the same deterministic sequences."""
    def restart():
        mono = itertools.count(1000.0, 0.25)
        wall = itertools.count(1.7e9, 0.125)
        monkeypatch.setattr(time, "perf_counter", lambda: next(mono))
        monkeypatch.setattr(time, "time", lambda: next(wall))
        monkeypatch.setattr(threading, "get_ident", lambda: 4242)

    return restart


def _drive(spans, journal, out: Path) -> dict[str, bytes]:
    """One run's events: nested spans with args (a path and an int among
    them), instants, a journal whose every event is mirrored into the
    trace, a nested tracing scope, and the journal rebuilt as a trace."""
    trace = out / "spans.json"
    with spans.tracing(trace, meta={"run": "parity"}) as tracer:
        assert spans.active() is tracer
        with spans.span("sweep", cat="phase", ranks=4, out=out / "x"):
            spans.instant("tick", step=1)
            with spans.span("measure", config="allreduce_1KB"):
                spans.instant("retry", reason="transient")
        with spans.tracing(out / "nested.json") as inner:
            assert inner is tracer  # the outer tracer keeps the events
            spans.instant("nested")
        with journal.SweepJournal(out, meta={"mode": "serve"},
                                  sink=spans.journal_sink) as j:
            j.event("request-arrived", config="r0", prompt=12)
            j.event("started", config="allreduce_1KB")
            j.event("completed", config="allreduce_1KB", seconds=0.5)
            j.event("request-completed", config="r0", tokens=5)
            j.event("degraded", reason="cpu-sim")
            j.event("prefix-attach", config="r1", donor=0)
            j.event("replica-fenced", replica=1)
    assert spans.active() is None and not (out / "nested.json").exists()
    with (out / journal.JOURNAL_NAME).open("a") as f:  # a torn tail
        f.write('{"ts": 1.8e9, "event": "torn')
    rebuilt, n_events, torn = spans.journal_to_trace(out, out / "rebuilt.json")
    assert torn == 1 and n_events > 7
    events, torn_lines = journal.read_journal(out)
    assert torn_lines == 1 and len(events) == 8
    assert journal.completed_configs(events) == {"allreduce_1KB"}
    assert journal.started_not_completed(events) == set()
    return {name: (out / name).read_bytes()
            for name in ("spans.json", journal.JOURNAL_NAME, "rebuilt.json")}


def test_span_journal_and_rebuilt_trace_files_are_byte_equal(tmp_path, fixed_clocks):
    """Both packages run in the same directory in turn (its path is in the
    files), each after the clocks restart."""
    out, files = tmp_path / "run", {}
    for name, (spans, journal, _) in PACKAGES.items():
        fixed_clocks()
        if out.exists():
            shutil.rmtree(out)
        out.mkdir()
        files[name] = _drive(spans, journal, out)
    for f in files["jax"]:
        assert files["port"][f] == files["jax"][f], f
    trace = pt_spans.load_trace(out / "spans.json")
    assert pt_spans.validate_trace_events(trace["traceEvents"]) == []


BAD_TRACES = {
    "missing_keys": [{"name": "a", "ph": "B"}],
    "unknown_phase": [{"name": "a", "ph": "Q", "ts": 0, "pid": 1, "tid": 1}],
    "misnested": [{"name": "a", "ph": "B", "ts": 0, "pid": 1, "tid": 1},
                  {"name": "b", "ph": "B", "ts": 1, "pid": 1, "tid": 1},
                  {"name": "a", "ph": "E", "ts": 2, "pid": 1, "tid": 1}],
    "unopened_end": [{"name": "a", "ph": "E", "ts": 0, "pid": 1, "tid": 7}],
    "x_without_dur": [{"name": "a", "ph": "X", "ts": 0, "pid": 1, "tid": 1}],
}


@pytest.mark.parametrize("name", sorted(BAD_TRACES))
def test_trace_validation_matches_jax(name):
    problems = pt_spans.validate_trace_events(BAD_TRACES[name])
    assert problems and problems == jax_spans.validate_trace_events(BAD_TRACES[name])


def test_disabled_tracing_is_the_shared_null_span():
    assert pt_spans.active() is None
    assert pt_spans.span("a") is pt_spans.span("b", x=1)
    pt_spans.instant("nothing")  # no tracer: a no-op
    pt_spans.journal_sink("event", {"ts": 0.0})
    with pt_spans.tracing(None) as tracer:
        assert tracer is None


def test_journal_degrades_instead_of_raising(tmp_path, fixed_clocks, capsys):
    fixed_clocks()
    j = pt_journal.SweepJournal(tmp_path)
    j._fh.close()  # a write that fails: the journal turns itself off
    j.event("completed", config="c")
    assert j.degraded and "journaling disabled" in capsys.readouterr().out
    j.event("completed", config="d")  # no file, no sink: nothing happens


def _metrics(export, path: Path) -> tuple[bytes, dict]:
    reg = export.MetricsRegistry()
    reg.inc("serve_requests", outcome="completed", help="requests by outcome")
    reg.inc("serve_requests", 2, outcome="rejected")
    reg.inc("serve_decode_steps", 7)
    reg.set_gauge("serve_decode_batch_occupancy", 0.75, help="active slots / max_batch")
    reg.set_gauge("serve_ttft_seconds", 0.0123, quantile="p99")
    reg.set_gauge("label_escapes", 1.5, path='a\\b"c\nd')
    counts = reg.labeled_counter("sweep_configs", "outcome",
                                 initial=("measured", "failed"), help="configs")
    counts["measured"] += 3
    counts["failed"] = 1
    for bad in (lambda: reg.inc("serve_decode_steps", -1),
                lambda: reg.set_gauge("serve_decode_steps", 1.0),
                lambda: counts.__setitem__("measured", 0)):
        with pytest.raises(ValueError):
            bad()
    assert dict(counts) == {"measured": 3, "failed": 1} and len(counts) == 2
    assert reg.get("serve_requests", outcome="rejected") == 2.0
    assert reg.get("absent") == 0.0
    reg.write_textfile(path)
    return path.read_bytes(), reg.as_dict()


def test_metrics_textfile_is_byte_equal(tmp_path):
    ref, ref_dict = _metrics(jax_export, tmp_path / "jax.prom")
    got, got_dict = _metrics(pt_export, tmp_path / "port.prom")
    assert got == ref and got_dict == ref_dict
    assert b"dlbb_serve_requests_total{outcome=\"completed\"} 1" in got
