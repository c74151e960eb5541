"""The sweep's failure handling and tracing (ROADMAP Queue 1, Slice F, item
13, part 13a: ``dlbb_tpu_torch/bench/runner.py``'s fault sites, watchdog,
retries, quarantine, journal, preemption and span trace, ``obs/export.py::
sweep_metrics``) on 4 gloo ranks, mirroring JAX's sweep tests
``tests/test_resilience.py`` (the transient retried, NaN stats never
written, transients exhausted and quarantined, a torn write re-measured on
resume, resume trusting only valid artifacts, the hung unit's watchdog, the
zombie write suppressed, preemption and resume, no cost without a plan) and
``tests/test_obs.py::test_traced_sweep_equivalent_to_untraced``.  JAX's
compile-engine tests (a compile failure, the scheduler's abandoned unit, a
wedged compile) wait for part 13b, which ports that engine.

The port runs one process per rank: each fault site fires on the mesh's
rank 0 and its verdict is broadcast, so every rank retries, abandons or
stops together, and rank 0 alone journals, traces and writes.

Each test also runs JAX's ``run_sweep`` on the same sweep and fault plan on
JAX's simulated CPU devices and holds the port's journal, manifest and
``metrics.prom`` against JAX's (``_hold_against_jax``).
"""

import json
import re
import time

import pytest

from dlbb_tpu.bench import Sweep1D as JaxSweep1D
from dlbb_tpu.bench import run_sweep as jax_run_sweep
from dlbb_tpu_torch import cli
from dlbb_tpu_torch.bench import runner
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu_torch.obs.spans import validate_trace_events
from dlbb_tpu_torch.resilience import inject
from dlbb_tpu_torch.resilience.journal import read_journal

WORLD = 4


def _tiny(tmp_path, out="results", **kw):
    """JAX's ``_tiny`` sweep: 2 configs on a 4-rank mesh."""
    defaults = dict(implementation="rt", operations=("allreduce", "broadcast"),
                    data_sizes=(("1KB", 256),), rank_counts=(WORLD,), dtype="float32",
                    warmup_iterations=1, measurement_iterations=3,
                    output_dir=str(tmp_path / out))
    defaults.update(kw)
    return runner.Sweep1D(**defaults)


def _run(sweep, timeout=240):
    """Rank 0's written files (JAX's ``run_sweep`` return) and every rank's
    result."""
    results = launch(cli.sweep_worker, WORLD, "cpu", args=(sweep, "cpu"), timeout=timeout)
    return results[0].written, results


def _manifest(tmp_path, out="results"):
    return json.loads((tmp_path / out / "sweep_manifest.json").read_text())


def _jax(tmp_path, out="jax", **kw):
    """JAX's ``run_sweep`` on JAX's own ``_tiny`` sweep with the same knobs,
    on JAX's simulated CPU devices (its compile-ahead engine as JAX's tests
    run it)."""
    defaults = dict(implementation="rt", operations=("allreduce", "broadcast"),
                    data_sizes=(("1KB", 256),), rank_counts=(WORLD,), dtype="float32",
                    warmup_iterations=1, measurement_iterations=3,
                    output_dir=str(tmp_path / out), compile_cache="off", pipeline=True)
    defaults.update(kw)
    return jax_run_sweep(JaxSweep1D(**defaults), verbose=False)


# manifest values that differ between any two runs, or that only JAX's
# compile-ahead engine (part 13b) and its platform set
_MANIFEST_OWN = {"wall_seconds", "timestamp", "compile_seconds_total", "compile_cache",
                 "work_units", "pipeline", "prefetch", "cost_model_version", "topology",
                 "observability"}
# the gauges of the wall clock and of JAX's compiles: the port compiles
# nothing, so its compile gauges read 0
_PROM_MASKED = re.compile(r"^dlbb_sweep_(wall_seconds|compile_seconds|compile_cache\{[^}]*\})"
                          r" (\S+)$", re.M)


def _quarantine_record(rec):
    """A quarantine record without its traceback text and the messages
    that name JAX's compile unit or the port's config (the exception types
    and the chain's length stay)."""
    return {"config": rec["config"], "phase": rec["phase"], "retries": rec["retries"],
            "error": rec["error"].split(":")[0],
            "chain": [c["type"] for c in rec["chain"]]}


def _hold_against_jax(port_dir, jax_dir, gate_degraded=False):
    """The port's journal, manifest and ``metrics.prom`` against JAX's for
    the same sweep and plan: the same journal events with the same keys
    for the same configs, the same manifest keys, ``configs`` counts and
    ``resilience`` section (tracebacks aside), and ``metrics.prom`` byte for
    byte once the wall-time and compile gauges are masked, those of the
    port reading 0.  ``gate_degraded`` names a run where JAX's measurement
    gate (part 13b's engine) degraded and the port, with no gate, did not."""
    port_ev, port_torn = read_journal(port_dir)
    jax_ev, jax_torn = read_journal(jax_dir)
    assert port_torn == jax_torn == 0
    strip = lambda evs: [(e["event"], e.get("config"), sorted(e)) for e in evs]  # noqa: E731
    assert strip(port_ev) == strip(jax_ev)
    pm = json.loads((port_dir / "sweep_manifest.json").read_text())
    jm = json.loads((jax_dir / "sweep_manifest.json").read_text())
    assert sorted(pm) == sorted(jm)
    for k in sorted(set(jm) - _MANIFEST_OWN - {"resilience"}):
        assert pm[k] == jm[k], k
    assert sorted(pm["topology"]) == sorted(jm["topology"])
    assert sorted(pm["observability"]) == sorted(jm["observability"])
    assert pm["work_units"]["planned_configs"] == jm["work_units"]["planned_configs"]
    pr, jr = dict(pm["resilience"]), dict(jm["resilience"])
    assert sorted(pr) == sorted(jr)
    pq, jq = pr.pop("quarantined"), jr.pop("quarantined")
    assert [_quarantine_record(q) for q in pq] == [_quarantine_record(q) for q in jq]
    assert all(q["traceback"] for q in pq)
    assert jr["watchdog"].pop("gate_degraded") is gate_degraded
    assert pr["watchdog"].pop("gate_degraded") is False
    assert pr == jr
    port_prom = (port_dir / "metrics.prom").read_text()
    jax_prom = (jax_dir / "metrics.prom").read_text()
    port_masked = _PROM_MASKED.findall(port_prom)
    assert [k for k, _ in port_masked] == [k for k, _ in _PROM_MASKED.findall(jax_prom)]
    assert all(float(v) == 0.0 for k, v in port_masked if k != "wall_seconds")
    mask = lambda text: _PROM_MASKED.sub(r"dlbb_sweep_\1 <masked>", text)  # noqa: E731
    assert mask(port_prom) == mask(jax_prom)


def _valid(path):
    return runner._validate_result(path)[0]


def test_sweep_transient_retried_and_flagged(tmp_path):
    files, _ = _run(_tiny(tmp_path, fault_plan="exec-transient:1", max_retries=2))
    jax_files = _jax(tmp_path, fault_plan="exec-transient:1", max_retries=2)
    assert len(files) == 2
    retries = sorted(json.loads(f.read_text())["retries"] for f in files)
    assert retries == [0, 1] == sorted(json.loads(f.read_text())["retries"]
                                       for f in jax_files)
    man = _manifest(tmp_path)
    assert man["resilience"]["retries_total"] == 1
    assert man["configs"]["failed"] == 0
    for f in files:
        assert _valid(f)
    events, _ = read_journal(tmp_path / "results")
    assert any(e["event"] == "retry" for e in events)
    _hold_against_jax(tmp_path / "results", tmp_path / "jax")


def test_sweep_nan_stats_never_written(tmp_path):
    """NaN/Inf in rank 0's timings is caught in the gathered timings on
    every rank before the write, and the config re-measures."""
    files, _ = _run(_tiny(tmp_path, fault_plan="stats-nan:1", max_retries=2))
    _jax(tmp_path, fault_plan="stats-nan:1", max_retries=2)
    assert len(files) == 2
    for f in files:
        assert _valid(f)
    assert sum(json.loads(f.read_text())["retries"] for f in files) == 1
    _hold_against_jax(tmp_path / "results", tmp_path / "jax")


def test_sweep_transient_exhausted_is_quarantined(tmp_path):
    files, ranks = _run(_tiny(tmp_path, fault_plan="exec-transient:*", max_retries=1))
    assert files == [] == _jax(tmp_path, fault_plan="exec-transient:*", max_retries=1)
    man = _manifest(tmp_path)
    assert man["configs"]["failed"] == 2
    q = man["resilience"]["quarantined"]
    assert len(q) == 2
    for rec in q:
        assert rec["retries"] == 1
        assert "TransientFault" in rec["error"]
        assert rec["traceback"]
    events, _ = read_journal(tmp_path / "results")
    assert sum(1 for e in events if e["event"] == "failed") == 2
    assert all(len(r.failed) == 2 for r in ranks)  # every rank quarantined both
    _hold_against_jax(tmp_path / "results", tmp_path / "jax")


def test_sweep_torn_write_resume_revalidates(tmp_path):
    _run(_tiny(tmp_path, fault_plan="torn-write:@1", max_retries=0))
    _jax(tmp_path, fault_plan="torn-write:@1", max_retries=0)
    _jax(tmp_path, resume=True)
    out = tmp_path / "results"
    torn = [p for p in out.glob("rt_*.json") if not _valid(p)]
    assert len(torn) == 1
    files, _ = _run(_tiny(tmp_path, resume=True))
    assert len(files) == 2
    for f in files:
        assert _valid(f)
    events, _ = read_journal(out)
    invalid = [e for e in events if e["event"] == "resume-invalid"]
    assert len(invalid) == 1 and invalid[0]["config"] == torn[0].name
    man = _manifest(tmp_path)
    assert man["configs"]["resume_invalid"] == 1
    assert man["configs"]["resumed"] == 1
    _hold_against_jax(out, tmp_path / "jax")


def test_sweep_resume_trusts_only_valid_artifacts(tmp_path):
    first, _ = _run(_tiny(tmp_path))
    assert len(first) == 2
    victim, kept = sorted(first)
    victim.write_text(victim.read_text()[:30])  # torn
    kept_mtime = kept.stat().st_mtime_ns
    resumed, _ = _run(_tiny(tmp_path, resume=True))
    assert sorted(resumed) == sorted(first)
    assert kept.stat().st_mtime_ns == kept_mtime, "valid artifact re-ran"
    assert _valid(victim), "torn artifact not re-measured"
    jax_victim = tmp_path / "jax" / victim.name
    _jax(tmp_path)
    jax_victim.write_text(jax_victim.read_text()[:30])
    _jax(tmp_path, resume=True)
    _hold_against_jax(tmp_path / "results", tmp_path / "jax")


def test_sweep_hung_unit_watchdog_quarantine_and_drain(tmp_path):
    """A hung measurement is abandoned at the deadline on every rank (rank
    0's verdict) and quarantined; the rest of the grid measures and the
    sweep returns long before the hang would.  The port has no measurement
    gate (the compile-ahead engine is part 13b), so ``gate_degraded`` stays
    False where JAX's reads True."""
    t0 = time.perf_counter()
    files, ranks = _run(_tiny(tmp_path, fault_plan="exec-hang:@1,hang_seconds=120",
                              unit_deadline_seconds=0.75, max_retries=0))
    wall = time.perf_counter() - t0
    assert len(files) == 1
    assert wall < 60.0, f"sweep blocked behind the hang ({wall:.1f}s)"
    man = _manifest(tmp_path)
    assert man["resilience"]["watchdog"]["abandoned_measurements"] == 1
    assert man["resilience"]["watchdog"]["gate_degraded"] is False
    [q] = man["resilience"]["quarantined"]
    assert "DeadlineExceeded" in q["error"]
    assert _valid(files[0])
    assert all([f["config"] for f in r.failed] == [q["config"]] for r in ranks)
    _jax(tmp_path, fault_plan="exec-hang:@1,hang_seconds=120",
         unit_deadline_seconds=0.75, max_retries=0)
    _hold_against_jax(tmp_path / "results", tmp_path / "jax", gate_degraded=True)


def _sweep_then_wait(sweep):
    """A rank body: the sweep, then 3.5 s in the rank's process, past the
    abandoned thread's wake-up."""
    result = cli.sweep_worker(sweep, "cpu")
    time.sleep(3.5)
    return result


def test_watchdog_zombie_write_suppressed(tmp_path):
    """An abandoned thread that wakes after its config was quarantined
    runs no collective and writes no artifact."""
    knobs = dict(fault_plan="exec-hang:@1,hang_seconds=2", unit_deadline_seconds=0.5,
                 max_retries=0)
    _jax(tmp_path, **knobs)  # its zombie wakes while the ranks run
    launch(_sweep_then_wait, WORLD, "cpu", args=(_tiny(tmp_path, **knobs),), timeout=240)
    man = _manifest(tmp_path)
    [q] = man["resilience"]["quarantined"]
    for out in ("results", "jax"):
        assert not (tmp_path / out / q["config"]).exists(), (
            f"zombie thread resurrected a quarantined config on disk ({out})")
    _hold_against_jax(tmp_path / "results", tmp_path / "jax", gate_degraded=True)


def test_sweep_preemption_journaled_resume_equivalent(tmp_path):
    """SIGTERM between configs (each rank's own, as a scheduler sends it)
    stops every rank at the same config boundary; a resume run completes
    the grid with the uninterrupted run's artifact set."""
    ref, _ = _run(_tiny(tmp_path, out="ref"))
    files, _ = _run(_tiny(tmp_path, fault_plan="preempt:@2"))
    assert len(files) == 1
    man = _manifest(tmp_path)
    assert man["resilience"]["preempted"] is True
    events, _ = read_journal(tmp_path / "results")
    assert any(e["event"] == "preempted" for e in events)
    resumed, _ = _run(_tiny(tmp_path, resume=True))
    assert sorted(p.name for p in resumed) == sorted(p.name for p in ref)
    for got in resumed:
        want = json.loads((tmp_path / "ref" / got.name).read_text())
        have = json.loads(got.read_text())
        assert sorted(have) == sorted(want), got.name
        assert _valid(got)
    _jax(tmp_path, out="jax_ref")
    _jax(tmp_path, fault_plan="preempt:@2")
    _jax(tmp_path, resume=True)
    _hold_against_jax(tmp_path / "results", tmp_path / "jax")
    _hold_against_jax(tmp_path / "ref", tmp_path / "jax_ref")


def test_sweep_without_plan_has_no_resilience_cost(tmp_path):
    assert inject.active() is None
    files, _ = _run(_tiny(tmp_path))
    assert all(json.loads(f.read_text())["retries"] == 0 for f in files)
    man = _manifest(tmp_path)
    r = man["resilience"]
    assert r["fault_plan"] is None
    assert r["retries_total"] == 0 and r["quarantined"] == []
    assert r["watchdog"]["abandoned_measurements"] == 0
    assert r["preempted"] is False
    prom = (tmp_path / "results" / "metrics.prom").read_text()
    for gauge in ("dlbb_sweep_wall_seconds", "dlbb_sweep_compile_seconds 0",
                  'dlbb_sweep_configs_total{outcome="measured"} 2', "dlbb_sweep_retries 0"):
        assert gauge in prom, gauge
    _jax(tmp_path)
    _hold_against_jax(tmp_path / "results", tmp_path / "jax")


# the fields that differ between two runs of one config
_VOLATILE = {"timings", "timestamp", "system_info", "compile_seconds", "compile_cache_hit",
             "forced_completion_s", "forced_completion_probe_skipped"}


def test_traced_sweep_equivalent_to_untraced(tmp_path):
    """JAX's gate without its device capture (part 13b): a span-traced
    sweep writes a valid trace with the sweep's phases and results
    equivalent to an untraced run's."""
    trace_path = tmp_path / "spans.json"
    kw = dict(operations=("allreduce", "allgather"), warmup_iterations=2,
              measurement_iterations=8)
    ft, _ = _run(_tiny(tmp_path, "traced", span_trace=str(trace_path), **kw))
    fu, _ = _run(_tiny(tmp_path, "untraced", **kw))
    assert [p.name for p in ft] == [p.name for p in fu]
    for pt, pu in zip(ft, fu):
        dt, du = json.loads(pt.read_text()), json.loads(pu.read_text())
        assert sorted(dt) == sorted(du)
        for k in sorted(set(dt) - _VOLATILE):
            assert dt[k] == du[k], k
        for d in (dt, du):
            assert d["measurement_iterations"] == 8
            assert all(len(row) == 8 for row in d["timings"])
    evs = json.loads(trace_path.read_text())["traceEvents"]
    assert validate_trace_events(evs) == []
    assert {"sweep", "config", "measure", "payload", "io", "journal"} <= {
        e.get("cat") for e in evs}
    manifest = _manifest(tmp_path, "traced")
    assert manifest["observability"]["span_trace"] == str(trace_path)
    assert manifest["observability"]["device_captures"] == 0
    assert _manifest(tmp_path, "untraced")["observability"]["span_trace"] is None
    jax_trace = tmp_path / "jax_spans.json"
    _jax(tmp_path, span_trace=str(jax_trace), **kw)
    _hold_against_jax(tmp_path / "traced", tmp_path / "jax")
    # JAX's phases but its compiles (part 13b's engine)
    jax_evs = json.loads(jax_trace.read_text())["traceEvents"]
    assert {e.get("cat") for e in evs} == {e.get("cat") for e in jax_evs} - {"compile"}


@pytest.mark.parametrize("kind", ["bench1d", "bench3d"])
def test_cli_sweep_flags_reach_the_sweep(kind, tmp_path):
    """``--fault-plan``, ``--deadline``, ``--max-retries``, ``--no-journal``
    and ``--span-trace`` set the sweep's knobs as JAX's parser reads them."""
    from dlbb_tpu import cli as jax_cli

    argv = [kind, "--fault-plan", "exec-transient:1", "--deadline", "5", "--max-retries",
            "3", "--no-journal", "--span-trace", str(tmp_path / "s.json")]
    knobs = lambda sw: (sw.fault_plan, sw.unit_deadline_seconds, sw.max_retries,  # noqa: E731
                        sw.journal, sw.span_trace)
    jax_knobs = lambda a: (a.fault_plan, a.unit_deadline, a.max_retries,  # noqa: E731
                           not a.no_journal, a.span_trace)
    sweep = cli._sweep(cli.build_parser().parse_args(argv))
    assert knobs(sweep) == ("exec-transient:1", 5.0, 3, False, str(tmp_path / "s.json"))
    assert knobs(sweep) == jax_knobs(jax_cli.build_parser().parse_args(argv))
    default = cli._sweep(cli.build_parser().parse_args([kind]))
    assert knobs(default) == jax_knobs(jax_cli.build_parser().parse_args([kind]))
    assert (default.max_retries, default.journal, default.fault_plan) == (2, True, None)
