"""Serving resilience (ROADMAP Queue 1, Slice E, item 11, part 11d:
``dlbb_tpu_torch/serve/engine.py``'s failure paths, with ``serve/bench.py``,
``obs/export.py::serving_metrics`` and ``stats/serving_report.py`` of item
12) against the JAX package, on the CPU: the 16 tests of
``tests/test_serve_resilience.py``, mirrored.

- the fault sites and the static pin: no device program of the engine (the
  fast path's, the verify's and the draft's included) or of
  ``serve/kvcache.py`` names the injection registry;
- the whole engine under each fault against JAX's, on traces whose admission
  does not depend on timing (every arrival at t=0, ``max_batch`` and the
  queue holding the first wave): per-request outcomes and tokens, the
  report's sections and keys, the resilience counters and the journal's
  lifecycle in order, at world 1, at tp=2 and at dp=2 x tp=4 on gloo ranks
  (``tests/torch_serve_worker.py::run_faults``).  The deadline runs read a
  stepped clock (0 s once, then 1 s), so that deadlines of 1e-9 s and 1e9 s
  are met or missed whatever the host's speed;
- at dp=2, a hang is abandoned at the same unit on both ranks (rank 0's
  verdict), and an abandoned thread launches nothing after its deadline;
- the drain and ``resume_serving`` at world 1 and at dp=2 x tp=4 (with a
  hang and a torn cache on the way), the ranks in agreement;
- ``serving_metrics``'s ``metrics.prom`` and the serving report's CSV and
  markdown equal to JAX's byte for byte on the same report dicts (the
  markdown's prose names the port's command).
"""

import ast
import dataclasses
import json
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch_serve_worker
from torch_serve_worker import faulted_run

from dlbb_tpu.comm.mesh import build_parallelism_mesh as jax_parallelism_mesh
from dlbb_tpu.models import configs as jax_configs
from dlbb_tpu.obs import export as jax_export
from dlbb_tpu.obs import spans as jax_spans
from dlbb_tpu.resilience import inject as jax_inject
from dlbb_tpu.serve import engine as jax_engine
from dlbb_tpu.serve import traffic as jax_traffic
from dlbb_tpu.stats import serving_report as jax_report
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu_torch.models import ModelConfig, params_from_jax
from dlbb_tpu_torch.obs import export as pt_export
from dlbb_tpu_torch.obs import spans
from dlbb_tpu_torch.resilience import inject
from dlbb_tpu_torch.resilience.journal import SweepJournal, read_journal
from dlbb_tpu_torch.serve import engine as pt_engine
from dlbb_tpu_torch.serve.traffic import Request, TrafficTrace, generate_trace
from dlbb_tpu_torch.stats import serving_report as pt_report
from dlbb_tpu_torch.utils.config import save_json

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

TINY = dict(hidden_size=64, num_layers=2, num_heads=4, ffn_intermediate=128,
            dtype="float32", attention="full")
# JAX's SMOKE_SERVING: 8 slots, a queue holding the whole trace, fast backoff
SERVING = dict(max_batch=8, block_size=8, max_seq=64, queue_capacity=64,
               hbm_budget_gb=None, retry_backoff_s=0.01)
# The watchdog's floor and the injected hang, on the run's first decode unit
# (JAX's @1), whose deadline is the floor whatever the timing: the step EMA
# is cold until a unit syncs.  At world 1 JAX's floor (0.3 s) with a 2 s
# hang; on 8 gloo ranks a loaded host can stretch a TINY unit's all-reduces,
# so the floor of every later unit there is 1 s.
WATCHDOG = dict(dispatch_deadline_factor=50.0, dispatch_deadline_min_s=0.3)
WATCHDOG_RANKS = dict(dispatch_deadline_factor=50.0, dispatch_deadline_min_s=1.0)
HANG_S = 2.0


class _CopyingJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy argument first (the
    race of JAX's engine on the CPU, ROADMAP Queue 3: its host mask upload
    can alias ``active_np``)."""

    def __getattr__(self, name):
        return getattr(jax.numpy, name)

    @staticmethod
    def asarray(a, *args, **kwargs):
        return jax.numpy.asarray(a.copy() if isinstance(a, np.ndarray) else a,
                                 *args, **kwargs)


def _t0(trace):
    return dataclasses.replace(trace, requests=tuple(
        dataclasses.replace(r, arrival_s=0.0) for r in trace.requests))


def _trace(n=10, seed=5):
    """JAX's ``_trace`` (10 requests, prompts 4-12, outputs 3-6), every
    arrival at t=0: the first 8 are admitted at once, the rest as slots
    free."""
    return _t0(generate_trace("poisson", n, seed=seed, rate=200.0, prompt_range=(4, 12),
                              output_range=(3, 6)))


def _deadline_trace():
    """12 requests at t=0 with deadlines alternating 1e-9 s and 1e9 s.
    Under the stepped clock the first wave (rids 0-7) is admitted at 0 s,
    so its 1e-9 s requests complete late; at the next boundary rid 8 heads
    the queue and is shed, and rid 9 (in time) stops the shedding; rids
    9-11 are admitted together once the first wave completes, so rid 10
    completes late too."""
    return TrafficTrace(kind="poisson", seed=0, params={}, requests=tuple(
        Request(rid=i, arrival_s=0.0, prompt_len=8, output_len=4, seed=100 + i,
                deadline_s=1e-9 if i % 2 == 0 else 1e9) for i in range(12)))


def _chunk_trace():
    """JAX's carry-reset trace: rid 0 (1 chunk) is resident when rid 1's
    3-chunk prefill interleaves a decode unit, the first decode dispatch."""
    return TrafficTrace(kind="poisson", seed=0, params={}, requests=(
        Request(rid=0, arrival_s=0.0, prompt_len=4, output_len=4, seed=11),
        Request(rid=1, arrival_s=0.0, prompt_len=20, output_len=4, seed=12)))


def _jax_trace(trace):
    return jax_traffic.TrafficTrace.from_dict(trace.to_dict())


# name: (trace, plan, serving overrides, stepped clock)
SCENARIOS = {
    "transient": (_trace, "serve-prefill-fail:1,serve-decode-fail:1", {}, False),
    "torn": (_trace, "serve-cache-torn:1", {}, False),
    "permanent": (_trace, "serve-decode-fail:*", dict(max_dispatch_retries=0), False),
    "hang": (_trace, f"serve-decode-hang:@1,hang_seconds={HANG_S}", WATCHDOG, False),
    "preempt": (_trace, "serve-preempt:@3", {}, False),
    "deadline": (_deadline_trace, None, {}, True),
}


def _compare(got, ref):
    """The port's faulted run against JAX's: every comparable section."""
    for key in ("requests", "completed_tokens", "resilience", "preempted", "remaining_rids",
                "failed", "counters", "journal", "keys", "decode_steps", "generated_tokens"):
        if key == "failed":
            # the exception chains name each package's own types and paths
            assert [(r, rids) for r, rids, _e in got[key]] == \
                [(r, rids) for r, rids, _e in ref[key]], key
            assert [e.split(":")[0] for *_x, e in got[key]] == \
                [e.split(":")[0] for *_x, e in ref[key]], key
        else:
            assert got[key] == ref[key], key
    for key in ("peak_blocks_reserved", "peak_blocks_in_use", "blocks_reserved",
                "blocks_in_use"):
        assert got["cache"][key] == ref["cache"][key], key


@pytest.fixture(scope="module")
def jax_world1():
    """JAX's engine on one device (weights from seed 3) and the port's on
    the same weights."""
    jmesh = jax_parallelism_mesh(devices=jax.devices()[:1])
    jeng = jax_engine.ServingEngine(jax_configs.ModelConfig(**TINY),
                                    jax_engine.ServingConfig(**SERVING), jmesh,
                                    verbose=False, capture_tokens=True, seed=3)
    cfg = ModelConfig(**TINY)
    peng = pt_engine.ServingEngine(
        cfg, pt_engine.ServingConfig(**SERVING),
        params=params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg),
        verbose=False, capture_tokens=True, device="cpu")
    return jeng, peng


def _both(engines, scenario, monkeypatch):
    """Scenario ``scenario`` through JAX's engine and the port's."""
    jeng, peng = engines
    make, plan, knobs, clock = SCENARIOS[scenario]
    trace = make()
    j_sv, p_sv = jeng.serving, peng.serving
    jeng.serving = dataclasses.replace(j_sv, **knobs)
    peng.serving = dataclasses.replace(p_sv, **knobs)
    try:
        with monkeypatch.context() as mp:
            mp.setattr(jax_engine, "jnp", _CopyingJnp())
            ref = faulted_run(jeng, _jax_trace(trace), plan, clock, inject=jax_inject)
        got = faulted_run(peng, trace, plan, clock)
    finally:
        jeng.serving, peng.serving = j_sv, p_sv
    _compare(got, ref)
    return got


# ---------------------------------------------------------------------------
# the injection registry and the static hot-path pin
# ---------------------------------------------------------------------------


def test_serve_sites_registered_and_parse():
    for site in ("serve-prefill-fail", "serve-decode-fail", "serve-decode-hang",
                 "serve-cache-torn", "serve-trace-corrupt", "serve-preempt"):
        assert site in inject.SITES
    assert inject.SITES == jax_inject.SITES
    plan = inject.FaultPlan.parse("serve-decode-fail:2,serve-decode-hang:@1,hang_seconds=5")
    assert plan.fire("serve-decode-fail")
    assert plan.fire("serve-decode-hang")
    assert plan.param("hang_seconds") == 5.0


# every device program of the port's engine: the core's, the fast path's
# (11b), the verify's and the draft's (11c)
DEVICE_FNS = {
    "_block_head", "_block_tail", "_serve_block", "_heads", "_kv32", "_attend",
    "_cached_attention", "_layer_planes", "_write_prompt_blocks",
    "_write_kv_blocks", "build_prefill", "create_prefix", "_chunk_attention",
    "build_prefill_chunk", "build_prefix_attach", "build_compact_gather",
    "build_compact_scatter", "_append_rows", "_append_rows_int8", "_decode_step_math",
    "build_decode_step", "build_decode_fused", "_inject_token", "_inject_token_greedy",
    "build_decode_token_step", "build_decode_fused_token", "_gather_dp",
    "_inject_token_sampled", "_verify_math", "build_verify_step",
    "build_verify_probs", "build_spec_commit", "build_draft_scan",
}


def test_decode_hot_path_static_zero_injection_pin():
    """The zero-overhead contract: no device program of the port's engine
    names the injection registry, so the programs are the same with or
    without a plan (the fault sites live on the host side of a dispatch),
    and ``serve/kvcache.py`` does not either."""
    src = (REPO / "dlbb_tpu_torch" / "serve" / "engine.py").read_text()
    seen = set()
    for node in ast.parse(src).body:
        if isinstance(node, ast.FunctionDef) and node.name in DEVICE_FNS:
            seen.add(node.name)
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name) and sub.id == "inject":
                    raise AssertionError(f"injection reference inside device program "
                                         f"{node.name}")
                if (isinstance(sub, ast.Attribute) and sub.attr in ("fire", "param")
                        and isinstance(sub.value, ast.Name) and sub.value.id == "inject"):
                    raise AssertionError(f"inject.{sub.attr} inside device program "
                                         f"{node.name}")
    assert seen == DEVICE_FNS, f"missing device fns: {DEVICE_FNS - seen}"
    assert "inject" not in (REPO / "dlbb_tpu_torch" / "serve" / "kvcache.py").read_text()


# ---------------------------------------------------------------------------
# traffic: deadlines and a corrupt trace
# ---------------------------------------------------------------------------


def test_request_deadline_field_roundtrip(tmp_path):
    t = generate_trace("poisson", 10, seed=5, rate=200.0, prompt_range=(4, 12),
                       output_range=(3, 6), deadline_s=0.5)
    assert all(r.deadline_s == 0.5 for r in t)
    assert t.params["deadline_s"] == 0.5
    assert t.to_dict() == jax_traffic.generate_trace(
        "poisson", 10, seed=5, rate=200.0, prompt_range=(4, 12), output_range=(3, 6),
        deadline_s=0.5).to_dict()
    path = tmp_path / "t.json"
    t.save(path)
    assert TrafficTrace.load(path) == t
    plain = generate_trace("poisson", 10, seed=5, rate=200.0, prompt_range=(4, 12),
                           output_range=(3, 6))
    assert all("deadline_s" not in r for r in plain.to_dict()["requests"])
    with pytest.raises(ValueError, match="deadline_s"):
        generate_trace("poisson", 10, seed=5, deadline_s=0.0)


def test_trace_corrupt_load_fails_closed(tmp_path):
    path = tmp_path / "t.json"
    _trace().save(path)
    with inject.plan_scope("serve-trace-corrupt:@1"):
        with pytest.raises(ValueError, match="corrupt or truncated") as ei:
            TrafficTrace.load(path)
        assert ei.value.__cause__ is not None
        # the site is spent and the file untouched: the next load succeeds
        assert len(TrafficTrace.load(path)) == 10


# ---------------------------------------------------------------------------
# the fault matrix through the engine, against JAX's, at world 1
# ---------------------------------------------------------------------------


def test_transient_dispatch_failures_retry_and_recover(jax_world1, monkeypatch):
    """serve-prefill-fail and serve-decode-fail fire once each before any
    launch; the engine restores the snapshot, backs off and re-issues:
    every request completes, the retries journaled and counted."""
    got = _both(jax_world1, "transient", monkeypatch)
    assert got["requests"]["completed"] == 10 and got["requests"]["failed"] == 0
    assert got["resilience"]["retries"] >= 2
    assert set(got["requests"]["outcomes"].values()) == {"completed"}
    phases = {p for e, _c, p in got["journal"] if e == "dispatch-retry"}
    assert {"prefill", "decode"} <= phases
    assert got["counters"]["serve_request_retries[('phase', 'prefill')]"] >= 1
    assert got["counters"]["serve_request_retries[('phase', 'decode')]"] >= 1


def test_cache_torn_bookkeeping_rolls_back_and_replays(jax_world1, monkeypatch):
    """serve-cache-torn raises mid-way through a unit's accounting: the
    snapshot is restored and the accounting replayed from the device
    result in hand; nothing dangles."""
    got = _both(jax_world1, "torn", monkeypatch)
    assert got["requests"]["completed"] == 10
    assert got["resilience"]["retries"] >= 1
    assert got["cache"]["blocks_reserved"] == 0 and got["cache"]["blocks_in_use"] == 0
    assert got["counters"]["serve_request_retries[('phase', 'bookkeeping')]"] >= 1


def test_permanent_decode_failure_fails_only_affected_requests(jax_world1, monkeypatch):
    """Retries exhausted: the resident requests fail closed (journaled
    with their exception chain), the run drains, and the engine serves the
    next trace."""
    got = _both(jax_world1, "permanent", monkeypatch)
    req = got["requests"]
    assert req["failed"] == 10 and req["completed"] == 0
    assert set(req["outcomes"].values()) == {"failed[dispatch-failed]"}
    assert got["failed"] and got["failed"][0][2].startswith("TransientFault")
    assert len([e for e, _c, _r in got["journal"] if e == "request-failed"]) == 10
    assert got["cache"]["blocks_reserved"] == 0
    clean = jax_world1[1].run_trace(_trace(seed=6))
    assert clean["requests"]["completed"] == 10


def test_hung_dispatch_abandoned_by_watchdog(jax_world1, monkeypatch):
    """serve-decode-hang sleeps on the first decode dispatch; the watchdog
    (0.3 s floor) abandons it, fails the resident requests as hung-dispatch, and
    the engine continues on a fresh carry: the later requests complete,
    and the run does not wait for the hang."""
    t0 = time.perf_counter()
    got = _both(jax_world1, "hang", monkeypatch)
    assert time.perf_counter() - t0 < 2 * HANG_S + 6.0
    assert got["resilience"]["hung_dispatches"] == 1
    hung = [r for r, o in got["requests"]["outcomes"].items() if o == "failed[hung-dispatch]"]
    assert len(hung) >= 1
    assert got["requests"]["completed"] == 10 - len(hung)
    assert any(e == "request-failed" and r == "hung-dispatch" for e, _c, r in got["journal"])
    assert got["counters"]["serve_hung_dispatches[]"] == 1


def test_carry_reset_mid_chunked_prefill_restarts_prefill(monkeypatch):
    """A hang during the chunked-prefill interleave replaces the carry,
    taking the admitting request's chunks with it: the prefill restarts on
    the fresh carry, the resident request fails and the admitting one
    completes with the tokens of an unfaulted run (and JAX's)."""
    sv = dict(SERVING, prefill_chunk=8, **WATCHDOG)
    jeng = jax_engine.ServingEngine(jax_configs.ModelConfig(**TINY),
                                    jax_engine.ServingConfig(**sv),
                                    jax_parallelism_mesh(devices=jax.devices()[:1]),
                                    verbose=False, capture_tokens=True, seed=3)
    cfg = ModelConfig(**TINY)
    peng = pt_engine.ServingEngine(
        cfg, pt_engine.ServingConfig(**sv),
        params=params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg),
        verbose=False, capture_tokens=True, device="cpu")
    trace = _chunk_trace()
    baseline = peng.run_trace(trace)
    assert baseline["requests"]["completed"] == 2
    plan = f"serve-decode-hang:@1,hang_seconds={HANG_S}"
    with monkeypatch.context() as mp:
        mp.setattr(jax_engine, "jnp", _CopyingJnp())
        ref = faulted_run(jeng, _jax_trace(trace), plan, inject=jax_inject)
    got = faulted_run(peng, trace, plan)
    _compare(got, ref)
    outcomes = got["requests"]["outcomes"]
    assert outcomes == {"0": "failed[hung-dispatch]", "1": "completed"}
    assert got["resilience"]["hung_dispatches"] == 1
    assert got["resilience"]["retries"] >= 1
    assert got["counters"]["serve_request_retries[('phase', 'prefill')]"] >= 1
    assert got["completed_tokens"]["1"] == baseline["completed_tokens"]["1"]


def test_deadline_sheds_queue_heads_and_counts_late_completions(jax_world1, monkeypatch):
    """Queue heads past their deadline are shed (reason "deadline",
    distinct from queue-full: shed_rate stays 0) and completions past it
    are counted, under the stepped clock: rid 8 shed, the 1e-9 s
    requests admitted (rids 0-6 and 10) late, the 1e9 s ones in time."""
    got = _both(jax_world1, "deadline", monkeypatch)
    req = got["requests"]
    assert req["deadline_shed"] == 1 and req["completed_past_deadline"] == 5
    assert req["shed_rate"] == 0.0
    assert req["completed"] + req["deadline_shed"] == 12
    shed = [d for d in req["rejected_detail"] if d["reason"] == "deadline"]
    assert [d["rid"] for d in shed] == [8]
    assert all(d["queue_wait_s"] > d["deadline_s"] for d in shed)
    assert all(req["outcomes"][str(d["rid"])] == "rejected[deadline]" for d in shed)
    assert got["counters"]["serve_deadline_exceeded[('reason', 'completed-late')]"] == 5
    assert got["counters"]["serve_deadline_exceeded[('reason', 'shed-queued')]"] == 1
    assert ("request-rejected", "request-8", "deadline") in got["journal"]


def test_preempt_drains_and_journals(jax_world1, monkeypatch):
    """serve-preempt SIGTERMs the process at a scheduler boundary; the
    engine's own guard drains: admission stops, the window settles, the
    resident requests are journaled request-preempted, and the report
    carries the remaining rids and its raw samples."""
    got = _both(jax_world1, "preempt", monkeypatch)
    assert got["preempted"] is True and got["remaining_rids"]
    preempted = [r for r, o in got["requests"]["outcomes"].items() if o == "preempted"]
    assert got["requests"]["completed"] + len(got["remaining_rids"]) == 10
    assert got["cache"]["blocks_reserved"] == 0
    assert ("preempted", None, None) in got["journal"]
    assert len([e for e, _c, _r in got["journal"]
                if e == "request-preempted"]) == len(preempted)
    assert "raw_samples" in got["keys"]


def _serve_config(**parallelism):
    return {"experiment": {"name": "x"}, "model": dict(TINY),
            "parallelism": {"data_parallel": 1, "world_size": 1, **parallelism},
            "serving": {"max_batch": 8, "block_size": 8, "max_seq": 64,
                        "queue_capacity": 64, "hbm_budget_gb": None}}


def test_kill_mid_trace_resume_equals_uninterrupted(tmp_path):
    """``serve/bench.py``: a SIGTERM mid-trace writes the checkpoint instead
    of the result; the resume replays the rest and merges both sessions
    into the artifact set of an uninterrupted run: the same names, report
    keys, and the outcome of every request that was not preempted."""
    from dlbb_tpu_torch.serve.bench import RESUME_CHECKPOINT, resume_serving, run_serving

    config = _serve_config()
    trace = _trace()
    ref, out = tmp_path / "ref", tmp_path / "preempted"
    run_serving(config, trace, str(ref), verbose=False, device="cpu")
    rep = run_serving(config, trace, str(out), verbose=False, fault_plan="serve-preempt:@3",
                      device="cpu")
    assert rep["preempted"]
    assert (out / RESUME_CHECKPOINT).exists()
    assert not (out / "serving_x.json").exists()
    preempted = {r for r, o in rep["requests"]["outcomes"].items() if o == "preempted"}
    merged = resume_serving(str(out), verbose=False, device="cpu")
    assert not (out / RESUME_CHECKPOINT).exists()
    assert merged["requests"]["sessions"] == 2
    assert sorted(p.name for p in ref.iterdir()) == sorted(p.name for p in out.iterdir())
    a = json.loads((ref / "serving_x.json").read_text())
    b = json.loads((out / "serving_x.json").read_text())
    assert sorted(a) == sorted(b)
    oa, ob = a["requests"]["outcomes"], b["requests"]["outcomes"]
    assert set(oa) == set(ob)
    for rid in oa:
        if rid not in preempted:
            assert oa[rid] == ob[rid], rid
    assert b["ttft"]["count"] >= a["ttft"]["count"]
    assert "raw_samples" not in b
    events, torn = read_journal(out)
    assert torn == 0
    assert [e for e in events if e["event"] == "sweep-start" and e.get("resume")]
    assert any(e["event"] == "request-preempted" for e in events)


def test_journal_to_trace_pairs_failed_and_preempted(tmp_path):
    """``obs/spans.journal_to_trace`` turns failed and preempted request
    lifecycles into X spans, JAX's, event for event."""
    def write(journal_cls, path):
        with journal_cls(path, meta={"mode": "serve"}) as j:
            j.event("request-arrived", config="request-1", prompt=4)
            j.event("dispatch-retry", phase="decode", attempt=1)
            j.event("request-failed", config="request-1", reason="hung-dispatch",
                    error="DeadlineExceeded: ...")
            j.event("request-arrived", config="request-2", prompt=8)
            j.event("request-preempted", config="request-2", tokens_done=3)
            j.event("preempted", remaining=1)

    from dlbb_tpu.resilience.journal import SweepJournal as JaxJournal

    write(SweepJournal, tmp_path / "port")
    write(JaxJournal, tmp_path / "jax")
    path, _n, torn = spans.journal_to_trace(tmp_path / "port", tmp_path / "port.json")
    assert torn == 0
    payload = spans.load_trace(path)
    xs = {e["name"]: e for e in payload["traceEvents"] if e["ph"] == "X"}
    assert xs["request-1"]["cat"] == "config-failed"
    assert xs["request-1"]["args"]["reason"] == "hung-dispatch"
    assert xs["request-2"]["cat"] == "config-preempted"
    assert "dispatch-retry" in [e["name"] for e in payload["traceEvents"] if e["ph"] == "i"]
    jpath, _n, _t = jax_spans.journal_to_trace(tmp_path / "jax", tmp_path / "jax.json")
    names = [(e["ph"], e["name"], e.get("cat")) for e in payload["traceEvents"]]
    assert names == [(e["ph"], e["name"], e.get("cat"))
                     for e in jax_spans.load_trace(jpath)["traceEvents"]]


# ---------------------------------------------------------------------------
# config validation, metrics, report columns
# ---------------------------------------------------------------------------


def test_resilience_config_validation_ladder():
    cfg, jcfg = ModelConfig(**TINY), jax_configs.ModelConfig(**TINY)
    base = dict(max_batch=4, block_size=8, max_seq=32, hbm_budget_gb=None)
    good = pt_engine.ServingConfig(**base, dispatch_deadline_factor=8.0)
    good.validate(cfg)
    for bad in (dict(max_dispatch_retries=-1), dict(retry_backoff_s=-0.1),
                dict(dispatch_deadline_factor=0.0), dict(dispatch_deadline_min_s=0.0)):
        with pytest.raises(ValueError, match=next(iter(bad))) as e:
            pt_engine.ServingConfig(**base, **bad).validate(cfg)
        with pytest.raises(ValueError) as je:
            jax_engine.ServingConfig(**base, **bad).validate(jcfg)
        assert str(e.value) == str(je.value)
    rt = pt_engine.ServingConfig.from_dict(good.to_dict())
    assert rt.dispatch_deadline_factor == 8.0
    assert rt.max_dispatch_retries == good.max_dispatch_retries
    # the watchdog is served, no longer refused
    pt_engine.ServingEngine(cfg, good, verbose=False, device="cpu")


RESILIENCE_REPORT = {
    "goodput_tokens_per_s": 100.0,
    "requests": {"shed_rate": 0.1, "deadline_shed": 3, "completed_past_deadline": 2,
                 "failed": 1, "preempted": 0},
    "resilience": {"retries": 4, "hung_dispatches": 1},
}


def test_serving_metrics_folds_resilience_and_deadlines():
    reg = pt_export.serving_metrics(RESILIENCE_REPORT)
    assert reg.get("serve_deadline_shed") == 3
    assert reg.get("serve_completed_past_deadline") == 2
    assert reg.get("serve_failed_requests") == 1
    assert reg.get("serve_request_retries", phase="decode") == 4
    assert reg.get("serve_hung_dispatches") == 1
    text = reg.to_prometheus()
    assert "dlbb_serve_deadline_shed" in text
    assert "dlbb_serve_request_retries_total" in text
    assert "dlbb_serve_hung_dispatches_total" in text
    assert text == jax_export.serving_metrics(RESILIENCE_REPORT).to_prometheus()
    # a live registry whose retries were all bookkeeping is already seeded:
    # the fold must not add the total again under phase=decode
    live = pt_export.MetricsRegistry()
    live.labeled_counter("serve_request_retries", "phase")["bookkeeping"] += 4
    reg2 = pt_export.serving_metrics(RESILIENCE_REPORT, registry=live)
    assert reg2.get("serve_request_retries", phase="decode") == 0
    assert reg2.get("serve_request_retries", phase="bookkeeping") == 4


def write_both_reports(tmp_path, reports):
    """Each report dict as ``serving_<name>.json`` under one results tree,
    then JAX's writer and the port's: their rows, CSVs and markdowns."""
    results = tmp_path / "results"
    for name, report in reports.items():
        save_json(report, results / f"serving_{name}.json")
    jrows = jax_report.write_serving_report(results, tmp_path / "jax")
    prows = pt_report.write_serving_report(results, tmp_path / "port")
    assert prows == jrows
    assert (tmp_path / "port" / "serving.csv").read_bytes() == \
        (tmp_path / "jax" / "serving.csv").read_bytes()
    jmd = (tmp_path / "jax" / "SERVING.md").read_text()
    pmd = (tmp_path / "port" / "SERVING.md").read_text()
    assert pmd == jmd.replace("`python -m dlbb_tpu.cli serve`",
                              "`python -m dlbb_tpu_torch.cli serve`")
    return prows, pmd, (tmp_path / "port" / "serving.csv").read_text()


def test_serving_report_gains_resilience_columns(tmp_path):
    fake = {
        "schema": "dlbb_serving_report_v1",
        "trace": {"kind": "poisson", "num_requests": 10},
        "requests": {"completed": 7, "rejected": 2, "failed": 1,
                     "deadline_shed": 2, "completed_past_deadline": 3},
        "resilience": {"retries": 5},
        "mesh": {"dp": 2, "tp": 4},
        "serving": {"max_batch": 8, "block_size": 16, "max_seq": 256},
        "goodput_tokens_per_s": 10.0,
        "ttft": {"median": 0.01, "p99": 0.02, "p999": 0.03},
        "per_token_latency": {"median": 0.001, "p99": 0.002, "p999": 0.003},
        "cache": {"peak_blocks_in_use": 4},
        "timeseries": {"queue_depth": [0, 1]},
        "decode_steps": 9,
        "wall_seconds": 1.0,
    }
    rows, md, csv_head = write_both_reports(tmp_path, {"r1": fake})
    assert rows[0]["failed"] == 1
    assert rows[0]["deadline_shed"] == 2
    assert rows[0]["past_deadline"] == 3
    assert rows[0]["retries"] == 5
    assert "| late |" in md.replace("  ", " ")
    assert "failed" in csv_head and "past_deadline" in csv_head


# ---------------------------------------------------------------------------
# the watchdog's thread
# ---------------------------------------------------------------------------


def test_abandoned_thread_launches_nothing_after_its_deadline(jax_world1, monkeypatch):
    """The hung dispatch's thread wakes after the run and returns without
    calling its program: no decode program starts after the watchdog gave
    up on it, and no watchdog thread is left once the hang has passed."""
    peng = jax_world1[1]
    starts = []
    real = peng._decode

    def recording(*args):
        starts.append(time.perf_counter())
        return real(*args)

    monkeypatch.setattr(peng, "_decode", recording)
    monkeypatch.setattr(peng, "serving", dataclasses.replace(peng.serving, **WATCHDOG))
    t0 = time.perf_counter()
    with inject.plan_scope(f"serve-decode-hang:@1,hang_seconds={HANG_S}"):
        report = peng.run_trace(_trace())
    t_end = time.perf_counter()
    assert report["resilience"]["hung_dispatches"] == 1
    assert t_end - t0 < HANG_S, "the run waited for the hang"
    time.sleep(max(0.0, t0 + HANG_S + 0.5 - time.perf_counter()))
    assert [t for t in starts if t > t_end] == []
    assert [t.name for t in threading.enumerate() if t.name.startswith("dlbb-serve")] == []
    # the watchdog itself: calls in time share one thread; an overrun sets
    # the cancel flag fn reads and the next call runs on a new thread
    thread, flags = pt_engine._WatchdogThread(), []

    def slow(cancel):
        time.sleep(0.2)
        flags.append(cancel.is_set())

    workers = [pt_engine._with_deadline(lambda c: threading.current_thread(), 1.0, "unit",
                                        "serve-dispatch", thread) for _ in range(2)]
    assert workers[0] is workers[1] is not threading.current_thread()
    with pytest.raises(pt_engine.DeadlineExceeded):
        pt_engine._with_deadline(slow, 0.05, "unit", "serve-dispatch", thread)
    time.sleep(0.3)
    assert flags == [True]
    after = pt_engine._with_deadline(lambda c: threading.current_thread(), 1.0, "unit",
                                     "serve-dispatch", thread)
    assert after is not workers[0] and not workers[0].is_alive()
    thread.close()
    assert pt_engine._with_deadline(lambda c: c, None, "unit", "serve-dispatch", thread) is None


# ---------------------------------------------------------------------------
# on gloo ranks: tp=2, dp=2 x tp=4, dp=2
# ---------------------------------------------------------------------------

# the runs on the 8-rank world, and the fault scenarios each serves (JAX's
# engine serves those of tp2 and dp2x4 on the same meshes)
RANK_SCENARIOS = {
    "tp2": ("transient", "hang"),
    "dp2x4": ("transient", "torn", "permanent", "hang", "preempt", "deadline"),
    "dp2": ("hang",),
}
RANK_MESHES = {"tp2": (1, 2), "dp2x4": (2, 4), "dp2": (2, 1)}
JAX_MESHES = ("tp2", "dp2x4")


def _rank_scenarios(name):
    out = {}
    for s in RANK_SCENARIOS[name]:
        make, plan, knobs, clock = SCENARIOS[s]
        if s == "hang":
            knobs = WATCHDOG_RANKS
        out[s] = (make().to_dict(), plan, knobs, clock)
    return out


@pytest.fixture(scope="module")
def jax_ranks():
    """JAX's engine on each mesh of ``JAX_MESHES`` (weights from seed 3),
    its faulted runs, and its weights."""
    out = {}
    for name in JAX_MESHES:
        dp, tp = RANK_MESHES[name]
        jmesh = jax_parallelism_mesh(data_parallel=dp, tensor_parallel=tp,
                                     devices=jax.devices()[:dp * tp])
        jeng = jax_engine.ServingEngine(jax_configs.ModelConfig(**TINY),
                                        jax_engine.ServingConfig(**SERVING), jmesh,
                                        verbose=False, capture_tokens=True, seed=3)
        runs = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_engine, "jnp", _CopyingJnp())
            for s, (trace, plan, knobs, clock) in _rank_scenarios(name).items():
                jeng.serving = dataclasses.replace(jax_engine.ServingConfig(**SERVING),
                                                   **knobs)
                runs[s] = faulted_run(jeng, jax_traffic.TrafficTrace.from_dict(trace), plan,
                                      clock, inject=jax_inject)
        out[name] = (runs, jax.tree.map(np.asarray, jeng.params))
    return out


# the first unit hangs (the first wave fails), the next one's bookkeeping
# tears, and the preemption finds rids 8 and 9 resident
SERVE_FAULTS = f"serve-cache-torn:1,serve-decode-hang:@1,hang_seconds={HANG_S},serve-preempt:@3"


@pytest.fixture(scope="module")
def ranks(jax_ranks, tmp_path_factory):
    """The port on 8 gloo ranks: every run of ``RANK_SCENARIOS`` on its
    mesh, then ``serve/bench.py`` at dp=2 x tp=4 under a torn cache, a hang
    and a preemption, and its resume."""
    out_dir = tmp_path_factory.mktemp("serve_ranks")
    weights = jax_ranks["tp2"][1]
    runs = {name: (*RANK_MESHES[name], TINY, SERVING, weights, _rank_scenarios(name))
            for name in RANK_MESHES}
    config = _serve_config(data_parallel=2, world_size=4)
    config["serving"].update(WATCHDOG_RANKS, retry_backoff_s=0.01)
    serve_case = (config, _trace().to_dict(), SERVE_FAULTS)
    return launch(torch_serve_worker.run_faults, 8, "cpu",
                  args=(runs, serve_case, str(out_dir)), timeout=400,
                  group_timeout=200), out_dir


@pytest.mark.parametrize("name,scenario", [(n, s) for n in JAX_MESHES
                                           for s in RANK_SCENARIOS[n]])
def test_faults_on_gloo_ranks_match_jax(ranks, jax_ranks, name, scenario):
    """Each fault on a (dp, tp) mesh of gloo ranks against JAX's engine on
    the same mesh: every rank's outcomes, tokens, counters, journal and
    report keys equal JAX's."""
    results, _out = ranks
    dp, tp = RANK_MESHES[name]
    ref = jax_ranks[name][0][scenario]
    for rank in range(dp * tp):
        _compare(results[rank][f"{name}/{scenario}"], ref)


def test_hang_at_dp2_every_rank_abandons_the_same_unit(ranks, jax_ranks):
    """At dp=2 each rank runs its own scheduler and watchdog; the verdict
    is rank 0's, so both ranks abandon the same unit: one hung dispatch
    each, the same requests failed and completed with the same tokens, the
    same journal, as at dp=2 x tp=4 against JAX's engine."""
    results, _out = ranks
    a, b = results[0]["dp2/hang"], results[1]["dp2/hang"]
    assert a["resilience"]["hung_dispatches"] == b["resilience"]["hung_dispatches"] == 1
    assert a["requests"] == b["requests"]
    assert a["completed_tokens"] == b["completed_tokens"]
    assert a["journal"] == b["journal"]
    ref = jax_ranks["dp2x4"][0]["hang"]
    assert a["requests"]["outcomes"] == ref["requests"]["outcomes"]


def test_preempt_resume_and_torn_cache_at_dp2_tp4_ranks_agree(ranks):
    """``run_serving`` at dp=2 x tp=4 under a torn cache, a hang and a
    preemption, then ``resume_serving`` on the same world: the ranks agree
    on every outcome, rank 0 alone wrote the artifact set, and the merge
    accounts for every request."""
    results, out = ranks

    def agreed(run):
        # each rank's exception chains carry its own deadline (its own
        # step EMA); the verdict and everything it decides are rank 0's
        res = {k: v for k, v in run["resilience"].items() if k != "failed"}
        return (run["requests"], run["preempted"], run.get("remaining_rids"), res,
                [(f["reason"], f["rids"]) for f in run["resilience"]["failed"]])

    for key in ("serve", "resume"):
        assert all(agreed(r[key]) == agreed(results[0][key]) for r in results), key
    first, merged = results[0]["serve"], results[0]["resume"]
    assert first["preempted"] and first["remaining_rids"]
    assert first["resilience"]["hung_dispatches"] == 1
    assert first["resilience"]["retries"] >= 1
    assert not merged["preempted"]
    assert merged["requests"]["sessions"] == 2
    outcomes = merged["requests"]["outcomes"]
    assert len(outcomes) == 10 and "preempted" not in outcomes.values()
    assert sorted(p.name for p in out.iterdir()) == sorted(
        ["metrics.prom", "serving_manifest.json", "serving_x.json", "sweep_journal.jsonl",
         "trace_x.json"])
