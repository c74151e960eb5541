"""Span-level time attribution of the port (ROADMAP Queue 1, Slice F, item
14, part 14b: ``dlbb_tpu_torch/obs/attribution.py``, ``cli obs attribute``)
and the train loop's spans it reads, each held against JAX's
``dlbb_tpu/obs/attribution.py`` and ``dlbb_tpu/train/loop.py`` on the same
inputs: the partitions of the same events, and JAX's and the port's
``run_attribution`` of the same port run directories (a sweep on 2 gloo
ranks with a span trace and device captures, a serving run with a journal,
a 2-layer ``run_train`` under a tracer), equal to 1e-9 relative.  The tier
is named and the model is cm1; the port's cm2 prices with a fit or fails
closed (JAX falls back to cm1 with a warning).
"""

from __future__ import annotations

import json
import math

import pytest

from dlbb_tpu.obs import attribution as jattr
from dlbb_tpu.obs import spans as jspans
from dlbb_tpu.train import loop as jax_loop
from dlbb_tpu_torch import cli
from dlbb_tpu_torch.analysis.costmodel import FitMissingError, get_tier
from dlbb_tpu_torch.analysis.findings import EXIT_CLEAN, EXIT_CRASH, EXIT_FINDINGS
from dlbb_tpu_torch.obs import attribution as pattr
from dlbb_tpu_torch.obs import run_obs
from dlbb_tpu_torch.obs import spans as pspans
from dlbb_tpu_torch.train import loop as pt_loop

REL = 1e-9
FIT_DIR = "stats/analysis/costmodel_fit"  # JAX's committed cpu-sim fit, read as data


def _close(a, b):
    """Equal records: same keys, numbers within REL, the rest equal."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(a, b, rel_tol=REL, abs_tol=1e-12)
    return a == b


def _both(input_dir, tmp_path, **kw):
    """JAX's and the port's ``run_attribution`` of one directory."""
    kw = {"tier": "cpu-sim", "model": "cm1", "verbose": False, **kw}
    j = jattr.run_attribution(input_dir, out_dir=tmp_path / "jax", **kw)
    p = pattr.run_attribution(input_dir, out_dir=tmp_path / "port", **kw)
    return j, p


def _same_record(j, p, drop=()):
    for key in ("kind", "source", "tier", "cost_model_version", "fit_version",
                "torn_journal_lines"):
        assert j[key] == p[key], key
    for key in ("wall_us", "phases_us", "predicted_us", "peak_bytes"):
        assert _close(j[key], p[key]), (key, j[key], p[key])
    ents = [[{k: v for k, v in e.items() if k not in drop} for e in r["entities"]]
            for r in (j, p)]
    assert _close(*ents), ents


# ---------------------------------------------------------------------------
# the partitions and the prices, on synthetic inputs (JAX's fixtures)
# ---------------------------------------------------------------------------


def _events(tracks=((1, 7),), misnest=False):
    ev = []
    for pid, tid in tracks:
        def b(name, ts):
            ev.append({"name": name, "ph": "B", "ts": ts, "pid": pid, "tid": tid})

        def e(name, ts):
            ev.append({"name": name, "ph": "E", "ts": ts, "pid": pid, "tid": tid})

        scale = 1.0 + tid / 10
        b("plan", 0.0); e("plan", 100.0 * scale)                 # noqa: E702
        b("cfg.json", 150.0 * scale)                              # unmapped parent
        b("compile-wait", 160.0 * scale)
        b("calibrate:x", 170.0 * scale); e("calibrate:x", 200.0 * scale)  # noqa: E702
        if misnest:
            e("cfg.json", 390.0 * scale)
        e("compile-wait", 400.0 * scale)
        b("measure", 420.0 * scale)
        b("train_step", 430.0 * scale); e("train_step", 800.0 * scale)  # noqa: E702
        e("measure", 900.0 * scale)
        b("write", 900.0 * scale); e("write", 950.0 * scale)     # noqa: E702
        if not misnest:
            e("cfg.json", 960.0 * scale)
    return ev


@pytest.mark.parametrize("tracks,misnest", [(((1, 7),), False), (((1, 7),), True),
                                            (((1, 7), (1, 9), (2, 7)), False), ((), False)])
def test_partition_trace_equals_jax(tracks, misnest):
    ev = _events(tracks, misnest)
    j = jattr.partition_trace(ev)
    p = pattr.partition_trace(ev)
    assert p == j
    phases, wall, _ = p
    if tracks:
        assert sum(phases.values()) == pytest.approx(wall)
        assert set(phases) <= set(pattr.PHASES)


def test_partition_journal_and_last_session_equal_jax():
    recs = [
        {"ts": 0.0, "event": "sweep-start"},
        {"ts": 0.5, "event": "request-arrived", "config": "request-0"},
        {"ts": 0.6, "event": "sweep-start"},
        {"ts": 0.7, "event": "request-arrived", "config": "request-0"},
        {"ts": 0.8, "event": "request-admitted", "config": "request-0"},
        {"event": "torn-without-ts"},
        {"ts": 0.9, "event": "request-prefill", "config": "request-0"},
        {"ts": 1.5, "event": "request-completed", "config": "request-0"},
        {"ts": 1.6, "event": "retry", "config": "c"},
        {"ts": 1.9, "event": "mystery"},
    ]
    assert pattr.last_session(recs) == jattr.last_session(recs)
    for r in (recs, pattr.last_session(recs), recs[:1], []):
        if not [x for x in r if "ts" in x]:
            continue
        assert pattr.partition_journal(r) == jattr.partition_journal(r)
    phases, wall = pattr.partition_journal(recs)
    assert sum(phases.values()) == pytest.approx(wall) == pytest.approx(1.9e6)


@pytest.mark.parametrize("sample", [
    {"dispatches": 1.0, "collectives": 3.0, "wire_bytes": 1000, "flops": 500},
    {"wire_bytes": 65536},
    {"dispatches": 0.1, "collectives": 7.0, "wire_bytes": 8 << 20, "flops": 16_000_000},
])
@pytest.mark.parametrize("tier", ["cpu-sim", "cuda"])
def test_predict_iteration_equals_jax(sample, tier):
    from dlbb_tpu.analysis.costmodel import CostTier as JTier

    pt = get_tier(tier)
    jt = JTier(name=pt.name, alpha_us=pt.alpha_us, beta_bytes_per_us=pt.beta_bytes_per_us,
               peak_flops_per_us=pt.peak_flops_per_us, gamma_dispatch_us=200.0)
    pt = type(pt)(name=pt.name, alpha_us=pt.alpha_us, beta_bytes_per_us=pt.beta_bytes_per_us,
                  peak_flops_per_us=pt.peak_flops_per_us, gamma_dispatch_us=200.0)
    got, ref = pattr.predict_iteration_us(sample, pt), jattr.predict_iteration_us(sample, jt)
    assert _close(got, ref)
    assert got["total"] == pytest.approx(got["dispatch"] + got["wire"] + got["compute"])


@pytest.mark.parametrize("record", [
    {"schema": pattr.ATTRIBUTION_SCHEMA, "name": "x", "kind": "sweep",
     "cost_model_version": "cm1", "wall_us": 100.0, "phases_us": {"execute": 10.0},
     "entities": []},
    {"schema": pattr.ATTRIBUTION_SCHEMA, "name": "x", "kind": "sweep",
     "cost_model_version": "cm1", "wall_us": 100.0, "phases_us": {"execute": 97.0},
     "entities": []},
    {"schema": pattr.ATTRIBUTION_SCHEMA, "name": "x", "kind": "sweep",
     "cost_model_version": "cm1", "wall_us": 100.0, "phases_us": {"warpdrive": 100.0},
     "entities": []},
    {"schema": "other", "wall_us": 0.0, "phases_us": {}},
])
def test_validate_attribution_equals_jax(record):
    assert pattr.validate_attribution(record) == jattr.validate_attribution(record)


_SERVING_REPORT = {
    "schema": "dlbb_serving_report_v1",
    "model": {"hidden_size": 64, "num_layers": 2, "num_heads": 4, "kv_heads": 2,
              "dtype": "float32"},
    "mesh": {"dp": 2, "tp": 4},
    "serving": {"max_batch": 4, "max_seq": 64, "prefill_buckets": [16, 64],
                "decode_horizon": 1},
    "requests": {"arrived": 2, "admitted": 1, "completed": 1, "rejected": 1},
    "decode_units": 4, "decode_steps": 4,
    "fast_path": {"prefill_chunks": 0},
}


@pytest.mark.parametrize("report", [
    _SERVING_REPORT,
    {**_SERVING_REPORT, "mesh": {"dp": 1, "tp": 1}, "model": {
        **_SERVING_REPORT["model"], "dtype": "bfloat16"}},
    {"schema": "dlbb_serving_report_v1"},
])
def test_serving_features_and_peak_bytes_equal_jax(report):
    assert pattr._serving_dispatch_features(report) == jattr._serving_dispatch_features(report)
    assert pattr._serving_peak_bytes(report) == jattr._serving_peak_bytes(report)


def _serving_dir(tmp_path):
    """JAX's journal-only serving fixture (``tests/test_costmodel_fit.py``)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    recs = [
        {"ts": 10.0, "event": "sweep-start", "mode": "serve", "name": "mini"},
        {"ts": 10.1, "event": "request-arrived", "config": "request-0", "prompt": 8,
         "output": 4},
        {"ts": 10.2, "event": "request-admitted", "config": "request-0", "queue_depth": 1},
        {"ts": 10.5, "event": "request-prefill", "config": "request-0", "slot": 0,
         "ttft_s": 0.4},
        {"ts": 11.4, "event": "request-completed", "config": "request-0",
         "output_tokens": 4, "latency_s": 1.3},
        {"ts": 11.5, "event": "request-arrived", "config": "request-1"},
        {"ts": 11.6, "event": "request-rejected", "config": "request-1",
         "reason": "queue-full"},
    ]
    with open(tmp_path / "sweep_journal.jsonl", "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    (tmp_path / "serving_mini.json").write_text(json.dumps(_SERVING_REPORT))
    return tmp_path


def test_attribution_serving_from_journal(tmp_path):
    """JAX's ``test_attribution_serving_from_journal`` on the port, and the
    same record as JAX's, MD and CSV byte-equal."""
    run = _serving_dir(tmp_path / "run")
    record = pattr.run_attribution(run, out_dir=tmp_path / "attr", name="mini",
                                   verbose=False)
    assert pattr.validate_attribution(record) == []
    assert record["kind"] == "serving" and record["source"] == "journal"
    assert record["tier"] == "cpu-sim"  # no artifact records a backend
    assert record["wall_us"] == pytest.approx(1.6e6)
    assert sum(record["phases_us"].values()) == pytest.approx(record["wall_us"], rel=1e-4)
    rows = {e["name"]: e for e in record["entities"]}
    assert rows["request-0"]["queue_wait_us"] == pytest.approx(0.1e6)
    assert rows["request-0"]["decode_us"] == pytest.approx(0.9e6)
    assert rows["request-0"]["tokens"] == 4
    assert rows["request-1"]["outcome"] == "rejected"
    assert record["predicted_us"]["decode_units"] == 4
    assert record["predicted_us"]["prefill_dispatches"] == 1
    ref = jattr.run_attribution(run, out_dir=tmp_path / "jattr", name="mini", verbose=False)
    _same_record(ref, record)
    for ext in ("md", "csv"):
        assert (tmp_path / "attr" / f"mini.{ext}").read_text() \
            == (tmp_path / "jattr" / f"mini.{ext}").read_text()


# ---------------------------------------------------------------------------
# the port's own run directories
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sweep_dir(tmp_path_factory):
    """A sweep on 2 gloo ranks with a span trace, a journal and a device
    capture per config."""
    out = tmp_path_factory.mktemp("attr_sweep") / "sweep"
    assert cli.main(["bench1d", "--device", "cpu", "--world", "2", "--ranks", "2",
                     "--ops", "allreduce", "alltoall", "--sizes", "1KB", "--iters", "8",
                     "--warmup", "2", "--output", str(out), "--span-trace",
                     str(out / "spans.json"), "--device-trace", str(out / "dev"),
                     "--no-pipeline"]) == 0
    return out


@pytest.fixture(scope="module")
def serving_dir(tmp_path_factory):
    """A served trace at world 1 with its journal (no span trace) and its
    prefill and decode captures."""
    out = tmp_path_factory.mktemp("attr_serve") / "serve"
    assert cli.main(["serve", "--device", "cpu", "--requests", "6", "--rate", "200",
                     "--max-seq", "64", "--output", str(out), "--device-trace",
                     str(out / "dev")]) == 0
    return out


def test_sweep_attribution_equals_jax(sweep_dir, tmp_path):
    j, p = _both(sweep_dir, tmp_path)
    assert p["kind"] == "sweep" and p["source"] == "span-trace"
    assert pattr.validate_attribution(p) == []
    assert sum(p["phases_us"].values()) == pytest.approx(p["wall_us"], rel=1e-6)
    # the device column reads the port's captures (the gloo ranks'
    # timelines), which JAX's devtrace does not parse; the rest is JAX's
    _same_record(j, p, drop=("device_us",))
    configs = [e for e in p["entities"] if e["name"].endswith("_1KB.json")]
    assert len(configs) == 2
    for e in configs:
        assert e["outcome"] == "completed" and e["iterations"] == 16
        assert e["device_us"] > 0
    assert p["device_us"]["execute"] == pytest.approx(
        sum(e["device_us"] * e["iterations"] for e in configs))


def test_sweep_attribution_of_the_journal_alone_equals_jax(sweep_dir, tmp_path):
    """Without the span trace the journal is partitioned, as in JAX."""
    import shutil

    run = tmp_path / "run"
    shutil.copytree(sweep_dir, run, ignore=shutil.ignore_patterns("spans.json", "dev"))
    j, p = _both(run, tmp_path)
    assert p["source"] == "journal"
    _same_record(j, p, drop=("device_us",))


def test_serving_attribution_equals_jax(serving_dir, tmp_path):
    j, p = _both(serving_dir, tmp_path)
    assert p["kind"] == "serving" and p["source"] == "journal"
    assert pattr.validate_attribution(p) == []
    assert len(p["entities"]) == 6
    assert all(e["outcome"] == "completed" for e in p["entities"])
    assert p["predicted_us"]["decode_units"] > 0
    _same_record(j, p)
    # the device column: each phase's captured dispatch (the port's
    # capture, parsed by its devtrace) times the run's dispatch counts
    assert set(p["device_us"]) == {"prefill", "decode"}
    assert all(v > 0 for v in p["device_us"].values())


@pytest.mark.parametrize("model", ["cm1", "cm2"])
def test_cm2_prices_with_a_fit_as_jax(serving_dir, tmp_path, model):
    j, p = _both(serving_dir, tmp_path, model=model, fit_dir=FIT_DIR)
    assert p["cost_model_version"] == model
    _same_record(j, p)


def test_cm2_without_a_fit_fails_closed(serving_dir, tmp_path, capsys):
    with pytest.raises(FitMissingError):
        pattr.run_attribution(serving_dir, out_dir=tmp_path / "a", model="cm2",
                              tier="cuda", fit_dir=str(tmp_path / "no_fit"), verbose=False)
    assert not (tmp_path / "a").exists()
    assert run_obs("attribute", journal=str(serving_dir), output=str(tmp_path / "a"),
                   model="cm2", tier="cuda", fit_dir=str(tmp_path / "no_fit"),
                   verbose=False) == EXIT_FINDINGS
    assert "attribution refused" in capsys.readouterr().out


def test_cli_obs_attribute_exit_codes(sweep_dir, tmp_path):
    out = tmp_path / "o"
    assert cli.main(["obs", "attribute", "--journal", str(sweep_dir), "--tier", "cuda",
                     "--output", str(out)]) == EXIT_CLEAN
    assert (out / "sweep.md").is_file() and (out / "sweep.csv").is_file()
    assert "tier cuda" in (out / "sweep.md").read_text()
    assert cli.main(["obs", "attribute", "--output", str(out)]) == EXIT_CRASH
    (tmp_path / "empty").mkdir()
    assert cli.main(["obs", "attribute", "--journal", str(tmp_path / "empty"),
                     "--output", str(out)]) == EXIT_CRASH
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    assert cli.main(["obs", "attribute", "--journal", str(sweep_dir), "--span-trace-file",
                     str(bad), "--output", str(out)]) == EXIT_CRASH
    assert cli.main(["obs", "attribute", "--journal", str(sweep_dir), "--span-trace-file",
                     str(sweep_dir / "spans.json"), "--model", "cm2", "--fit-dir",
                     str(tmp_path / "no_fit"), "--output", str(out)]) == EXIT_FINDINGS
    assert pattr.DEFAULT_ATTRIBUTION_DIR.as_posix() == "stats/torch/analysis/attribution"


# ---------------------------------------------------------------------------
# the train loop's spans (JAX's names, counts, nesting and step args)
# ---------------------------------------------------------------------------


def _train_config(**over):
    cfg = {
        "experiment": {"name": "train_spans"},
        "model": {"hidden_size": 32, "num_layers": 2, "num_heads": 4,
                  "ffn_intermediate": 64, "attention": "full", "dtype": "float32"},
        "parallelism": {"world_size": 1, "data_parallel": 1},
        "input": {"batch_size": 2, "sequence_length": 16, "seed": 42},
        "execution": {"warmup_iterations": 2, "benchmark_iterations": 3},
        "training": {"learning_rate": 1e-3},
    }
    cfg.update(over)
    return cfg


def _tree(path):
    """The trace's B spans in order: (depth, name, cat, args)."""
    events = json.loads(path.read_text())["traceEvents"]
    out, depth = [], 0
    for ev in events:
        if ev["ph"] == "B":
            out.append((depth, ev["name"], ev["cat"], ev.get("args")))
            depth += 1
        elif ev["ph"] == "E":
            depth -= 1
    return out, events


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory, devices):
    """The port's ``run_train`` and JAX's (per-iteration timing, and its
    chained regime, whose ``measure`` span wraps the timed region) under a
    tracer on the same 2-layer config."""
    root = tmp_path_factory.mktemp("train_spans")
    with pspans.tracing(root / "port" / "spans.json", meta={"cmd": "train"}):
        port = pt_loop.run_train(_train_config(), device="cpu", output_dir=str(root / "port"),
                                 verbose=False)
    with jspans.tracing(root / "jax" / "spans.json", meta={"cmd": "train"}):
        jax_loop.run_train(_train_config(), output_dir=str(root / "jax"), verbose=False)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_loop, "resolve_timing_mode", lambda mode="auto": "chained")
    try:
        with jspans.tracing(root / "chained.json", meta={"cmd": "train"}):
            jax_loop.run_train(_train_config(), verbose=False)
    finally:
        mp.undo()
    return root, port


def test_train_spans_match_jax(train_runs):
    root, result = train_runs
    port, events = _tree(root / "port" / "spans.json")
    jax_iter, _ = _tree(root / "jax" / "spans.json")
    jax_chained, _ = _tree(root / "chained.json")
    assert pspans.validate_trace_events(events) == []
    iters = _train_config()["execution"]["benchmark_iterations"]
    steps = [(d, n, c, a) for d, n, c, a in port if n == "train_step"]
    # JAX's per-iteration timing: compile+warmup, then one train_step per
    # timed step with its index (JAX emits measure only in its chained
    # regime, around the timed region; the port's timed region is the
    # per-iteration loop, so its measure holds the train_step spans)
    assert [(n, c, a) for _, n, c, a in port if n != "measure"] \
        == [(n, c, a) for _, n, c, a in jax_iter]
    assert [(n, c, a) for _, n, c, a in port if n != "train_step"] \
        == [(n, c, a) for _, n, c, a in jax_chained]
    assert [a for *_, a in steps] == [{"step": i} for i in range(iters)]
    assert [n for _, n, _, _ in port] == ["compile+warmup", "measure"] + ["train_step"] * iters
    assert {d for d, *_ in steps} == {1} and port[1][0] == 0
    assert len(result["losses"]) == iters


def test_train_attribution_equals_jax(train_runs, tmp_path):
    root, _ = train_runs
    j, p = _both(root / "port", tmp_path)
    assert p["source"] == "span-trace" and pattr.validate_attribution(p) == []
    _same_record(j, p)
    assert sum(p["phases_us"].values()) == pytest.approx(p["wall_us"], rel=1e-6)
    _, events = _tree(root / "port" / "spans.json")
    opened = {}
    step_us = 0.0
    for ev in events:
        if ev["ph"] == "B":
            opened[ev["name"]] = ev["ts"]
        elif ev["ph"] == "E" and ev["name"] == "train_step":
            step_us += ev["ts"] - opened[ev["name"]]
    assert p["phases_us"]["execute"] >= step_us > 0
    assert p["phases_us"]["compile"] > 0


@pytest.mark.parametrize("cmd,dp", [("e2e", 1), ("train", 2)])
def test_cli_span_trace_is_rank_zeros(tmp_path, cmd, dp):
    """``cli e2e|train --span-trace FILE`` runs under rank 0's tracer, as
    JAX's CLI wraps them (at dp=2 on 2 gloo ranks: one trace, one track)."""
    import yaml

    cfg = _train_config(parallelism={"world_size": 1, "data_parallel": dp},
                        execution={"warmup_iterations": 1, "benchmark_iterations": 2})
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(cfg))
    trace = tmp_path / "spans.json"
    assert cli.main([cmd, "--config", str(tmp_path / "c.yaml"), "--device", "cpu",
                     "--output", str(tmp_path), "--span-trace", str(trace)]) == 0
    data = json.loads(trace.read_text())
    assert data["otherData"]["cmd"] == cmd
    assert pspans.validate_trace_events(data["traceEvents"]) == []
    if cmd == "train":
        tree, events = _tree(trace)
        assert [n for _, n, _, _ in tree] == ["compile+warmup", "measure"] + ["train_step"] * 2
        assert len({(ev["pid"], ev["tid"]) for ev in events}) == 1
