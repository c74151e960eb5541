"""The cost model, the corpus walk and the cm2 fit of the port (ROADMAP
Queue 1, Slice F, item 14, part 14a: ``dlbb_tpu_torch/analysis/
costmodel.py``, ``obs/corpus.py``, ``obs/fit.py``, ``cli obs fit``), the
mirror of JAX's ``tests/test_costmodel_fit.py`` (its tests up to the
schedule-meta one), each held against JAX's function on the same inputs:
the same rows in the same order, so the coefficients, intervals and
residuals agree to 1e-12 relative.

JAX's ``test_schedule_meta_carries_dispatch_overhead`` reads HLO; it waits
for the schedule auditor (item 15), as the calibration rows do: the port
skips every calibration report with its reason.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import pytest

from dlbb_tpu.analysis import costmodel as jcm
from dlbb_tpu.obs import corpus as jcorpus
from dlbb_tpu.obs import fit as jfit
from dlbb_tpu_torch import cli
from dlbb_tpu_torch.analysis import costmodel as pcm
from dlbb_tpu_torch.bench import runner
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu_torch.obs import corpus as pcorpus
from dlbb_tpu_torch.obs import fit as pfit

REL = 1e-12

# ---------------------------------------------------------------------------
# synthetic corpora (JAX's)
# ---------------------------------------------------------------------------

TRUE = {"gamma": 220.0, "alpha": 35.0, "beta": 5000.0, "peak": 2000.0}


def _sample(wire, collectives=1.0, dispatches=1.0, flops=0, op="allreduce",
            tier="cpu-sim", noise=1.0):
    measured = (TRUE["gamma"] * dispatches + TRUE["alpha"] * collectives
                + wire / TRUE["beta"] + flops / TRUE["peak"]) * noise
    return {
        "file": f"synth_{op}_{wire}_{collectives}.json", "op": op,
        "variant": "default", "kind": "all-reduce", "ranks": 8,
        "dtype": "bfloat16", "num_elements": wire // 2,
        "wire_bytes": int(wire), "flops": int(flops),
        "collectives": float(collectives), "dispatches": float(dispatches),
        "measured_median_us": measured, "measured_p99_us": measured * 1.2,
        "iterations": 20, "tier": tier, "host": "synthhost/cpu2/dev8",
        "timestamp": 0.0,
    }


def _synthetic_corpus():
    samples = []
    for wire in (1024, 65536, 1048576, 8 * 1048576):
        for coll in (1.0, 7.0):
            samples.append(_sample(wire, collectives=coll))
        samples.append(_sample(wire, collectives=1.0, dispatches=0.1))
        samples.append(_sample(wire, flops=2_000_000, op="ag_matmul"))
        samples.append(_sample(wire, flops=16_000_000, op="ag_matmul"))
    return samples


def _seeded_corpus(seed, n=48):
    """Rows from a numpy seed: JAX's model with 5 % log-normal noise and one
    wild row, over mixed dispatch, collective and FLOP counts."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        wire = int(rng.choice([1024, 16384, 262144, 4194304, 33554432]))
        rows.append(_sample(wire, collectives=float(rng.choice([1.0, 3.0, 7.0])),
                            dispatches=float(rng.choice([1.0, 0.1])),
                            flops=int(rng.choice([0, 0, 4_000_000])), op=f"op{i % 5}",
                            noise=float(np.exp(rng.normal(0.0, 0.05)))))
    rows.append(_sample(65536, noise=50.0))
    return rows


def _close(a, b, path="fit"):
    """``a`` equals ``b`` key for key, floats within REL relative."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert math.isclose(a, b, rel_tol=REL, abs_tol=0.0) or a == b, (path, a, b)
    else:
        assert a == b, (path, a, b)


def _both_fit(samples, tier="cpu-sim", **kw):
    port = pfit.fit_tier(samples, tier, **kw)
    _close(port, jfit.fit_tier(samples, tier, **kw))
    return port


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------


def test_fit_recovers_seeded_coefficients():
    fit = _both_fit(_synthetic_corpus())
    c = fit["coefficients"]
    assert c["gamma_dispatch_us"]["value"] == pytest.approx(TRUE["gamma"], rel=0.05)
    assert c["alpha_us"]["value"] == pytest.approx(TRUE["alpha"], rel=0.1)
    assert c["beta_bytes_per_us"]["value"] == pytest.approx(TRUE["beta"], rel=0.05)
    assert c["peak_flops_per_us"]["value"] == pytest.approx(TRUE["peak"], rel=0.05)
    assert not fit["alpha_pinned"] and not fit["peak_pinned"]
    assert fit["residuals"]["geomean_error_factor"] < 1.05
    ci = c["gamma_dispatch_us"].get("ci95")
    assert ci and ci[0] <= c["gamma_dispatch_us"]["value"] <= ci[1]


def test_fit_rejects_outliers():
    samples = _synthetic_corpus()
    samples.append(_sample(1024, noise=80.0))  # one wild host spike
    fit = _both_fit(samples)
    assert fit["outliers_rejected"] >= 1
    assert fit["coefficients"]["gamma_dispatch_us"]["value"] == \
        pytest.approx(TRUE["gamma"], rel=0.08)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_equals_jax_on_seeded_rows(seed):
    """Noisy rows with an outlier: the port's coefficients, CIs and
    residuals equal JAX's to 1e-12 relative, with and without a host
    filter (whose single dispatch count pins γ from the whole tier)."""
    rows = _seeded_corpus(seed)
    fit = _both_fit(rows)
    assert fit["outliers_rejected"] >= 1
    filtered = [dict(r, dispatches=1.0) if i % 2 else dict(r, host="otherhost/cpu4/dev8")
                for i, r in enumerate(rows)]
    _both_fit(filtered, host_filter="synthhost", min_samples=8)


def test_fit_pins_alpha_and_peak_when_unidentifiable():
    samples = [_sample(w) for w in
               (1024, 4096, 65536, 262144, 1048576, 4 * 1048576)] * 4
    fit = _both_fit(samples, min_samples=8)
    assert fit["alpha_pinned"] and fit["peak_pinned"]
    cm1 = pcm.get_tier("cpu-sim")
    c = fit["coefficients"]
    assert c["alpha_us"] == {"value": cm1.alpha_us, "pinned": "cm1"}
    assert c["peak_flops_per_us"]["pinned"] == "cm1"
    assert c["gamma_dispatch_us"]["value"] == pytest.approx(
        TRUE["gamma"] + TRUE["alpha"] - cm1.alpha_us, rel=0.05)


@pytest.mark.parametrize("case", ["thin", "one_size", "empty", "non_finite", "tier"])
def test_fit_fails_closed_on_degenerate_corpora(case):
    rows, tier, err, match = {
        "thin": (_synthetic_corpus()[:4], "cpu-sim", pfit.FitError, "need >="),
        "one_size": ([_sample(1024) for _ in range(20)], "cpu-sim", pfit.FitError,
                     "single message size"),
        "empty": ([], "cpu-sim", pfit.FitError, "no usable corpus samples"),
        "non_finite": ([dict(_sample(1024), measured_median_us=float("nan"))
                        for _ in range(20)], "cpu-sim", pfit.FitError,
                       "no usable corpus samples"),
        "tier": (_synthetic_corpus(), "no-such-tier", KeyError, None),
    }[case]
    with pytest.raises(err, match=match) as port:
        pfit.fit_tier(rows, tier)
    jerr = jfit.FitError if err is pfit.FitError else err
    with pytest.raises(jerr) as ref:
        jfit.fit_tier(rows, tier)
    # the same message, but for the tier the port adds to the known names
    assert str(port.value).replace("'cuda', ", "") == str(ref.value)


def test_fit_db_versioning_append_only(tmp_path):
    fit = pfit.fit_tier(_synthetic_corpus(), "cpu-sim")
    path, v1 = pfit.save_fit(fit, tmp_path)
    assert path == pcm.fit_db_path("cpu-sim", tmp_path) and v1 == 1
    _, v2 = pfit.save_fit(fit, tmp_path)
    assert v2 == 2
    db = json.loads(path.read_text())
    assert [e["fit_version"] for e in db["versions"]] == [1, 2]
    tier = pcm.load_fitted_tier("cpu-sim", tmp_path)
    assert tier.version == pcm.CM2_VERSION
    assert tier.fit["fit_version"] == 2  # latest wins
    pinned = pcm.load_fitted_tier("cpu-sim", tmp_path, fit_version=1)
    assert pinned.fit["fit_version"] == 1
    with pytest.raises(pcm.FitMissingError):
        pcm.load_fitted_tier("cpu-sim", tmp_path, fit_version=9)
    assert tier.gamma_dispatch_us == pytest.approx(TRUE["gamma"], rel=0.05)
    assert pcm.dispatch_cost_us(3, tier) == pytest.approx(3 * tier.gamma_dispatch_us)
    # JAX's DB of the same two fits holds the same entries, timestamps aside
    jpath, _ = jfit.save_fit(jfit.fit_tier(_synthetic_corpus(), "cpu-sim"), tmp_path / "j")
    jfit.save_fit(jfit.fit_tier(_synthetic_corpus(), "cpu-sim"), tmp_path / "j")
    jdb = json.loads(jpath.read_text())
    for d in (db, jdb):
        for e in d["versions"]:
            e.pop("fitted_at")
    _close(db, jdb)
    jtier = jcm.load_fitted_tier("cpu-sim", tmp_path / "j")
    assert dataclasses.asdict(tier) | {"fit": None, "description": None} == \
        dataclasses.asdict(jtier) | {"fit": None, "description": None}


def test_resolve_tier_cm2_fallback_warns(tmp_path, capsys):
    tier = pcm.resolve_tier("cpu-sim", model=pcm.CM2_VERSION, fit_dir=tmp_path)
    out = capsys.readouterr().out
    assert "fit-missing" in out and "falling back to cm1" in out
    assert tier.version == pcm.COST_MODEL_VERSION
    assert tier.gamma_dispatch_us == 0.0
    with pytest.raises(KeyError):
        pcm.resolve_tier("cpu-sim", model="cm99")
    jtier = jcm.resolve_tier("cpu-sim", model=jcm.CM2_VERSION, fit_dir=tmp_path)
    assert dataclasses.asdict(tier) == dataclasses.asdict(jtier)


def test_resolve_tier_cm1_is_identity():
    assert pcm.resolve_tier("cpu-sim") == pcm.get_tier("cpu-sim")
    assert pcm.resolve_tier("cuda") == pcm.get_tier("cuda")


@pytest.mark.parametrize("name", sorted(jcm.COST_MODELS["cm1"]))
def test_cm1_tiers_equal_jax_field_for_field(name):
    assert dataclasses.asdict(pcm.get_tier(name)) == dataclasses.asdict(jcm.get_tier(name))


def test_cuda_tier_and_versions():
    """The port adds one tier and changes none: the version stays JAX's."""
    assert (pcm.COST_MODEL_VERSION, pcm.CM2_VERSION, pcm.FIT_SCHEMA) == \
        (jcm.COST_MODEL_VERSION, jcm.CM2_VERSION, jcm.FIT_SCHEMA)
    assert set(pcm.COST_MODELS["cm1"]) == set(jcm.COST_MODELS["cm1"]) | {"cuda"}
    cuda = pcm.get_tier("cuda")
    assert cuda.peak_flops_per_us == 989e6 and cuda.beta_bytes_per_us == 450e3
    assert cuda.hbm_bytes == 80 * 2**30 and cuda.version == "cm1" and cuda.alpha_us > 0
    assert pcm.memory_feasible(79 * 2**30, cuda) and not pcm.memory_feasible(81 * 2**30, cuda)
    assert str(pcm.DEFAULT_FIT_DIR) == "stats/torch/analysis/costmodel_fit"
    assert pcm.DEFAULT_FIT_DIR != jcm.DEFAULT_FIT_DIR


# ---------------------------------------------------------------------------
# corpus ingestion
# ---------------------------------------------------------------------------


def _artifact(op="allreduce", ranks=8, elems=512, dtype="bfloat16",
              variant="default", timings=((0.001, 0.0012, 0.0011),),
              **extra):
    return {
        "operation": op, "num_ranks": ranks, "num_elements": elems,
        "dtype": dtype, "variant": variant,
        "timings": [list(t) for t in timings],
        "timing_mode": extra.pop("timing_mode", "per_iter"),
        "system_info": {"backend": extra.pop("backend", "cpu"),
                        "platform": "testbox", "cpu_count": 2,
                        "num_devices": ranks},
        **extra,
    }


def _both_corpora(roots, baselines_dir):
    port = pcorpus.build_corpus(roots, baselines_dir=baselines_dir)
    ref = jcorpus.build_corpus(roots, baselines_dir=baselines_dir)
    assert port == ref
    return port


def test_corpus_ingest_and_features(tmp_path):
    (tmp_path / "a.json").write_text(json.dumps(_artifact()))
    (tmp_path / "b.json").write_text(json.dumps(_artifact(
        op="ag_matmul", tensor_shape=[2, 64, 256], elems=2 * 64 * 256)))
    (tmp_path / "chained.json").write_text(json.dumps(_artifact(
        timing_mode="chained", timing_granularity="chunked(10)")))
    (tmp_path / "noop.json").write_text(json.dumps({"hello": 1}))
    (tmp_path / "sweep_manifest.json").write_text(json.dumps(
        {"wall_seconds": 2.0, "compile_seconds_total": 1.0}))
    (tmp_path / "torn.json").write_text('{"operation": "allre')
    (tmp_path / "dev").mkdir()
    (tmp_path / "dev" / "d.json").write_text(json.dumps({
        "schema": "dlbb_devtrace_v1",
        "op_samples": [dict(_sample(4096), source="devtrace", dispatches=0.0),
                       {"op": "allreduce"},
                       dict(_sample(4096), measured_median_us=0.0)]}))
    corpus = _both_corpora([tmp_path], tmp_path / "no_baselines")
    by_op = {s["op"]: s for s in corpus["samples"] if s.get("source") != "devtrace"}
    assert set(by_op) == {"allreduce", "ag_matmul"} and len(corpus["samples"]) == 4
    by_file = {s["file"].rsplit("/", 1)[-1]: s for s in corpus["samples"]}
    ar = by_file["a.json"]
    assert ar["wire_bytes"] == int(2 * 7 / 8 * 512 * 2)
    assert ar["measured_median_us"] == pytest.approx(1100.0)
    assert ar["tier"] == "cpu-sim" and ar["dispatches"] == 1.0
    ag = by_file["b.json"]
    assert ag["flops"] == 2 * 2 * 64 * 256 * 256
    assert ag["wire_bytes"] == 7 * 2 * 64 * 256 * 2
    chained = [s for s in corpus["samples"] if s["dispatches"] not in (0.0, 1.0)]
    assert chained and chained[0]["dispatches"] == pytest.approx(0.1)
    reasons = [s["reason"] for s in corpus["skipped"]]
    assert any("no operation/timings" in r for r in reasons)
    assert any(r.startswith("unreadable") for r in reasons)
    assert "malformed devtrace op sample" in reasons
    assert "non-finite measured_median_us" in reasons
    assert corpus["manifests"][0]["wall_seconds"] == 2.0
    # a card's artifact is the cuda tier in the port (JAX's TPU tier there)
    assert pcorpus.tier_of_result(_artifact(backend="cuda")) == "cuda"
    for mod in (pcorpus, jcorpus):
        with pytest.raises(FileNotFoundError):
            mod.build_corpus([tmp_path / "missing"])


def test_calibration_reports_wait_for_item_15(tmp_path):
    """A ``dlbb_calibration_v1`` report is skipped, never turned into rows:
    with JAX's reason where the baselines directory is missing, and with
    the reason that names the calibration (item 14, part 14b) where one
    exists: the schedule baselines are ported (item 15), the join waits
    for the calibration that writes such reports."""
    (tmp_path / "r").mkdir()
    (tmp_path / "r" / "calibration_report.json").write_text(json.dumps({
        "schema": "dlbb_calibration_v1", "tier": "cpu-sim",
        "targets": [{"target": "t", "measured_us": 10.0}]}))
    missing = _both_corpora([tmp_path / "r"], tmp_path / "none")
    assert missing["samples"] == [] and "no schedule baselines under" in \
        missing["skipped"][0]["reason"]
    (tmp_path / "baselines").mkdir()
    port = pcorpus.build_corpus([tmp_path / "r"], baselines_dir=tmp_path / "baselines")
    (skip,) = port["skipped"]
    assert port["samples"] == [] and "ROADMAP Queue 1, Slice F, item 14" in skip["reason"]


def test_run_fit_end_to_end(tmp_path):
    results = tmp_path / "results"
    results.mkdir()
    i = 0
    for elems in (512, 8192, 65536, 524288, 1048576, 4194304):
        for ranks in (4, 8):
            for variant in ("default", "overlap_ring"):
                op = "ag_matmul" if variant == "overlap_ring" else "allreduce"
                art = _artifact(op=op, ranks=ranks, elems=elems, variant=variant)
                if op == "ag_matmul":
                    art["tensor_shape"] = [1, 32, 64]
                meas = 300.0 + elems / 2000.0
                art["timings"] = [[meas * 1e-6] * 5]
                (results / f"r{i}.json").write_text(json.dumps(art))
                i += 1
    out = pfit.run_fit([results], fit_dir=tmp_path / "db", min_samples=8, verbose=False)
    ref = jfit.run_fit([results], fit_dir=tmp_path / "jdb", min_samples=8, verbose=False)
    assert "cpu-sim" in out["fits"]
    assert pcm.fit_db_path("cpu-sim", tmp_path / "db").exists()
    strip = lambda r: {t: {k: v for k, v in f.items() if k != "path"}  # noqa: E731
                       for t, f in r["fits"].items()}
    _close(strip(out), strip(ref))
    # an explicitly requested unfittable tier fails closed, as in JAX
    for tier in ("tpu-v5lite", "cuda"):
        with pytest.raises(pfit.FitError):
            pfit.run_fit([results], tiers=[tier], fit_dir=tmp_path / "db2", min_samples=8,
                         verbose=False)
    assert not (tmp_path / "db2").exists()


def test_fit_corpus_parity_on_the_committed_corpus(tmp_path):
    """The repo's ``results/fit_corpus/`` through both walks and both fits,
    the baselines pointed at a directory that does not exist: the samples,
    skips and manifest summaries equal, the fitted coefficients equal."""
    root = "results/fit_corpus"
    none = tmp_path / "no_baselines"
    corpus = _both_corpora([root], none)
    assert len(corpus["samples"]) >= 100 and len(corpus["manifests"]) >= 1
    assert [s["reason"] for s in corpus["skipped"]] == [
        f"no schedule baselines under {none} to join features from"]
    port = pfit.run_fit([root], fit_dir=tmp_path / "p", baselines_dir=none, verbose=False)
    ref = jfit.run_fit([root], fit_dir=tmp_path / "j", baselines_dir=none, verbose=False)
    assert sorted(port["fits"]) == sorted(ref["fits"]) == ["cpu-sim"]
    assert port["skipped_tiers"] == ref["skipped_tiers"]
    for tier, fit in port["fits"].items():
        _close({k: v for k, v in fit.items() if k != "path"},
               {k: v for k, v in ref["fits"][tier].items() if k != "path"})


# ---------------------------------------------------------------------------
# the port's own sweep, fitted; cli obs fit
# ---------------------------------------------------------------------------


def test_gloo_sweep_fits_cpu_sim_and_cm2_loads(tmp_path):
    """A 4-rank gloo sweep at worlds 2 and 4 and three sizes fits the
    ``cpu-sim`` tier through ``cli obs fit``; the DB it appends loads as
    cm2; an explicit tier the corpus lacks exits 1, as in JAX."""
    sweep = runner.Sweep1D(operations=("allreduce", "allgather", "broadcast", "reduce"),
                           data_sizes=(("1KB", 256), ("64KB", 16384), ("1MB", 262144)),
                           rank_counts=(2, 4), dtype="float32", warmup_iterations=2,
                           measurement_iterations=10, output_dir=str(tmp_path / "res"),
                           compile_cache="off")
    launch(cli.sweep_worker, 4, "cpu", args=(sweep, "cpu"), timeout=240)
    db = tmp_path / "db"
    argv = ["obs", "fit", "--results", str(tmp_path / "res"), "--tier", "cpu-sim",
            "--fit-dir", str(db)]
    assert cli.main(argv) == 0
    assert cli.main(argv) == 0
    doc = json.loads(pcm.fit_db_path("cpu-sim", db).read_text())
    assert doc["schema"] == pcm.FIT_SCHEMA and [v["fit_version"] for v in doc["versions"]] \
        == [1, 2]
    fit = doc["versions"][-1]
    assert fit["samples_total"] == 24 and fit["distinct_wire_sizes"] >= 2
    assert fit["hosts"] and fit["corpus"]["manifests"] == 1
    tier = pcm.resolve_tier("cpu-sim", model="cm2", fit_dir=db)
    assert tier.version == "cm2" and tier.fit["fit_version"] == 2
    assert all(math.isfinite(v) and v >= 0 for v in (
        tier.alpha_us, tier.beta_bytes_per_us, tier.peak_flops_per_us,
        tier.gamma_dispatch_us))
    assert cli.main(["obs", "fit", "--results", str(tmp_path / "res"), "--tier", "cuda",
                     "--fit-dir", str(tmp_path / "db_cuda")]) == 1
    assert not (tmp_path / "db_cuda").exists()
