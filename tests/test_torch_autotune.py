"""The port's plan autotuner and capacity planner (ROADMAP Queue 1, Slice F,
item 14, part 14b: ``dlbb_tpu_torch/plan/autotune.py``, ``cli plan
--auto|--capacity``, ``stats/parallelism_report.py::write_autotune_report``),
the mirror of JAX's ``tests/test_autotune.py``, held against JAX's
``dlbb_tpu/plan/autotune.py`` on the same inputs: ``DEFAULT_PLAN_MODEL`` at
8 and 4 devices, priced by JAX's committed ``cm2_cpu-sim.json`` (read as
data by both) give the same ordered keys, the same prune reason and detail
per key, the same predictions (1e-9 relative), the same ranking and
heuristic plan, and the same calibration agreement on JAX's committed
baseline.  The measured search runs the port's serving engine on 2 gloo
ranks.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import pytest

from dlbb_tpu.analysis.costmodel import load_fitted_tier as jax_fitted_tier
from dlbb_tpu.models.configs import ModelConfig as JaxModelConfig
from dlbb_tpu.plan import autotune as jat
from dlbb_tpu.stats import parallelism_report as jreport
from dlbb_tpu.stats import serving_report as jserving
from dlbb_tpu_torch import cli
from dlbb_tpu_torch.analysis.costmodel import CostTier, load_fitted_tier
from dlbb_tpu_torch.models.configs import ModelConfig
from dlbb_tpu_torch.plan import autotune as pat
from dlbb_tpu_torch.plan.autotune import (
    CAL_FAMILIES,
    DEFAULT_PLAN_INPUT,
    DEFAULT_PLAN_MODEL,
    DEFAULT_PLAN_SERVING,
    PRUNE_FIT,
    PRUNE_HBM,
    PRUNE_REASONS,
    PRUNE_VALIDATION,
    PlanPoint,
    calibration_agreement,
    enumerate_serving_space,
    enumerate_train_space,
    heuristic_point,
    predict_point_us,
    prune_point,
    rank_points,
    run_capacity_plan,
    run_plan_search,
)
from dlbb_tpu_torch.resilience.journal import read_journal
from dlbb_tpu_torch.stats.parallelism_report import write_autotune_report
from dlbb_tpu_torch.stats.serving_report import publish_capacity_curve

REPO = Path(__file__).resolve().parents[1]
# JAX's committed fit and calibration baseline, read as data files
FIT_DIR = REPO / "stats" / "analysis" / "costmodel_fit"
CAL_BASELINE = REPO / "stats" / "analysis" / "calibration" / "calibration_baseline_cm2.json"
REL = 1e-9

MODEL = ModelConfig.from_dict(DEFAULT_PLAN_MODEL)
JAX_MODEL = JaxModelConfig.from_dict(jat.DEFAULT_PLAN_MODEL)


@pytest.fixture(scope="module")
def tier():
    return load_fitted_tier("cpu-sim", FIT_DIR)


@pytest.fixture(scope="module")
def jax_tier():
    return jax_fitted_tier("cpu-sim", FIT_DIR)


def _space(mod, model, n, target):
    if target == "serving":
        return mod.enumerate_serving_space(model, n, mod.DEFAULT_PLAN_SERVING)
    return mod.enumerate_train_space(model, n)


def _jax_point(p):
    return jat.PlanPoint(**{k: v for k, v in p.to_dict().items() if k != "key"})


# ---------------------------------------------------------------------------
# parity with JAX: enumeration, pruning, prediction, ranking
# ---------------------------------------------------------------------------


def test_defaults_are_jax():
    assert DEFAULT_PLAN_MODEL == jat.DEFAULT_PLAN_MODEL
    assert DEFAULT_PLAN_SERVING == jat.DEFAULT_PLAN_SERVING
    assert DEFAULT_PLAN_INPUT == jat.DEFAULT_PLAN_INPUT
    assert CAL_FAMILIES == jat.CAL_FAMILIES
    assert PRUNE_REASONS == jat.PRUNE_REASONS
    assert (pat.AUTOTUNE_SCHEMA, pat.BENCH_SCHEMA, pat.CAPACITY_SCHEMA) \
        == (jat.AUTOTUNE_SCHEMA, jat.BENCH_SCHEMA, jat.CAPACITY_SCHEMA)
    assert pat.DEFAULT_CAL_BASELINE.as_posix() \
        == "stats/torch/analysis/calibration/calibration_baseline_cm2.json"


def test_fitted_tier_is_jax(tier, jax_tier):
    for f in ("name", "alpha_us", "beta_bytes_per_us", "peak_flops_per_us",
              "gamma_dispatch_us", "hbm_bytes", "version"):
        assert getattr(tier, f) == getattr(jax_tier, f), f


@pytest.mark.parametrize("n", [8, 4])
@pytest.mark.parametrize("target", ["serving", "train"])
def test_enumeration_equals_jax(n, target):
    pts = _space(pat, MODEL, n, target)
    ref = _space(jat, JAX_MODEL, n, target)
    assert [p.key() for p in pts] == [p.key() for p in ref]
    assert [p.to_dict() for p in pts] == [p.to_dict() for p in ref]
    assert [p.complexity() for p in pts] == [p.complexity() for p in ref]


@pytest.mark.parametrize("n", [8, 4])
@pytest.mark.parametrize("target", ["serving", "train"])
def test_pruning_equals_jax(n, target, tier, jax_tier):
    pts = _space(pat, MODEL, n, target)
    ref = _space(jat, JAX_MODEL, n, target)
    got = [prune_point(p, MODEL, tier, n) for p in pts]
    want = [jat.prune_point(p, JAX_MODEL, jax_tier, n) for p in ref]
    assert got == want
    assert {r[0] for r in got if r} <= set(PRUNE_REASONS)
    assert any(r is None for r in got) and any(r is not None for r in got)


@pytest.mark.parametrize("n", [8, 4])
@pytest.mark.parametrize("target", ["serving", "train"])
def test_prediction_and_ranking_equal_jax(n, target, tier, jax_tier):
    pts = [p for p in _space(pat, MODEL, n, target)
           if prune_point(p, MODEL, tier, n) is None]
    scored = [(p, predict_point_us(p, MODEL, tier)) for p in pts]
    ref = [(jp, jat.predict_point_us(jp, JAX_MODEL, jax_tier))
           for jp in map(_jax_point, pts)]
    for (p, got), (_, want) in zip(scored, ref):
        assert got.keys() == want.keys()
        for k in got:
            assert math.isclose(got[k], want[k], rel_tol=REL, abs_tol=1e-12), (p.key(), k)
    assert [p.key() for p, _ in rank_points(scored)] \
        == [p.key() for p, _ in jat.rank_points(ref)]
    assert heuristic_point(target, n, MODEL).key() \
        == jat.heuristic_point(target, n, JAX_MODEL).key()


@pytest.mark.parametrize("prompt_len", [8, 33, 256])
def test_ttft_and_capacity_prices_equal_jax(tier, jax_tier, prompt_len):
    for p in enumerate_serving_space(MODEL, 8, DEFAULT_PLAN_SERVING)[::7]:
        got = pat.predict_ttft_us(p, MODEL, DEFAULT_PLAN_SERVING, tier, prompt_len)
        want = jat.predict_ttft_us(_jax_point(p), JAX_MODEL, DEFAULT_PLAN_SERVING,
                                   jax_tier, prompt_len)
        assert math.isclose(got, want, rel_tol=REL)


# ---------------------------------------------------------------------------
# JAX's contract tests, on the port
# ---------------------------------------------------------------------------


def test_serving_space_is_the_full_grid():
    pts = enumerate_serving_space(MODEL, 8, DEFAULT_PLAN_SERVING)
    assert len(pts) == 4 * 5 * 2 * 2 * 2
    keys = [p.key() for p in pts]
    assert len(set(keys)) == len(keys)
    assert all(p.dp * p.tp == 8 for p in pts)


def test_train_space_covers_variant_axis():
    pts = enumerate_train_space(MODEL, 8)
    assert all(p.dp * p.sp * p.pp * p.tp == 8 for p in pts)
    assert {p.attention for p in pts if p.sp > 1} == {"ring", "ulysses"}
    assert {p.attention for p in pts if p.sp == 1} == {None}


def test_validation_reject_quotes_the_contract(tier):
    reason, detail = prune_point(PlanPoint(target="serving", dp=4, tp=4), MODEL, tier, 8,
                                 serving=DEFAULT_PLAN_SERVING)
    assert reason == PRUNE_VALIDATION and "16" in detail and "8" in detail
    reason, detail = prune_point(PlanPoint(target="serving", dp=1, tp=8), MODEL, tier, 8,
                                 serving=DEFAULT_PLAN_SERVING)
    assert reason == PRUNE_VALIDATION and detail


def test_infeasible_hbm_prunes_with_headroom_detail(tier):
    tiny = CostTier(name="cpu-sim-tiny", alpha_us=tier.alpha_us,
                    beta_bytes_per_us=tier.beta_bytes_per_us,
                    peak_flops_per_us=tier.peak_flops_per_us,
                    gamma_dispatch_us=tier.gamma_dispatch_us, hbm_bytes=1.0,
                    version=tier.version, fit=tier.fit)
    ok = PlanPoint(target="serving", dp=2, tp=4)
    reason, detail = prune_point(ok, MODEL, tiny, 8, serving=DEFAULT_PLAN_SERVING)
    assert reason == PRUNE_HBM and "peak" in detail and "headroom" in detail
    unknown = CostTier(name="cpu-sim-nohbm", alpha_us=1, beta_bytes_per_us=1,
                       peak_flops_per_us=1, hbm_bytes=0.0)
    assert prune_point(ok, MODEL, unknown, 8, serving=DEFAULT_PLAN_SERVING) is None


def test_train_prune_divisibility(tier):
    res = prune_point(PlanPoint(target="train", dp=8), MODEL, tier, 8,
                      input_cfg={**DEFAULT_PLAN_INPUT, "batch_size": 6})
    assert res is not None and res[0] == PRUNE_VALIDATION and "divisible" in res[1]


def test_tie_break_prefers_simpler_then_lexical():
    plain = PlanPoint(target="serving", dp=8, tp=1)
    knobby = PlanPoint(target="serving", dp=8, tp=1, decode_horizon=16, inflight_window=2)
    cost = {"cost_us": 100.0}
    assert rank_points([(knobby, cost), (plain, cost)])[0][0] is plain
    a = PlanPoint(target="serving", dp=2, tp=4)
    b = PlanPoint(target="serving", dp=4, tp=2)
    assert [p.key() for p, _ in rank_points([(b, cost), (a, cost)])] == [a.key(), b.key()]


def test_fused_horizon_shrinks_predicted_dispatch(tier):
    slow = predict_point_us(PlanPoint(target="serving", dp=2, tp=4), MODEL, tier,
                            serving=DEFAULT_PLAN_SERVING)
    fast = predict_point_us(PlanPoint(target="serving", dp=2, tp=4, decode_horizon=16,
                                      inflight_window=2), MODEL, tier,
                            serving=DEFAULT_PLAN_SERVING)
    assert fast["dispatch_us"] < slow["dispatch_us"] and fast["cost_us"] < slow["cost_us"]


# ---------------------------------------------------------------------------
# the calibration agreement
# ---------------------------------------------------------------------------


def test_calibration_grid_agreement_equals_jax():
    """JAX's committed baseline: the same record, and JAX's >= 0.70 gate."""
    cal = calibration_agreement(CAL_BASELINE)
    assert cal == jat.calibration_agreement(CAL_BASELINE)
    assert cal.get("error") is None
    assert cal["total"] == len(CAL_FAMILIES)
    assert all(f["status"] == "ok" for f in cal["families"])
    assert cal["ratio"] >= 0.70


def test_port_baseline_absent_is_reported(tmp_path, monkeypatch):
    """The port's calibration baseline waits for item 14's calibration: the
    default path yields JAX's "not found" record, visibly."""
    monkeypatch.chdir(tmp_path)
    cal = calibration_agreement()
    assert cal == {"ratio": None, "families": [],
                   "error": f"calibration baseline not found: {pat.DEFAULT_CAL_BASELINE}"}


def test_agreement_reports_missing_targets_visibly(tmp_path):
    baseline = tmp_path / "cal.json"
    baseline.write_text(json.dumps({"targets": [
        {"target": "a", "predicted_us": 1.0, "measured_us": 1.0},
        {"target": "b", "predicted_us": 2.0, "measured_us": 0.5},
    ]}))
    fams = {"present": [("a", 1), ("b", 1)], "absent": [("a", 1), ("ghost", 1)]}
    cal = calibration_agreement(baseline, families=fams)
    assert cal == jat.calibration_agreement(baseline, families=fams)
    assert cal["total"] == 1 and cal["ratio"] == 1.0
    assert {f["family"]: f["status"] for f in cal["families"]} \
        == {"present": "ok", "absent": "missing-target"}


# ---------------------------------------------------------------------------
# the search driver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("target", ["serving", "train"])
def test_missing_fit_fails_closed_and_journals_every_point(tmp_path, target):
    out = tmp_path / "search"
    res = run_plan_search(target=target, n_devices=8, measure=False, verbose=False,
                          output_dir=out, fit_dir=tmp_path / "no_fit_here",
                          cal_baseline=CAL_BASELINE)
    assert res["error"].startswith(PRUNE_FIT)
    assert res["ranked"] == [] and res["measured"] == []
    manifest = json.loads((out / "sweep_manifest.json").read_text())
    assert manifest["pruned"][PRUNE_FIT] == manifest["searched"] \
        == len(_space(pat, MODEL, 8, target))
    events, bad = read_journal(out)
    assert bad == 0
    pruned = [e for e in events if e.get("event") == "plan-pruned"]
    assert len(pruned) == manifest["searched"]
    assert all(e["reason"] == PRUNE_FIT for e in pruned)
    prom = (out / "metrics.prom").read_text()
    assert (f'dlbb_plan_search_points_total{{outcome="pruned-{PRUNE_FIT}"}} '
            f'{manifest["searched"]}') in prom


@pytest.mark.parametrize("target", ["serving", "train"])
def test_static_search_accounts_for_every_point_as_jax(tmp_path, target, devices):
    """searched == pruned + ranked, journal, manifest and metrics agree, a
    re-run ranks identically, and JAX's static search on the same fit and
    baseline gives the same report but for the tier's DB path."""
    kw = dict(target=target, n_devices=8, measure=False, verbose=False, fit_dir=FIT_DIR,
              cal_baseline=CAL_BASELINE)
    out = tmp_path / "auto"
    res = run_plan_search(output_dir=out, **kw)
    n_pruned = sum(res["pruned"].values())
    assert res["searched"] == n_pruned + len(res["ranked"]) and res["ranked"]
    assert set(res["pruned"]) == set(PRUNE_REASONS)
    assert len(res["pruned_points"]) == n_pruned
    events, bad = read_journal(out)
    assert bad == 0
    assert len([e for e in events if e.get("event") == "plan-pruned"]) == n_pruned
    assert len([e for e in events if e.get("event") == "plan-ranked"]) == len(res["ranked"])
    manifest = json.loads((out / "sweep_manifest.json").read_text())
    assert manifest["searched"] == res["searched"] and manifest["pruned"] == res["pruned"]
    prom = (out / "metrics.prom").read_text()
    assert f'dlbb_plan_search_points_total{{outcome="searched"}} {res["searched"]}' in prom
    assert 'dlbb_plan_agreement_ratio{scope="calibration-grid"}' in prom
    again = run_plan_search(output_dir=tmp_path / "auto2", **kw)
    assert [r["plan"] for r in again["ranked"]] == [r["plan"] for r in res["ranked"]]
    ref = jat.run_plan_search(output_dir=tmp_path / "jax", **kw)
    for key in ("searched", "pruned", "pruned_points", "ranked", "measured", "winner",
                "default_plan", "calibration_agreement", "model", "serving", "input"):
        assert res[key] == ref[key], key
    if target == "train":
        assert heuristic_point("train", 8, MODEL).key() == "train[dp8,tp1,sp1,pp1]"


def test_measured_search_smoke(tmp_path):
    """Top-1 + the default heuristic measured through the port's serving
    engine on 2 gloo ranks on one shared seeded trace (JAX's structural
    checks); the bench artifact's chip block says the card has no fit."""
    out = tmp_path / "auto"
    bench = tmp_path / "BENCH_autotune.json"
    res = run_plan_search(
        target="serving", n_devices=2, top_k=1, mesh_champions=False, num_requests=4,
        seed=11, rate=500.0, trace_params={"prompt_range": (8, 16), "output_range": (16, 24)},
        output_dir=out, fit_dir=FIT_DIR, cal_baseline=CAL_BASELINE, device="cpu",
        verbose=False, bench_out=bench)
    assert {r["role"] for r in res["measured"]} == {"top-k", "default-heuristic"}
    assert res["winner"] in {r["plan"] for r in res["measured"]}
    assert res["speedup_vs_default"] is not None
    for row in res["agreement"]["rows"]:
        assert row["predicted_rank"] >= 1 and row["measured_rank"] >= 1
        assert row["goodput_tokens_per_s"] > 0 and row["completed"] == row["total"] == 4
    manifest = json.loads((out / "sweep_manifest.json").read_text())
    assert manifest["measured"] == len(res["measured"])
    events, _ = read_journal(out)
    assert len([e for e in events if e.get("event") == "plan-measured"]) \
        == len(res["measured"])
    assert 'dlbb_plan_agreement_ratio{scope="measured-topk"}' \
        in (out / "metrics.prom").read_text()
    for r in res["measured"]:  # each plan's own serving artifacts
        slug = r["plan"].replace("[", "_").replace("]", "").replace(",", "_")
        assert list((out / "measure" / slug).glob("serving_*.json"))
    payload = json.loads(bench.read_text())
    assert payload["schema"] == "dlbb_bench_autotune_v1" and payload["backend"] == "cpu"
    assert payload["chip"]["status"] == "no-cuda-fit"
    assert "world 1" in payload["chip"]["note"]
    assert payload["measured"] == res["measured"]


def test_capacity_plan_fails_closed_after_journaling_every_point(tmp_path):
    """No fit: the default candidates' static search journals every point
    cm2-fit-missing under ``static_search``, then the planner raises."""
    from dlbb_tpu_torch.analysis.costmodel import FitMissingError

    out = tmp_path / "cap"
    with pytest.raises(FitMissingError):
        run_capacity_plan(n_devices=4, output_dir=out, fit_dir=tmp_path / "no_fit",
                          verbose=False, stats_dir=tmp_path / "stats")
    manifest = json.loads((out / "static_search" / "sweep_manifest.json").read_text())
    assert manifest["pruned"][PRUNE_FIT] == manifest["searched"] == 3 * 5 * 2 * 2 * 2
    events, _ = read_journal(out / "static_search")
    assert len([e for e in events if e.get("reason") == PRUNE_FIT]) == manifest["searched"]
    assert not (tmp_path / "stats").exists() and not (out / "capacity_report.json").exists()


def test_cli_plan_exit_codes(tmp_path, capsys):
    """``--simulate N`` searches N gloo ranks' plan space on the CPU; a
    missing fit exits 1 for both modes, a ranked static search 0."""
    assert cli.main(["plan", "--auto", "--simulate", "4", "--no-measure", "--output",
                     str(tmp_path / "a"), "--fit-dir", str(tmp_path / "no_fit")]) == 1
    assert cli.main(["plan", "--capacity", "--simulate", "4", "--output",
                     str(tmp_path / "c"), "--fit-dir", str(tmp_path / "no_fit")]) == 1
    assert f"plan --capacity: {PRUNE_FIT}" in capsys.readouterr().out
    assert cli.main(["plan", "--auto", "--target", "train", "--simulate", "4",
                     "--no-measure", "--output", str(tmp_path / "t"), "--fit-dir",
                     str(FIT_DIR)]) == 0
    report = json.loads((tmp_path / "t" / "autotune_report.json").read_text())
    assert report["tier"]["name"] == "cpu-sim" and report["devices"] == 4
    assert report["calibration_agreement"]["error"].startswith(
        "calibration baseline not found")


# ---------------------------------------------------------------------------
# the report writers: JAX's text on the same payload
# ---------------------------------------------------------------------------


def _bench_payload():
    return {
        "schema": "dlbb_bench_autotune_v1", "target": "serving",
        "devices": 8, "searched": 10,
        "pruned": {"validation-reject": 4, "infeasible-hbm": 0, "cm2-fit-missing": 0},
        "tier": {"name": "cpu-sim", "fit": {"fit_version": 2}},
        "ranked": [{"plan": "serve[dp8,tp1,K16,W2]"}],
        "default_plan": "serve[dp2,tp4,K1,W1]",
        "speedup_vs_default": 1.4,
        "agreement": {
            "rows": [
                {"plan": "serve[dp4,tp2,K16,W2]", "role": "top-k", "predicted_us": 300.0,
                 "predicted_rank": 1, "measured_rank": 1, "goodput_tokens_per_s": 1600.0,
                 "ttft_p50_s": 0.02},
                {"plan": "serve[dp2,tp4,K1,W1]", "role": "default-heuristic",
                 "predicted_us": 400.0, "predicted_rank": 2, "measured_rank": 2,
                 "goodput_tokens_per_s": 900.0, "ttft_p50_s": 0.03},
            ],
            "measured_winner": "serve[dp4,tp2,K16,W2]",
            "predicted_winner": "serve[dp4,tp2,K16,W2]",
            "top1_match": True, "top2_contains": True,
        },
        "calibration_agreement": {
            "ratio": 1.0, "agree": 1, "total": 1, "baseline": "b.json",
            "families": [
                {"family": "decode_path", "status": "ok", "predicted_order": ["a::x", "a::y"],
                 "measured_winner": "a::x", "top2_contains_winner": True},
                {"family": "gone", "status": "missing-target", "missing": ["a::z"]},
            ],
        },
    }


# the sentences of AUTOTUNE.md that name the card's rows and the test file
_PORT_PROSE = (
    ("Chip rows stay `pending_tunnel` in the bench artifact.",
     "The card's rows wait for a `cuda` fit (the bench artifact's `chip` block)."),
    ("`tests/test_autotune.py`", "`tests/test_torch_autotune.py`"),
)


def test_write_autotune_report_is_jax_text(tmp_path):
    bench = tmp_path / "BENCH_autotune.json"
    bench.write_text(json.dumps(_bench_payload()))
    rows = write_autotune_report(bench, tmp_path / "port")
    assert rows == jreport.write_autotune_report(bench, tmp_path / "jax") and len(rows) == 2
    md = (tmp_path / "port" / "AUTOTUNE.md").read_text()
    want = (tmp_path / "jax" / "AUTOTUNE.md").read_text()
    for old, new in _PORT_PROSE:
        assert old in want
        want = want.replace(old, new)
    assert md == want
    for key in ("## Search accounting", "## Measured agreement",
                "## Calibration-grid agreement", "serve[dp4,tp2,K16,W2]", "**1.40x**"):
        assert key in md


def test_autotune_report_never_clobbers_on_empty(tmp_path):
    stats = tmp_path / "stats"
    stats.mkdir()
    (stats / "AUTOTUNE.md").write_text("committed")
    payload = _bench_payload()
    payload["agreement"]["rows"] = []
    bench = tmp_path / "BENCH_autotune.json"
    bench.write_text(json.dumps(payload))
    assert write_autotune_report(bench, stats) == []
    assert (stats / "AUTOTUNE.md").read_text() == "committed"
    assert write_autotune_report(tmp_path / "nope.json", stats) == []


def _capacity_report():
    curve = [
        {"users": 4, "demand_tokens_per_s": 160.0, "replicas_predicted": 1,
         "replicas_measured": 1},
        {"users": 64, "demand_tokens_per_s": 2560.0, "replicas_predicted": 2,
         "replicas_measured": None},
    ]
    return {
        "schema": "dlbb_capacity_v1", "devices": 8, "slo_s": 30.0,
        "user_rate_req_per_s": 0.2, "mean_output_tokens": 200.0,
        "trace": {"kind": "poisson", "num_requests": 24, "seed": 42},
        "plans": [
            {"plan": "serve[dp4,tp2,K16,W2]", "slo_attainable": True,
             "predicted_goodput_tokens_per_s": 3000.0,
             "measured_goodput_tokens_per_s": 1600.0, "predicted_ttft_s": 0.004,
             "measured_ttft_p50_s": 0.02, "completed": 24, "total": 24, "curve": curve},
        ],
    }


@pytest.mark.parametrize("existing", [None, "# Serving benchmark report\n\nrows\n"])
def test_publish_capacity_curve_is_jax_text(tmp_path, existing):
    """Publishing writes capacity.json and the SERVING.md section as JAX's
    does; a second publish replaces the section instead of stacking two."""
    paths = {}
    for name, fn in (("port", publish_capacity_curve), ("jax", jserving.publish_capacity_curve)):
        out = tmp_path / name
        if existing is not None:
            out.mkdir()
            (out / "SERVING.md").write_text(existing)
        fn(_capacity_report(), out)
        paths[name] = fn(_capacity_report(), out)
    text = paths["port"].read_text()
    assert text == paths["jax"].read_text()
    assert text.count("## Fleet capacity curve") == 1
    assert "2 / —" in text
    assert json.loads((tmp_path / "port" / "capacity.json").read_text()) == _capacity_report()
