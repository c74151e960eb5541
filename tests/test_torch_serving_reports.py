"""The port's serving bench writers and scripts (``stats/serving_report.py``:
``write_fastpath_report``, ``write_speculative_report``,
``write_prefix_report``, ``publish_capacity_curve``; ``cli reports``'
fast-path report; ``scripts/torch_bench_{serving,speculative,prefix}.py``)
against the JAX package's.

Each writer runs on the fixture of its JAX test (``test_serve_fastpath.py::
test_fastpath_report_writer``, ``test_speculative.py::
test_speculative_report_writer``, ``test_autotune.py::
test_publish_capacity_curve_idempotent``) and on a prefix fixture with every
kind of row, and its files are held byte-equal to JAX's writer's on the
same input, but for the script the prose names (``scripts/torch_bench_*``
for ``scripts/bench_*``); a missing or unreadable bench file gives no rows
and writes nothing, as in JAX.  The scripts run end to end on CPU ranks
with JAX's small models (``--device cpu``), and a forced gate failure
exits 1 with nothing written.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from dlbb_tpu.stats import serving_report as jax_report
from dlbb_tpu_torch import cli
from dlbb_tpu_torch.stats import serving_report as pt_report

REPO = Path(__file__).resolve().parents[1]
SCRIPT_NAMES = {"bench_serving": "torch_bench_serving", "bench_speculative":
                "torch_bench_speculative", "bench_prefix": "torch_bench_prefix"}


def _jax_text(path: Path) -> str:
    """JAX's file as the port writes it: its prose names the port's script."""
    text = path.read_text()
    for jax_name, port_name in SCRIPT_NAMES.items():
        text = text.replace(f"scripts/{jax_name}.py", f"scripts/{port_name}.py")
    return text


def _write(path: Path, data) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=2))
    return path


FASTPATH = {
    "schema": "dlbb_bench_serve_v1",
    "baseline": "per_step",
    "settings": {
        "per_step": {"decode_horizon": 1,
                     "output_tokens_per_s": {"median": 100.0, "min": 95.0, "max": 105.0},
                     "per_token_p50_ms": 10.0, "decode_units": 200},
        "fused_k16": {"decode_horizon": 16,
                      "output_tokens_per_s": {"median": 250.0, "min": 240.0, "max": 260.0},
                      "per_token_p50_ms": 4.0, "decode_units": 20},
        # a script's own speedup and baseline win; a skipped setting has none
        "tp4_fused_k16_compact": {"trace": "staggered", "decode_horizon": 16,
                                  "compact_threshold": 0.5, "baseline": "tp4_per_step",
                                  "speedup_vs_per_step": 1.234,
                                  "output_tokens_per_s": {"median": 80.0, "min": 70.5,
                                                          "max": 90.25}},
        "tp4_per_step": {"trace": "staggered", "decode_horizon": 1,
                         "status": "skipped", "output_tokens_per_s": {}},
    },
}

SPECULATIVE = {
    "schema": "dlbb_bench_spec_v1",
    "baseline": "off_fused16",
    "settings": {
        "off_fused16": {"speculation": "off", "decode_horizon": 16,
                        "output_tokens_per_s": {"median": 100.0, "min": 95.0, "max": 105.0},
                        "ttft_p50_ms": 10.0, "per_token_p50_ms": 2.0},
        "ngram_g4_fused16": {"speculation": "ngram", "spec_gamma": 4, "decode_horizon": 16,
                             "output_tokens_per_s": {"median": 150.0, "min": 140.0,
                                                     "max": 160.0},
                             "ttft_p50_ms": 8.0, "per_token_p50_ms": 1.2,
                             "acceptance_rate": 0.7, "mean_accepted_len": 3.8,
                             "draft_overhead_s": 0.01, "token_identical": True},
        "draft_g4_per_step": {"speculation": "draft-model", "spec_gamma": 4,
                              "output_tokens_per_s": {"median": 40.0, "min": 39.0,
                                                      "max": 41.0},
                              "speedup_vs_baseline": 0.4, "token_identical": False,
                              "status": "pending_tunnel"},
    },
}

PREFIX = {
    "schema": "dlbb_bench_prefix_v1",
    "traces": {"share80": {"shared_token_share": 0.8123, "prefix_groups": 2,
                           "prefix_len": 64},
               "share60": {"shared_token_share": 0.6, "prefix_groups": 2,
                           "prefix_len": 48}},
    "settings": {
        "share60/off_none": {"trace": "share60", "prefix_caching": False,
                             "kv_quantization": "none",
                             "output_tokens_per_s": {"median": 50.0, "min": 49.0,
                                                     "max": 52.0},
                             "ttft_p50_ms": 120.0, "per_token_p50_ms": 9.5,
                             "prefix_hit_rate": None, "tokens_reused": 0,
                             "token_identical": None, "token_identity_fraction": None,
                             "baseline": "share60/off_none", "ttft_speedup_vs_baseline": 1.0,
                             "goodput_speedup_vs_baseline": 1.0},
        "share60/on_none": {"trace": "share60", "prefix_caching": True,
                            "kv_quantization": "none",
                            "output_tokens_per_s": {"median": 60.0, "min": 58.0,
                                                    "max": 61.0},
                            "ttft_p50_ms": 80.0, "per_token_p50_ms": 9.0,
                            "prefix_hit_rate": 0.875, "tokens_reused": 672,
                            "token_identical": True, "token_identity_fraction": 1.0,
                            "baseline": "share60/off_none", "ttft_speedup_vs_baseline": 1.5,
                            "goodput_speedup_vs_baseline": 1.2},
        "share60/on_int8": {"trace": "share60", "prefix_caching": True,
                            "kv_quantization": "int8",
                            "output_tokens_per_s": {"median": 30.0, "min": 29.0,
                                                    "max": 33.0},
                            "ttft_p50_ms": 90.0, "per_token_p50_ms": 20.0,
                            "prefix_hit_rate": 0.875, "tokens_reused": 672,
                            "token_identical": False, "token_identity_fraction": 0.8125,
                            "baseline": "share60/off_none",
                            "ttft_speedup_vs_baseline": 1.333,
                            "goodput_speedup_vs_baseline": 0.6, "status": "pending_tunnel"},
    },
    "capacity": {"hbm_budget_gb": 1.0, "max_seq": 160, "block_size": 8, "dp": 1, "tp": 1,
                 "per_request_bytes_per_device": {"none": 31457280, "int8": 16711680},
                 "resident_requests": {"none": 34, "int8": 64}, "capacity_ratio": 1.882,
                 "min_ratio": 1.8, "passed": True},
    "acceptance": {"ttft": {"setting": "share60/on_none", "baseline": "share60/off_none",
                            "min_speedup": 1.3, "measured_speedup": 1.5, "passed": True},
                   "capacity": {"min_ratio": 1.8, "measured_ratio": 1.882, "passed": True}},
}

CAPACITY = {
    "schema": "dlbb_capacity_v1", "devices": 8, "slo_s": 30.0,
    "user_rate_req_per_s": 0.2, "mean_output_tokens": 200.0,
    "trace": {"kind": "poisson", "num_requests": 24, "seed": 42},
    "plans": [
        {"plan": "serve[dp4,tp2,K16,W2]", "slo_attainable": True,
         "predicted_goodput_tokens_per_s": 3000.0,
         "measured_goodput_tokens_per_s": 1600.0,
         "predicted_ttft_s": 0.004, "measured_ttft_p50_s": 0.02,
         "completed": 24, "total": 24,
         "curve": [{"users": 4, "demand_tokens_per_s": 160.0,
                    "replicas_predicted": 1, "replicas_measured": 1},
                   {"users": 64, "demand_tokens_per_s": 2560.0,
                    "replicas_predicted": 2, "replicas_measured": None}]},
    ],
}

WRITERS = {
    "fastpath": ("write_fastpath_report", FASTPATH, "BENCH_serve.json", "FASTPATH.md"),
    "speculative": ("write_speculative_report", SPECULATIVE, "BENCH_spec.json",
                    "SPECULATIVE.md"),
    "prefix": ("write_prefix_report", PREFIX, "BENCH_prefix.json", "PREFIX.md"),
}


@pytest.mark.parametrize("kind", sorted(WRITERS))
def test_bench_report_writer_equals_jax(tmp_path, kind):
    """The rows and the table of JAX's writer on the same bench file; a
    missing or unreadable file (or one with no settings) is no rows and no
    table, as in JAX."""
    name, bench, fname, md = WRITERS[kind]
    path = _write(tmp_path / fname, bench)
    want = getattr(jax_report, name)(path, tmp_path / "jax")
    got = getattr(pt_report, name)(path, tmp_path / "port")
    assert got == want and len(got) == len(bench["settings"])
    assert (tmp_path / "port" / md).read_text() == _jax_text(tmp_path / "jax" / md)
    assert sorted(os.listdir(tmp_path / "port")) == [md]
    (tmp_path / "torn.json").write_text('{"settings": {')
    _write(tmp_path / "empty.json", {"settings": {}})
    for bad in ("missing.json", "torn.json", "empty.json"):
        out = tmp_path / f"none_{bad}"
        assert getattr(pt_report, name)(tmp_path / bad, out) == [] \
            == getattr(jax_report, name)(tmp_path / bad, out)
        assert not out.exists()


def test_fastpath_report_writer(tmp_path):
    """JAX's ``test_fastpath_report_writer`` on the port's writer."""
    bench = {k: v for k, v in FASTPATH.items() if k != "settings"}
    bench["settings"] = {k: FASTPATH["settings"][k] for k in ("per_step", "fused_k16")}
    rows = pt_report.write_fastpath_report(_write(tmp_path / "BENCH_serve.json", bench),
                                           tmp_path / "stats")
    by_name = {r["setting"]: r for r in rows}
    assert len(rows) == 2
    assert by_name["fused_k16"]["speedup_vs_baseline"] == 2.5
    assert by_name["per_step"]["speedup_vs_baseline"] == 1.0
    md = (tmp_path / "stats" / "FASTPATH.md").read_text()
    assert "2.50x" in md and "fused_k16" in md
    assert pt_report.write_fastpath_report(tmp_path / "nope.json", tmp_path / "stats2") == []


def test_speculative_report_writer(tmp_path):
    """JAX's ``test_speculative_report_writer`` on the port's writer."""
    bench = dict(SPECULATIVE, settings={k: SPECULATIVE["settings"][k]
                                        for k in ("off_fused16", "ngram_g4_fused16")})
    rows = pt_report.write_speculative_report(_write(tmp_path / "BENCH_spec.json", bench),
                                              tmp_path / "stats")
    by_name = {r["setting"]: r for r in rows}
    assert len(rows) == 2
    assert by_name["ngram_g4_fused16"]["speedup_vs_baseline"] == 1.5
    assert by_name["ngram_g4_fused16"]["token_identical"] is True
    md = (tmp_path / "stats" / "SPECULATIVE.md").read_text()
    assert "1.50x" in md and "ngram_g4_fused16" in md and "yes" in md
    assert pt_report.write_speculative_report(tmp_path / "nope.json", tmp_path / "stats2") == []


@pytest.mark.parametrize("existing", [False, True])
def test_publish_capacity_curve_idempotent(tmp_path, existing):
    """JAX's ``test_publish_capacity_curve_idempotent`` on the port's
    publisher, with ``capacity.json`` and ``SERVING.md`` byte-equal to
    JAX's after each publish, onto no report and onto an existing one (the
    section replaced, not stacked); ``write_serving_report`` then folds the
    record back in as JAX's does."""
    dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    if existing:
        for d in dirs.values():
            d.mkdir()
            (d / "SERVING.md").write_text("# Serving benchmark report\n\n| a |\n\n\n")
    for _ in range(2):
        jmd = jax_report.publish_capacity_curve(CAPACITY, dirs["jax"])
        pmd = pt_report.publish_capacity_curve(CAPACITY, dirs["port"])
        assert pmd == dirs["port"] / "SERVING.md" and jmd.name == pmd.name
        text = pmd.read_text()
        assert text == jmd.read_text()
        assert text.count("## Fleet capacity curve") == 1
        assert "serve[dp4,tp2,K16,W2]" in text and "2 / —" in text
        assert ((dirs["port"] / "capacity.json").read_bytes()
                == (dirs["jax"] / "capacity.json").read_bytes())


def test_cli_reports_writes_fastpath_from_the_port_results(tmp_path, capsys, monkeypatch):
    """``cli reports`` writes ``FASTPATH.md`` from ``RESULTS/BENCH_serve.json``
    (JAX's reads the root one) and never reads a ``BENCH_serve.json`` in
    the working directory, which holds the JAX package's runs."""
    results, stats = tmp_path / "results" / "torch", tmp_path / "stats"
    _write(results / "BENCH_serve.json", FASTPATH)
    root = dict(FASTPATH, settings={"root_only": FASTPATH["settings"]["per_step"]})
    _write(tmp_path / "BENCH_serve.json", root)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["reports", "--stats", str(stats), "--results", str(results)]) == 0
    printed = capsys.readouterr().out
    assert f"fastpath: 4 setting(s) -> {stats / 'serving' / 'FASTPATH.md'}" in printed
    jax_report.write_fastpath_report(results / "BENCH_serve.json", tmp_path / "jax")
    md = (stats / "serving" / "FASTPATH.md").read_text()
    assert md == _jax_text(tmp_path / "jax" / "FASTPATH.md") and "root_only" not in md
    (results / "BENCH_serve.json").unlink()
    cli.main(["reports", "--stats", str(tmp_path / "s2"), "--results", str(results)])
    assert f"fastpath: no BENCH_serve.json under {results} — skipped" in capsys.readouterr().out
    assert not (tmp_path / "s2" / "serving" / "FASTPATH.md").exists()
