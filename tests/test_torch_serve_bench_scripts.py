"""The port's serving bench scripts (``scripts/torch_bench_serving.py``,
``torch_bench_speculative.py``, ``torch_bench_prefix.py``) end to end on CPU
ranks with JAX's small models (``--device cpu``, ``--reps 1``, a few
requests): each writes its ``BENCH_*.json`` (JAX's schema and keys, the
gates passed, the acceptance bars recorded) and its table (the port's
writer), and a gate that fails exits 1 with nothing written.

``torch_bench_prefix.py`` and the int8 witness behind its gate
(``scripts/torch_int8_witness.py``) run as processes, as a user runs them
(their 4 gloo ranks spawned from the script); the other two run their ``main`` on JAX's
meshes (8 gloo ranks) with their traces' outputs cut to a few tokens, which
keeps them to seconds (the schedules do not change: the same settings, the
same gates).
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"


@pytest.fixture
def script(monkeypatch):
    """Import ``scripts/<name>.py`` as a module (its helper importable, as
    in the spawned ranks)."""
    monkeypatch.syspath_prepend(str(SCRIPTS))

    def load(name):
        spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    return load


def _short(generate, **cut):
    def traces(*args, **kw):
        return generate(*args, **{**kw, **cut})
    return traces


def _outputs(tmp_path, bench):
    return ["--device", "cpu", "--reps", "1", "--output", str(tmp_path / bench),
            "--stats", str(tmp_path / "stats")]


def test_bench_serving_end_to_end(tmp_path, script, monkeypatch):
    from dlbb_tpu.stats.serving_report import write_fastpath_report as jax_writer

    mod = script("torch_bench_serving")
    import dlbb_tpu_torch.serve.traffic as traffic

    monkeypatch.setattr(traffic, "generate_trace",
                        _short(traffic.generate_trace, output_range=(6, 12)))
    assert mod.main(["--requests", "2"] + _outputs(tmp_path, "BENCH_serve.json")) == 0
    bench = json.loads((tmp_path / "BENCH_serve.json").read_text())
    assert bench["schema"] == "dlbb_bench_serve_v1" and bench["equivalence"]["identical"]
    assert set(bench["settings"]) == set(mod.SETTINGS)
    assert bench["settings"]["tp4_per_step"]["mesh"] == "tp4"
    assert bench["settings"]["per_step"]["mesh"] == "dp8"
    for name, s in bench["settings"].items():
        assert s["output_tokens_per_s"]["median"] > 0 and "speedup_vs_per_step" in s, name
    assert set(bench["acceptance"]) >= {"measured_speedup", "passed", "min_speedup"}
    assert bench["chip"]["status"] == "not measured"
    rows = jax_writer(tmp_path / "BENCH_serve.json", tmp_path / "jax")
    assert len(rows) == 7 and (tmp_path / "stats" / "FASTPATH.md").is_file()


def test_bench_speculative_end_to_end(tmp_path, script, monkeypatch):
    mod = script("torch_bench_speculative")
    import dlbb_tpu_torch.serve.traffic as traffic

    monkeypatch.setattr(traffic, "generate_trace",
                        _short(traffic.generate_trace, output_range=(12, 16)))
    assert mod.main(["--requests", "2"] + _outputs(tmp_path, "BENCH_spec.json")) == 0
    bench = json.loads((tmp_path / "BENCH_spec.json").read_text())
    assert bench["schema"] == "dlbb_bench_spec_v1" and bench["mesh"] == {"dp": 2, "tp": 4}
    assert set(bench["settings"]) == set(mod.SETTINGS)
    assert all(bench["equivalence"]["identical"].values())
    assert len(bench["equivalence"]["identical"]) == 10
    acc = bench["acceptance"]
    assert acc["setting"] == "ngram_g16_fused16" and isinstance(acc["passed"], bool)
    assert bench["settings"]["ngram_g4_fused16"]["verify_units"] > 0
    assert (tmp_path / "stats" / "SPECULATIVE.md").is_file()


def test_bench_prefix_runs_as_a_script(tmp_path):
    out = subprocess.run(
        [sys.executable, str(SCRIPTS / "torch_bench_prefix.py"), "--requests", "4"]
        + _outputs(tmp_path, "BENCH_prefix.json"),
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-4000:]
    bench = json.loads((tmp_path / "BENCH_prefix.json").read_text())
    assert bench["schema"] == "dlbb_bench_prefix_v1" and bench["mesh"] == {"dp": 1, "tp": 4}
    assert all(v["passed"] for v in bench["equivalence"]["identical"].values())
    # JAX's capacity budget for JAX's model
    assert bench["capacity"]["hbm_budget_gb"] == 0.001
    assert bench["capacity"]["resident_requests"]["none"] > 0
    assert bench["settings"]["share60/on_none"]["prefix_hits"] > 0
    assert set(bench["acceptance"]) == {"ttft", "capacity"}
    assert (tmp_path / "stats" / "PREFIX.md").is_file()
    assert "[acceptance] int8 capacity" in out.stdout


def test_int8_witness_runs_as_a_script(tmp_path):
    """The int8 witness on the prefix bench's small model: every request of
    both traces decoded by both engines and both plain references, each
    int8 flip with its position and the fp32 reference's margin there."""
    out = subprocess.run(
        [sys.executable, str(SCRIPTS / "torch_int8_witness.py"), "--requests", "2",
         "--device", "cpu", "--output", str(tmp_path / "witness.json")],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads((tmp_path / "witness.json").read_text())
    assert set(got["traces"]) == {"share80", "share60"}
    for rec in got["traces"].values():
        same = rec["identical_to_fp_engine"]
        assert rec["requests"] == 2 and all(0 <= v <= 2 for v in same.values())
        assert same["int8_engine"] == 2 - len(rec["int8_flips"])
        for f in rec["int8_flips"]:
            assert 0 <= f["position"] < f["of"] and f["fp32_gap"] >= 0
    assert got["median_fp32_gap_all_positions"] > 0


@pytest.mark.parametrize("name,bench", [
    ("torch_bench_serving", "BENCH_serve.json"),
    ("torch_bench_speculative", "BENCH_spec.json"),
    ("torch_bench_prefix", "BENCH_prefix.json"),
])
def test_a_failed_gate_exits_1_and_writes_nothing(tmp_path, script, monkeypatch, capsys,
                                                  name, bench):
    """Each script's gate on captured tokens where one setting's tokens
    differ from its oracle's: exit code 1, no bench file, no table."""
    mod = script(name)

    def served(model, seed, meshes, runs, traces, reps, dev):
        captures = {r["name"]: {0: [1, 2, 3], 1: [4, 5]} for r in runs if r["capture"]}
        last = [r["name"] for r in runs if r["capture"]][-1]
        captures[last] = {0: [1, 2, 3], 1: [4, 6]}
        return {"captures": captures, "timed": {}}

    monkeypatch.setattr(mod, "serve_settings", served)
    assert mod.main(_outputs(tmp_path, bench)) == 1
    assert "equivalence gate FAILED" in capsys.readouterr().err
    assert not (tmp_path / bench).exists() and not (tmp_path / "stats").exists()
