"""The chaos gate's sweep, checkpoint and CLI classes (ROADMAP Queue 1,
Slice F, item 13, part 13c: ``dlbb_tpu_torch/resilience/chaos.py``,
``cli chaos``), the mirror of JAX's gate tests (``tests/test_resilience.py``'s
chaos tests): each class green on 4 gloo ranks in JAX's layout, the
transient and torn classes held against JAX's ``run_chaos`` on its
simulated mesh (artifact names, journal events, the manifests' ``configs``
and ``resilience``), an unknown class exiting 2, a broken invariant
exiting 1, and the kill class (a SIGKILLed child launch) marked slow as
JAX's is.  The serve and fleet classes are ``tests/test_torch_chaos_
serving.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from dlbb_tpu.resilience.chaos import run_chaos as jax_run_chaos
from dlbb_tpu_torch.resilience import chaos
from dlbb_tpu_torch.resilience.journal import read_journal

REPO = Path(__file__).resolve().parents[1]


def test_unknown_class_exits_2(tmp_path, capsys):
    assert chaos.run_chaos(plan="nope", output=str(tmp_path), device="cpu") == 2
    assert "unknown class(es) ['nope']" in capsys.readouterr().out
    assert jax_run_chaos(plan="nope", output=str(tmp_path / "jax")) == 2


def test_classes_in_jax_order():
    from dlbb_tpu.resilience.chaos import CHAOS_CLASSES

    assert list(chaos.CHAOS_CLASSES) == list(CHAOS_CLASSES) == [
        "compile", "transient", "nan", "torn", "hang", "ckpt", "preempt", "kill", "serve",
        "fleet"]
    assert chaos._GRID_FILES == ["chaos_allreduce_ranks4_1KB_fp32.json",
                                 "chaos_broadcast_ranks4_1KB_fp32.json"]


@pytest.mark.parametrize("name", ["compile", "nan", "hang", "ckpt", "preempt"])
def test_class_green_on_gloo_ranks(tmp_path, name, capsys):
    assert chaos.run_chaos(plan=name, output=str(tmp_path), device="cpu") == 0
    out = capsys.readouterr().out
    assert f"[chaos] {name} ok (" in out and "all 1 fault class(es) green" in out
    if name != "ckpt":
        assert "on 4 cpu rank(s)" in out


def _journal_events(out_dir):
    events, torn = read_journal(out_dir)
    assert torn == 0
    return [(e["event"], e.get("config"), sorted(e)) for e in events]


def _quarantine(rec):
    return {"config": rec["config"], "phase": rec["phase"], "retries": rec["retries"],
            "error": rec["error"].split(":")[0], "chain": [c["type"] for c in rec["chain"]]}


@pytest.mark.parametrize("name", ["transient", "torn"])
def test_class_matches_jax(tmp_path, name):
    """The class green on both packages; the same artifacts, the same
    journal events (event, config, keys) in the same order, and the same
    manifest ``configs`` and ``resilience`` (tracebacks aside)."""
    assert chaos.run_chaos(plan=name, output=str(tmp_path / "port"), verbose=False,
                           device="cpu") == 0
    assert jax_run_chaos(plan=name, output=str(tmp_path / "jax"), verbose=False) == 0
    port, ref = tmp_path / "port" / name, tmp_path / "jax" / name
    names = lambda d: sorted(p.name for p in d.glob("chaos_*.json"))  # noqa: E731
    assert names(port) == names(ref) == chaos._GRID_FILES
    assert _journal_events(port) == _journal_events(ref)
    pm = json.loads((port / "sweep_manifest.json").read_text())
    jm = json.loads((ref / "sweep_manifest.json").read_text())
    assert pm["configs"] == jm["configs"]
    assert pm["cost_model_version"] == jm["cost_model_version"] == "cm1"
    pr, jr = dict(pm["resilience"]), dict(jm["resilience"])
    assert sorted(pr) == sorted(jr)
    assert [_quarantine(q) for q in pr.pop("quarantined")] == \
        [_quarantine(q) for q in jr.pop("quarantined")]
    assert pr == jr


def test_broken_invariant_fails_the_gate(tmp_path, monkeypatch, capsys):
    """A gate that cannot fail proves nothing: with the gate's validator
    accepting a torn file, the torn class finds no torn artifact on disk
    and the gate exits 1 (at world 1, the classes in this process)."""
    monkeypatch.setattr(chaos, "validate_result_json", lambda path: (True, "ok"))
    assert chaos.run_chaos(plan="torn", output=str(tmp_path), device="cpu", world=1) == 1
    out = capsys.readouterr().out
    assert "[chaos] FAIL torn: expected exactly one torn artifact on disk" in out
    assert "1/1 class(es) FAILED" in out


def test_cli_chaos_transient(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "dlbb_tpu_torch.cli", "chaos", "--plan", "transient",
         "--device", "cpu", "--output", str(tmp_path)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[chaos] all 1 fault class(es) green" in proc.stdout
    assert sorted(p.name for p in (tmp_path / "transient").glob("chaos_*.json")) == \
        chaos._GRID_FILES


@pytest.mark.slow
def test_kill_class(tmp_path):
    """The SIGKILL-mid-write class (launched children, JAX's slow test):
    rank 0 killed in the atomic write leaves no destination artifact, and
    resume re-measures to a grid equivalent to an uninterrupted run."""
    assert chaos.run_chaos(plan="kill", output=str(tmp_path), verbose=False,
                           device="cpu") == 0
