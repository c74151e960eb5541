"""The chaos gate's serve and fleet classes (ROADMAP Queue 1, Slice F,
item 13, part 13c) in JAX's layouts on gloo ranks: serve at dp=2 x tp=4
(its prefix case dp=1 x tp=4), the fleet at 2 replicas of dp=2 x tp=2 (its
prefix case 2 of dp=1 x tp=4).  Each class runs once (a module fixture
records the reports its ranks returned); each is green, and each also
fails, exiting 1 and printing ``FAIL``, when its checks read those same
reports with one invariant broken.
"""

import copy

import pytest

from dlbb_tpu_torch.resilience import chaos


def _recorded(tmp_path_factory, name, hook):
    """``run_chaos(plan=name)`` on the CPU, with what ``hook`` returned (the
    ranks' reports) recorded."""
    out = tmp_path_factory.mktemp(name)
    seen = {}
    real = getattr(chaos, hook)

    def record(*args):
        seen["runs"] = real(*args)
        return seen["runs"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chaos, hook, record)
        rc = chaos.run_chaos(plan=name, output=str(out), device="cpu")
    return rc, out, seen.get("runs")


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    return _recorded(tmp_path_factory, "serve", "_serve_runs_on")


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    return _recorded(tmp_path_factory, "fleet", "_fleet_runs")


def _replay(monkeypatch, hook, runs, name, out, capsys):
    """The class's checks on ``runs`` in place of its ranks' reports."""
    monkeypatch.setattr(chaos, hook, lambda *args: runs)
    rc = chaos.run_chaos(plan=name, output=str(out), device="cpu")
    return rc, capsys.readouterr().out


def test_serve_class_green(serve_run):
    rc, out, runs = serve_run
    assert rc == 0
    assert runs["hang"]["resilience"]["hung_dispatches"] == 1
    assert runs["merged"]["requests"]["sessions"] == 2
    assert (out / "serve_preempt" / "serving_x.json").is_file()


def test_serve_class_fails_on_a_broken_invariant(serve_run, monkeypatch, capsys):
    """A hung dispatch that the serving run waited out (its wall past the
    60 s bound) fails the class."""
    rc, out, runs = serve_run
    broken = copy.deepcopy(runs)
    broken["hang_wall"] = 121.0
    rc, text = _replay(monkeypatch, "_serve_runs_on", broken, "serve", out, capsys)
    assert rc == 1
    assert "[chaos] FAIL serve: serve blocked behind the hung dispatch (121.0s" in text


def test_fleet_class_green(fleet_run):
    rc, out, runs = fleet_run
    assert rc == 0
    kill, _wall = runs["scenarios"]["kill"]
    assert [r["fence_reason"] for r in kill["replicas"]].count("replica-killed") == 1
    assert kill["completed_tokens"] == runs["references"]["kill"]["completed_tokens"]


def test_fleet_class_fails_on_a_broken_invariant(fleet_run, monkeypatch, capsys):
    """A failed-over request whose tokens are not the unfaulted single
    replica's fails the class."""
    rc, out, runs = fleet_run
    broken = copy.deepcopy(runs)
    rep, wall = broken["scenarios"]["kill"]
    rid = rep["failovers"]["requests"][0]["rid"]
    key = rid if rid in rep["completed_tokens"] else str(rid)
    rep["completed_tokens"][key] = [t + 1 for t in rep["completed_tokens"][key]]
    rc, text = _replay(monkeypatch, "_fleet_runs", broken, "fleet", out, capsys)
    assert rc == 1
    assert f"[chaos] FAIL fleet: kill: request {key} tokens diverged" in text
