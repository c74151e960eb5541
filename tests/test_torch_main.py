"""``python -m dlbb_tpu_torch`` (ROADMAP Queue 1, item 22): the package
runs as its CLI, as ``python -m dlbb_tpu`` runs JAX's, and lists JAX's
subcommands less ``analyze`` (item 15)."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest

from dlbb_tpu import cli as jax_cli
from dlbb_tpu_torch import cli

REPO = Path(__file__).resolve().parents[1]


def _subcommands(parser):
    action = next(a for a in parser._actions if a.dest == "cmd")
    return set(action.choices)


def test_subcommands_are_jax_less_analyze():
    assert _subcommands(cli.build_parser()) \
        == _subcommands(jax_cli.build_parser()) - {"analyze"}


@pytest.mark.parametrize("args", [["--help"], ["plan", "--help"]])
def test_python_dash_m_runs_the_cli(args):
    run = subprocess.run([sys.executable, "-m", "dlbb_tpu_torch", *args], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.startswith("usage: dlbb_tpu_torch")
    if args == ["--help"]:
        listed = run.stdout.split("{", 1)[1].split("}", 1)[0].split(",")
        assert set(listed) == _subcommands(cli.build_parser())
        assert len(listed) == 12
    else:
        for flag in ("--auto", "--capacity", "--simulate", "--tier", "--fit-dir"):
            assert flag in run.stdout


def test_python_dash_m_without_arguments_exits_2():
    run = subprocess.run([sys.executable, "-m", "dlbb_tpu_torch"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 2 and "required" in run.stderr
