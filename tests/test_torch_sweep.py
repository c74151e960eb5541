"""The port's sweeps (``dlbb_tpu_torch/bench/runner.py`` through ``cli
bench1d``/``bench3d`` and ``bench/launch.py``) and statistics against the
JAX pipeline's.

Tiny gloo sweeps on 4 spawned ranks (2 ops x 2 sizes or shapes, rank
counts 2 and 4) must write, per config, the file the JAX runner names
(with the implementation ``torch_gloo``), with the keys of a JAX result
of the same sweep and timings shaped ``[rank][iteration]``.  The port's
``process_1d_results``/``process_3d_results`` must give the JAX ones' CSV
rows on the same results: equal text, numbers within 1e-12 relative (the
JAX package sums per-rank means in its native core, in another order).
Nothing is measured here: the timings are gloo on the CPU.
"""

import csv
import json
import os

import numpy as np
import pytest

from dlbb_tpu.bench import Sweep1D as JaxSweep1D
from dlbb_tpu.bench import Sweep3D as JaxSweep3D
from dlbb_tpu.bench import run_sweep as jax_run_sweep
from dlbb_tpu.bench.runner import _iter_configs as jax_iter_configs
from dlbb_tpu.bench.runner import _result_filename as jax_result_filename
from dlbb_tpu.stats import process_1d_results as jax_process_1d
from dlbb_tpu.stats import process_3d_results as jax_process_3d
from dlbb_tpu_torch import cli
from dlbb_tpu_torch.bench import runner
from dlbb_tpu_torch.bench.launch import launch

OPS_1D, SIZES = ("allreduce", "alltoall"), (("1KB", 256), ("64KB", 16384))
OPS_3D, BATCH, SEQ, HIDDEN = ("allreduce", "gather"), (1, 2), (4,), (8,)
RANKS, WARMUP, ITERS = (2, 4), 2, 5
IMPL = "torch_gloo"


def _cli(kind, out, *extra):
    common = ["--device", "cpu", "--ranks", *map(str, RANKS), "--warmup", str(WARMUP),
              "--iters", str(ITERS), "--output", str(out), *extra]
    if kind == "1d":
        return cli.main(["bench1d", "--world", "4", "--ops", *OPS_1D,
                         "--sizes", *(s for s, _ in SIZES), *common])
    return cli.main(["bench3d", "--ops", *OPS_3D, "--batch", *map(str, BATCH),
                     "--seq", *map(str, SEQ), "--hidden", *map(str, HIDDEN), *common])


def _jax_sweep(kind, out):
    common = dict(rank_counts=RANKS, warmup_iterations=WARMUP,
                  measurement_iterations=ITERS, output_dir=str(out),
                  pipeline=False, compile_cache="off", journal=False)
    if kind == "1d":
        return JaxSweep1D(operations=OPS_1D, data_sizes=SIZES, **common)
    return JaxSweep3D(operations=OPS_3D, batch_sizes=BATCH, seq_lengths=SEQ,
                      hidden_dims=HIDDEN, **common)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's result directories and the CLI's exit codes, by kind."""
    root = tmp_path_factory.mktemp("port_sweeps")
    return {kind: (root / kind, _cli(kind, root / kind)) for kind in ("1d", "3d")}


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory, devices):
    root = tmp_path_factory.mktemp("jax_sweeps")
    for kind in ("1d", "3d"):
        jax_run_sweep(_jax_sweep(kind, root / kind), verbose=False)
    return root


def _results(directory):
    """The result JSONs in ``directory`` (not the JAX runner's manifest)."""
    return {p.name: json.loads(p.read_text()) for p in sorted(directory.glob("*.json"))
            if p.name != "sweep_manifest.json"}


@pytest.mark.parametrize("kind", ["1d", "3d"])
def test_cli_sweep_exits_zero(kind, port):
    assert port[kind][1] == 0


@pytest.mark.parametrize("kind", ["1d", "3d"])
def test_result_files_are_the_jax_names(kind, port, tmp_path):
    sweep = _jax_sweep(kind, tmp_path)
    expected = {jax_result_filename(sweep, IMPL, p, c)
                for p in RANKS for c in jax_iter_configs(sweep)}
    assert set(_results(port[kind][0])) == expected


@pytest.mark.parametrize("kind", ["1d", "3d"])
def test_result_keys_are_the_jax_keys(kind, port, jax_results):
    ours, theirs = _results(port[kind][0]), _results(jax_results / kind)
    assert len(ours) == len(theirs) == len(OPS_1D if kind == "1d" else OPS_3D) * 2 * 2
    for name, data in ours.items():
        ref = theirs[name.replace(IMPL, "xla_tpu", 1)]
        assert set(data) == set(ref), name
        assert set(data["system_info"]) >= {"backend", "comm_backend", "world_size"}


@pytest.mark.parametrize("kind", ["1d", "3d"])
def test_timings_are_rank_by_iteration(kind, port):
    for name, data in _results(port[kind][0]).items():
        t = np.asarray(data["timings"], dtype=np.float64)
        assert t.shape == (data["num_ranks"], ITERS), name
        assert np.all(np.isfinite(t)) and np.all(t > 0), name
        assert data["mesh_shape"] == [data["num_ranks"]]
        assert data["implementation"] == IMPL and data["timing_mode"] == "per_iter"
        assert data["system_info"]["comm_backend"] == "gloo"


def _same_rows(a_path, b_path):
    a, b = (list(csv.reader(open(p, newline=""))) for p in (a_path, b_path))
    assert len(a) == len(b) and len(a) > 1
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                assert x == y
            else:
                assert fx == pytest.approx(fy, rel=1e-12), (x, y)


def test_stats1d_rows_match_jax(port, tmp_path):
    from dlbb_tpu_torch.stats import process_1d_results

    src = port["1d"][0]
    ours = process_1d_results(src, tmp_path / "port", verbose=False)
    theirs = jax_process_1d(src, tmp_path / "jax", verbose=False)
    assert len(ours) == len(theirs) == len(_results(src))
    _same_rows(tmp_path / "port" / "benchmark_statistics.csv",
               tmp_path / "jax" / "benchmark_statistics.csv")
    for r in ours:
        assert len(r["per_rank_means_us"]) == r["num_ranks"]


def test_stats3d_rows_match_jax(port, tmp_path):
    from dlbb_tpu_torch.stats import process_3d_results

    src = port["3d"][0]
    ours = process_3d_results(src, tmp_path / "port", IMPL, verbose=False)
    theirs = jax_process_3d(src, tmp_path / "jax", IMPL, verbose=False)
    assert len(ours) == len(theirs) == len(_results(src))
    for suffix in ("standard", "transpose"):
        name = f"benchmark_statistics_3d_{IMPL}_{suffix}.csv"
        _same_rows(tmp_path / "port" / name, tmp_path / "jax" / name)


def test_resume_keeps_valid_results_and_remeasures_a_torn_one(port, tmp_path):
    import shutil

    out = tmp_path / "1d"
    shutil.copytree(port["1d"][0], out)
    torn = out / f"{IMPL}_allreduce_ranks4_1KB.json"
    torn.write_text(torn.read_text()[:40])
    before = {p.name: p.stat().st_mtime_ns for p in out.glob("*.json") if p != torn}
    assert _cli("1d", out, "--resume") == 0
    assert json.loads(torn.read_text())["num_ranks"] == 4
    assert {p.name: p.stat().st_mtime_ns for p in out.glob("*.json")
            if p != torn} == before


UNPORTED_KNOBS = [
    ("pipeline", True), ("compile_cache", "auto"), ("fault_plan", "exec-transient:1"),
    ("unit_deadline_seconds", 5.0), ("max_retries", 2), ("journal", True),
    ("span_trace", "spans.json"), ("device_trace_dir", "traces"),
    ("timing_mode", "chained")]


@pytest.mark.parametrize("knob,value", UNPORTED_KNOBS)
@pytest.mark.parametrize("sweep_cls", [runner.Sweep1D, runner.Sweep3D], ids=["1d", "3d"])
def test_unported_knob_raises(sweep_cls, knob, value):
    with pytest.raises(NotImplementedError):
        runner.run_sweep(sweep_cls(**{knob: value}), device="cpu")


def test_every_unported_knob_is_tested():
    assert set(runner._NOT_PORTED_KNOBS) <= {k for k, _ in UNPORTED_KNOBS}


def test_unported_variant_raises_in_a_sweep():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        runner.run_sweep(runner.Sweep1D(variant="overlap_ring"), device="cpu")


def test_run_sweep_without_device_cpu_raises_with_no_cuda():
    """The device defaults to cuda, and nothing falls back to the CPU; on a
    machine with a card the sweep raises for want of a process group."""
    with pytest.raises(RuntimeError):
        runner.run_sweep(runner.Sweep1D())


def test_launch_on_cuda_raises_with_no_cuda(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch(os.getcwd, 1)
