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
import time

import numpy as np
import pytest
import torch

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
from dlbb_tpu_torch.comm import get_op

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
    def mtimes():  # the results but the torn one
        return {p.name: p.stat().st_mtime_ns for p in out.glob("*.json")
                if p.name not in (torn.name, "sweep_manifest.json")}

    before = mtimes()
    assert _cli("1d", out, "--resume") == 0
    assert json.loads(torn.read_text())["num_ranks"] == 4
    assert mtimes() == before


# the fault plan, the watchdog, retries, the journal and span traces are
# live since item 13, part 13a (tests/test_torch_sweep_resilience.py)
UNPORTED_KNOBS = [
    ("pipeline", True), ("compile_cache", "auto"), ("device_trace_dir", "traces"),
    ("timing_mode", "chained")]


@pytest.mark.parametrize("knob,value", UNPORTED_KNOBS)
@pytest.mark.parametrize("sweep_cls", [runner.Sweep1D, runner.Sweep3D], ids=["1d", "3d"])
def test_unported_knob_raises(sweep_cls, knob, value):
    with pytest.raises(NotImplementedError):
        runner.run_sweep(sweep_cls(**{knob: value}), device="cpu")


def test_every_unported_knob_is_tested():
    assert set(runner._NOT_PORTED_KNOBS) <= {k for k, _ in UNPORTED_KNOBS}


def test_unported_variant_raises_in_a_sweep():
    # overlap_ring is ported (tests/test_torch_collective_matmul.py), and so
    # are the compress_* variants (tests/test_torch_compression.py) and
    # nofuse (test_nofuse_sweep_runs_under_its_label)
    with pytest.raises(NotImplementedError, match="pod launcher") as e:
        runner.run_sweep(runner.Sweep1D(variant="combine4mb"), device="cpu")
    assert "XLA_FLAGS" in str(e.value)


def test_nofuse_sweep_runs_under_its_label(tmp_path):
    """JAX's "combiners off": eager torch.distributed combines nothing, so
    the sweep runs as under default and its results carry the variant's
    name, as JAX labels them (``<impl>_nofuse``)."""
    assert cli.main(["bench1d", "--device", "cpu", "--world", "2", "--ranks", "2",
                     "--ops", "allreduce", "--sizes", "1KB", "--warmup", "1",
                     "--iters", "3", "--variant", "nofuse",
                     "--output", str(tmp_path)]) == 0
    (name,) = _results(tmp_path)
    path = tmp_path / name
    data = json.loads(path.read_text())
    assert path.name == f"{IMPL}_nofuse_allreduce_ranks2_1KB.json"
    assert (data["implementation"], data["variant"]) == (f"{IMPL}_nofuse", "nofuse")


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


def test_ranks_past_a_smaller_mesh_wait_for_it(tmp_path):
    """World 4, rank counts (2, 4), a 2 s group timeout and a P=2 part that
    takes longer: ranks 2 and 3 must wait for the P=2 mesh at the end of its
    rank count instead of timing out in the P=4 mesh's first collective, so
    every file is written and no config fails."""
    sweep = runner.Sweep1D(operations=("allreduce",), data_sizes=(("16MB", 4194304),),
                           rank_counts=(2, 4), warmup_iterations=1,
                           measurement_iterations=500, output_dir=str(tmp_path))
    results = launch(cli.sweep_worker, 4, "cpu", args=(sweep, "cpu"), timeout=240,
                     group_timeout=2.0)
    assert [r.failed for r in results] == [[], [], [], []]
    assert sorted(_results(tmp_path)) == [
        f"{IMPL}_allreduce_ranks2_16MB.json", f"{IMPL}_allreduce_ranks4_16MB.json"]


class _Recorder:
    """A collective whose ``prepare`` sleeps and whose call records the
    buffer it was given."""

    def __init__(self, sleep):
        self.sleep, self.prepared, self.called = sleep, [], []

    def prepare(self, x):
        time.sleep(self.sleep)
        buf = x.clone()
        self.prepared.append(buf)
        return buf

    def call(self, x, buf):
        self.called.append(buf)
        return buf


@pytest.fixture
def world_one_group(tmp_path):
    from dlbb_tpu_torch.comm import destroy_distributed, initialize_distributed

    initialize_distributed("gloo", 0, 1, str(tmp_path / "store"))
    try:
        yield
    finally:
        destroy_distributed()


def test_prepare_runs_outside_the_timed_interval(world_one_group):
    from dlbb_tpu_torch.utils.timing import time_collective

    sleep, warmup, iters = 0.05, 2, 5
    fn = _Recorder(sleep)
    samples, meta = time_collective(fn, torch.ones(8), None, warmup=warmup,
                                    iterations=iters, device="cpu")
    assert len(samples) == iters and float(np.median(samples)) < sleep
    assert meta["forced_completion_s"] < sleep
    assert "outside the timer" in meta["timing_method"]
    # warmup, timed and forced-completion calls: each on its own fresh buffer
    assert len(fn.called) == warmup + iters + 3
    assert [id(b) for b in fn.called] == [id(b) for b in fn.prepared]


def test_in_place_ops_refresh_their_output_in_prepare():
    from dlbb_tpu_torch.comm import Mesh, MeshSpec
    from dlbb_tpu_torch.comm.ops import build_allreduce_hierarchical

    mesh = Mesh(MeshSpec.ring(1), 0, None, {"ranks": None})
    x = torch.arange(4.0)
    for fn in [get_op(n).build(mesh) for n in ("allreduce", "broadcast", "reduce")] + [
            build_allreduce_hierarchical(mesh)]:
        buf = fn.prepare(x)
        assert torch.equal(buf, x) and buf.data_ptr() != x.data_ptr()
    for name in ("allgather", "gather", "scatter", "alltoall", "sendrecv",
                 "reducescatter"):
        assert get_op(name).build(mesh).prepare(x) is None


def test_payload_cache_evicts_at_its_budget_and_passes_oversized_through():
    cache = runner.PayloadCache(max_bytes=1000)
    built = []

    def make(n):
        def build():
            built.append(n)
            return torch.zeros(n, dtype=torch.uint8)
        return build

    a = cache.get("a", make(400))
    assert cache.get("a", make(400)) is a and built == [400]
    cache.get("b", make(400))
    cache.get("a", make(400))  # a is now the most recently used
    cache.get("c", make(400))  # 1200 bytes > 1000: the LRU entry, b, goes
    assert "a" in cache and "c" in cache and "b" not in cache
    assert cache.nbytes == 800
    big = cache.get("big", make(2000))
    assert big.nbytes == 2000 and "big" not in cache and cache.nbytes == 800


def test_payload_cache_budget_default_and_env_override(monkeypatch):
    monkeypatch.delenv("DLBB_PAYLOAD_CACHE_BYTES", raising=False)
    assert runner.PayloadCache().max_bytes == 1 << 30
    monkeypatch.setenv("DLBB_PAYLOAD_CACHE_BYTES", "4096")
    assert runner.PayloadCache().max_bytes == 4096
