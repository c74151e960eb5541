"""The port stands alone: no file of ``dlbb_tpu_torch/``, not
``chip_smoke.py`` or ``bench_torch.py``, and not ``scripts/torch_{e2e,comm,zero}_profile.py``,
``scripts/torch_gloo_p2p_probe.py``, ``scripts/torch_bench_{fleet,serving,speculative,
prefix}.py`` or their helper ``scripts/_torch_serve_bench.py`` imports
``jax`` or any module of ``dlbb_tpu`` (the JAX package runs nowhere on the card's
machine).  Static AST check, one case per file, in the manner of
``tests/test_fleet.py``'s host-side pin."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    [p.relative_to(REPO).as_posix() for p in (REPO / "dlbb_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py", "bench_torch.py", "scripts/torch_e2e_profile.py",
       "scripts/torch_comm_profile.py",
       "scripts/torch_zero_profile.py", "scripts/torch_gloo_p2p_probe.py",
       "scripts/torch_bench_fleet.py", "scripts/torch_bench_serving.py",
       "scripts/torch_bench_speculative.py", "scripts/torch_bench_prefix.py",
       "scripts/_torch_serve_bench.py"]
)


def _forbidden(module: str) -> bool:
    return any(module == root or module.startswith(root + ".")
               for root in ("jax", "jaxlib", "dlbb_tpu"))


def test_port_has_the_expected_modules():
    for rel in ("dlbb_tpu_torch/__init__.py", "dlbb_tpu_torch/cli.py",
                "dlbb_tpu_torch/bench/e2e.py", "dlbb_tpu_torch/models/transformer.py",
                "dlbb_tpu_torch/ops/flash_attention.py", "dlbb_tpu_torch/train/loop.py",
                "dlbb_tpu_torch/train/optim.py", "dlbb_tpu_torch/comm/mesh.py",
                "dlbb_tpu_torch/comm/ops.py", "dlbb_tpu_torch/comm/variants.py",
                "dlbb_tpu_torch/bench/runner.py", "dlbb_tpu_torch/bench/launch.py",
                "dlbb_tpu_torch/stats/stats1d.py", "dlbb_tpu_torch/stats/stats3d.py",
                "dlbb_tpu_torch/parallel/plan.py", "dlbb_tpu_torch/models/sharding.py",
                "dlbb_tpu_torch/train/zero.py", "dlbb_tpu_torch/train/checkpoint.py",
                "dlbb_tpu_torch/resilience/errors.py", "dlbb_tpu_torch/resilience/inject.py",
                "dlbb_tpu_torch/resilience/preempt.py", "dlbb_tpu_torch/parallel/ring.py",
                "dlbb_tpu_torch/parallel/collective_matmul.py",
                "dlbb_tpu_torch/parallel/ring_attention.py",
                "dlbb_tpu_torch/parallel/ulysses.py", "dlbb_tpu_torch/parallel/pipeline.py",
                "dlbb_tpu_torch/comm/compression.py", "dlbb_tpu_torch/stats/compare.py",
                "dlbb_tpu_torch/stats/variants_report.py",
                "dlbb_tpu_torch/stats/northstar.py",
                "dlbb_tpu_torch/stats/parallelism_report.py",
                "dlbb_tpu_torch/serve/kvcache.py", "dlbb_tpu_torch/serve/traffic.py",
                "dlbb_tpu_torch/serve/engine.py", "dlbb_tpu_torch/serve/bench.py",
                "dlbb_tpu_torch/stats/serving_report.py",
                "dlbb_tpu_torch/obs/spans.py", "dlbb_tpu_torch/obs/export.py",
                "dlbb_tpu_torch/resilience/journal.py", "chip_smoke.py",
                "dlbb_tpu_torch/bench/schedule.py", "dlbb_tpu_torch/utils/profiling.py",
                "dlbb_tpu_torch/obs/capture.py", "dlbb_tpu_torch/obs/devtrace.py",
                "dlbb_tpu_torch/obs/corpus.py", "dlbb_tpu_torch/analysis/findings.py",
                "dlbb_tpu_torch/resilience/validate.py", "dlbb_tpu_torch/resilience/chaos.py",
                "dlbb_tpu_torch/analysis/costmodel.py", "dlbb_tpu_torch/obs/fit.py",
                "dlbb_tpu_torch/obs/attribution.py", "dlbb_tpu_torch/plan/autotune.py",
                "dlbb_tpu_torch/plan/__init__.py", "dlbb_tpu_torch/__main__.py",
                "dlbb_tpu_torch/analysis/expectations.py",
                "dlbb_tpu_torch/analysis/source_lint.py",
                "dlbb_tpu_torch/analysis/op_capture.py",
                "dlbb_tpu_torch/analysis/hlo_audit.py", "bench_torch.py"):
        assert rel in PORT_FILES


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_jax_and_no_dlbb_tpu_import(rel):
    tree = ast.parse((REPO / rel).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad = [a.name for a in node.names if _forbidden(a.name)]
            assert not bad, f"{rel} imports {bad}"
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            assert not _forbidden(node.module or ""), \
                f"{rel}: from {node.module} import ..."
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            arg = node.args[0] if node.args else None
            assert not (isinstance(arg, ast.Constant) and _forbidden(str(arg.value))), \
                f"{rel}: __import__({arg.value!r})"


_BLOCKED_IMPORT = """
import importlib, importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "triton", "dlbb_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
importlib.import_module(sys.argv[1])
import torch
assert not torch.cuda.is_initialized(), "CUDA initialised at import"
"""


@pytest.mark.parametrize("module", [
    "dlbb_tpu_torch.parallel.ring", "dlbb_tpu_torch.parallel.collective_matmul",
    "dlbb_tpu_torch.parallel.ring_attention", "dlbb_tpu_torch.parallel.ulysses"])
def test_sequence_modules_import_without_jax_triton_or_cuda(module):
    """The modules of the sequence-sharded layouts import in a fresh process
    where ``jax``, ``triton`` and ``dlbb_tpu`` cannot be imported, and
    leave CUDA uninitialised."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, module], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", [
    "dlbb_tpu_torch.comm.compression", "dlbb_tpu_torch.stats.compare",
    "dlbb_tpu_torch.stats.variants_report", "dlbb_tpu_torch.stats.northstar",
    "dlbb_tpu_torch.stats.parallelism_report", "dlbb_tpu_torch.cli"])
def test_compression_and_report_modules_import_without_jax_triton_or_cuda(module):
    """The quantised-wire collectives, the derived reports and the CLI
    import in a fresh process where ``jax``, ``triton`` and ``dlbb_tpu``
    cannot be imported, and leave CUDA uninitialised."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, module], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", [
    "dlbb_tpu_torch.serve", "dlbb_tpu_torch.serve.engine", "dlbb_tpu_torch.serve.bench",
    "dlbb_tpu_torch.stats.serving_report", "dlbb_tpu_torch.obs",
    "dlbb_tpu_torch.resilience", "bench_torch", "dlbb_tpu_torch.bench.schedule",
    "dlbb_tpu_torch.bench.runner", "dlbb_tpu_torch.utils.profiling",
    "dlbb_tpu_torch.obs.capture", "dlbb_tpu_torch.obs.devtrace",
    "dlbb_tpu_torch.analysis.findings", "dlbb_tpu_torch.resilience.chaos",
    "dlbb_tpu_torch.resilience.validate", "dlbb_tpu_torch.analysis.costmodel",
    "dlbb_tpu_torch.obs.corpus", "dlbb_tpu_torch.obs.fit"])
def test_serving_obs_and_bench_import_without_jax_triton_or_cuda(module):
    """The serving foundations and engine, the span tracer and metrics
    registry, the journal, the headline script, the compile-ahead engine
    and the device traces import in a fresh process where
    ``jax``, ``triton`` and ``dlbb_tpu`` cannot be imported, and leave CUDA
    uninitialised."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, module], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_timing_never_imports_the_tracer():
    """``utils/timing.py`` brackets device work with clocks, so it imports
    nothing of ``obs`` (the spans and the device captures stay outside timed
    regions), nor the profiler (``utils/profiling.py``, ``torch.profiler``),
    nor the compile-ahead engine, as in JAX."""
    tree = ast.parse((REPO / "dlbb_tpu_torch" / "utils" / "timing.py").read_text())
    banned = ("obs", "profiling", "profiler", "schedule", "capture")
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            parts = (node.module or "").split(".") + [a.name for a in node.names]
            assert not set(parts) & set(banned), node.module
        elif isinstance(node, ast.Import):
            assert not any(set(a.name.split(".")) & set(banned) for a in node.names)
        elif isinstance(node, ast.Attribute):
            assert node.attr not in ("profiler", "record_function"), node.attr
