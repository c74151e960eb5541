"""The port's end-to-end harness, its utilities, its device rules and its
kernel build, on the CPU.

The CUDA kernel itself cannot build or run here (no ``nvcc``, no card):
``chip_smoke.py`` builds it and holds it against its plain version on the
card.  These tests pin what surrounds it: the route rule, the refusal to
run quietly on the CPU, the ``nvcc`` command and the ignored build
directory, and the harness's result schema.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlbb_tpu.data.synthetic import SyntheticEmbeddingDataset as JaxDataset
from dlbb_tpu.utils.metrics import summarize as jax_summarize
from dlbb_tpu_torch import cli
from dlbb_tpu_torch.bench.e2e import run_e2e
from dlbb_tpu_torch.data import SyntheticEmbeddingDataset
from dlbb_tpu_torch.models.transformer import flash_route
from dlbb_tpu_torch.ops import _build
from dlbb_tpu_torch.utils import metrics, sysinfo, timing
from dlbb_tpu_torch.utils.config import load_config, save_json

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

# the JAX harness's result keys (dlbb_tpu/bench/e2e.py, per-iteration mode)
JAX_RESULT_KEYS = {
    "experiment", "backend", "config", "model", "mesh", "init_time_s",
    "compiler_options", "compile_time_s", "forward_time", "timing_mode",
    "timing_method", "per_host_means_s", "cross_host_variance",
    "cross_host_cv", "tokens_per_second", "model_flops_per_forward",
    "achieved_tflops_per_second", "timings", "system_info", "timestamp",
}


def _config(attention="full", **over):
    cfg = {
        "experiment": {"name": "smoke"},
        "model": {"hidden_size": 64, "num_layers": 2, "num_heads": 4,
                  "num_kv_heads": 2, "ffn_intermediate": 128,
                  "attention": attention, "dtype": "float32"},
        "parallelism": {"world_size": 1, "data_parallel": 1},
        "input": {"batch_size": 2, "sequence_length": 32, "seed": 42},
        "execution": {"warmup_iterations": 2, "benchmark_iterations": 3},
    }
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("attention", ["simplified", "full", "flash"])
def test_run_e2e_cpu_writes_schema_complete_json(tmp_path, attention):
    result = run_e2e(_config(attention), device="cpu",
                     output_dir=str(tmp_path), verbose=False)
    assert JAX_RESULT_KEYS <= set(result)
    assert result["backend"] == "torch_cuda"
    assert result["forward_time"]["count"] == 3
    assert len(result["timings"][0]) == 3
    assert result["tokens_per_second"] > 0
    assert result["model_flops_per_forward"] > 0
    # on the CPU every mode is the plain path: no kernel launch
    assert result["flash_launches"] == 0
    assert result["mesh"] == {"dp": 1, "sp": 1, "pp": 1, "ep": 1, "tp": 1}
    assert result["system_info"]["device_kind"] == "cpu"
    saved = json.loads((tmp_path / "torch_cuda_smoke.json").read_text())
    assert saved["model"] == result["model"]
    assert set(saved) == set(result)


def test_run_e2e_without_cuda_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_e2e(_config(), verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_e2e(_config(), device="cuda", verbose=False)


def test_run_e2e_refuses_multi_device_configs():
    """Outside a process group there is one device: the plan's preflight
    refuses a config that needs four, with the JAX plan's message."""
    cfg = _config(parallelism={"world_size": 4, "data_parallel": 1})
    with pytest.raises(ValueError, match=r"needs 4 devices \(tp=4 x dp=1"):
        run_e2e(cfg, device="cpu", verbose=False)


def test_cli_e2e_on_cpu(tmp_path):
    import yaml

    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(_config()))
    assert cli.main(["e2e", "--config", str(path), "--device", "cpu",
                     "--output", str(tmp_path / "out")]) == 0
    assert (tmp_path / "out" / "torch_cuda_smoke.json").exists()


def test_shipped_config_loads_as_the_1b_main_path():
    from dlbb_tpu_torch.models import MODEL_CONFIGS, ModelConfig

    cfg = load_config(REPO / "dlbb_tpu_torch" / "configs" / "e2e_1b_full.yaml")
    model = ModelConfig.from_dict(cfg["model"])
    assert model == MODEL_CONFIGS["1B"].with_(attention="full")
    assert (cfg["input"]["batch_size"], cfg["input"]["sequence_length"]) == (8, 512)


@pytest.mark.parametrize("shape,dtype,device,expected", [
    ((8, 16, 512, 128), torch.bfloat16, "cpu", False),
    ((8, 16, 512, 128), torch.bfloat16, "cuda", True),
    ((1, 16, 8192, 128), torch.bfloat16, "cuda", True),
    ((8, 16, 512, 128), torch.float32, "cuda", False),
    ((8, 16, 256, 128), torch.bfloat16, "cuda", False),
    ((8, 16, 520, 128), torch.bfloat16, "cuda", False),
    ((8, 16, 512, 96), torch.bfloat16, "cuda", False),
])
def test_flash_route(shape, dtype, device, expected):
    assert flash_route(shape, dtype, device) is expected


def test_nvcc_command_targets_sm90a_and_build_dir_is_ignored():
    srcs = _build.sources()
    assert [s.name for s in srcs] == ["flash_bwd.cu", "flash_fwd.cu"]
    cmd = _build.nvcc_command("nvcc", srcs[0], Path("/x/libflash_fwd.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-O3", "-shared", "-std=c++17"} <= set(cmd)
    rel = _build.build_dir().relative_to(REPO).as_posix()
    assert rel.startswith("dlbb_tpu_torch/ops/_build/")
    ignored = [ln.strip() for ln in (REPO / ".gitignore").read_text().splitlines()]
    assert "dlbb_tpu_torch/ops/_build/" in ignored


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", "/nonexistent/bin/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dataset_is_bit_identical_to_jax(dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = np.asarray(JaxDataset(2, 16, 32, seed=42, dtype=jd).get_batch(), np.float32)
    got = SyntheticEmbeddingDataset(2, 16, 32, seed=42, dtype=td).get_batch()
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("n", [0, 1, 7, 1000])
def test_summarize_matches_jax(n):
    values = list(np.random.default_rng(n).exponential(1e-3, size=n))
    got, ref = metrics.summarize(values), jax_summarize(values)
    assert set(got) == set(ref) == set(metrics.SUMMARY_KEYS)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-12, equal_nan=True)


def test_time_fn_per_iter_cpu_counts_calls():
    calls = []
    out = timing.time_fn_per_iter(lambda: calls.append(1), iterations=5,
                                  device="cpu")
    assert len(out) == 5 and len(calls) == 5 and all(t >= 0 for t in out)


def test_resolve_device_and_system_info():
    assert sysinfo.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        sysinfo.resolve_device("meta")
    info = sysinfo.collect_system_info("cpu")
    assert info["torch_version"] == torch.__version__
    assert info["backend"] == "cpu"


def test_save_json_is_atomic_and_round_trips(tmp_path):
    path = save_json({"a": np.float32(1.5), "b": [np.int64(2)]}, tmp_path / "x" / "r.json")
    assert json.loads(path.read_text()) == {"a": 1.5, "b": [2]}
    assert list(path.parent.iterdir()) == [path]
