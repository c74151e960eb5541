"""Tracing and profiling (``dlbb_tpu_torch/utils/profiling.py``, ROADMAP
Queue 1, Slice F, item 13, part 13b), mirroring JAX's 4 tests
``tests/test_profiling.py`` over ``torch.profiler`` (a gzipped Kineto chrome
trace where JAX writes xplane files), and one more: tracing does not change
what is computed (a traced forward is bit-equal to an untraced one).
"""

import gzip
import json
from pathlib import Path

import pytest
import torch
import yaml

from dlbb_tpu_torch import cli
from dlbb_tpu_torch.utils.profiling import (
    TRACE_FILE,
    annotate,
    default_trace_dir,
    maybe_trace,
    profiler_active,
    step_annotation,
)

torch.set_num_threads(2)


def _events(trace_dir):
    path = Path(trace_dir) / TRACE_FILE
    data = json.loads(gzip.decompress(path.read_bytes()))
    return data, [e for e in data["traceEvents"] if e.get("ph") == "X"]


def test_maybe_trace_writes_a_trace(tmp_path):
    trace_dir = str(tmp_path / "trace")
    with maybe_trace(trace_dir, "cpu") as resolved:
        assert resolved == trace_dir and profiler_active()
        with annotate("measure"):
            for i in range(2):
                with step_annotation("step", i):
                    y = torch.ones(64, 64) @ torch.ones(64, 64)
    assert not profiler_active()
    assert float(y[0, 0]) == 64.0
    data, events = _events(trace_dir)
    assert data["dlbb_device"] == "cpu"
    names = {e["name"] for e in events}
    assert {"measure", "step#0", "step#1"} <= names
    assert any(e.get("cat") == "cpu_op" and "mm" in e["name"] for e in events)


def test_maybe_trace_noop_without_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("DLBB_TRACE_DIR", raising=False)
    assert default_trace_dir() is None
    with maybe_trace(None) as resolved:
        assert resolved is None and not profiler_active()
    assert list(tmp_path.iterdir()) == []


def test_maybe_trace_env_default(tmp_path, monkeypatch):
    trace_dir = str(tmp_path / "envtrace")
    monkeypatch.setenv("DLBB_TRACE_DIR", trace_dir)
    with maybe_trace(None, "cpu") as resolved:
        assert resolved == trace_dir
        torch.ones(8, 8) * 2
    assert _events(trace_dir)[1]


def _config(**model):
    return {
        "experiment": {"name": "trace_smoke"},
        "model": {"hidden_size": 32, "num_layers": 1, "num_heads": 2,
                  "ffn_intermediate": 64, "attention": "full", "dtype": "float32", **model},
        "parallelism": {"world_size": 1, "data_parallel": 1},
        "input": {"batch_size": 4, "sequence_length": 8, "seed": 42},
        "execution": {"warmup_iterations": 1, "benchmark_iterations": 2},
        "training": {"learning_rate": 1e-2},
    }


def test_cli_train_with_trace(tmp_path):
    """--trace on the CLI wraps the whole run and writes a trace."""
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(_config()))
    trace_dir = tmp_path / "clitrace"
    rc = cli.main(["train", "--config", str(cfg_path), "--trace", str(trace_dir),
                   "--output", str(tmp_path / "out"), "--device", "cpu"])
    assert rc == 0
    _data, events = _events(trace_dir)
    assert any(e.get("cat") == "cpu_op" for e in events)


@pytest.mark.parametrize("attention", ["full", "flash"])
def test_traced_forward_is_bit_equal_to_untraced(tmp_path, attention):
    """The profiler observes and changes nothing: the same weights and
    batch give the same bits with and without a trace around the forward."""
    from dlbb_tpu_torch.data import create_dataset_from_config
    from dlbb_tpu_torch.models import ModelConfig, forward, init_params

    config = _config(attention=attention)
    model_cfg = ModelConfig.from_dict(config["model"])
    params = init_params(model_cfg, 42, "cpu")
    batch = create_dataset_from_config(config, dtype=torch.float32, device="cpu",
                                       hidden_size=model_cfg.hidden_size).get_batch()
    with torch.inference_mode():
        plain = forward(params, batch, model_cfg)
        with maybe_trace(str(tmp_path / "t"), "cpu"), annotate("profile_rep:forward"):
            traced = forward(params, batch, model_cfg)
    assert torch.equal(plain, traced)
    assert _events(tmp_path / "t")[1]
