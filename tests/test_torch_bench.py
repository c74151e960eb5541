"""``bench_torch.py``, the port's headline benchmark, against ``bench.py``
(read from its source, never run), and the port's result paths.

On the CPU, with the model presets cut to a few narrow layers and the
extras' sequences cut in proportion (the extras' names and keys unchanged):
``main(device="cpu")`` prints one JSON line with ``bench.py``'s keys and
extras, an extra that raises lands in ``failed`` with exit 1, and with no
CUDA device the script prints no line.  The >= 2-GPU branch runs over gloo
on 2 spawned ranks.  Nothing here is a measurement.
"""

import ast
import io
import json
import math
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import yaml

import bench_torch
from dlbb_tpu_torch import cli
from dlbb_tpu_torch.bench import runner
from dlbb_tpu_torch.models import configs as pt_configs

REPO = Path(__file__).resolve().parents[1]
BENCH = ast.parse((REPO / "bench.py").read_text())

TINY = dict(hidden_size=32, num_layers=2, num_heads=2, ffn_intermediate=64)
# the extras' sequence lengths on the CPU: 512 -> 32, 1024 -> 64, 8192 -> 128
CPU_SEQ = {512: 32, 1024: 64, 8192: 128}


def _bench_fn(name):
    return next(n for n in BENCH.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _bench_consts():
    consts = {}
    for node in BENCH.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Tuple):
            names = [n.id for n in node.targets[0].elts]
            consts.update(zip(names, ast.literal_eval(node.value)))
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant):
            consts[node.targets[0].id] = node.value.value
    return consts


def _dict_keys(node):
    return [ast.literal_eval(k) for k in node.keys]


def _assigned_dicts(fn):
    """``target source -> dict node`` for every ``x = {...}`` and
    ``x[k] = {...}`` in ``fn``."""
    return {ast.unparse(n.targets[0]): n.value for n in ast.walk(fn)
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)}


def _bench_extras():
    loop = next(n for n in ast.walk(_bench_fn("bench_e2e_single_chip"))
                if isinstance(n, ast.For))
    return eval(compile(ast.Expression(loop.iter), "bench.py", "eval"), {}, _bench_consts())


def test_constants_and_extras_are_bench_pys():
    consts = _bench_consts()
    assert (bench_torch.E2E_BATCH, bench_torch.E2E_SEQ) == (consts["E2E_BATCH"],
                                                            consts["E2E_SEQ"])
    assert bench_torch.ONECCL_BASELINE_GBPS == consts["ONECCL_BASELINE_GBPS"]
    assert bench_torch.EXTRAS == _bench_extras()


def _bench_keys():
    """bench.py's keys: the headline's, an extra's, the train extra's, and
    the multi-chip line's."""
    dicts = _assigned_dicts(_bench_fn("bench_e2e_single_chip"))
    multi = next(n.value for n in ast.walk(_bench_fn("bench_allreduce_multichip"))
                 if isinstance(n, ast.Return))
    return {"headline": _dict_keys(dicts["out"]),
            "extra": _dict_keys(dicts["extras[key]"]),
            "train": _dict_keys(dicts[f"extras['{bench_torch.TRAIN_EXTRA}']"]),
            "multichip": _dict_keys(multi)}


def test_bench_py_keys_are_read():
    keys = _bench_keys()
    assert keys["headline"] == ["metric", "value", "unit", "vs_baseline"]
    assert "forward_mean_ms" in keys["extra"] and "remat_policy" in keys["train"]
    assert keys["multichip"][:4] == keys["headline"]


@pytest.mark.parametrize("size,attention,seq", [("1B", "simplified", 512),
                                                ("7B", "full", 512),
                                                ("1B", "flash", 8192)])
def test_e2e_config_is_bench_pys(monkeypatch, size, attention, seq):
    """``_e2e`` hands ``run_e2e`` the config ``bench.py::_e2e`` builds."""
    seen = {}

    def fake_run_e2e(config, device=None, verbose=True):
        seen.update(config=config, device=device, verbose=verbose)
        raise RuntimeError("stop")

    monkeypatch.setattr("dlbb_tpu_torch.bench.e2e.run_e2e", fake_run_e2e)
    with pytest.raises(RuntimeError, match="stop"):
        bench_torch._e2e(size, attention, seq=seq, device="cpu")
    fn = _bench_fn("_e2e")
    node = _assigned_dicts(fn)["config"]
    scope = dict(_bench_consts(), size=size, attention=attention, seq=seq, iters=10)
    want = eval(compile(ast.Expression(node), "bench.py", "eval"), {}, scope)
    assert seen == {"config": want, "device": "cpu", "verbose": False}


@pytest.fixture
def tiny(monkeypatch):
    """The 1B and 7B presets cut to two narrow layers, and each forward's
    sequence cut in proportion (the extras' names stay bench.py's)."""
    for size in ("1B", "7B"):
        monkeypatch.setitem(pt_configs.MODEL_CONFIGS, size, pt_configs.ModelConfig(**TINY))
    real_e2e = bench_torch._e2e

    def e2e(size, attention, iters=10, seq=None, device=None):
        return real_e2e(size, attention, iters=iters,
                        seq=CPU_SEQ[seq or bench_torch.E2E_SEQ], device=device)

    monkeypatch.setattr(bench_torch, "_e2e", e2e)


def _main(device="cpu"):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = bench_torch.main(device=device)
    return rc, buf.getvalue().splitlines()


def _extra_names():
    """bench.py's names of its extras (its key rule)."""
    seq512 = _bench_consts()["E2E_SEQ"]
    return [f"{size}_{att}" if seq == seq512 else f"{size}_{att}_s{seq}"
            for size, att, seq in _bench_extras()] + [bench_torch.TRAIN_EXTRA]


def test_main_prints_one_line_with_every_extra(tiny):
    rc, lines = _main()
    assert rc == 0 and len(lines) == 1
    out = json.loads(lines[0])
    keys = _bench_keys()
    assert list(out) == keys["headline"] + ["extras"]
    assert out["metric"] == "e2e_1B_forward_throughput_vs_reference_cpu_stack"
    assert out["unit"] == "tokens/s"
    baseline = json.loads((REPO / "bench_baseline_cpu.json").read_text())
    assert out["vs_baseline"] == round(out["value"] / baseline["tokens_per_second"], 3)
    assert list(out["extras"]) == _extra_names()
    for name, extra in out["extras"].items():
        train = name == bench_torch.TRAIN_EXTRA
        want = keys["train" if train else "extra"]
        assert list(extra) == want, name
        ms = "step_mean_ms" if train else "forward_mean_ms"
        # the TFLOP/s of a two-layer model on the CPU round to 0.0
        assert extra["tokens_per_second"] > 0 and extra[ms] > 0, name
        assert all(math.isfinite(extra[k]) and extra[k] >= 0
                   for k in want if k != "remat_policy"), name
    assert out["extras"][bench_torch.TRAIN_EXTRA]["remat_policy"] == "dots"


def test_a_failed_extra_is_recorded_and_exits_one(tiny, monkeypatch):
    real_e2e = bench_torch._e2e

    def e2e(size, attention, iters=10, seq=None, device=None):
        if (size, attention) == ("7B", "full"):
            raise RuntimeError("boom")
        return real_e2e(size, attention, iters=2, seq=seq, device=device)

    def train(device=None):
        raise MemoryError("no room")

    monkeypatch.setattr(bench_torch, "_e2e", e2e)
    monkeypatch.setattr(bench_torch, "_train_step_bench", train)
    rc, lines = _main()
    assert rc == 1 and len(lines) == 1
    out = json.loads(lines[0])
    assert out["failed"] == {"7B_full": "RuntimeError: boom",
                             bench_torch.TRAIN_EXTRA: "MemoryError: no room"}
    assert list(out["extras"]) == [n for n in _extra_names() if n not in out["failed"]]


def test_no_cuda_device_prints_no_line(monkeypatch, capsys):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert bench_torch.main() != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


def test_missing_baseline_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(bench_torch, "CPU_BASELINE_CACHE", tmp_path / "absent.json")
    with pytest.raises(FileNotFoundError, match="not re-measure"):
        bench_torch.bench_e2e_single_chip("cpu")


def test_bench_allreduce_multichip_schema():
    """The >= 2-GPU branch (one NCCL rank per GPU on the card) over gloo:
    schema, positive bandwidth and the vs_baseline arithmetic, as
    tests/test_bench.py holds bench.py's."""
    out = bench_torch.bench_allreduce_multichip(2, device="cpu", num_elements=262_144,
                                                warmup=1, iterations=5)
    assert list(out) == _bench_keys()["multichip"]
    assert out["metric"] == "1d_allreduce_1MB_bus_bandwidth_2ranks"
    assert out["unit"] == "GB/s" and out["value"] > 0 and out["max_time_s"] > 0
    assert out["vs_baseline"] == round(out["value"] / bench_torch.ONECCL_BASELINE_GBPS, 3)
    assert (out["timing_mode"], out["num_elements"]) == ("per_iter", 262_144)


# ---------------------------------------------------------------------------
# where the port writes its results (ROADMAP Queue 3, item 1)
# ---------------------------------------------------------------------------

PORT_ROOT = "results/torch/"


@pytest.mark.parametrize("path", sorted((REPO / "dlbb_tpu_torch" / "configs").glob("*.yaml")),
                         ids=lambda p: p.name)
def test_config_output_dirs_lie_under_results_torch(path):
    out = yaml.safe_load(path.read_text()).get("experiment", {}).get("output_dir")
    assert out is None or out.startswith(PORT_ROOT), out


def test_sweep_and_report_defaults_lie_under_results_torch():
    sweeps = {kind: cli._sweep(cli.build_parser().parse_args([kind]))
              for kind in ("bench1d", "bench3d")}
    assert sweeps["bench1d"].output_dir == runner.Sweep1D().output_dir == "results/torch/1d"
    assert sweeps["bench3d"].output_dir == runner.Sweep3D().output_dir == "results/torch/3d"
    compare = cli.build_parser().parse_args(["compare", "--reference", "ref"])
    # compare reads where the sweeps and the configs write
    assert (compare.own_1d, compare.own_3d, compare.own_e2e) == (
        "results/torch/1d", "results/torch/3d", "results/torch/e2e")
    assert compare.output.startswith("stats/torch")
    reports = cli.build_parser().parse_args(["reports"])
    assert (reports.results, reports.stats) == ("results/torch", "stats/torch")
