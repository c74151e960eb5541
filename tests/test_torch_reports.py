"""The port's derived reports (``dlbb_tpu_torch/stats/{compare,variants_report,
northstar,parallelism_report}.py``, ``cli compare`` and ``cli reports``)
against the JAX package's, on the same fixtures.

The fixtures are made here from a numpy seed: a reference corpus (two 1D
and two 3D backend directories in the reference's result schema), the
port's own 1D and 3D results (measured on the card and on the CPU, bf16
and fp32, a compressed op among them), per-variant stats CSVs, 3D variant
CSVs, and train results of the parallelism families and the long-context
grid.  Each JAX function and its port read the same files: the CSVs they
write are equal byte for byte, and the markdown is equal in every table
row, summary bullet and section heading that names neither package nor
implementation (the titles and the prose around them name each package's
own setup).
"""

import ast
import csv
import json
from pathlib import Path

import numpy as np
import pytest

from dlbb_tpu.stats import compare as jax_compare
from dlbb_tpu.stats import northstar as jax_northstar
from dlbb_tpu.stats import parallelism_report as jax_par
from dlbb_tpu.stats import variants_report as jax_variants
from dlbb_tpu_torch import cli
from dlbb_tpu_torch.stats import compare as pt_compare
from dlbb_tpu_torch.stats import northstar as pt_northstar
from dlbb_tpu_torch.stats import parallelism_report as pt_par
from dlbb_tpu_torch.stats import process_1d_results
from dlbb_tpu_torch.stats import variants_report as pt_variants

REPO = Path(__file__).resolve().parents[1]
SIZES = {"1KB": 256, "64KB": 16384, "1MB": 262144}
OPS = ("allreduce", "allgather", "broadcast")
RANKS = (2, 4)
SHAPES = ((1, 2048, 2048), (8, 2048, 4096))
NAMES = ("dlbb_tpu", "xla", "torch", "TPU", "tpu")


def _timings(rng, ranks, scale, iters=6):
    return (scale * rng.lognormal(0.0, 0.2, (ranks, iters))).tolist()


def _write(path: Path, data) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data))


def _result_1d(rng, impl, op, ranks, label, scale, dtype="bfloat16", backend=None, **extra):
    out = {"mpi_implementation": impl, "operation": op, "num_ranks": ranks,
           "data_size_name": label, "num_elements": SIZES[label], "dtype": dtype,
           "timings": _timings(rng, ranks, scale), **extra}
    if backend is not None:
        out["system_info"] = {"backend": backend}
    return out


def _result_3d(rng, op, ranks, shape, scale, backend=None):
    b, s, h = shape
    out = {"operation": op, "num_ranks": ranks, "num_elements": b * s * h,
           "tensor_shape": {"batch": b, "seq_len": s, "hidden_dim": h},
           "tensor_size_mb": b * s * h * 2 / 2**20, "timings": _timings(rng, ranks, scale)}
    if backend is not None:
        out["system_info"] = {"backend": backend}
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("report_fixtures")
    rng = np.random.default_rng(11)
    ref = root / "reference"
    for backend, slow in (("openmpi", 1.0), ("dsgloo", 1.3)):
        for op in OPS:
            for ranks in RANKS:
                for i, label in enumerate(SIZES):
                    _write(ref / "collectives/1d/results" / backend
                           / f"{op}_{ranks}_{label}.json",
                           _result_1d(rng, backend, op, ranks, label,
                                      slow * 1e-5 * (4 ** i),
                                      dtype="<class 'numpy.float16'>"))
        for op in ("allreduce", "allgather"):
            for ranks in RANKS:
                for shape in SHAPES:
                    _write(ref / "collectives/3d/results" / backend
                           / f"{op}_{ranks}_{'_'.join(map(str, shape))}.json",
                           _result_3d(rng, op, ranks, shape, slow * 2e-3))
    own1d, own3d = root / "own1d", root / "own3d"
    for op in OPS + ("allreduce_q",):
        for ranks in RANKS:
            for i, label in enumerate(SIZES):
                for dtype, backend in (("bfloat16", "cuda"), ("float32", "cpu")):
                    extra = {"compression": "fp8"} if op == "allreduce_q" else {}
                    _write(own1d / f"torch_nccl_{op}_ranks{ranks}_{label}_{dtype}.json",
                           _result_1d(rng, "torch_nccl", op, ranks, label,
                                      1e-5 * (4 ** i) * rng.uniform(0.5, 1.5),
                                      dtype=dtype, backend=backend, **extra))
    for op in ("allreduce", "allgather", "broadcast"):
        for ranks in RANKS:
            for shape in SHAPES:
                _write(own3d / f"torch_nccl_{op}_ranks{ranks}_{shape}.json",
                       _result_3d(rng, op, ranks, shape, 2e-3 * rng.uniform(0.5, 1.5),
                                  backend="cuda" if ranks == 2 else "cpu"))
    # per-variant 1D stats, through the port's stats1d
    variants = root / "stats" / "variants"
    for impl in ("torch_nccl", "torch_nccl_ring", "torch_nccl_compress_int8"):
        raw = root / "raw_variants" / impl
        for ranks in (1, 2, 4, 8):
            for i, label in enumerate(SIZES):
                if impl == "torch_nccl_ring" and label == "1MB":
                    continue  # a variant missing a row
                _write(raw / f"{impl}_allreduce_ranks{ranks}_{label}.json",
                       _result_1d(rng, impl, "allreduce", ranks, label,
                                  1e-5 * (4 ** i) * rng.uniform(0.5, 1.5)))
        process_1d_results(raw, variants / impl, verbose=False)
    process_1d_results(own1d, root / "stats" / "1d" / "torch_nccl", verbose=False)
    # 3D variant stats: the baseline's standard CSV and two variants'
    cols = ["implementation", "operation", "num_ranks", "hidden_dim", "seq_len", "batch",
            "mean_time_ms"]
    for impl, where in (("xla_tpu", root / "stats/3d/xla_tpu/benchmark_statistics_3d_"
                                          "xla_tpu_standard.csv"),
                        ("grid2x2", root / "stats/variants3d/grid2x2/std_standard.csv"),
                        ("ring", root / "stats/variants3d/ring/std_standard.csv")):
        where.parent.mkdir(parents=True, exist_ok=True)
        with where.open("w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=cols)
            w.writeheader()
            for ranks in RANKS:
                for b, s, h in SHAPES:
                    if impl == "ring" and b == 8:
                        continue
                    w.writerow({"implementation": impl, "operation": "allreduce",
                                "num_ranks": ranks, "hidden_dim": h, "seq_len": s,
                                "batch": b, "mean_time_ms": rng.uniform(1, 3)})
    # train results of the parallelism families and the long-context grid
    par = root / "results" / "parallelism"
    for name, mesh in (("pp2_gpipe", {"dp": 1, "pp": 2, "tp": 1}),
                       ("pp2_1f1b", {"dp": 1, "pp": 2, "tp": 1}),
                       ("sp2_ring", {"dp": 1, "sp": 2, "tp": 1}),
                       ("sp2_ulysses", {"dp": 1, "sp": 2, "tp": 1}),
                       ("ep2_moe_dense", {"dp": 2, "ep": 2, "tp": 1}),
                       ("ep2_moe_capacity", {"dp": 2, "ep": 2, "tp": 1}),
                       ("ga2_divisible_b16", {"dp": 4, "tp": 1})):
        _write(par / f"train_zero1_{name}.json",
               {"experiment": {"name": name}, "mesh": mesh,
                "step_time": {"mean": float(rng.uniform(0.1, 0.3))},
                "tokens_per_second": float(rng.uniform(1e4, 2e4))})
    for seq in (1024, 4096):
        for sp in (2, 4):
            for impl in ("ring", "ulysses"):
                name = f"cp_s{seq}_sp{sp}_{impl}"
                data = {"experiment": {"name": name},
                        "tokens_per_second": float(rng.uniform(1e3, 2e3))}
                if seq == 4096 and sp == 4 and impl == "ulysses":
                    data = {"experiment": {"name": name},
                            "status": "skipped_estimated_footprint",
                            "estimated_bytes": 3 * 2**30}
                _write(par / "cp_scaling" / f"train_ddp_{name}.json", data)
    return root


def _files(d: Path, pattern: str) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(Path(d).glob(pattern))}


def _md_lines(path: Path) -> list[str]:
    """The table rows, summary bullets and section headings that name
    neither package nor implementation."""
    return [line for line in Path(path).read_text().splitlines()
            if line.startswith(("|", "- **", "## ")) and not any(n in line for n in NAMES)]


def _same_outputs(jax_dir: Path, port_dir: Path, md: str) -> None:
    want, got = _files(jax_dir, "*.csv"), _files(port_dir, "*.csv")
    assert want and got == want
    assert _md_lines(port_dir / md) == _md_lines(jax_dir / md)
    assert len(_md_lines(port_dir / md)) > 2


def test_compare_matches_jax(corpus, tmp_path):
    args = (corpus / "reference", corpus / "own1d", corpus / "own3d")
    want = jax_compare.write_comparison(*args, tmp_path / "jax")
    got = pt_compare.write_comparison(*args, tmp_path / "port")
    _same_outputs(tmp_path / "jax", tmp_path / "port", "COMPARISON.md")
    for dim in ("1d", "3d"):
        assert got[dim] == want[dim] and got[dim]["rows"] > 0
    assert got["implementation"] == "torch_nccl"
    rows = list(csv.DictReader((tmp_path / "port" / "comparison_1d.csv").open()))
    assert {r["verdict"] for r in rows} >= {pt_compare.NOT_COMPARABLE}
    assert all(r["xla_bytes_on_wire"] for r in rows)


def test_compare_constants_are_jax_copies():
    assert (pt_compare.BEAT, pt_compare.LOSE) == (jax_compare.BEAT, jax_compare.LOSE)
    assert pt_compare.NOT_COMPARABLE == jax_compare.NOT_COMPARABLE
    assert pt_compare.COLUMNS_1D == jax_compare.COLUMNS_1D
    assert pt_compare.COLUMNS_3D == jax_compare.COLUMNS_3D
    rows = [{"a": 1, "b": None}, {"a": "x", "b": 2.5}]
    assert pt_compare.md_table(rows, ["a", "b"]) == jax_compare.md_table(rows, ["a", "b"])


def _e2e_result(backend, device_backend, name, batch=8, seq=512, size="1B", mesh=None):
    return {"experiment": {"name": name}, "backend": backend,
            "config": {"model": {"size": size, "attention": "full", "dtype": "bfloat16"},
                       "input": {"batch_size": batch, "sequence_length": seq}},
            "mesh": mesh or {"dp": 1, "tp": 1}, "tokens_per_second": 123456.0,
            "system_info": {"backend": device_backend, "device_kind": "NVIDIA H100",
                            "num_devices": 1}}


def test_compare_e2e_reads_only_the_ports_own_results(tmp_path):
    """A speedup is claimed only for the port's run on the card at the
    baseline's model and shape; a JAX result in the same directory, and the
    JAX package's BENCH_r*.json beside the baseline, are never read."""
    e2e = tmp_path / "e2e"
    _write(e2e / "torch_cuda_1b.json", _e2e_result("torch_cuda", "cuda", "1b"))
    _write(e2e / "torch_cuda_1b_s256.json", _e2e_result("torch_cuda", "cuda", "1b_s256",
                                                        seq=256))
    _write(e2e / "torch_cuda_cpu.json", _e2e_result("torch_cuda", "cpu", "cpu_run"))
    _write(e2e / "xla_tpu_1b.json", _e2e_result("xla_tpu", "tpu", "jax"))
    _write(tmp_path / "BENCH_r01.json", {"unit": "tokens/s", "value": 1.0})
    base = REPO / "bench_baseline_cpu.json"
    rows = pt_compare._e2e_rows(e2e, base)
    assert [r["config"].split(" ")[0] for r in rows] == ["1b", "1b_s256", "cpu_run"]
    tps = json.loads(base.read_text())["tokens_per_second"]
    assert rows[0]["speedup"] == round(123456.0 / tps, 2) and rows[0]["verdict"] == "beat"
    assert rows[1]["speedup"] is None and rows[2]["speedup"] is None
    summary = pt_compare.write_comparison(tmp_path / "none", tmp_path / "n1",
                                          tmp_path / "n3", tmp_path / "out",
                                          own_e2e=e2e, baseline_json=base)
    assert len(summary["e2e"]) == 3
    assert "torch_nccl" in (tmp_path / "out" / "COMPARISON.md").read_text()


def test_no_port_module_reads_bench_r_files():
    """No string of the port's code (docstrings aside) names the JAX
    package's BENCH_r*.json."""
    for path in (REPO / "dlbb_tpu_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
                and isinstance(n.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docs:
                assert "BENCH_r" not in node.value, path


@pytest.mark.parametrize("ranks,primary", [((2, 4, 8), 8), ((1, 2), 4)])
def test_variants_report_matches_jax(corpus, tmp_path, ranks, primary):
    root = corpus / "stats" / "variants"
    want = jax_variants.write_variants_report(root, tmp_path / "jax", rank_counts=ranks,
                                              primary_ranks=primary,
                                              baseline_impl="torch_nccl")
    got = pt_variants.write_variants_report(root, tmp_path / "port", rank_counts=ranks,
                                            primary_ranks=primary)
    assert got == want and got["winners"]
    _same_outputs(tmp_path / "jax", tmp_path / "port", "VARIANTS.md")


def test_variants_size_labels_parse_as_jax():
    for label in ("1KB", "64KB", "16MB", "1GB", "x", " 2MB "):
        assert pt_variants._parse_size_label(label) == jax_variants._parse_size_label(label)


def test_variants3d_report_matches_jax(corpus, tmp_path):
    root = corpus / "stats" / "variants3d"
    want = jax_variants.write_variants3d_report(root, out_dir=tmp_path / "jax")
    got = pt_variants.write_variants3d_report(root, out_dir=tmp_path / "port",
                                              baseline_impl="xla_tpu")
    assert got == want and got
    _same_outputs(tmp_path / "jax", tmp_path / "port", "VARIANTS3D.md")


def test_northstar_matches_jax(corpus, tmp_path):
    stats = corpus / "stats" / "1d" / "torch_nccl" / "benchmark_statistics.csv"
    assert pt_northstar.default_stats_1d_csv(corpus / "stats") == stats
    want = jax_northstar.write_northstar_report(stats, tmp_path / "jax")
    got = pt_northstar.write_northstar_report(stats, tmp_path / "port")
    assert got == want and set(got) == set(OPS)
    _same_outputs(tmp_path / "jax", tmp_path / "port", "NORTHSTAR.md")
    assert pt_northstar.write_northstar_report(tmp_path / "absent.csv", tmp_path / "x") == {}


def test_parallelism_report_matches_jax(corpus, tmp_path):
    par = corpus / "results" / "parallelism"
    assert pt_par.DEFAULT_FAMILIES == jax_par.DEFAULT_FAMILIES
    want = jax_par.write_parallelism_report(par, tmp_path / "jax", jax_par.DEFAULT_FAMILIES)
    got = pt_par.write_parallelism_report(par, tmp_path / "port", pt_par.DEFAULT_FAMILIES)
    assert got == want
    # the member the port cannot produce is listed, with null times
    missing = [r for r in got if r["member"] == "ga2_reshard_b20"]
    assert missing and missing[0]["tokens_per_second"] is None
    _same_outputs(tmp_path / "jax", tmp_path / "port", "PARALLELISM.md")


def test_cp_scaling_report_matches_jax(corpus, tmp_path):
    cp = corpus / "results" / "parallelism" / "cp_scaling"
    want = jax_par.write_cp_scaling_report(cp, tmp_path / "jax")
    got = pt_par.write_cp_scaling_report(cp, tmp_path / "port")
    assert got == want and len(got) == 4
    _same_outputs(tmp_path / "jax", tmp_path / "port", "CP_SCALING.md")


def test_cli_compare_writes_its_files(corpus, tmp_path, capsys):
    out = tmp_path / "cmp"
    assert cli.main(["compare", "--reference", str(corpus / "reference"),
                     "--own-1d", str(corpus / "own1d"), "--own-3d", str(corpus / "own3d"),
                     "--own-e2e", str(tmp_path / "none"), "--output", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "1d: 3 configs" not in printed and printed.startswith("1d: ")
    assert f"report written to {out}/COMPARISON.md" in printed
    for name in ("COMPARISON.md", "comparison_1d.csv", "comparison_3d.csv",
                 "comparison_summary.json"):
        assert (out / name).is_file()


def test_cli_reports_writes_its_files(corpus, tmp_path, capsys):
    import shutil

    stats = tmp_path / "stats"
    shutil.copytree(corpus / "stats", stats)
    assert cli.main(["reports", "--stats", str(stats),
                     "--results", str(corpus / "results")]) == 0
    printed = capsys.readouterr().out
    for key in ("variants:", "variants3d:", "parallelism:", "cp_scaling:", "northstar:"):
        assert key in printed
    for rel in ("variants/VARIANTS.md", "variants/variants_comparison.csv",
                "parallelism/PARALLELISM.md", "parallelism/CP_SCALING.md",
                "northstar/NORTHSTAR.md", "northstar/northstar_allreduce.csv"):
        assert (stats / rel).is_file(), rel
    # the 3D variants join each other where the baseline's corpus is absent
    assert (stats / "variants3d" / "VARIANTS3D.md").is_file()


def test_cli_reports_with_nothing_to_report_fails(tmp_path, capsys):
    assert cli.main(["reports", "--stats", str(tmp_path / "s"),
                     "--results", str(tmp_path / "r")]) == 1
    assert "nothing to report" in capsys.readouterr().out


@pytest.mark.parametrize("rel,item", [("BENCH_autotune.json", "item 14")])
def test_cli_reports_refuses_unported_inputs(tmp_path, rel, item, capsys):
    """No input is refused any more: the autotuner's bench (``rel``, item 14,
    part 14b) is ported, and ``cli reports`` writes ``AUTOTUNE.md`` from it,
    its measured rows JAX's ``write_autotune_report``'s
    (``tests/test_torch_autotune.py`` holds the text); a bench without
    measured rows writes nothing and is no report."""
    from dlbb_tpu.stats.parallelism_report import write_autotune_report

    bench = {"schema": "dlbb_bench_autotune_v1", "target": "serving", "devices": 2,
             "searched": 80, "pruned": {"validation-reject": 28, "infeasible-hbm": 0,
                                        "cm2-fit-missing": 0},
             "tier": {"name": "cpu-sim", "fit": {"fit_version": 2}}, "ranked": [{}] * 52,
             "default_plan": "serve[dp1,tp2,K1,W1]", "speedup_vs_default": 3.4,
             "agreement": {"rows": [
                 {"plan": "serve[dp2,tp1,K16,W2]", "role": "top-k", "predicted_us": 2657.0,
                  "predicted_rank": 1, "measured_rank": 1, "goodput_tokens_per_s": 633.8},
                 {"plan": "serve[dp1,tp2,K1,W1]", "role": "default-heuristic",
                  "predicted_us": 3017.1, "predicted_rank": 2, "measured_rank": 2,
                  "goodput_tokens_per_s": 186.4}],
                 "measured_winner": "serve[dp2,tp1,K16,W2]",
                 "predicted_winner": "serve[dp2,tp1,K16,W2]", "top2_contains": True}}
    _write(tmp_path / "results" / rel, {**bench, "agreement": {"rows": []}})
    args = ["reports", "--stats", str(tmp_path / "s"), "--results", str(tmp_path / "results")]
    assert cli.main(args) == 1  # no measured rows: nothing to report
    assert not (tmp_path / "s" / "parallelism" / "AUTOTUNE.md").exists()
    _write(tmp_path / "results" / rel, bench)
    assert cli.main(args) == 0
    assert "autotune: 2 measured plan(s)" in capsys.readouterr().out
    md = (tmp_path / "s" / "parallelism" / "AUTOTUNE.md").read_text()
    rows = write_autotune_report(tmp_path / "results" / rel, tmp_path / "jax")
    assert len(rows) == 2 and "**3.40x**" in md
    assert md.split("## Search accounting")[1] \
        == (tmp_path / "jax" / "AUTOTUNE.md").read_text().split("## Search accounting")[1]


def test_cli_reports_writes_the_serving_report(tmp_path, capsys):
    """``cli reports`` over ``RESULTS/serving``: ``stats/serving`` gets the
    CSV byte-equal to JAX's ``write_serving_report`` on the same reports,
    and the markdown too but for the command its prose names."""
    from dlbb_tpu.stats.serving_report import write_serving_report

    rng = np.random.default_rng(5)
    for name in ("a", "b"):
        q = sorted(rng.lognormal(-4.0, 0.5, 3).tolist())
        _write(tmp_path / "results" / "serving" / f"serving_{name}.json", {
            "schema": "dlbb_serving_report_v1",
            "trace": {"kind": "poisson", "num_requests": 10},
            "requests": {"arrived": 10, "completed": 9, "rejected": 1, "failed": 0,
                         "deadline_shed": 0, "completed_past_deadline": 1},
            "resilience": {"retries": int(rng.integers(0, 3))},
            "mesh": {"dp": 1, "sp": 1, "pp": 1, "ep": 1, "tp": 1},
            "serving": {"max_batch": 32, "block_size": 16, "max_seq": 2048},
            "goodput_tokens_per_s": float(rng.uniform(300, 400)),
            "ttft": dict(zip(("median", "p99", "p999"), q)),
            "per_token_latency": dict(zip(("median", "p99", "p999"), [x / 40 for x in q])),
            "cache": {"peak_blocks_in_use": 900},
            "timeseries": {"queue_depth": [0, 32, 0]},
            "decode_steps": 200,
            "wall_seconds": 12.5,
        })
    _write(tmp_path / "results" / "serving" / "serving_manifest.json", {"name": "a"})
    stats = tmp_path / "stats"
    assert cli.main(["reports", "--stats", str(stats),
                     "--results", str(tmp_path / "results")]) == 0
    assert f"serving: 2 run(s) -> {stats / 'serving' / 'SERVING.md'}" in \
        capsys.readouterr().out
    write_serving_report(tmp_path / "results" / "serving", tmp_path / "jax")
    assert (stats / "serving" / "serving.csv").read_bytes() == \
        (tmp_path / "jax" / "serving.csv").read_bytes()
    assert (stats / "serving" / "SERVING.md").read_text() == \
        (tmp_path / "jax" / "SERVING.md").read_text().replace(
            "`python -m dlbb_tpu.cli serve`", "`python -m dlbb_tpu_torch.cli serve`")
