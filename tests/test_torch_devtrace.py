"""Device traces (ROADMAP Queue 1, Slice F, item 13, part 13b:
``dlbb_tpu_torch/obs/{capture,devtrace,corpus}.py``, ``cli obs``, the
sweep's ``device_trace_dir`` and the serving capture).

The port's pure functions are held against JAX's ``dlbb_tpu.obs.devtrace``
on the same inputs: the committed golden capture
(``tests/data/golden_capture``) and the event lists built by JAX's own
fixtures (``tests/test_devtrace.py``'s ``_dev``, ``_annot``,
``_ring_events``, ``_write_capture``, ``_result_json``): the same timelines,
analyses, comm samples, gate findings, fail-closed findings and CSV rows.
The static column joins a schedule baseline directory: on JAX's committed
baselines and on a seeded one, the port's rows (static column included)
and gate findings equal JAX's; by default the port joins its own
committed baselines (``stats/torch/analysis/baselines``).

The captures themselves run in the port only (JAX's own captured-sweep test
is red on this host): one launch of 2 gloo ranks runs a captured and an
uncaptured sweep (stats-equal, ``obs devtrace`` green), a captured sweep
under an outer ``--trace`` session (the contained "broken profiler" case)
and a ``--trace`` of a sweep (one trace per rank); the serving capture runs
at world 1.
"""

import gzip
import json
from pathlib import Path

import pytest
from test_devtrace import _annot, _dev, _result_json, _ring_events, _write_capture

from dlbb_tpu.obs import devtrace as jdt
from dlbb_tpu_torch.analysis.findings import EXIT_CLEAN, EXIT_CRASH, EXIT_FINDINGS
from dlbb_tpu_torch.bench import runner
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu.analysis import schedule_audit as jax_schedule
from dlbb_tpu_torch.analysis import schedule_audit as pt_schedule
from dlbb_tpu_torch.obs import capture, run_obs
from dlbb_tpu_torch.obs import devtrace as pdt

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "data" / "golden_capture"
BASELINES = REPO / "stats" / "analysis" / "baselines"
PORT_BASELINES = REPO / "stats" / "torch" / "analysis" / "baselines"

# JAX's _dev/_annot event lists of tests/test_devtrace.py, by case
CASES = {
    "warmup": [_annot("warmup", 0, 100), _annot("measure", 200, 100),
               _dev("all-reduce.1", 10, 50), _dev("all-reduce.1", 220, 50),
               _dev("all-reduce.1", 400, 50)],
    "profile_rep": [_annot("profile_rep:cfg", 100, 200), _dev("all-gather.1", 150, 20),
                    _dev("all-gather.1", 500, 20)],
    "container": [_dev("call.3", 0, 100), _dev("convert_fusion.1", 1, 98),
                  _dev("all-reduce.1", 200, 10)],
    "async_pair": [_dev("all-gather-start.1", 0, 100), _dev("all-gather-done.1", 100, 0),
                   _dev("dot.1", 10, 50)],
    "ring_concurrent": _ring_events(concurrent=True),
    "ring_single_stream": _ring_events(concurrent=False),
    "hidden_ring": [e for i in range(4) for e in (
        _dev(f"collective-permute.{i}", i * 100, 80, tid=1),
        _dev(f"dot_fusion.{i}", i * 100 + 10, 60, tid=1))],
    "two_devices": [{"ph": "M", "pid": 7, "name": "process_name",
                     "args": {"name": "/device:TPU:0"}},
                    _dev("all-reduce.1", 0, 10, pid=7), _dev("fusion.1", 5, 10, pid=7, tid=2),
                    _dev("all-reduce.1", 0, 12, pid=8)],
}


def test_bucket_classification_matches_jax():
    names = ["all-reduce.2", "all-gather-start.1", "reduce-scatter.7", "all-to-all",
             "collective-permute.21", "collective-permute-done.3", "dot.39",
             "convolution.1", "broadcast_multiply_fusion", "convert_bitcast_fusion.5.clone",
             "convert.12", "partition-id.7", "call.3", "while.1"]
    assert [pdt.bucket_of(n) for n in names] == [jdt.bucket_of(n) for n in names]


@pytest.mark.parametrize("name,in_a2a,bucket", [
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", False,
     "collective"),
    ("ncclKernel_AllGather_RING_LL_Sum_int8_t", False, "collective"),
    ("ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL(x)", False, "collective"),
    ("ncclDevKernel_Broadcast_RING_LL(x)", False, "collective"),
    ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", False, "permute"),
    ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", True, "collective"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", False, "dot"),
    ("nvjet_hsh_256x128_64x4_1x2_h_bz_coopA_NTN", False, "dot"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64>(x)", False,
     "dot"),
    ("void flash_fwd_kernel<128, 64>(FlashParams)", False, "other"),
    ("void flash_bwd_dq_kernel<128>(x)", False, "other"),
    ("void at::native::reduce_kernel<512, 1>(x)", False, "other"),
    ("void at::native::vectorized_elementwise_kernel<4>(x)", False, "other"),
    ("c10d::allreduce_", False, "collective"),
    ("gloo:all_to_all", False, "collective"),
    ("c10d::send", False, "permute"),
    ("aten::mm", False, "dot"),
    ("aten::scatter_add_", False, "other"),
    ("aten::clone", False, "other"),
])
def test_kernel_and_cpu_op_buckets(name, in_a2a, bucket):
    """The port's bucket table: NCCL collectives and all-to-all (SendRecv
    inside the port's ``all-to-all`` annotation), a P2P SendRecv, cuBLAS and
    CUTLASS GEMMs, the flash kernels as JAX's Pallas call (``other``), and
    the CPU's c10d, gloo and aten ops."""
    assert pdt.kernel_bucket(name, in_a2a) == bucket


def _timeline_equal(path):
    port, jax = pdt.parse_capture(path), jdt.parse_capture(path)
    assert port == jax
    assert pdt.analyze_capture(port) == jdt.analyze_capture(jax)
    for buckets in (("collective", "permute"), None):
        assert pdt.device_comm_samples(port, 2, buckets) == \
            jdt.device_comm_samples(jax, 2, buckets)
    return port


def test_parse_golden_capture_equals_jax():
    """The committed golden capture (a sim-mesh allreduce capture) parses
    into JAX's 8 devices x one all-reduce each, the same timeline and the
    same analysis."""
    [trace] = capture.perfetto_trace_files(GOLDEN / "trace")
    timeline = _timeline_equal(trace)
    assert len(timeline["devices"]) == 8
    analysis = pdt.analyze_capture(timeline)
    by_name = {r["name"]: r for r in analysis["per_op"]}
    assert by_name["all-reduce.2"]["count"] == 8
    assert analysis["comm_events"] == 8


@pytest.mark.parametrize("case", sorted(CASES))
def test_fixture_captures_equal_jax(case, tmp_path):
    """JAX's fixture event lists (warmup exclusion, rep windows, containers,
    async pairs, rings, device grouping) parse and analyse as in JAX."""
    _timeline_equal(_write_capture(tmp_path, CASES[case]))


@pytest.mark.parametrize("kind", ["missing", "truncated", "empty"])
def test_fail_closed_captures_equal_jax(kind, tmp_path):
    path = tmp_path / "perfetto_trace.json.gz"
    good = gzip.compress(json.dumps({"traceEvents": [_dev("all-reduce.1", 0, 1)]}).encode())
    if kind == "truncated":
        path.write_bytes(good[: len(good) // 2])
    elif kind == "empty":
        with gzip.open(path, "wt") as f:
            json.dump({"traceEvents": [{"ph": "M", "pid": 1, "tid": 0,
                                        "name": "process_name",
                                        "args": {"name": "/host:CPU"}}]}, f)
    messages = []
    for mod in (pdt, jdt):
        with pytest.raises(mod.CaptureError) as e:
            mod.parse_capture(path)
        messages.append(str(e.value).split(" —")[0].split(" (")[0])
    assert messages[0] == messages[1]


def _kernel(name, ts, dur, stream=7):
    return {"ph": "X", "cat": "kernel", "pid": 0, "tid": stream, "ts": float(ts),
            "dur": float(dur), "name": name, "args": {"device": 0, "stream": stream}}


def _kineto(tmp_path, events, device):
    """A Kineto-shaped trace as the port's capture writes it."""
    path = tmp_path / "rank0" / capture.TRACE_FILE
    path.parent.mkdir(parents=True)
    with gzip.open(path, "wt") as f:
        json.dump({"dlbb_device": device, "traceEvents": events}, f)
    return path


def test_card_trace_counts_kernels_and_never_cpu_ops(tmp_path):
    """On the card the kernels are the device events (one device per GPU,
    a lane per stream) and CPU ops never are: a CUDA trace without kernels
    (CUPTI unavailable) fails closed."""
    host = {"ph": "X", "cat": "cpu_op", "pid": 99, "tid": 1, "ts": 0.0, "dur": 500.0,
            "name": "aten::mm"}
    rep = {"ph": "X", "cat": "user_annotation", "pid": 99, "tid": 1, "ts": 10.0,
           "dur": 200.0, "name": "profile_rep:fwd"}
    a2a = {"ph": "X", "cat": "user_annotation", "pid": 99, "tid": 1, "ts": 150.0,
           "dur": 50.0, "name": "all-to-all"}
    # Kineto's GPU-timeline copy of an annotation is no window
    gpu_warmup = {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7, "ts": 15.0,
                  "dur": 100.0, "name": "warmup"}
    events = [host, rep, a2a, gpu_warmup, _kernel("void flash_fwd_kernel<128>(x)", 20, 30),
              _kernel("nvjet_hsh_256x128", 60, 40, stream=9),
              _kernel("ncclDevKernel_SendRecv(x)", 100, 20),
              _kernel("ncclDevKernel_SendRecv(x)", 160, 20),
              {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7, "ts": 190.0,
               "dur": 5.0, "name": "Memcpy DtoD (Device -> Device)"},
              _kernel("void flash_fwd_kernel<128>(x)", 400, 30)]
    timeline = pdt.parse_capture(_kineto(tmp_path / "a", events, "cuda"))
    assert list(timeline["devices"]) == ["0"] and len(timeline["lanes"]) == 2
    assert timeline["device_events"] == 5 and timeline["excluded_warmup"] == 1
    analysis = pdt.analyze_capture(timeline)
    assert analysis["buckets_us"] == {"collective": 20.0, "permute": 20.0, "dot": 40.0,
                                      "fusion": 0.0, "other": 35.0}
    with pytest.raises(pdt.CaptureError, match="no device events"):
        pdt.parse_capture(_kineto(tmp_path / "b", [host, rep], "cuda"))
    # the same host op is a device event on a CPU run
    assert pdt.parse_capture(_kineto(tmp_path / "c", [host], "cpu"))["device_events"] == 1


def _launch(name, ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "pid": 99, "tid": 1, "ts": float(ts),
            "dur": 10.0, "name": name, "args": {"correlation": corr}}


def test_card_records_are_placed_by_their_launch(tmp_path):
    """A record of the card whose own timestamp lies outside the rep's
    window (the card's clock converted to the host's) is kept when its
    launch lies inside, and one launched outside, or inside the session's
    ``warmup`` guard, is excluded; the census counts the records found,
    excluded, and the work's launches that left none (not the guard's)."""
    rep = {"ph": "X", "cat": "user_annotation", "pid": 99, "tid": 1, "ts": 1000.0,
           "dur": 400.0, "name": "profile_rep:allreduce"}
    early = {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7, "ts": 100.0, "dur": 5.0,
             "name": "Memcpy DtoD (Device -> Device)", "args": {"correlation": 1}}
    kernel = _kernel("ncclDevKernel_AllReduce(x)", 1100, 20)
    kernel["args"]["correlation"] = 2
    outside = _kernel("void elementwise_kernel(x)", 1200, 20)
    outside["args"]["correlation"] = 3
    primer = {"ph": "X", "cat": "user_annotation", "pid": 99, "tid": 1, "ts": 900.0,
              "dur": 50.0, "name": "warmup"}
    fill = _kernel("void at::native::vectorized_elementwise_kernel<4>(x)", 1150, 2)
    fill["args"]["correlation"] = 6
    events = [primer, _launch("cudaLaunchKernel", 910, 6), fill, _launch("cudaLaunchKernel", 920, 7),
              rep, early, kernel, outside, _launch("cudaMemcpyAsync", 1050, 1),
              _launch("cudaLaunchKernel", 1080, 2), _launch("cudaLaunchKernel", 1500, 3),
              _launch("cudaLaunchKernel", 1300, 4), _launch("cudaStreamIsCapturing", 1310, 5)]
    timeline, census = pdt.parse_capture_census(_kineto(tmp_path / "a", events, "cuda"))
    assert [e["name"] for e in timeline["lanes"]["0/7"]] == [early["name"], kernel["name"]]
    assert census == {"total": 4, "excluded": 2, "launches_without_record": 1}
    assert timeline["excluded_warmup"] == 2
    assert pdt.parse_capture(_kineto(tmp_path / "b", events, "cuda")) == timeline
    with pytest.raises(pdt.CaptureError, match="no device events") as e:
        pdt.parse_capture(_kineto(tmp_path / "c", [rep, _launch("cudaMemcpyAsync", 1050, 1)],
                                  "cuda"))
    assert e.value.census == {"total": 0, "excluded": 0, "launches_without_record": 1}


def _without_static(report):
    rows = []
    for c in report["captures"]:
        c = dict(c)
        c.pop("static", None)
        rows.append(c)
    return rows


def test_run_walks_equal_jax(tmp_path):
    """The run-directory walk: no captures, a capture missing on disk, a
    contained run-time failure and a capture recorded from another cwd give
    JAX's findings and rows."""
    dirs = {name: tmp_path / name for name in ("none", "missing", "failed", "foreign")}
    for d in dirs.values():
        d.mkdir()
    (dirs["none"] / "unrelated.json").write_text("{}")
    _result_json(dirs["missing"], dirs["missing"] / "deleted_dir")
    path = _result_json(dirs["failed"], dirs["failed"] / "dev")
    data = json.loads(path.read_text())
    data["device_trace"].update(error="RuntimeError: profiler held", error_kind="RuntimeError")
    path.write_text(json.dumps(data))
    _write_capture(dirs["foreign"] / "captures" / "xla_tpu_fixture",
                   [_dev("all-gather.1", 0, 10)])
    _result_json(dirs["foreign"], Path("who/knows/where") / "captures" / "xla_tpu_fixture",
                 op="allgather", variant="default")
    for name, d in dirs.items():
        port, pf = pdt.analyze_run(d)
        jax, jf = jdt.analyze_run(d, BASELINES)
        assert [(f.rule, f.severity, f.target) for f in pf] == \
            [(f.rule, f.severity, f.target) for f in jf], name
        assert _without_static(port) == _without_static(jax), name
        assert port["op_samples"] == jax["op_samples"], name
        # on the same baselines the static column is JAX's too
        port, _ = pdt.analyze_run(d, BASELINES)
        assert port["captures"] == jax["captures"], name


def test_golden_capture_op_sample_equals_jax(tmp_path):
    """The golden capture's fit sample (device-timed: dispatches 0, flops
    0, the analytic wire joined from the artifact) as JAX mines it."""
    port, pf = pdt.run_devtrace(GOLDEN, out_dir=tmp_path / "p", verbose=False)
    jax, jf = jdt.run_devtrace(GOLDEN, out_dir=tmp_path / "j", baselines_dir=BASELINES,
                               verbose=False)
    assert not pf and not [f for f in jf if f.severity == "error"]
    assert port["op_samples"] == jax["op_samples"]
    [s] = port["op_samples"]
    assert (s["op"], s["wire_bytes"], s["dispatches"], s["tier"]) == \
        ("allreduce", 896, 0.0, "cpu-sim")
    # the per-op CSV rows are JAX's but for the static join's target
    import csv

    def rows(side):
        with open(tmp_path / side / "golden_capture.csv", newline="") as f:
            return [{k: v for k, v in r.items() if k != "target"} for r in csv.DictReader(f)]

    assert rows("p") == rows("j") and len(rows("p")) == 3
    md = (tmp_path / "p" / "golden_capture.md").read_text()
    assert "measured overlap" in md and "static overlap" in md and "schedule_audit" in md
    assert "stats/torch/analysis/baselines" in md


@pytest.mark.parametrize("case", ["ring_concurrent", "ring_single_stream", "hidden_ring"])
@pytest.mark.parametrize("op,variant", [("ag_matmul", "overlap_ring"),
                                        ("allreduce_q", "compress_int8"),
                                        ("allgather", "default")])
def test_gate_overlap_equals_jax(case, op, variant, tmp_path):
    """The static-vs-measured gate on a row given JAX's static overlap: the
    same findings as JAX's gate on the same row (an error on a
    concurrent runtime, a warning on a single stream, none for a hidden
    ring, a quantised ring or a fused op)."""
    timeline = pdt.parse_capture(_write_capture(tmp_path, CASES[case]))
    row = {"label": "x", "op": op, "variant": variant, **pdt.analyze_capture(timeline),
           "static": {"target": "comm/ops.py::ag_matmul[ring]", "overlap_efficiency": 0.87}}
    port, jax = [], []
    pdt._gate_overlap(dict(row), port)
    jdt._gate_overlap(dict(row), jax)
    assert [f.to_dict() for f in port] == [f.to_dict() for f in jax]
    if op == "ag_matmul" and case != "hidden_ring":
        assert port[0].severity == ("error" if case == "ring_concurrent" else "warning")


def test_serving_capture_phase_rows_equal_jax(tmp_path):
    cap = tmp_path / "cap_decode"
    _write_capture(cap, [_dev("all-reduce.1", 0, 10), _dev("loop_fusion.1", 20, 40)])
    report = {"schema": "dlbb_serving_report_v1", "observability": {"device_captures": [{
        "schema": "dlbb_device_capture_v1", "label": "serve_decode_fused_k2",
        "trace_dir": str(cap), "profile_reps": 1, "excluded_from_stats": True,
        "phase": "decode"}]}}
    (tmp_path / "serving_test.json").write_text(json.dumps(report))
    port, pf = pdt.analyze_run(tmp_path)
    jax, jf = jdt.analyze_run(tmp_path, BASELINES)
    assert pf == [] and [f.rule for f in jf] == []
    assert port["captures"] == jax["captures"]
    assert port["captures"][0]["phase"] == "decode"
    pdt.write_devtrace(port, pf, tmp_path / "p", "s")
    jdt.write_devtrace(jax, jf, tmp_path / "j", "s")
    assert (tmp_path / "p" / "s.csv").read_text() == (tmp_path / "j" / "s.csv").read_text()
    pj = json.loads((tmp_path / "p" / "s.json").read_text())
    jj = json.loads((tmp_path / "j" / "s.json").read_text())
    for d in (pj, jj):
        d.pop("baselines_dir")
        d.pop("static_note", None)
    assert pj == jj


def test_obs_exit_codes(tmp_path):
    (tmp_path / "unrelated.json").write_text("{}")
    assert run_obs("devtrace", journal=str(tmp_path), output=str(tmp_path / "o"),
                   verbose=False) == EXIT_FINDINGS
    assert run_obs("devtrace", journal=None, verbose=False) == EXIT_CRASH
    for which in ("calibrate", "diff", "nonsense"):
        assert run_obs(which, journal=str(tmp_path), verbose=False) == EXIT_CRASH
    # obs attribute (ported): a directory with neither a span trace nor a
    # journal is a crash, as in JAX (tests/test_torch_attribution.py)
    assert run_obs("attribute", journal=str(tmp_path), output=str(tmp_path / "a"),
                   verbose=False) == EXIT_CRASH
    # obs fit (ported): a tree without samples is a refused fit, a finding
    assert run_obs("fit", results=[str(tmp_path)], fit_dir=str(tmp_path / "db"),
                   verbose=False) == EXIT_FINDINGS
    assert not (tmp_path / "db").exists()
    _write_capture(tmp_path / "dev", [_dev("all-reduce.1", 0, 10)])
    _result_json(tmp_path, tmp_path / "dev", op="allreduce", variant="default")
    assert run_obs("devtrace", journal=str(tmp_path), output=str(tmp_path / "o"),
                   verbose=False) == EXIT_CLEAN


# --- captures in the port: one launch of 2 gloo ranks ------------------------

WORLD = 2
# the fields that differ between two runs of one config (JAX's volatile set)
_VOLATILE = {
    "timings", "timestamp", "compile_seconds", "compile_cache_hit",
    "forced_completion_s", "forced_completion_probe_skipped", "system_info",
    "device_trace", "per_iter_sanity_failed", "per_iter_median_s",
    "measurement_iterations", "warmup_iterations", "time_budget_s", "time_budget_clamped",
}


def _sweep(out, **kw):
    return runner.Sweep1D(implementation="dt", operations=("allreduce", "alltoall",
                                                           "sendrecv"),
                          data_sizes=(("1KB", 256),), rank_counts=(WORLD,), dtype="float32",
                          warmup_iterations=1, measurement_iterations=4,
                          output_dir=str(out), pipeline=False, **kw)


def _capture_jobs(root):
    """A rank body: a captured and an uncaptured sweep, a captured sweep
    inside an outer ``--trace`` session, and a ``--trace`` of a sweep."""
    from dlbb_tpu_torch import cli

    cli.sweep_worker(_sweep(root / "captured", device_trace_dir=str(root / "dev")), "cpu")
    cli.sweep_worker(_sweep(root / "uncaptured"), "cpu")
    cli.sweep_worker(_sweep(root / "held", device_trace_dir=str(root / "held_dev")), "cpu",
                     str(root / "outer"))
    cli.sweep_worker(_sweep(root / "traced"), "cpu", str(root / "whole"))
    return True


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    root = tmp_path_factory.mktemp("devtrace")
    assert launch(_capture_jobs, WORLD, "cpu", args=(root,), timeout=300) == [True] * WORLD
    return root


def test_captured_sweep_devtrace_green_and_stats_equivalent(captured, tmp_path):
    """JAX's gate in the port: a device-captured sweep stays equal to an
    uncaptured run in every field but the volatile set, each capture lists
    both ranks' traces, and ``obs devtrace`` on it exits 0 with every
    capture parsed and a fit sample per op."""
    root = captured
    names = sorted(p.name for p in (root / "captured").glob("dt_*.json"))
    assert names == sorted(p.name for p in (root / "uncaptured").glob("dt_*.json"))
    assert len(names) == 3
    for name in names:
        dc = json.loads((root / "captured" / name).read_text())
        du = json.loads((root / "uncaptured" / name).read_text())
        assert "device_trace" in dc and "device_trace" not in du
        assert sorted(set(dc) - _VOLATILE) == sorted(set(du) - _VOLATILE)
        for k in sorted(set(dc) & set(du) - _VOLATILE):
            assert dc[k] == du[k], k
        meta = dc["device_trace"]
        assert meta["excluded_from_stats"] is True and "error" not in meta
        assert [Path(p).parent.name for p in meta["rank_traces"]] == ["rank0", "rank1"]
        assert meta["trace_bytes"] > 0 and meta["wall_seconds"] > 0
    man = json.loads((root / "captured" / runner.MANIFEST_NAME).read_text())
    assert man["observability"]["device_captures"] == 3
    assert man["observability"]["device_trace_dir"] == str(root / "dev")
    rc = run_obs("devtrace", journal=str(root / "captured"), output=str(tmp_path),
                 verbose=False)
    assert rc == EXIT_CLEAN
    report = json.loads((tmp_path / "captured.json").read_text())
    rows = {c["op"]: c for c in report["captures"]}
    assert all("error" not in c for c in rows.values())
    # the static column: the port's committed baseline of each op's target
    for op, c in rows.items():
        base = json.loads(pt_schedule.baseline_path(
            PORT_BASELINES, pdt.audit_target_name(op, c["variant"])).read_text())
        assert c["static"]["target"] == base["target"]
        assert c["static"]["critical_path_us"] == base["critical_path_us"]
    assert rows["alltoall"]["buckets_us"]["collective"] > 0
    assert rows["sendrecv"]["buckets_us"]["permute"] > 0
    assert {s["op"] for s in report["op_samples"]} == {"allreduce", "alltoall", "sendrecv"}


def test_capture_inside_a_trace_session_is_contained(captured):
    """JAX's broken-profiler case: a capture under an outer ``--trace``
    session fails with an ``error`` in its metadata, counted in
    ``obs_device_capture_failures_total``; every config still measures and
    ``obs devtrace`` reports the captures as contained failures."""
    root = captured
    files = sorted((root / "held").glob("dt_*.json"))
    assert len(files) == 3
    for f in files:
        meta = json.loads(f.read_text())["device_trace"]
        assert meta["error_kind"] == "RuntimeError" and "already active" in meta["error"]
    man = json.loads((root / "held" / runner.MANIFEST_NAME).read_text())
    assert man["configs"]["measured"] == 3 and man["observability"]["device_captures"] == 0
    prom = (root / "held" / "metrics.prom").read_text()
    assert 'dlbb_obs_device_capture_failures_total{reason="RuntimeError"} 3' in prom
    report, findings = pdt.analyze_run(root / "held")
    assert {f.rule for f in findings} == {"capture-failed", "no-captures"}
    # the outer session's trace is each rank's own
    for r in range(WORLD):
        assert (root / "outer" / f"rank{r}" / capture.TRACE_FILE).exists()


def test_trace_of_a_sweep_writes_one_trace_per_rank(captured):
    root = captured
    for r in range(WORLD):
        data = json.loads(gzip.decompress(
            (root / "whole" / f"rank{r}" / capture.TRACE_FILE).read_bytes()))
        assert data["dlbb_device"] == "cpu"
        names = {e.get("name") for e in data["traceEvents"]}
        assert "c10d::allreduce_" in names


def test_serving_capture_gives_prefill_and_decode_rows(tmp_path):
    """``run_serving(device_trace=)`` at world 1: after the trace is served,
    one prefill and one fused decode scan are captured on fresh state, the
    report records them with their phases, and ``obs devtrace`` on the run
    directory is green with one row per phase."""
    from dlbb_tpu_torch.serve.bench import run_serving
    from dlbb_tpu_torch.serve.traffic import generate_trace

    config = {"experiment": {"name": "cap"},
              "model": dict(hidden_size=64, num_layers=2, num_heads=4, ffn_intermediate=128,
                            dtype="float32", attention="full"),
              "parallelism": {"data_parallel": 1, "world_size": 1},
              "serving": {"max_batch": 4, "block_size": 8, "max_seq": 64,
                          "queue_capacity": 64, "hbm_budget_gb": None,
                          "decode_horizon": 4}}
    trace = generate_trace("poisson", 4, seed=5, rate=200.0, prompt_range=(4, 12),
                           output_range=(3, 6))
    report = run_serving(config, trace, str(tmp_path / "run"), verbose=False,
                         device_trace=str(tmp_path / "dev"), device="cpu")
    from dlbb_tpu_torch.serve.engine import ServingConfig

    serving = ServingConfig.from_dict(config["serving"])
    bucket, k = serving.prefill_buckets[0], min(serving.fused_horizons)
    metas = report["observability"]["device_captures"]
    assert [(m["phase"], m["label"]) for m in metas] == [
        ("prefill", f"serve_prefill_b{bucket}"), ("decode", f"serve_decode_fused_k{k}")]
    assert metas[1]["decode_steps_per_scan"] == k
    assert all("error" not in m for m in metas)
    saved = json.loads((tmp_path / "run" / "serving_cap.json").read_text())
    assert saved["observability"]["device_trace_dir"] == str(tmp_path / "dev")
    assert run_obs("devtrace", journal=str(tmp_path / "run"), output=str(tmp_path / "o"),
                   verbose=False) == EXIT_CLEAN
    rows = json.loads((tmp_path / "o" / "run.json").read_text())["captures"]
    assert [r["phase"] for r in rows] == ["prefill", "decode"]
    assert all(r["device_events"] > 0 for r in rows)


def test_capture_without_a_device_event_fails_closed(tmp_path):
    """A capture whose trace holds no device event (on the card: CUPTI gave
    no kernel) records the failure in its metadata as devtrace would find
    it, and ``obs devtrace`` on a run recording it exits 1."""
    meta = capture.capture_device_trace(lambda _: None, lambda: None, tmp_path / "dev",
                                        "idle", device="cpu")
    assert meta["error_kind"] == "CaptureError" and "no device events" in meta["error"]
    assert meta["device_records"]["launches_without_record"] == 0 and meta["attempts"] == 1
    assert Path(meta["perfetto_trace"]).exists()
    (tmp_path / "run").mkdir()
    (tmp_path / "run" / "idle.json").write_text(json.dumps(
        {"operation": "allreduce", "timings": [[0.0]], "device_trace": meta}))
    assert run_obs("devtrace", journal=str(tmp_path / "run"), output=str(tmp_path / "o"),
                   verbose=False) == EXIT_FINDINGS
    findings = json.loads((tmp_path / "o" / "run.json").read_text())["findings"]
    assert [f["rule"] for f in findings] == ["capture-failed", "no-captures"]
    assert "no device events" in findings[0]["message"]


@pytest.mark.parametrize("op,variant", [("ag_matmul", "overlap_ring"), ("ag_matmul", "default"),
                                        ("matmul_rs", "overlap_bidir"),
                                        ("allreduce_q", "compress_fp8"),
                                        ("allgather", "default")])
def test_static_join_on_seeded_baselines_equals_jax(tmp_path, op, variant):
    """A run directory with one ring-hop capture joined against a seeded
    baseline directory, written by each side's ``snapshot_baselines``: the
    target name, the static column and the overlap gate's findings are
    JAX's."""
    assert pdt.audit_target_name(op, variant) == jdt.audit_target_name(op, variant)
    target = pdt.audit_target_name(op, variant)
    meta = {"cost_model_version": "cm1", "tier": "cpu-sim", "critical_path_us": 13.39,
            "overlap_efficiency": 0.87, "num_collectives": 7, "total_wire_bytes": 57344,
            "collective_kinds": {"collective-permute": 7}}
    pt_schedule.snapshot_baselines({target: meta}, tmp_path / "pb")
    jax_schedule.snapshot_baselines({target: meta}, tmp_path / "jb")
    run = tmp_path / "run"
    _write_capture(run / "captures" / "xla_tpu_fixture", CASES["ring_concurrent"])
    _result_json(run, run / "captures" / "xla_tpu_fixture", op=op, variant=variant)
    port, pf = pdt.analyze_run(run, tmp_path / "pb")
    jax, jf = jdt.analyze_run(run, tmp_path / "jb")
    assert [c["static"] for c in port["captures"]] == [c["static"] for c in jax["captures"]]
    assert port["captures"][0]["static"]["target"] == target
    assert [f.to_dict() for f in pf] == [f.to_dict() for f in jf]
    # no baseline for the target: no static column, no gate
    empty, ef = pdt.analyze_run(run, tmp_path / "none")
    assert empty["captures"][0]["static"] is None and ef == []


def test_cli_obs_devtrace_baselines_flag_equals_jax(tmp_path):
    """``cli obs devtrace --baselines DIR`` joins the static column against
    DIR, as JAX's flag does: on a seeded directory the row carries the
    target's column and both CLIs give the same exit code and findings; on
    a directory without the target the row has none."""
    from dlbb_tpu import cli as jax_cli
    from dlbb_tpu_torch import cli as pt_cli

    target = pdt.audit_target_name("ag_matmul", "overlap_ring")
    meta = {"cost_model_version": "cm1", "tier": "cpu-sim", "critical_path_us": 13.39,
            "overlap_efficiency": 0.87, "num_collectives": 7, "total_wire_bytes": 57344,
            "collective_kinds": {"collective-permute": 7}}
    pt_schedule.snapshot_baselines({target: meta}, tmp_path / "pb")
    jax_schedule.snapshot_baselines({target: meta}, tmp_path / "jb")
    run = tmp_path / "run"
    _write_capture(run / "captures" / "xla_tpu_fixture", CASES["ring_single_stream"])
    _result_json(run, run / "captures" / "xla_tpu_fixture", op="ag_matmul",
                 variant="overlap_ring")
    reports = {}
    for side, main, base in (("p", pt_cli.main, "pb"), ("j", jax_cli.main, "jb"),
                             ("none", pt_cli.main, "none")):
        rc = main(["obs", "devtrace", "--journal", str(run), "--output",
                   str(tmp_path / side), "--baselines", str(tmp_path / base)])
        reports[side] = (rc, json.loads((tmp_path / side / "run.json").read_text()))
    (prc, port), (jrc, jax) = reports["p"], reports["j"]
    assert prc == jrc
    assert port["captures"][0]["static"]["target"] == target
    assert [c["static"] for c in port["captures"]] == [c["static"] for c in jax["captures"]]
    assert port["findings"] == jax["findings"]
    assert reports["none"][1]["captures"][0]["static"] is None
