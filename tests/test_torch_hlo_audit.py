"""The collective audit and the passes over the 41 targets (ROADMAP Queue
1, Slice F, item 15, part 15b: ``dlbb_tpu_torch/analysis/{op_capture,
hlo_audit,schedule_audit,memory_audit,numerics_audit}.py``, ``cli
analyze``) against JAX's ``dlbb_tpu.analysis``.

The port's targets carry JAX's ``default_targets()`` names, in JAX's order,
and JAX's byte ceilings, trip counts and donation flags (the four rooted
registry ops expect the native c10d kinds the port issues).  One launch of
8 gloo ranks (``tests/torch_audit_worker.py``) audits the whole default
registry, which is clean, and seeded violations, each of which gives JAX's
rule: a weight all-gathered where only all-reduce is allowed, an oversized
collective, a missing defining collective, a wire total over its ceiling,
a step that reallocates its state, a crashing target (contained); a
target needing more ranks than the world is skipped.  The capture's
pieces (the send/recv pairing, the flash launch deltas, the storages of
the state) and the train step's in-place update are held at world 1.

The same launch runs the schedule, memory and numerics passes on every
target (one call each): every target is clean, the committed baselines
under ``stats/torch/analysis/baselines`` diff clean, each target's wire
bytes, collective count and kinds equal JAX's committed baseline but for
the pinned exceptions (``INVENTORY_EXCEPTIONS``, each with its cause), its
compute total equals JAX's, its peak stays under JAX's ceiling, and a
seeded violation of each pass's rules gives JAX's rule.  ``cli analyze``
runs over the launch's reports: exit codes, the byte-identical snapshot,
the refused snapshot and the failing diff.
"""

import copy
import dataclasses
import inspect
import json
from pathlib import Path

import pytest
import torch

from dlbb_tpu.analysis import hlo_audit as jax_audit
from dlbb_tpu.analysis import memory_audit as jax_mem
from dlbb_tpu.analysis import numerics_audit as jax_num
from dlbb_tpu.analysis import schedule_audit as jax_sched
from dlbb_tpu_torch import analysis, cli
from dlbb_tpu_torch.analysis import fold_gate_keys
from dlbb_tpu_torch.analysis import hlo_audit as pt_audit
from dlbb_tpu_torch.analysis import op_capture
from dlbb_tpu_torch.analysis import schedule_audit as pt_sched
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu_torch.models import ModelConfig, init_params
from dlbb_tpu_torch.ops import flash_attention as fa
from dlbb_tpu_torch.train.loop import make_train_step
from dlbb_tpu_torch.train.optim import build_optimizer, tree_leaves

import torch_audit_worker

NATIVE_ROOTED = {"comm/ops.py::broadcast": "broadcast", "comm/ops.py::gather": "gather",
                 "comm/ops.py::scatter": "scatter", "comm/ops.py::reduce": "reduce"}


@pytest.fixture(scope="module")
def audits():
    """Rank 0's (default report under every pass, default metas, the
    collective audit's seeded report, the passes' seeded report) of one
    launch of 8 gloo ranks."""
    return launch(torch_audit_worker.run_audits, 8, "cpu", timeout=600)[0]


def test_target_names_equal_jax():
    assert [t.name for t in pt_audit.default_targets()] == \
        [t.name for t in jax_audit.default_targets()]
    assert len(pt_audit.default_targets()) == 41
    assert pt_audit._TINY_MODEL == jax_audit._TINY_MODEL
    assert pt_audit._MATMUL_SHAPE == jax_audit._MATMUL_SHAPE
    assert pt_audit._SERVE_SHAPE == jax_audit._SERVE_SHAPE


def test_target_ceilings_equal_jax():
    assert pt_audit._tiny_params_bytes() == jax_audit._tiny_params_bytes()
    for args in ((2, 4), (1, 4), (2, 4, 1), (1, 4, None, "int8")):
        assert pt_audit._serve_cache_bytes_per_device(*args) == \
            jax_audit._serve_cache_bytes_per_device(*args)
    for pt_t, jax_t in zip(pt_audit.default_targets(), jax_audit.default_targets()):
        got = dataclasses.asdict(pt_t.expectation)
        want = dataclasses.asdict(jax_t.expectation)
        if pt_t.name in NATIVE_ROOTED:
            want["allowed"] = want["required_any"] = {NATIVE_ROOTED[pt_t.name]}
        assert got == want, pt_t.name
        assert pt_t.min_devices == jax_t.min_devices, pt_t.name


def test_whole_default_registry_audits_clean_on_8_gloo_ranks(audits):
    default, metas, *_ = audits
    assert [f.render() for f in default.findings] == []
    assert default.targets_audited == [t.name for t in pt_audit.default_targets()]
    assert default.skipped_targets == []
    # the step and the serving programs update their state in place
    for name, meta in metas.items():
        exp = next(t for t in pt_audit.default_targets() if t.name == name).expectation
        if exp.expect_donation:
            assert meta["has_donation"], name
        if exp.required_any:
            assert meta["num_collectives"] >= exp.min_required, name
    assert metas["comm/ops.py::sendrecv"]["collectives"][0]["kind"] == "collective-permute"
    assert {c["kind"] for c in metas["comm/ops.py::broadcast"]["collectives"]} == {"broadcast"}
    assert metas["serve/engine.py::compact_gather[tp]"]["num_collectives"] == 0


@pytest.mark.parametrize("case,rule", [(c, r) for c, r, _ in torch_audit_worker.seeded_targets()
                                       if r is not None])
def test_seeded_violation_gives_jax_rule(audits, case, rule):
    seeded = audits[2]
    rules = {f.rule for f in seeded.findings if f.target == f"seeded::{case}"}
    assert rule in rules
    assert f'rule="{rule}"' in inspect.getsource(jax_audit)
    assert all(f.pass_name == "hlo" and f.severity == "error" for f in seeded.findings)


def test_crash_contained_controls_clean_and_too_few_ranks_skipped(audits):
    seeded = audits[2]
    flagged = {f.target for f in seeded.findings}
    assert "seeded::in_place_step" not in flagged
    assert "seeded::after_crash" in seeded.targets_audited
    assert "seeded::after_crash" not in flagged
    assert "seeded::crash" not in seeded.targets_audited
    assert seeded.skipped_targets == [{"target": "seeded::too_few_ranks",
                                       "reason": "needs 16 devices, 8 available"}]
    assert seeded.exit_code() == 1


def test_one_rank_skips_every_target():
    report = pt_audit.run_hlo_audit(device="cpu")
    assert report.targets_audited == []
    assert len(report.skipped_targets) == 41
    # every pass at world 1: still every target skipped, none refused
    report = pt_audit.run_hlo_audit(passes=("hlo", "schedule", "memory", "numerics"),
                                    device="cpu")
    assert report.targets_audited == [] and len(report.skipped_targets) == 41
    assert report.findings == []


def _collective_nodes(ops):
    """The recorder's graph of ``ops`` ((c10d op, kind, group size)), each
    permute paired as the capture pairs it."""
    rec, t = op_capture._Recorder(), torch.zeros(16)
    for op, kind, size in ops:
        node = rec.add_node(op_capture.OpNode(
            index=-1, op=op, kind=kind, group_size=size, result_bytes=64,
            stream_index=len(rec.nodes), lead=rec.ref(t)))
        if kind == "collective-permute":
            rec._pair(node)
    return rec.nodes


def test_send_recv_pairs_into_one_permute():
    send = ("c10d::send", "collective-permute", 2)
    recv = ("c10d::recv_", "collective-permute", 2)
    nodes = _collective_nodes([send, recv, ("c10d::allreduce_", "all-reduce", 8), recv])
    out = op_capture._collectives(nodes, "x")
    assert [(i.kind, i.index, i.group_size) for i in out] == [
        ("collective-permute", 1, 2), ("all-reduce", 2, 8), ("collective-permute", 3, 2)]
    assert (nodes[0].merged, nodes[1].partner, 0 in nodes[1].deps) == (True, 0, True)
    # a receive posted before its send: the send carries the pair in the
    # graph, the collective is read from the receive
    nodes = _collective_nodes([recv, send])
    [instr] = op_capture._collectives(nodes, "x")
    assert (instr.index, instr.op_name, instr.dtype, instr.shape) == \
        (0, "c10d::recv_", "float32", (16,))
    assert nodes[0].merged and 0 in nodes[1].deps


def test_capture_records_ops_launches_and_storages(monkeypatch):
    w = torch.ones(8)

    def fn(x):
        fa.flash_fwd_launches += 2
        w.mul_(x)
        return {"w": w, "y": x + 1}

    spec = op_capture.StateSpec(before=lambda args: [w], after=lambda out, args: [out["w"]])
    monkeypatch.setattr(fa, "flash_fwd_launches", fa.flash_fwd_launches)
    out, cap = op_capture.capture_call(fn, (torch.full((8,), 2.0),), state=spec)
    assert cap.flash_launches == {"flash_fwd_launches": 2, "flash_bwd_dq_launches": 0,
                                  "flash_bwd_dkv_launches": 0}
    assert cap.collectives == [] and cap.has_donation
    assert any(op.startswith("aten::mul") for op in cap.aten_ops)
    assert torch.equal(out["w"], torch.full((8,), 2.0))
    _, cap = op_capture.capture_call(lambda x: {"w": w * x}, (torch.ones(8),), state=spec)
    assert not cap.has_donation
    assert not op_capture.Capture().has_donation


def test_train_step_updates_its_state_in_place():
    """The step's state is the caller's parameters (JAX's donated ones) and
    Adam's moments, written in place: no copy is made of the parameters,
    nor a second state by the step."""
    cfg = ModelConfig(**pt_audit._TINY_MODEL)
    params = init_params(cfg, 0, "cpu")
    before = [p.clone() for p in tree_leaves(params)]
    step, state = make_train_step(cfg, build_optimizer({"learning_rate": 1e-3}), params,
                                  batch_size=2)
    storages = [op_capture._storage(p) for p in tree_leaves(params)]
    assert [op_capture._storage(p) for p in tree_leaves(state.params)] == storages
    x = torch.ones((2, 8, cfg.hidden_size))
    spec = pt_audit._train_state_spec()
    (new, loss), cap = op_capture.capture_call(step, (state, x, x.clone()), state=spec)
    assert cap.has_donation and len(cap.state_before) == 3 * len(before)
    assert cap.collectives == []
    assert new.step == 1 and torch.isfinite(loss)
    assert all(p.requires_grad for p in tree_leaves(new.params))
    assert [op_capture._storage(p) for p in tree_leaves(new.params)] == storages
    assert not all(torch.equal(a, b) for a, b in zip(before, tree_leaves(new.params)))


# ---------------------------------------------------------------------------
# the schedule, memory and numerics passes over the same launch
# ---------------------------------------------------------------------------

BASELINES = Path(__file__).resolve().parent.parent / "stats" / "torch" / "analysis" / "baselines"
JAX_BASELINES = BASELINES.parents[2] / "analysis" / "baselines"

# the targets whose collective inventory differs from JAX's committed
# baseline, with the cause, pinned to the port's (wire bytes, collectives,
# kinds, wire bytes by kind); tests/test_torch_inventory_pins.py holds each
# cause against JAX's HLO compiled on this host (the op names of the
# collectives the port does not issue, the wire of those it does)
_QKV = ("XLA's partitioner reshards the fused QKV projection's q/k/v slices across "
        "the tp shards (7 collective-permutes per layer and trip, op name "
        ".../closed_call/slice); each port tp rank holds its own q, k and v columns "
        "and issues none")
_SLOTS = ", and one all-gather with no op name of the int32 slot vector"
INVENTORY_EXCEPTIONS = {
    "comm/ops.py::broadcast": ("the native c10d op (PR 22)", 1792, 1, {"broadcast": 1},
                               {"broadcast": 1792}),
    "comm/ops.py::gather": ("the native c10d op (PR 22)", 7168, 1, {"gather": 1},
                            {"gather": 7168}),
    "comm/ops.py::reduce": ("the native c10d op (PR 22)", 1792, 1, {"reduce": 1},
                            {"reduce": 1792}),
    "comm/ops.py::scatter": ("the native c10d op (PR 22)", 14336, 1, {"scatter": 1},
                             {"scatter": 14336}),
    "models/transformer.py::forward[dp,tp]": (_QKV, 24576, 4, {"all-reduce": 4},
                                              {"all-reduce": 24576}),
    "serve/engine.py::prefill[dp,tp]": (_QKV, 24576, 4, {"all-reduce": 4},
                                        {"all-reduce": 24576}),
    "serve/engine.py::prefill_chunk[dp,tp]": (_QKV, 12288, 4, {"all-reduce": 4},
                                              {"all-reduce": 12288}),
    "serve/engine.py::decode_step[dp,tp]": (_QKV, 3072, 4, {"all-reduce": 4},
                                            {"all-reduce": 3072}),
    "serve/engine.py::decode_step[int8,tp]": (_QKV, 6144, 4, {"all-reduce": 4},
                                              {"all-reduce": 6144}),
    "models/transformer.py::forward[dp,tp,overlap=ring]": (
        _QKV + ", and one all-gather with no op name that XLA adds at the entry", 24576,
        24, {"collective-permute": 24}, {"collective-permute": 24576}),
    "models/transformer.py::forward[dp,tp,overlap=bidir]": (
        _QKV + ", and one all-gather with no op name that XLA adds at the entry", 24576,
        36, {"collective-permute": 36}, {"collective-permute": 24576}),
    "serve/engine.py::decode_fused[k4,dp,tp]": (
        _QKV + _SLOTS, 12288, 16, {"all-reduce": 16}, {"all-reduce": 12288}),
    "serve/engine.py::decode_fused_token[k4,dp,tp]": (
        _QKV + _SLOTS, 12288, 16, {"all-reduce": 16}, {"all-reduce": 12288}),
    "serve/engine.py::draft_scan[gamma4,dp,tp]": (
        _QKV + _SLOTS, 6144, 8, {"all-reduce": 8}, {"all-reduce": 6144}),
    "serve/engine.py::verify_step[gamma4,dp,tp]": (
        "an open fault of the port (ROADMAP Queue 3 item 6): its verify runs each of "
        "its gamma + 1 positions through the decode step's calls, 20 all-reduces of "
        "the same 15360 bytes JAX moves in 4 batched ones, and gathers tok and "
        "commits apart (2 all-gathers, 48 bytes) where JAX gathers one (8 bytes); "
        "and " + _QKV, 15408, 22, {"all-gather": 2, "all-reduce": 20},
        {"all-gather": 48, "all-reduce": 15360}),
    "train/loop.py::train_step[zero0,dp]": (
        "the same wire in another count: the port all-reduces each of its 15 "
        "gradient leaves once; the committed HLO all-reduced each scanned leaf per "
        "trip (27), and this host's XLA combines them (3)", 469511, 15,
        {"all-reduce": 15}, {"all-reduce": 469511}),
    "train/loop.py::train_step[zero1,dp]": (
        "the port's ZeRO-1 reduce-scatters each of the 12 sharded gradients "
        "(train/zero.py), where JAX's program all-reduces them whole (twice the "
        "bytes) and slices; the 12 parameter all-gathers and the 3 unsharded "
        "leaves' all-reduces are JAX's", 469511, 27,
        {"all-gather": 12, "all-reduce": 3, "reduce-scatter": 12},
        {"all-gather": 232512, "all-reduce": 4487, "reduce-scatter": 232512}),
    "train/loop.py::train_step[dp,tp,overlap=ring]": (
        "XLA's differentiated program reshards through its own collectives (the QKV "
        "slice permutes, pad all-gathers; an all-to-all in the committed HLO) and "
        "combines its all-reduces (the same 75146 bytes as the port's 24); the port "
        "issues 72 ring hops against JAX's 60 (PERF.md section 7)", 148874, 96,
        {"all-reduce": 24, "collective-permute": 72},
        {"all-reduce": 75146, "collective-permute": 73728}),
}


def _jax_baseline(name):
    return json.loads(jax_sched.baseline_path(JAX_BASELINES, name).read_text())


def test_every_pass_meta_for_every_target(audits):
    default, metas, *_ = audits
    names = [t.name for t in pt_audit.default_targets()]
    for section in (default.schedule, default.memory, default.numerics):
        assert sorted(section) == sorted(names)
    for name in names:
        assert metas[name]["schedule"]["tier"] == "cpu-sim"
        assert metas[name]["signature"] is not None


def test_diff_against_committed_baselines_is_clean(audits):
    default = copy.deepcopy(audits[0])
    fold_gate_keys(default)
    assert len(list(BASELINES.glob("*.json"))) == 41
    assert [f.render() for f in pt_sched.diff_baselines(default.schedule, BASELINES)] == []


@pytest.mark.parametrize("name", [t.name for t in jax_audit.default_targets()])
def test_inventory_and_compute_equal_jax_baselines(audits, name):
    """Wire bytes, collective count and kinds equal JAX's committed
    baseline except the pinned exceptions (each with its cause); the
    compute total equals JAX's to 1e-6 on every target (the port issues
    JAX's products)."""
    sched = audits[0].schedule[name]
    want = _jax_baseline(name)
    got = (sched["total_wire_bytes"], sched["num_collectives"], sched["collective_kinds"])
    if name in INVENTORY_EXCEPTIONS:
        kind_wire = {}
        for c in sched["collectives"]:
            kind_wire[c["kind"]] = kind_wire.get(c["kind"], 0) + c["wire_bytes"]
        assert (*got, kind_wire) == INVENTORY_EXCEPTIONS[name][1:]
        assert got != (want["total_wire_bytes"], want["num_collectives"],
                       want["collective_kinds"])
    else:
        assert got == (want["total_wire_bytes"], want["num_collectives"],
                       want["collective_kinds"])
    assert sched["compute_total_us"] == pytest.approx(want["compute_total_us"], rel=1e-6,
                                                      abs=1e-12)
    assert sched["cost_model_version"] == want["cost_model_version"]


def test_peaks_under_jax_ceilings(audits):
    for target in pt_audit.default_targets():
        peak = audits[0].memory[target.name]["peak_live_bytes"]
        assert peak <= target.expectation.max_peak_bytes, target.name


@pytest.mark.parametrize("case,rule", [(c, r) for c, r, _ in
                                       torch_audit_worker.seeded_pass_targets()])
def test_seeded_pass_violation_gives_jax_rule(audits, case, rule):
    passes = audits[3]
    assert f"seeded::{case}" in passes.targets_audited
    found = [f for f in passes.findings if f.target == f"seeded::{case}"]
    assert rule in {f.rule for f in found}
    source = "".join(inspect.getsource(m) for m in (jax_sched, jax_mem, jax_num))
    assert f'rule="{rule}"' in source
    assert passes.exit_code() == 1


@pytest.mark.parametrize("which,want", [("schedule", 0), ("memory", 0), ("numerics", 0),
                                        ("all", 0), ("snapshot", 0), ("diff", 0)])
def test_cli_analyze_passes_on_8_ranks(audits, monkeypatch, tmp_path, which, want):
    """``cli analyze ... --simulate 8`` over the launch's reports (the
    launch itself is ``_target_report``'s): the clean audit exits 0, its
    snapshot rewrites the committed baselines byte for byte, its diff is
    clean."""
    monkeypatch.setattr(analysis, "_target_report",
                        lambda *a: copy.deepcopy(audits[0]))
    base = tmp_path / "base"
    args = ["analyze", which, "--simulate", "8", "--output", str(tmp_path / "out")]
    args += ["--baselines", str(base if which == "snapshot" else BASELINES)]
    assert cli.main(args) == want
    if which == "snapshot":
        assert sorted(p.name for p in base.iterdir()) == \
            sorted(p.name for p in BASELINES.iterdir())
        for p in base.iterdir():
            assert p.read_text() == (BASELINES / p.name).read_text(), p.name
    if which in ("memory", "all"):
        assert (tmp_path / "out" / "memory_audit.json").is_file()
        assert "analysis_peak_live_bytes" in (tmp_path / "out" / "metrics.prom").read_text()


def test_cli_snapshot_refused_and_diff_fails_on_findings(audits, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(analysis, "_target_report", lambda *a: copy.deepcopy(audits[3]))
    base = tmp_path / "base"
    assert cli.main(["analyze", "snapshot", "--simulate", "8", "--baselines", str(base)]) == 1
    assert "snapshot refused" in capsys.readouterr().out and not base.exists()
    grown = copy.deepcopy(audits[0])
    grown.schedule["comm/ops.py::allreduce"]["critical_path_us"] *= 2
    monkeypatch.setattr(analysis, "_target_report", lambda *a: copy.deepcopy(grown))
    assert cli.main(["analyze", "diff", "--simulate", "8", "--baselines", str(BASELINES)]) == 1
    assert "critical-path-regression" in capsys.readouterr().out
