"""The collective audit (ROADMAP Queue 1, Slice F, item 15, part 15b's
collective pass: ``dlbb_tpu_torch/analysis/{op_capture,hlo_audit}.py``,
``cli analyze hlo``) against JAX's ``dlbb_tpu.analysis.hlo_audit``.

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
"""

import dataclasses
import inspect

import pytest
import torch

from dlbb_tpu.analysis import hlo_audit as jax_audit
from dlbb_tpu_torch.analysis import hlo_audit as pt_audit
from dlbb_tpu_torch.analysis import op_capture
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
    """Rank 0's (default report, default metas, seeded report) of one
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
    default, metas, _ = audits
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
    _, _, seeded = audits
    rules = {f.rule for f in seeded.findings if f.target == f"seeded::{case}"}
    assert rule in rules
    assert f'rule="{rule}"' in inspect.getsource(jax_audit)
    assert all(f.pass_name == "hlo" and f.severity == "error" for f in seeded.findings)


def test_crash_contained_controls_clean_and_too_few_ranks_skipped(audits):
    _, _, seeded = audits
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
    with pytest.raises(NotImplementedError, match="part 15b"):
        pt_audit.run_hlo_audit(passes=("hlo", "schedule"))


def test_send_recv_pairs_into_one_permute():
    t = torch.zeros(16)
    raw = [(0, "c10d::send", "collective-permute", [t], 64, 8, None),
           (1, "c10d::recv_", "collective-permute", [t], 64, 8, None),
           (2, "c10d::allreduce_", "all-reduce", [t], 64, 8, None),
           (3, "c10d::recv_", "collective-permute", [t], 64, 8, None)]
    out = op_capture._collectives(raw, "x")
    assert [(i.kind, i.index, i.group_size) for i in out] == [
        ("collective-permute", 1, 2), ("all-reduce", 2, 8), ("collective-permute", 3, 2)]


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
