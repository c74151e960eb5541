"""The schedule auditor (ROADMAP Queue 1, Slice F, item 15, part 15b:
``dlbb_tpu_torch/analysis/{op_capture,schedule_audit}.py``) against JAX's
``dlbb_tpu.analysis.schedule_audit``.

- The baseline gate's pure functions (``baseline_path``,
  ``snapshot_baselines``, ``load_baselines``, ``diff_baselines``) on the
  same meta dicts write the same files and give the same findings (rule,
  severity, target, details): growth past every slack, a new collective
  kind, a new low-precision site, tier skew, missing and stale baselines,
  a skipped target keeping its file, an improvement.
- Small graphs against JAX's HLO fixtures: each fixture's computation is
  captured in torch on a fake process group of 8 ranks (one process) and
  the pass's critical path, compute and comm totals equal JAX's
  ``analyze_schedule`` on the fixture to 1e-9 relative, with the same
  rules: ``test_costmodel_fit.py``'s ``_TINY_HLO``, and
  ``test_schedule_audit.py``'s ``WHILE_MODULE`` (the trip-count loop is
  three executed calls), ``ASYNC_MODULE`` (the async pair's window ends
  where the capture marks the wait), ``SERIALIZED_RING`` and
  ``OVERLAPPED_RING`` (ring hops through ``parallel/ring.py``).
  No torch form: the control-dependency fixture (eager torch has no
  control edge: an op depends on data only) and the conditional fixtures
  (eager torch has no ``conditional``; the divergence rule's port compares
  ranks, ``check_divergent_ranks``, held here on given sequences and in
  ``tests/test_torch_hlo_audit.py`` on 8 gloo ranks).
- The graph: buffer identity (a new tensor at a freed address is a new
  buffer), the edges, the product table's flops.
"""

import json

import pytest
import torch
import torch.distributed as dist
from test_costmodel_fit import _TINY_HLO
from test_schedule_audit import (
    ASYNC_MODULE,
    OVERLAPPED_RING,
    SERIALIZED_RING,
    WHILE_MODULE,
)

from dlbb_tpu.analysis import schedule_audit as jsa
from dlbb_tpu.analysis.costmodel import CostTier as JCostTier
from dlbb_tpu.analysis.expectations import TargetExpectation as JExp
from dlbb_tpu_torch.analysis import op_capture as oc
from dlbb_tpu_torch.analysis import schedule_audit as psa
from dlbb_tpu_torch.analysis.costmodel import CM2_VERSION, COST_MODEL_VERSION, CostTier
from dlbb_tpu_torch.analysis.expectations import TargetExpectation
from dlbb_tpu_torch.parallel.ring import FORWARD, Ring


@pytest.fixture(scope="module")
def fake8():
    """A fake process group of 8 ranks in this process (rank 0): its
    collectives return at once, so a capture records them as 8 real ranks
    would post them."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield dist.group.WORLD
    dist.destroy_process_group()


def _keys(meta):
    return {k: meta[k] for k in ("critical_path_us", "compute_total_us", "comm_total_us")}


def _same(port, jax):
    for k, v in _keys(jax).items():
        assert port[k] == pytest.approx(v, rel=1e-9, abs=1e-12), k


def _tiny(_):
    c = torch.tensor([1.0, 2.0, 3.0, 4.0])
    dist.all_reduce(c)
    return c


def _scanned(arg):
    for _ in range(3):
        dist.all_reduce(arg)
    return arg


def _async_gather(p, w):
    out = torch.empty((256, 32))
    work = dist.all_gather_into_tensor(out, p, async_op=True)
    dot_in = p @ w
    work.wait()
    oc.note_wait([out])
    dot_out = dot_in @ w
    return out + out, dot_out


def _ring(group):
    return Ring(group)


def _serialized(ring):
    def fn(p, w):
        cp1 = ring.shift([p], FORWARD)[0]
        cp2 = ring.shift([cp1 @ w], FORWARD)[0]
        return cp2 @ w

    return fn


def _overlapped(ring):
    def fn(p, w):
        hop = ring.start([(p, FORWARD)])
        dot1 = p @ w
        (cp1,) = hop.wait()
        hop = ring.start([(cp1, FORWARD)])
        dot2 = cp1 @ w
        hop.wait()
        return dot1 + dot2

    return fn


@pytest.mark.parametrize("case", ["tiny", "while", "async", "serialized", "overlapped"])
def test_small_graphs_equal_jax_fixtures(fake8, case):
    ring4 = dist.new_group([0, 1, 2, 3])
    ones = torch.ones
    fixtures = {
        "tiny": (_TINY_HLO, _tiny, (None,), {}),
        "while": (WHILE_MODULE, _scanned, (ones(64),), {}),
        "async": (ASYNC_MODULE, _async_gather, (ones(32, 32), ones(32, 32)), {}),
        "serialized": (SERIALIZED_RING, _serialized(_ring(ring4)),
                       (ones(128, 128), ones(128, 128)), {"expect_overlap": True}),
        "overlapped": (OVERLAPPED_RING, _overlapped(_ring(ring4)),
                       (ones(128, 128), ones(128, 128)), {"expect_overlap": True}),
    }
    hlo, fn, args, exp = fixtures[case]
    _, cap = oc.capture_call(fn, args, target=case)
    pf, pm = psa.analyze_schedule(cap, TargetExpectation(**exp), case, tier="cpu-sim")
    jf, jm = jsa.analyze_schedule(hlo, JExp(**exp), case, tier="cpu-sim")
    _same(pm, jm)
    assert [f.rule for f in pf] == [f.rule for f in jf]
    assert pm["total_wire_bytes"] == jm["total_wire_bytes"]
    assert pm["collective_kinds"] == jm["collective_kinds"]
    if case == "async":
        (c,) = pm["collectives"]
        assert c["async"] and c["straddling_flops"] == 2 * 32 * 32 * 32   # dot.in only
    if exp:
        assert pm["ring_hops"] == jm["ring_hops"]


def test_schedule_meta_carries_dispatch_overhead(fake8):
    """JAX's ``test_costmodel_fit.py::test_schedule_meta_carries_dispatch_
    overhead`` on the captured ``_TINY_HLO``: one call is one dispatch,
    priced at γ under a fitted tier and at 0 under cm1."""
    exp = TargetExpectation(allowed={"all-reduce"})
    fitted = CostTier(name="cpu-sim", alpha_us=10.0, beta_bytes_per_us=1000.0,
                      peak_flops_per_us=1000.0, gamma_dispatch_us=500.0, version=CM2_VERSION)
    _, cap = oc.capture_call(_tiny, (None,))
    _, meta = psa.analyze_schedule(cap, exp, "t", tier=fitted)
    assert meta["cost_model_version"] == CM2_VERSION
    assert meta["dispatch_count"] == 1
    assert meta["dispatch_overhead_us"] == pytest.approx(500.0)
    assert meta["predicted_wall_us"] == pytest.approx(meta["critical_path_us"] + 500.0)
    _, jmeta = jsa.analyze_schedule(_TINY_HLO, JExp(allowed={"all-reduce"}), "t",
                                    tier=JCostTier(**vars(fitted)))
    assert {k: meta[k] for k in ("critical_path_us", "dispatch_overhead_us",
                                 "predicted_wall_us")} == \
        {k: jmeta[k] for k in ("critical_path_us", "dispatch_overhead_us", "predicted_wall_us")}
    _, meta1 = psa.analyze_schedule(cap, exp, "t", tier="cpu-sim")
    assert meta1["cost_model_version"] == COST_MODEL_VERSION
    assert meta1["dispatch_overhead_us"] == 0.0
    assert meta1["predicted_wall_us"] == meta1["critical_path_us"]


def test_buffer_identity_and_edges():
    """A buffer is one allocation: a tensor made at a freed address is a new
    buffer; a view shares its base's; an in-place write depends on the
    earlier readers of what it overwrites."""

    def fn(x):
        a = x * 2
        ptr = a.data_ptr()
        v = a.view(4, 4)
        y = v.sum()
        del a, v
        b = torch.empty(16)          # the allocator may hand back a's block
        b.fill_(1.0)
        x.add_(1.0)                  # overwrites x after ``mul`` read it
        return y, b, ptr == b.data_ptr()

    (_, _, reused), cap = oc.capture_call(fn, (torch.ones(16),))
    ops = [n.op for n in cap.nodes]
    mul, view, total = (ops.index(o) for o in ("aten::mul.Tensor", "aten::view",
                                               "aten::sum"))
    empty, add = ops.index("aten::empty.memory_format"), ops.index("aten::add_.Tensor")
    nodes = cap.nodes
    assert nodes[view].out_kinds == ["view"] and nodes[view].outputs[0].buf == \
        nodes[mul].outputs[0].buf
    assert nodes[total].deps == [mul]                  # the view's reader reads a's buffer
    assert nodes[empty].outputs[0].buf != nodes[mul].outputs[0].buf
    assert mul in nodes[add].deps                      # write after read
    assert cap.arg_buffers == [nodes[mul].reads[0].buf]
    assert isinstance(reused, bool)


@pytest.mark.parametrize("fn,args,want", [
    (lambda a, b: a @ b, ((8, 16), (16, 4)), 2 * 8 * 4 * 16),
    (lambda a, b: torch.bmm(a, b), ((3, 8, 16), (3, 16, 4)), 2 * 3 * 8 * 4 * 16),
    (lambda a, b: torch.einsum("bsh,bsf->hf", a, b), ((2, 8, 16), (2, 8, 4)),
     2 * 16 * 4 * 2 * 8),
    (lambda a, b: torch.nn.functional.linear(a, b), ((2, 8, 16), (4, 16)), 2 * 2 * 8 * 4 * 16),
])
def test_product_flops(fn, args, want):
    """Each product is priced at 2·out·K whether it reaches the capture
    lowered (under autograd's absence here: ``mm``/``bmm``) or whole
    (under ``torch.inference_mode``: ``matmul``, ``einsum``, ``linear``)."""
    tensors = [torch.ones(s) for s in args]
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            _, cap = oc.capture_call(fn, tuple(tensors))
        assert sum(psa.node_flops(n) for n in cap.nodes) == want, mode


def test_divergent_ranks_rule_on_given_sequences():
    ab = [["all-reduce", 2, "a", [0, 1]], ["all-reduce", 2, "b", [0, 1]]]
    ba = [ab[1], ab[0]]
    tp0 = [["all-reduce", 4, "t0", [0, 1, 2, 3]]]
    tp1 = [["all-reduce", 4, "t1", [4, 5, 6, 7]]]
    assert psa.check_divergent_ranks({0: ab, 1: ab}, "t") == []
    # a prefill on the tp group of its slot: the other group posts nothing
    assert psa.check_divergent_ranks({0: tp0, 1: tp0, 4: [], 5: []}, "t") == []
    assert psa.check_divergent_ranks({0: tp0, 4: tp1}, "t") == []
    (f,) = psa.check_divergent_ranks({0: ab, 1: ba}, "t")
    assert f.rule == "divergent-branch-collectives" and f.severity == "error"
    assert set(f.details["ranks"]) == {"rank0", "rank1"}
    (f,) = psa.check_divergent_ranks({0: tp0, 1: []}, "t")
    assert "deadlock" in f.message


# ---------------------------------------------------------------------------
# the baseline gate, on the same meta dicts as JAX's
# ---------------------------------------------------------------------------


def _meta(**overrides):
    meta = {
        "cost_model_version": "cm1", "tier": "cpu-sim", "critical_path_us": 10.0,
        "comm_on_critical_path_us": 4.0, "comm_total_us": 6.0, "compute_total_us": 5.0,
        "overlap_efficiency": 0.5, "total_wire_bytes": 1000, "num_collectives": 3,
        "collective_kinds": {"all-reduce": 3}, "peak_live_bytes": 4096,
        "max_transient_bytes": 1024, "numerics_low_precision_sites": 0,
        "numerics_convert_count": 4, "numerics_max_rel_error_bound": 3.6e-7,
    }
    meta.update(overrides)
    return meta


def _findings(findings):
    return [(f.rule, f.severity, f.target, f.details) for f in findings]


@pytest.mark.parametrize("name", ["comm/ops.py::ag_matmul[ring]",
                                  "train/loop.py::train_step[dp,tp,overlap=ring]",
                                  "serve/engine.py::decode_step[int8,tp]", "a b::c", "__x__"])
def test_baseline_path_equals_jax(tmp_path, name):
    assert psa.baseline_path(tmp_path, name) == jsa.baseline_path(tmp_path, name)


@pytest.mark.parametrize("current", [
    {},
    {"critical_path_us": 11.5},
    {"total_wire_bytes": 1200},
    {"peak_live_bytes": 5000},
    {"max_transient_bytes": 2048},
    {"numerics_max_rel_error_bound": 1e-6},
    {"numerics_convert_count": 6},
    {"collective_kinds": {"all-reduce": 3, "all-gather": 1}},
    {"numerics_low_precision_sites": 1},
    {"tier": "cuda"},
    {"cost_model_version": "cm2"},
    {"critical_path_us": 5.0, "peak_live_bytes": 1000},
    {"critical_path_us": 10.9, "total_wire_bytes": 1099},
])
def test_diff_baselines_equals_jax(tmp_path, current):
    """Each slack, a new kind, a new low-precision site, tier and model
    skew, an improvement, and growth just under every slack."""
    base = {"t": _meta(), "u": _meta(total_wire_bytes=10)}
    pdir, jdir = tmp_path / "p", tmp_path / "j"
    psa.snapshot_baselines(base, pdir)
    jsa.snapshot_baselines(base, jdir)
    cur = {"t": _meta(**current), "u": _meta(total_wire_bytes=10)}
    assert _findings(psa.diff_baselines(cur, pdir)) == _findings(jsa.diff_baselines(cur, jdir))


def test_snapshot_and_bookkeeping_equal_jax(tmp_path):
    """The same files byte for byte; a missing directory, a target with no
    baseline, a stale baseline, and a skipped target keeping its file."""
    metas = {"a::x": _meta(), "b::y[1,2]": _meta(critical_path_us=3.0)}
    pdir, jdir = tmp_path / "p", tmp_path / "j"
    pw = psa.snapshot_baselines(metas, pdir)
    jw = jsa.snapshot_baselines(metas, jdir)
    assert [p.name for p in pw] == [p.name for p in jw]
    for p, j in zip(pw, jw):
        assert p.read_text() == j.read_text()
    assert psa.load_baselines(pdir) == jsa.load_baselines(jdir)
    assert json.loads(pw[0].read_text())["target"] == "a::x"
    # missing directory
    none = tmp_path / "none"
    assert _findings(psa.diff_baselines(metas, none))[0][:2] == \
        _findings(jsa.diff_baselines(metas, none))[0][:2] == ("missing-baseline", "error")
    # a new target, a stale one, a skipped one
    cur = {"a::x": _meta(), "c::z": _meta()}
    assert _findings(psa.diff_baselines(cur, pdir)) == _findings(jsa.diff_baselines(cur, jdir))
    assert _findings(psa.diff_baselines(cur, pdir, skipped_targets=("b::y[1,2]",))) == \
        _findings(jsa.diff_baselines(cur, jdir, skipped_targets=("b::y[1,2]",)))
    psa.snapshot_baselines({"a::x": _meta()}, pdir, skipped_targets=("b::y[1,2]",))
    jsa.snapshot_baselines({"a::x": _meta()}, jdir, skipped_targets=("b::y[1,2]",))
    assert sorted(p.name for p in pdir.iterdir()) == sorted(p.name for p in jdir.iterdir())
    psa.snapshot_baselines({"a::x": _meta()}, pdir)
    assert [p.name for p in pdir.iterdir()] == ["a_x.json"]


def test_slacks_equal_jax():
    for name in ("CRITICAL_PATH_SLACK", "WIRE_SLACK", "PEAK_MEMORY_SLACK",
                 "NUMERICS_ERROR_SLACK", "NUMERICS_CONVERT_SLACK", "_BASELINE_KEYS"):
        assert getattr(psa, name) == getattr(jsa, name), name
    assert str(psa.DEFAULT_BASELINE_DIR) == "stats/torch/analysis/baselines"
