"""The numerics auditor and its fp64 shadow (ROADMAP Queue 1, Slice F, item
15, part 15b: ``dlbb_tpu_torch/analysis/{numerics_audit,numerics_shadow}.py``)
against JAX's ``dlbb_tpu.analysis.numerics_audit`` and ``numerics_shadow``.

- The error-bound model is JAX's: ``unit_roundoff``,
  ``accumulation_error_bounds``, the dtype tables and the floors.
- Small graphs against JAX's seeded fixtures of
  ``tests/test_numerics_audit.py``, each in its torch form, give JAX's
  rules: the low-precision accumulation (a bf16 add chain over 4096 values;
  the f32 chain clean), the silent upcast across a collective (on a fake
  process group of 8 ranks) and in the state (JAX's while carry), the
  quantise roundtrip, its masked form, the legitimate ring-hop and merge
  requantisations, convert churn and the narrowing clamp, the
  nondeterministic reduction, and the policy checks (an f64 tensor; a bf16
  argument and a short bf16 accumulation under an f32 policy, clean under
  bf16).  No torch form: the fused-scan fixture's fusion-body walk (eager
  torch fuses nothing).
- ``numerics_metrics`` writes JAX's ``metrics.prom`` lines.
- The shadow's four cases equal JAX's committed report: the same flags and
  bounds, and each ``measured_rel_error`` within 1e-12; the port's committed
  report is the shadow's output.
"""

import json
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from dlbb_tpu.analysis import numerics_audit as jna
from dlbb_tpu_torch.analysis import numerics_audit as pna
from dlbb_tpu_torch.analysis import numerics_shadow as psh
from dlbb_tpu_torch.analysis import op_capture as oc
from dlbb_tpu_torch.analysis.expectations import TargetExpectation

REPO = Path(__file__).resolve().parent.parent
JAX_SHADOW = REPO / "stats" / "analysis" / "numerics" / "shadow_report.json"
PORT_SHADOW = REPO / "stats" / "torch" / "analysis" / "numerics" / "shadow_report.json"


@pytest.fixture(scope="module")
def fake8():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield
    dist.destroy_process_group()


def _audit(fn, args, state=None, **exp):
    _, cap = oc.capture_call(fn, args, state=state)
    findings, meta = pna.analyze_numerics(cap, TargetExpectation(**exp), "t")
    return sorted(f.rule for f in findings), findings, meta


def test_bounds_and_tables_equal_jax():
    for d in ("f64", "f32", "f16", "bf16", "s8", "f8e4m3fn", "pred"):
        assert pna.unit_roundoff(d) == jna.unit_roundoff(d)
    for n in (0, 1, 2, 3, 64, 4096, 4097):
        for d in ("f32", "bf16", "f16", "f64"):
            assert pna.accumulation_error_bounds(n, d) == jna.accumulation_error_bounds(n, d)
    for name in ("SIGNIFICAND_BITS", "LOW_PRECISION_DTYPES", "QUANT_DTYPES",
                 "LOW_PRECISION_ACCUM_FLOOR", "UPCAST_BYTES_FLOOR", "POLICY_BYTES_FLOOR",
                 "NUMERICS_REPORT_SCHEMA", "NUMERICS_REPORT_NAME"):
        assert getattr(pna, name) == getattr(jna, name), name


def _chain(x):
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def _ladder(v):
    while v.shape[0] > 1:
        v = v[0::2] + v[1::2]
    return v[0]


def test_low_precision_accumulation():
    rules, findings, meta = _audit(_chain, (torch.ones(4096, dtype=torch.bfloat16),))
    assert rules == ["low-precision-accumulation"]
    d = findings[0].details
    assert d["elements"] == 4096 and d["bound_sequential"] == 4095 * 2.0 ** -8
    assert meta["numerics_low_precision_sites"] == 1
    assert meta["numerics_max_rel_error_bound"] == d["bound_tree"]
    # the halving ladder reaches the same site; the f32 chain and a bf16
    # ``sum`` (torch accumulates it in f32) are clean
    assert _audit(_ladder, (torch.ones(4096, dtype=torch.bfloat16),))[0] == rules
    assert _audit(_chain, (torch.ones(4096),))[0] == []
    rules, _, meta = _audit(torch.sum, (torch.ones(4096, dtype=torch.bfloat16),))
    assert rules == [] and meta["numerics_max_rel_error_bound"] == \
        jna.accumulation_error_bounds(4096, "f32")[1]


def _ar(x):
    dist.all_reduce(x)
    return x


def test_silent_upcast_and_nondeterministic_reduction(fake8):
    x = torch.ones(4096)
    rules, findings, meta = _audit(_ar, (x,), policy_dtype="bf16")
    assert rules == ["silent-upcast"] and findings[0].details["extra_bytes"] == 4096 * 4 // 2
    assert _audit(_ar, (x,), policy_dtype="f32")[0] == []
    assert meta["nondeterministic_reductions"] == 1
    rules, findings, _ = _audit(_ar, (x,), expect_bitwise_reproducible=True)
    assert rules == ["nondeterministic-reduction"] and findings[0].details["group_size"] == 8

    def amax(t):
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t

    assert _audit(amax, (x,))[2]["nondeterministic_reductions"] == 0


def test_silent_upcast_of_state():
    """JAX's while-carry leg: f32 state held across calls under a bf16
    policy, priced against the memory pass's peak."""
    state = oc.StateSpec(before=lambda a: [a[0]], after=lambda out, a: [out])
    _, cap = oc.capture_call(lambda s: s.mul_(2), (torch.ones(2048),), state=state)
    findings, _ = pna.analyze_numerics(cap, TargetExpectation(policy_dtype="bf16"), "t",
                                       peak_live_bytes=32_768)
    (f,) = findings
    assert f.rule == "silent-upcast" and f.details["extra_bytes"] == 2048 * 4 // 2
    assert f.details["peak_live_bytes"] == 32_768


@pytest.mark.parametrize("case,want", [
    ("roundtrip", ["quantise-roundtrip"]),
    ("masked", ["quantise-roundtrip"]),
    ("merge", []),
    ("ring_hop", []),
])
def test_quantise_roundtrip_forms(case, want):
    x = torch.ones(1024, dtype=torch.int8)
    mask = torch.ones(1024, dtype=torch.bool)
    fn, args = {
        "roundtrip": (lambda q: (q.float() * 0.5).to(torch.int8), (x,)),
        "masked": (lambda q, m: torch.where(m, torch.zeros(1024), q.float()).to(torch.int8),
                   (x, mask)),
        "merge": (lambda q, fresh, m: torch.where(m, fresh, q.float()).to(torch.int8),
                  (x, torch.ones(1024), mask)),
        "ring_hop": (lambda q, acc: (q.float() + acc).to(torch.int8), (x, torch.ones(1024))),
    }[case]
    rules, findings, _ = _audit(fn, args)
    assert rules == want
    if want:
        assert findings[0].details["wire_dtype"] == "s8"


def test_convert_churn_and_narrowing_clamp():
    x = torch.ones(256, dtype=torch.bfloat16)
    rules, findings, meta = _audit(
        lambda t: (t.to(torch.bfloat16, copy=True), t.float().to(torch.bfloat16)), (x,))
    assert rules == ["convert-churn", "convert-churn"]
    assert [f.details["chain"] for f in findings] == [["bf16", "bf16"], ["bf16", "f32", "bf16"]]
    assert meta["numerics_convert_count"] >= 3
    assert _audit(lambda t: t.bfloat16().float(), (torch.ones(256),))[0] == []


def test_policy_conformance():
    rules, findings, _ = _audit(lambda t: t + t, (torch.ones(512, dtype=torch.float64),),
                                policy_dtype="f32")
    assert rules == ["policy-conformance"] and "f64" in findings[0].message
    below = (torch.ones(1024, dtype=torch.bfloat16),)
    rules, findings, _ = _audit(lambda t: _chain(t[:64]), below, policy_dtype="f32")
    assert rules == ["policy-conformance", "policy-conformance"]
    msgs = " ".join(f.message for f in findings)
    assert "parameter" in msgs and "accumulator" in msgs
    assert _audit(lambda t: _chain(t[:64]), below, policy_dtype="bf16")[0] == []


def test_numerics_metrics_equal_jax():
    numerics = {"b": {"numerics_max_rel_error_bound": 3.6e-7,
                      "numerics_low_precision_sites": 0, "numerics_convert_count": 3},
                "a": {"numerics_max_rel_error_bound": 0.0}}
    assert pna.numerics_metrics(numerics).to_prometheus() == \
        jna.numerics_metrics(numerics).to_prometheus()


def test_shadow_equals_jax_committed_report(tmp_path, capsys):
    want = json.loads(JAX_SHADOW.read_text())
    assert psh.main(["--output", str(tmp_path), "--device", "cpu"]) == 0
    got = json.loads((tmp_path / psh.SHADOW_REPORT_NAME).read_text())
    assert (got["schema"], got["seed"], got["unit_roundoff"]) == \
        (want["schema"], want["seed"], want["unit_roundoff"])
    assert (got["confirmed"], got["refuted"]) == (want["confirmed"], want["refuted"]) == (4, 0)
    for g, w in zip(got["cases"], want["cases"], strict=True):
        for key in ("case", "dtype", "n", "order", "static_flagged", "predicted_bound_seq",
                    "predicted_bound_tree", "gating_bound", "confirmed"):
            assert g[key] == w[key], (g["case"], key)
        assert abs(g["measured_rel_error"] - w["measured_rel_error"]) <= 1e-12, g["case"]
    assert "4 confirmed, 0 refuted" in capsys.readouterr().out
    # the committed report is the shadow's output
    committed = json.loads(PORT_SHADOW.read_text())
    assert committed == got
