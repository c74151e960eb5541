"""The memory auditor (ROADMAP Queue 1, Slice F, item 15, part 15b:
``dlbb_tpu_torch/analysis/memory_audit.py``) against JAX's
``dlbb_tpu.analysis.memory_audit``.

Small graphs against JAX's HLO fixtures of ``tests/test_memory_audit.py``:
each fixture's computation is captured in torch and the pass's
``peak_live_bytes`` equals JAX's ``analyze_memory`` on the fixture, with the
same rules: ``CHAIN_HLO`` (and its ceiling and headroom cases), the
dead-buffer and bitcast-alias modules (a torch view is JAX's bitcast),
``DONATED_HLO`` donated (the state updated in place) and undonated (the
state reallocated), the serving-cache drift on it, and ``_replicated_hlo``
with its exemptions (one device, under the floor, a gathering collective;
XLA's ``slice`` makes a new array, so its torch form clones the slice).
No torch form: the parser units (the port parses no text), and the
``while``, ``conditional`` and ``fusion`` modules (eager torch runs a loop's
trips as ops, has no ``conditional`` and fuses nothing).

``memory_metrics`` writes JAX's ``metrics.prom`` lines, and the artifacts
JAX's files.
"""

import json
from dataclasses import replace

import pytest
import torch
import torch.distributed as dist
from test_memory_audit import CHAIN_HLO, DONATED_HLO, _replicated_hlo

from dlbb_tpu.analysis import memory_audit as jma
from dlbb_tpu.analysis.costmodel import get_tier as jget_tier
from dlbb_tpu.analysis.expectations import TargetExpectation as JExp
from dlbb_tpu_torch.analysis import memory_audit as pma
from dlbb_tpu_torch.analysis import op_capture as oc
from dlbb_tpu_torch.analysis.costmodel import get_tier
from dlbb_tpu_torch.analysis.expectations import TargetExpectation

DEAD_HLO = """
HloModule t, is_scheduled=true
ENTRY %main (p: f32[100]) -> f32[100] {
  %p = f32[100]{0} parameter(0)
  %a = f32[100]{0} negate(f32[100]{0} %p)
  %b = f32[100]{0} exponential(f32[100]{0} %a)
  %c = f32[100]{0} add(f32[100]{0} %b, f32[100]{0} %b)
  ROOT %d = f32[100]{0} negate(f32[100]{0} %c)
}
"""

BITCAST_HLO = """
HloModule t, is_scheduled=true
ENTRY %main (p: f32[100]) -> f32[100] {
  %p = f32[100]{0} parameter(0)
  %a = f32[100]{0} negate(f32[100]{0} %p)
  %v = f32[4,25]{1,0} bitcast(f32[100]{0} %a)
  %w = f32[4,25]{1,0} negate(f32[4,25]{1,0} %v)
  ROOT %c = f32[100]{0} bitcast(f32[4,25]{1,0} %w)
}
"""

UNDONATED_HLO = DONATED_HLO.replace(", input_output_alias={ {0}: (0, {}, may-alias) }", "")
DONOR = "{jax.buffer_donor = true}"


def _chain(p):
    a = -p
    return a + torch.exp(a)


def _dead(p):
    a = -p
    b = torch.exp(a)
    return -(b + b)


def _bitcast(p):
    a = -p
    return (-a.view(4, 25)).view(100)


def _donated(state, x):
    state.add_(x)
    return state, torch.zeros(())


def _undonated(state, x):
    return state + x, torch.zeros(())


def _replicated(p):
    fat = p.repeat(8, 1)
    return fat[0:1].clone().reshape(-1)


def _gathered(p):
    fat = torch.empty(8 * p.shape[0])
    dist.all_gather_into_tensor(fat, p)
    return fat[0:p.shape[0]].clone()


STATE = oc.StateSpec(before=lambda args: [args[0]], after=lambda out, args: [out[0]])


def _port(fn, args, exp, state=None, **kw):
    _, cap = oc.capture_call(fn, args, state=state)
    findings, meta = pma.analyze_memory(cap, TargetExpectation(**exp), "t", **kw)
    return [f.rule for f in findings], meta


def _jax(hlo, exp, **kw):
    findings, meta = jma.analyze_memory(hlo, JExp(**exp), "t", **kw)
    return [f.rule for f in findings], meta


@pytest.mark.parametrize("case", ["chain", "dead", "bitcast", "ceiling"])
def test_liveness_fixtures_equal_jax(case):
    p = torch.ones(100)
    fn, hlo, exp = {"chain": (_chain, CHAIN_HLO, {}), "dead": (_dead, DEAD_HLO, {}),
                    "bitcast": (_bitcast, BITCAST_HLO, {}),
                    "ceiling": (_chain, CHAIN_HLO, {"max_peak_bytes": 1000})}[case]
    (pr, pm), (jr, jm) = _port(fn, (p,), exp), _jax(hlo, exp)
    assert pm["peak_live_bytes"] == jm["peak_live_bytes"]
    assert pr == jr
    assert pm["parameter_bytes"] == jm["parameter_bytes"]
    assert pm["output_bytes"] == jm["output_bytes"]
    assert len(pm["live_at_peak"]) == len(jm["live_at_peak"])


@pytest.mark.parametrize("case", ["donated", "undonated", "drift", "in_tolerance"])
def test_donation_fixtures_equal_jax(case):
    exp = {"donated": {"expect_donation": True}, "undonated": {"expect_donation": True},
           "drift": {"donated_bytes_expected": 4096, "donated_bytes_tolerance": 0.10},
           "in_tolerance": {"donated_bytes_expected": 2000,
                            "donated_bytes_tolerance": 0.10}}[case]
    fn, hlo = (_undonated, UNDONATED_HLO) if case == "undonated" else (_donated, DONATED_HLO)
    pr, pm = _port(fn, (torch.ones(512), torch.ones(512)), exp, state=STATE)
    jr, jm = _jax(hlo, exp, lowered_text=DONOR)
    assert pm["peak_live_bytes"] == jm["peak_live_bytes"]
    assert pm["donated_param_bytes"] == jm["donated_param_bytes"]
    assert pr == jr
    assert [p["aliased"] for p in pm["donated_params"]] == \
        [p["aliased"] for p in jm["donated_params"]]


@pytest.mark.parametrize("case", ["fires", "one_device", "under_floor"])
def test_replicated_fixture_equals_jax(case):
    elems, devices = {"fires": (131072, 8), "one_device": (131072, 1),
                      "under_floor": (1024, 8)}[case]
    pr, _ = _port(_replicated, (torch.ones(elems),), {}, num_devices=devices)
    jr, _ = _jax(_replicated_hlo(elems), {}, num_devices=devices)
    assert pr == jr == (["transient-replicated-buffer"] if case == "fires" else [])


def test_gathering_collective_is_exempt():
    """A collective that gathers P x its operand does its job (JAX's third
    exemption), on a fake process group of 8 ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        pr, _ = _port(_gathered, (torch.ones(131072),), {}, num_devices=8)
    finally:
        dist.destroy_process_group()
    gathered = _replicated_hlo().replace(
        "broadcast(f32[131072]{0} %p), dimensions={1}",
        "all-gather(f32[131072]{0} %p), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}")
    jr, _ = _jax(gathered, {}, num_devices=8)
    assert pr == jr == []


def test_hbm_headroom_and_infeasible_equal_jax():
    tier, jtier = get_tier("cpu-sim"), jget_tier("cpu-sim")
    _, pm = _port(_chain, (torch.ones(100),), {}, tier=tier)
    _, jm = _jax(CHAIN_HLO, {}, tier=jtier)
    for key in ("hbm_bytes", "hbm_headroom_bytes", "feasible"):
        assert pm[key] == jm[key], key
    pr, pm = _port(_chain, (torch.ones(100),), {}, tier=replace(tier, hbm_bytes=1024.0))
    jr, jm = _jax(CHAIN_HLO, {}, tier=replace(jtier, hbm_bytes=1024.0))
    assert pr == jr == ["hbm-infeasible"] and pm["feasible"] is jm["feasible"] is False


def test_only_the_calls_device_counts():
    """A buffer on another device than the call's arguments is not charged
    (on the card, a gloo hop's host staging copies)."""

    def fn(p):
        host = torch.ones(1 << 16, device="meta")
        return p * 2, host

    _, cap = oc.capture_call(fn, (torch.ones(100),))
    _, meta = pma.analyze_memory(cap, TargetExpectation(), "t")
    assert meta["peak_live_bytes"] == 800


def test_memory_metrics_and_artifacts_equal_jax(tmp_path):
    memory = {"b::y": {"peak_live_bytes": 2048, "hbm_headroom_bytes": 100},
              "a::x": {"peak_live_bytes": 4096}}
    tier, jtier = get_tier("cpu-sim"), jget_tier("cpu-sim")
    assert pma.memory_metrics(memory, tier).to_prometheus() == \
        jma.memory_metrics(memory, jtier).to_prometheus()
    (tmp_path / "p").mkdir()
    (tmp_path / "p" / "metrics.prom").write_text("dlbb_other_gauge 1\n")
    path = pma.write_memory_artifacts(memory, tmp_path / "p", tier)
    jma.write_memory_artifacts(memory, tmp_path / "j", jtier)
    got, want = (json.loads((tmp_path / d / "memory_audit.json").read_text())
                 for d in ("p", "j"))
    assert path.name == "memory_audit.json"
    got.pop("timestamp"), want.pop("timestamp")
    assert got == want
    man = json.loads((tmp_path / "p" / "sweep_manifest.json").read_text())
    assert man["memory_audit"]["peak_live_bytes"] == {"a::x": 4096, "b::y": 2048}
    prom = (tmp_path / "p" / "metrics.prom").read_text()
    assert "dlbb_other_gauge 1" in prom and 'analysis_peak_live_bytes{target="a::x"' in prom
