"""Rank body of ``tests/test_torch_hlo_audit.py``: the port's collective
audit on a gloo group of host processes, over the default registry and
seeded violations.  It imports torch and the port only, since
``bench.launch`` imports it by name in every spawned rank."""

import torch
import torch.distributed as dist

from dlbb_tpu_torch.analysis.expectations import TargetExpectation, op_expectation
from dlbb_tpu_torch.analysis.hlo_audit import (
    AuditTarget,
    _mesh,
    default_targets,
    run_hlo_audit,
)
from dlbb_tpu_torch.analysis.op_capture import StateSpec


def _ring_build(fn_of):
    """A target on the 8-rank ring whose call is ``fn_of(mesh)(x)`` on a
    1024-element f32 payload."""

    def build(device):
        mesh = _mesh(("ring", 8))
        if mesh is None:
            return None
        return fn_of(mesh), (torch.ones(1024, dtype=torch.float32, device=device),)

    return build


def _weight_gathered(mesh):
    def fn(x):
        dist.all_reduce(x, group=mesh.group)
        w = torch.ones((64, 64), dtype=torch.float32, device=x.device)
        full = torch.empty((8 * 64, 64), dtype=torch.float32, device=x.device)
        dist.all_gather_into_tensor(full, w, group=mesh.group)
        return x, full

    return fn


def _big_allreduce(mesh):
    def fn(x):
        big = x.repeat(4)
        dist.all_reduce(big, group=mesh.group)
        return big

    return fn


def _allreduce(mesh):
    def fn(x):
        dist.all_reduce(x, group=mesh.group)
        return x

    return fn


def _state_step(in_place):
    def build(device):
        mesh = _mesh(("ring", 8))
        if mesh is None:
            return None
        state = {"w": torch.ones(256, device=device), "m": torch.zeros(256, device=device)}

        def step(st, g):
            dist.all_reduce(g, group=mesh.group)
            if in_place:
                st["m"].add_(g)
                st["w"].sub_(0.1 * st["m"])
                return st
            m = st["m"] + g
            return {"w": st["w"] - 0.1 * m, "m": m}

        spec = StateSpec(before=lambda args: [args[0]["w"], args[0]["m"]],
                         after=lambda out, args: [out["w"], out["m"]])
        return step, (state, torch.ones(256, device=device)), spec

    return build


def _crashing(device):
    raise RuntimeError("seeded build failure")


def seeded_targets():
    """(name, rule JAX raises for it, target): one per seeded violation,
    then the controls (a clean in-place step, a clean all-reduce after the
    crash, a target that needs more ranks than the world)."""
    allreduce_only = TargetExpectation(allowed={"all-reduce"}, required_any={"all-reduce"})
    wire = op_expectation("allreduce", 4096)
    wire.max_total_wire_bytes = 100
    donate = TargetExpectation(allowed={"all-reduce"}, expect_donation=True)
    return [
        ("weight_gathered", "unexpected-collective",
         AuditTarget("seeded::weight_gathered", _ring_build(_weight_gathered),
                     allreduce_only, min_devices=8)),
        ("oversized", "oversized-collective",
         AuditTarget("seeded::oversized", _ring_build(_big_allreduce),
                     op_expectation("allreduce", 4096), min_devices=8)),
        ("missing", "missing-collective",
         AuditTarget("seeded::missing", _ring_build(lambda mesh: lambda x: x * 2),
                     op_expectation("allreduce", 4096), min_devices=8)),
        ("wire", "wire-volume-ceiling",
         AuditTarget("seeded::wire", _ring_build(_allreduce), wire, min_devices=8)),
        ("reallocating_step", "missing-donation",
         AuditTarget("seeded::reallocating_step", _state_step(False), donate, min_devices=8)),
        ("crash", "audit-crash",
         AuditTarget("seeded::crash", _crashing, allreduce_only, min_devices=8)),
        ("in_place_step", None,
         AuditTarget("seeded::in_place_step", _state_step(True), donate, min_devices=8)),
        ("after_crash", None,
         AuditTarget("seeded::after_crash", _ring_build(_allreduce), allreduce_only,
                     min_devices=8)),
        ("too_few_ranks", None,
         AuditTarget("seeded::too_few_ranks", _ring_build(_allreduce), allreduce_only,
                     min_devices=16)),
    ]


def run_audits():
    """The default registry, then the seeded targets, on this rank; rank 0
    returns ``(default report, default metas, seeded report)``."""
    torch.set_num_threads(1)
    metas = {}
    default = run_hlo_audit(default_targets(), device="cpu", metas=metas)
    seeded = run_hlo_audit([t for _, _, t in seeded_targets()], device="cpu")
    return (default, metas, seeded) if dist.get_rank() == 0 else None
