"""Rank body of ``tests/test_torch_hlo_audit.py``: the port's audit on a
gloo group of host processes, over the default registry (every pass) and
seeded violations (the collective audit's, then one per rule of the
schedule, memory and numerics passes).  It imports torch and the port
only, since ``bench.launch`` imports it by name in every spawned rank."""

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


ALL_PASSES = ("hlo", "schedule", "memory", "numerics")


def _ring4_build(fn_of, *shapes, dtype=torch.float32):
    """A target on a ring of the first 4 ranks whose call is
    ``fn_of(Ring)(*tensors)`` on ones of ``shapes``."""

    def build(device):
        from dlbb_tpu_torch.parallel.ring import Ring

        mesh = _mesh(("ring", 4))
        if mesh is None:
            return None
        return fn_of(Ring(mesh.group)), tuple(torch.ones(s, dtype=dtype, device=device)
                                              for s in shapes)

    return build


def _serialized_ring(ring):
    """Each hop waited before the product that needs it: no product is
    independent of a hop in flight."""
    from dlbb_tpu_torch.parallel.ring import FORWARD

    def fn(p, w):
        cp = ring.shift([p], FORWARD)[0]
        return ring.shift([cp @ w], FORWARD)[0] @ w

    return fn


def _replicated(ring):
    def fn(p):
        fat = p.repeat(8, 1)             # 8 x the operand, 4 MiB
        return fat[0:1].clone().reshape(-1)

    return fn


def _bf16_chain(ring):
    def fn(x):
        acc = x[0]
        for i in range(1, x.shape[0]):
            acc = acc + x[i]
        return acc

    return fn


def _roundtrip(ring):
    return lambda x: (x.float() * 0.5).to(torch.int8)


def _reallocated(ring):
    return lambda st: {"w": st["w"] * 2}


def _undonated_build(device):
    mesh = _mesh(("ring", 4))
    if mesh is None:
        return None
    state = {"w": torch.ones(256, device=device)}
    spec = StateSpec(before=lambda args: [args[0]["w"]], after=lambda out, args: [out["w"]])
    return _reallocated(None), (state,), spec


_PAIR_GROUPS: dict = {}


def _divergent_build(device):
    """Ranks 0 and 1 share two groups and post one all-reduce on each, in
    opposite orders (asynchronously, so that the launch completes): the
    sequences on the groups they share differ."""
    key = id(dist.group.WORLD)
    if key not in _PAIR_GROUPS:
        _PAIR_GROUPS[key] = (dist.new_group([0, 1]), dist.new_group([0, 1]))
    a, b = _PAIR_GROUPS[key]
    if dist.get_rank() > 1:
        return None
    order = (a, b) if dist.get_rank() == 0 else (b, a)

    def fn(x):
        works = [dist.all_reduce(x, group=g, async_op=True) for g in order]
        for w in works:
            w.wait()
        return x

    return fn, (torch.ones(16, device=device),)


def seeded_pass_targets():
    """(name, rule JAX raises for it, target): one seeded violation per
    rule of the schedule, memory and numerics passes."""
    overlap = TargetExpectation(allowed={"collective-permute"}, expect_overlap=True)
    return [
        ("serialized_ring", "serialized-collective",
         AuditTarget("seeded::serialized_ring", _ring4_build(_serialized_ring, (64, 64), (64, 64)),
                     overlap, min_devices=4)),
        ("divergent", "divergent-branch-collectives",
         AuditTarget("seeded::divergent", _divergent_build,
                     TargetExpectation(allowed={"all-reduce"}), min_devices=2)),
        ("ceiling", "peak-memory-ceiling",
         AuditTarget("seeded::ceiling", _ring4_build(_roundtrip, (4096,), dtype=torch.int8),
                     TargetExpectation(allowed=set(), max_peak_bytes=4096), min_devices=4)),
        ("undonated", "unaliased-donation",
         AuditTarget("seeded::undonated", _undonated_build, TargetExpectation(allowed=set()),
                     min_devices=4)),
        ("replicated", "transient-replicated-buffer",
         AuditTarget("seeded::replicated", _ring4_build(_replicated, (131072,)),
                     TargetExpectation(allowed=set()), min_devices=4)),
        ("bf16_chain", "low-precision-accumulation",
         AuditTarget("seeded::bf16_chain", _ring4_build(_bf16_chain, (600,), dtype=torch.bfloat16),
                     TargetExpectation(allowed=set()), min_devices=4)),
        ("roundtrip", "quantise-roundtrip",
         AuditTarget("seeded::roundtrip", _ring4_build(_roundtrip, (1024,), dtype=torch.int8),
                     TargetExpectation(allowed=set()), min_devices=4)),
    ]


def run_audits():
    """The default registry under every pass, the collective audit's
    seeded targets, then the passes' seeded targets, on this rank; rank 0
    returns ``(default report, default metas, seeded report, the passes'
    seeded report)``."""
    torch.set_num_threads(1)
    metas = {}
    default = run_hlo_audit(default_targets(), device="cpu", metas=metas, passes=ALL_PASSES)
    seeded = run_hlo_audit([t for _, _, t in seeded_targets()], device="cpu")
    passes = run_hlo_audit([t for _, _, t in seeded_pass_targets()], device="cpu",
                           passes=ALL_PASSES)
    return (default, metas, seeded, passes) if dist.get_rank() == 0 else None
