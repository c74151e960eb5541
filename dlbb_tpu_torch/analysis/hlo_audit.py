"""The collective audit, ``cli analyze hlo`` (counterpart of
``dlbb_tpu/analysis/hlo_audit.py``, whose name it keeps so that the CLI's
pass and the findings' ``pass_name="hlo"`` read as JAX's do).

JAX lowers each registered computation on a simulated mesh and audits the
collectives of its compiled HLO.  The port calls each target once on its
ranks and audits the ``c10d`` ops the call issued (``op_capture.py``)
against the analytic expectation model (``expectations.py``), with JAX's
rules:

- ``unexpected-collective``: a kind outside the target's allowed set;
- ``oversized-collective``: a collective over the per-collective byte
  ceiling;
- ``missing-collective``: fewer than ``min_required`` collectives of the
  ``required_any`` kinds (every executed call counts);
- ``wire-volume-ceiling``: the analytic wire bytes of the whole call over
  the ceiling (the compressed targets' proof);
- ``missing-donation``: a target that must update its state in place
  (``expect_donation``) whose state tensors changed storage
  (``Capture.has_donation``);
- ``audit-crash``: a target that raised, contained per target;
- ``no-targets-audited``: every target skipped (``analysis.run_analysis``).

Targets.  ``default_targets()`` builds each of JAX's 41 targets, with
JAX's names letter for letter, from the port's own modules at JAX's sizes
(``_TINY_MODEL``, ``_MATMUL_SHAPE``, ``_SERVE_SHAPE``), meshes (dp, tp, sp)
and ceilings (``_tiny_params_bytes``, ``_serve_cache_bytes_per_device``).
A target's ``build(device)`` runs on every rank of the world, in the same
order (the meshes are process groups, ``comm/mesh.py``), and returns
``(fn, args)`` or ``(fn, args, state)`` on the ranks of the target's mesh,
None on the others.  Every rank calls the target, so that its collectives
complete; rank 0's capture is the one audited, as JAX audits its one SPMD
program.  The expectation of a registry op follows the port's kind table
(``expectations.OP_EXPECTED_KINDS``: broadcast, gather, scatter and reduce
are native c10d ops here).

A target needing more ranks than the world has is recorded as skipped,
as JAX does; ``cli analyze hlo --simulate N`` launches N gloo ranks
(``bench/launch.py``) and ``_audit_rank`` runs the audit on each.

The schedule, memory and numerics passes are ROADMAP Queue 1, Slice F,
item 15, part 15b: ``run_hlo_audit`` refuses them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

from dlbb_tpu_torch.analysis import NOT_PORTED
from dlbb_tpu_torch.analysis.expectations import (
    TargetExpectation,
    compact_expectation,
    compressed_op_expectation,
    compression_wire_ceiling,
    decode_scan_expectation,
    op_expectation,
    op_wire_bytes,
    overlap_op_expectation,
    plan_expected_kinds,
    scale_bytes,
    verify_step_expectation,
    wire_bytes,
)
from dlbb_tpu_torch.analysis.findings import (
    SEVERITY_ERROR,
    AnalysisReport,
    Finding,
)
from dlbb_tpu_torch.analysis.op_capture import CollectiveInstr, StateSpec, capture_call


@dataclass
class AuditTarget:
    """One computation to call and audit.

    ``build(device)`` returns ``(fn, args)`` or ``(fn, args, state)``
    (``state``: an ``op_capture.StateSpec`` naming the call's state
    tensors) on the ranks of the target's mesh, None elsewhere.
    ``min_devices`` is the ranks the target needs: with fewer in the world
    it is skipped, not failed."""

    name: str
    build: Callable[[Any], Optional[tuple]]
    expectation: TargetExpectation
    min_devices: int = 1


def audit_target(target: AuditTarget, passes: Sequence[str] = ("hlo",),
                 device=None) -> tuple[list[Finding], dict]:
    """Build, call once under the capture, and check one target on this
    rank.  Returns the findings and a meta dict (the collective inventory,
    the flash launches, the donation counterpart).  A rank outside the
    target's mesh returns no findings and ``{"on_mesh": False}``."""
    _refuse(passes)
    built = target.build(device)
    if built is None:
        return [], {"on_mesh": False}
    fn, args = built[0], built[1]
    state = built[2] if len(built) > 2 else None
    _, cap = capture_call(fn, args, state=state, target=target.name)
    exp = target.expectation
    instrs = cap.collectives

    findings: list[Finding] = []
    for instr in instrs:
        base = _instr_details(instr, exp)
        if instr.kind not in exp.allowed:
            findings.append(Finding(
                pass_name="hlo",
                rule="unexpected-collective",
                severity=SEVERITY_ERROR,
                target=target.name,
                message=(
                    f"{instr.kind} of {instr.dtype}{list(instr.shape)} "
                    f"({instr.result_bytes} B/device) is not in the "
                    f"plan's allowed set {sorted(exp.allowed)}: the call "
                    "issues a collective the parallelism plan does not "
                    "account for"
                ),
                location=instr.source,
                details=base,
            ))
        elif (exp.max_bytes_per_instr is not None
                and instr.result_bytes > exp.max_bytes_per_instr):
            findings.append(Finding(
                pass_name="hlo",
                rule="oversized-collective",
                severity=SEVERITY_ERROR,
                target=target.name,
                message=(
                    f"{instr.kind} carries {instr.result_bytes} B/device, "
                    f"over the plan ceiling of {exp.max_bytes_per_instr} B "
                    "— a larger buffer than the benchmark claims to move"
                ),
                location=instr.source,
                details=base,
            ))
    if exp.required_any:
        hits = sum(i.execution_count for i in instrs if i.kind in exp.required_any)
        if hits < exp.min_required:
            findings.append(Finding(
                pass_name="hlo",
                rule="missing-collective",
                severity=SEVERITY_ERROR,
                target=target.name,
                message=(
                    f"expected >= {exp.min_required} execution(s) of "
                    f"{sorted(exp.required_any)}, found {hits} — the "
                    "benchmark does not perform the collective it claims"
                ),
                details={
                    "expected_kinds": sorted(exp.required_any),
                    "expected_min_count": exp.min_required,
                    "found_count": hits,
                    "present": [i.to_dict() for i in instrs],
                },
            ))
    total_wire = sum(
        wire_bytes(i.kind, i.result_bytes, i.group_size) * i.execution_count
        for i in instrs
    )
    if (exp.max_total_wire_bytes is not None
            and total_wire > exp.max_total_wire_bytes):
        findings.append(Finding(
            pass_name="hlo",
            rule="wire-volume-ceiling",
            severity=SEVERITY_ERROR,
            target=target.name,
            message=(
                f"total analytic wire volume {total_wire} B/device exceeds "
                f"the ceiling of {exp.max_total_wire_bytes} B — for a "
                "compressed collective this means the quantisation did "
                "not reach the wire (an uncompressed reduction survived)"
            ),
            details={
                "total_wire_bytes": total_wire,
                "max_total_wire_bytes": exp.max_total_wire_bytes,
                "per_instr_wire_bytes": [
                    {"kind": i.kind,
                     "execution_count": i.execution_count,
                     "wire_bytes": wire_bytes(i.kind, i.result_bytes, i.group_size)}
                    for i in instrs
                ],
            },
        ))
    if exp.expect_donation and not cap.has_donation:
        findings.append(Finding(
            pass_name="hlo",
            rule="missing-donation",
            severity=SEVERITY_ERROR,
            target=target.name,
            message=(
                "the call did not update its state in place (a state "
                "tensor changed storage, or the target names none): input "
                "AND output state are resident, doubling state memory"
            ),
            details={"expected": "the step writes its state in place",
                     "state_tensors": len(cap.state_before)},
        ))
    meta = {
        "collectives": [i.to_dict() for i in instrs],
        "num_collectives": sum(i.execution_count for i in instrs),
        "total_wire_bytes": total_wire,
        "flash_launches": cap.flash_launches,
        "has_donation": cap.has_donation,
        "aten_ops": len(cap.aten_ops),
    }
    return findings, meta


def _instr_details(instr: CollectiveInstr, exp: TargetExpectation) -> dict:
    d = instr.to_dict()
    d["expected_allowed_kinds"] = sorted(exp.allowed)
    d["expected_max_bytes_per_instr"] = exp.max_bytes_per_instr
    d["analytic_wire_bytes"] = wire_bytes(instr.kind, instr.result_bytes, instr.group_size)
    return d


def _refuse(passes: Sequence[str]) -> None:
    others = [p for p in passes if p != "hlo"]
    if others:
        raise NotImplementedError(f"analyze pass(es) {others} {NOT_PORTED}")


# ---------------------------------------------------------------------------
# helpers of the builders
# ---------------------------------------------------------------------------

_TINY_MODEL = dict(hidden_size=64, num_layers=2, num_heads=4,
                   ffn_intermediate=128, dtype="float32",
                   attention="full")

# (B, S, H) payload of the collective-matmul targets
_MATMUL_SHAPE = (2, 16, 64)

# the serving geometry: 4 decode slots of 4 x 8-token blocks, one 16-token
# prefill bucket
_SERVE_SHAPE = dict(max_batch=4, num_blocks=4, block_size=8, bucket=16)

# meshes of this process's world, built once per key: every rank builds
# them in the same order (a mesh is a set of process groups)
_MESHES: dict[tuple, Any] = {}


def _mesh(key: tuple):
    """``("ring", p)``, ``("grid", shape, names)`` or ``("plan", dp, sp,
    tp)``: this rank's mesh, None off it."""
    import torch.distributed as dist

    from dlbb_tpu_torch.comm.mesh import MeshSpec, build_parallelism_mesh, get_mesh

    full = (id(dist.group.WORLD), key)
    if full not in _MESHES:
        if key[0] == "ring":
            _MESHES[full] = get_mesh(MeshSpec.ring(key[1]))
        elif key[0] == "grid":
            _MESHES[full] = get_mesh(MeshSpec.grid(key[1], key[2]))
        else:
            _, dp, sp, tp = key
            _MESHES[full] = build_parallelism_mesh(data_parallel=dp, sequence_parallel=sp,
                                                   tensor_parallel=tp)
    return _MESHES[full]


def _device(device):
    from dlbb_tpu_torch.utils.sysinfo import resolve_device

    return resolve_device(device)


def _tensors_of(tree) -> list:
    """The tensors of a state (dicts, tuples, NamedTuples), in order."""
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors_of(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors_of(v)]
    return []


def _tiny_params_bytes() -> int:
    """f32 parameter bytes of the tiny audit model, the unit the model and
    train ceilings are priced in."""
    from dlbb_tpu_torch.models.configs import ModelConfig
    from dlbb_tpu_torch.models.transformer import num_parameters

    return num_parameters(ModelConfig(**_TINY_MODEL)) * 4


def _global_ones(shape, device):
    import torch

    return torch.ones(shape, dtype=torch.float32, device=device)


def _rank_batch(global_batch, mesh):
    from dlbb_tpu_torch.data.synthetic import batch_slice
    from dlbb_tpu_torch.models.sharding import batch_spec

    return batch_slice(global_batch, **batch_spec(mesh)).contiguous()


# ---------------------------------------------------------------------------
# registry ops
# ---------------------------------------------------------------------------


def _registry_op_target(op_name: str, num_ranks: int = 8,
                        num_elements: int = 256) -> AuditTarget:
    def build(device):
        import torch

        from dlbb_tpu_torch.comm.ops import get_op, make_payload

        op = get_op(op_name)
        if op_name == "allreduce_hierarchical":
            mesh = _mesh(("grid", (2, num_ranks // 2), ("outer", "inner")))
        else:
            mesh = _mesh(("ring", num_ranks))
        if mesh is None:
            return None
        fn = op.build(mesh, 0)
        x = make_payload(op, mesh.rank, num_ranks, num_elements, dtype=torch.float32,
                         device=_device(device))
        return fn, (x,)

    per_rank = num_elements * 4  # float32 payloads
    if op_name in ("allgather", "gather", "scatter", "alltoall", "reducescatter"):
        ceiling = per_rank * num_ranks
    else:
        ceiling = per_rank
    exp = op_expectation(op_name, ceiling)
    exp.max_peak_bytes = 4 * ceiling + 8192
    return AuditTarget(name=f"comm/ops.py::{op_name}", build=build, expectation=exp,
                       min_devices=num_ranks)


def _collective_matmul_target(op_name: str, schedule: str,
                              num_ranks: int = 8) -> AuditTarget:
    """One target per (micro-op, schedule): the fused schedule shows its
    gather or scatter, the decomposed ones a pure permute chain."""
    import math

    def build(device):
        import torch

        from dlbb_tpu_torch.comm.ops import build_ag_matmul, build_matmul_rs, get_op, make_payload

        mesh = _mesh(("ring", num_ranks))
        if mesh is None:
            return None
        builder = build_ag_matmul if op_name == "ag_matmul" else build_matmul_rs
        fn = builder(mesh, 0, schedule=schedule)
        x = make_payload(get_op(op_name), mesh.rank, num_ranks, math.prod(_MATMUL_SHAPE),
                         dtype=torch.float32, shape=_MATMUL_SHAPE, device=_device(device))
        return fn, (x,)

    per_rank = math.prod(_MATMUL_SHAPE) * 4
    if schedule == "fused":
        exp = op_expectation(op_name, per_rank * num_ranks)
        exp.max_peak_bytes = int(2.5 * per_rank * num_ranks)
    else:
        exp = overlap_op_expectation(num_ranks, per_rank)
        exp.max_peak_bytes = 8 * per_rank
    return AuditTarget(name=f"comm/ops.py::{op_name}[{schedule}]", build=build,
                       expectation=exp, min_devices=num_ranks)


def _compressed_op_target(op_name: str, compression: str, num_ranks: int = 8,
                          num_elements: int = 4096) -> AuditTarget:
    """One target per (compressed micro-op, wire dtype): the quantised ring
    under the compression wire ceiling."""

    def build(device):
        import torch

        from dlbb_tpu_torch.comm.ops import get_op, make_payload

        op = get_op(op_name)
        mesh = _mesh(("ring", num_ranks))
        if mesh is None:
            return None
        fn = op.build(mesh, 0, compression=compression)
        x = make_payload(op, mesh.rank, num_ranks, num_elements, dtype=torch.bfloat16,
                         device=_device(device))
        return fn, (x,)

    exp = compressed_op_expectation(op_name, num_ranks, num_elements, compression=compression)
    exp.max_peak_bytes = (
        2 * num_ranks * num_elements * 2 if op_name == "reducescatter_q"
        else 4 * num_elements * 2 + 8192
    )
    return AuditTarget(name=f"comm/ops.py::{op_name}[{compression}]", build=build,
                       expectation=exp, min_devices=num_ranks)


def _barrier_target(num_ranks: int = 8) -> AuditTarget:
    """``build_barrier``, the timing synchronisation point: a scalar-sized
    all-reduce, never anything that moves real data."""

    def build(device):
        import torch

        from dlbb_tpu_torch.comm.ops import build_barrier

        mesh = _mesh(("ring", num_ranks))
        if mesh is None:
            return None
        return build_barrier(mesh), (torch.ones((1,), dtype=torch.float32,
                                                device=_device(device)),)

    exp = op_expectation("barrier", 4)
    exp.max_peak_bytes = 8192
    return AuditTarget(name="comm/ops.py::barrier", build=build, expectation=exp,
                       min_devices=num_ranks)


# ---------------------------------------------------------------------------
# forwards and train steps
# ---------------------------------------------------------------------------


def _forward_build(dp: int, sp: int, tp: int, fields: dict, batch: int, seq: int):
    def build(device):
        import torch

        from dlbb_tpu_torch.models.configs import ModelConfig
        from dlbb_tpu_torch.models.transformer import forward, init_params

        cfg = ModelConfig(**fields)
        mesh = _mesh(("plan", dp, sp, tp))
        if mesh is None:
            return None
        dev = _device(device)
        c = mesh.coords
        params = init_params(cfg, 0, dev, tp_rank=c["tp"], tp=tp)
        x = _rank_batch(_global_ones((batch, seq, cfg.hidden_size), dev), mesh)

        def fn(p, a):
            with torch.inference_mode():
                return forward(p, a, cfg, mesh=mesh)

        return fn, (params, x)

    return build


def _tp_forward_target(dp: int = 2, tp: int = 4) -> AuditTarget:
    act_bytes = (2 * dp // dp) * 8 * _TINY_MODEL["hidden_size"] * 4
    return AuditTarget(
        name="models/transformer.py::forward[dp,tp]",
        build=_forward_build(dp, 1, tp, _TINY_MODEL, 2 * dp, 8),
        expectation=TargetExpectation(
            allowed=plan_expected_kinds(dp=dp, tp=tp),
            required_any={"all-reduce"},
            min_required=1,
            max_bytes_per_instr=int(act_bytes * 1.25),
            max_peak_bytes=int(0.7 * _tiny_params_bytes()),
        ),
        min_devices=dp * tp,
    )


def _cp_forward_target(attention: str, dp: int = 2, sp: int = 4) -> AuditTarget:
    required = "collective-permute" if attention == "ring" else "all-to-all"
    return AuditTarget(
        name=f"models/transformer.py::forward[sp,{attention}]",
        build=_forward_build(dp, sp, 1, {**_TINY_MODEL, "attention": attention}, dp, 16),
        expectation=TargetExpectation(
            allowed=plan_expected_kinds(dp=dp, sp=sp, attention=attention),
            required_any={required},
            min_required=1,
            max_peak_bytes=int(1.3 * _tiny_params_bytes()) + 65536,
        ),
        min_devices=dp * sp,
    )


def _tp_overlap_forward_target(schedule: str, dp: int = 2, tp: int = 4) -> AuditTarget:
    """The overlapped tp forward: every projection's collective a ring of
    hops (4 ring matmuls x (tp - 1) hops per layer), no all-reduce."""
    act_bytes = (2 * dp // dp) * 8 * _TINY_MODEL["hidden_size"] * 4
    return AuditTarget(
        name=f"models/transformer.py::forward[dp,tp,overlap={schedule}]",
        build=_forward_build(dp, 1, tp, {**_TINY_MODEL, "tp_overlap": schedule}, 2 * dp, 8),
        expectation=TargetExpectation(
            allowed=plan_expected_kinds(tp=tp, tp_overlap=schedule),
            required_any={"collective-permute"},
            min_required=4 * (tp - 1),
            max_bytes_per_instr=int(act_bytes * 1.25),
            expect_overlap=True,
            max_peak_bytes=int(0.7 * _tiny_params_bytes()),
        ),
        min_devices=dp * tp,
    )


def _train_state_spec() -> StateSpec:
    """The train step's state: every parameter and optimizer-state tensor
    (Adam's moments, the error-feedback residual), in the argument and in
    the returned state."""
    return StateSpec(
        before=lambda args: _tensors_of((args[0].params, args[0].opt_state)),
        after=lambda out, args: _tensors_of((out[0].params, out[0].opt_state)))


def _train_build(dp: int, tp: int, fields: dict, zero_stage: int = 0,
                 compression: str = "none"):
    def build(device):
        from dlbb_tpu_torch.models.configs import ModelConfig
        from dlbb_tpu_torch.models.transformer import init_params
        from dlbb_tpu_torch.train.loop import make_train_step
        from dlbb_tpu_torch.train.optim import build_optimizer

        cfg = ModelConfig(**fields)
        mesh = _mesh(("plan", dp, 1, tp))
        if mesh is None:
            return None
        dev = _device(device)
        c = mesh.coords
        batch_size = 2 * dp if tp > 1 else dp
        step, state = make_train_step(
            cfg, build_optimizer({"optimizer": "adam", "learning_rate": 1e-3}),
            init_params(cfg, 0, dev, tp_rank=c["tp"], tp=tp), mesh=mesh,
            zero_stage=zero_stage, grad_compression=compression, batch_size=batch_size)
        glob = _global_ones((batch_size, 8, cfg.hidden_size), dev)
        batch, tgt = _rank_batch(glob, mesh), _rank_batch(glob.clone(), mesh)
        return step, (state, batch, tgt), _train_state_spec()

    return build


def _tp_overlap_train_target(schedule: str, dp: int = 2, tp: int = 4) -> AuditTarget:
    """The overlapped train step: the backward's rings too, the dp (and the
    chunks' tp) gradient sums the only all-reduces, the state updated in
    place."""
    params_bytes = _tiny_params_bytes()
    return AuditTarget(
        name=f"train/loop.py::train_step[dp,tp,overlap={schedule}]",
        build=_train_build(dp, tp, {**_TINY_MODEL, "tp_overlap": schedule}),
        expectation=TargetExpectation(
            allowed=plan_expected_kinds(dp=dp, tp=tp, tp_overlap=schedule) | {"all-to-all"},
            required_any={"collective-permute"},
            min_required=4 * (tp - 1),
            max_bytes_per_instr=int(params_bytes * 1.25),
            expect_donation=True,
            expect_overlap=True,
            max_peak_bytes=int(2.0 * params_bytes),
        ),
        min_devices=dp * tp,
    )


def _compressed_train_target(compression: str = "int8", dp: int = 8) -> AuditTarget:
    """The compressed DDP step: the quantised ring and its wire-dtype
    all-gather, the loss mean the only all-reduce, the total wire under
    the compression ceiling, the state (residual included) in place."""
    n_params = _tiny_params_bytes() // 4
    baseline = wire_bytes("all-reduce", n_params * 2, dp)
    analytic = op_wire_bytes("allreduce_q", n_params, dp, 2, compression=compression)
    return AuditTarget(
        name=f"train/loop.py::train_step[ddp,compressed={compression}]",
        build=_train_build(dp, 1, _TINY_MODEL, compression=compression),
        expectation=TargetExpectation(
            allowed=plan_expected_kinds(dp=dp, compression=compression),
            required_any={"collective-permute"},
            min_required=dp - 1,
            max_bytes_per_instr=int(n_params * 1.25 + scale_bytes(n_params) * dp),
            max_total_wire_bytes=compression_wire_ceiling(baseline, analytic),
            expect_donation=True,
            max_peak_bytes=int(7.5 * n_params * 4),
        ),
        min_devices=dp,
    )


def _train_step_target(zero_stage: int, dp: int = 8) -> AuditTarget:
    n4 = _tiny_params_bytes()
    peak_ceiling = int(6.5 * n4) if zero_stage == 0 else int(2.85 * n4)
    return AuditTarget(
        name=f"train/loop.py::train_step[zero{zero_stage},dp]",
        build=_train_build(dp, 1, _TINY_MODEL, zero_stage=zero_stage),
        expectation=TargetExpectation(
            allowed=plan_expected_kinds(dp=8, zero_stage=zero_stage),
            required_any={"all-reduce", "reduce-scatter"},
            min_required=1,
            expect_donation=True,
            max_peak_bytes=peak_ceiling,
        ),
        min_devices=dp,
    )


# ---------------------------------------------------------------------------
# serving programs
# ---------------------------------------------------------------------------


def _serve_cache_bytes_per_device(dp: int, tp: int, num_layers: Optional[int] = None,
                                  kv_quantization: str = "none") -> int:
    """Analytic per-rank KV-cache bytes of the serving geometry (the
    ``kv_cache_bytes_per_device`` the budget gate prices)."""
    from dlbb_tpu_torch.models.configs import ModelConfig, kv_cache_bytes_per_device

    model = dict(_TINY_MODEL)
    if num_layers is not None:
        model["num_layers"] = num_layers
    return kv_cache_bytes_per_device(
        ModelConfig(**model), _SERVE_SHAPE["max_batch"],
        _SERVE_SHAPE["num_blocks"] * _SERVE_SHAPE["block_size"],
        dp=dp, tp=tp, kv_quantization=kv_quantization,
        block_size=_SERVE_SHAPE["block_size"])


def _cache_state(where: Callable[[Any], Any]) -> StateSpec:
    """The cache's tensors, found by ``where`` in the arguments and in the
    result alike."""
    return StateSpec(before=lambda args: list(where(args)),
                     after=lambda out, args: list(where(out)))


def _serve_build(dp: int, tp: int, what: str, k: int = 4):
    """The serving program ``what`` on a (dp, tp) mesh with this rank's
    cache shard and tp parameter shards: the programs
    ``serve/engine.py`` runs (``k`` is the fused trip count and γ)."""

    def build(device):
        import torch

        from dlbb_tpu_torch.data.synthetic import token_embedding_table
        from dlbb_tpu_torch.models.configs import ModelConfig
        from dlbb_tpu_torch.models.transformer import init_params
        from dlbb_tpu_torch.serve import engine as E
        from dlbb_tpu_torch.serve.kvcache import (
            create_kv_cache,
            create_quant_kv_cache,
            gather_cache_slots,
            shard_cache,
        )

        mesh = _mesh(("plan", dp, 1, tp))
        if mesh is None:
            return None
        dev = _device(device)
        c = mesh.coords
        cfg = ModelConfig(**_TINY_MODEL)
        mb, nb, bs = (_SERVE_SHAPE[key] for key in ("max_batch", "num_blocks", "block_size"))

        def cache_for(model_cfg, make=create_kv_cache):
            return shard_cache(make(model_cfg, mb, nb, bs, device=dev), c["dp"], dp,
                               c["tp"], tp)

        params = init_params(cfg, 0, dev, tp_rank=c["tp"], tp=tp)
        cache = cache_for(cfg)
        x = torch.zeros((mb // dp, 1, cfg.hidden_size), dtype=torch.float32, device=dev)
        active = torch.ones((mb,), dtype=torch.bool, device=dev)
        remaining = torch.full((mb,), k, dtype=torch.int32, device=dev)
        carry_cache = _cache_state(lambda t: t[0][0])
        if what == "decode":
            return E.build_decode_step(cfg, mesh), ((cache, x), params, active), carry_cache
        if what == "decode_fused":
            return (E.build_decode_fused(cfg, mesh, k=k),
                    ((cache, x), params, active, remaining), carry_cache)
        table = token_embedding_table(cfg.hidden_size, dtype=torch.float32, device=dev)
        if what == "decode_fused_token":
            return (E.build_decode_fused_token(cfg, mesh, k=k),
                    ((cache, x), params, table, active, remaining), carry_cache)
        if what == "verify":
            ids = torch.zeros((mb // dp, k), dtype=torch.int32, device=dev)
            return (E.build_verify_step(cfg, mesh, gamma=k),
                    ((cache, x), params, table, ids, active, remaining), carry_cache)
        if what == "draft_scan":
            # the 1-layer draft model over its own cache plane
            draft_cfg = ModelConfig(**{**_TINY_MODEL, "num_layers": 1})
            draft_params = init_params(draft_cfg, 1, dev, tp_rank=c["tp"], tp=tp)
            lengths = torch.zeros((mb,), dtype=torch.int32, device=dev)
            return (E.build_draft_scan(draft_cfg, mesh, gamma=k),
                    (cache_for(draft_cfg), draft_params, table, x, lengths, active),
                    _cache_state(lambda t: t[0]))
        if what == "prefill_chunk":
            # the second chunk: a nonempty prefix carry and an offset write
            chunk = bs
            local_kvh = cfg.kv_heads // tp
            pk = torch.zeros((cfg.num_layers, chunk, local_kvh, cfg.head_dim),
                             dtype=torch.float32, device=dev)
            xc = torch.zeros((1, chunk, cfg.hidden_size), dtype=torch.float32, device=dev)
            return (E.build_prefill_chunk(cfg, mesh, chunk_len=chunk, start=chunk),
                    (cache, (pk, pk.clone()), params, xc, 0, 2 * chunk),
                    _cache_state(lambda t: t[0]))
        if what == "prefix_attach":
            return (E.build_prefix_attach(cfg, mesh, matched_len=bs, block_size=bs),
                    (cache, 0, 1), _cache_state(lambda t: t[0]))
        if what == "decode_quant":
            return (E.build_decode_step(cfg, mesh),
                    ((cache_for(cfg, create_quant_kv_cache), x), params, active), carry_cache)
        if what in ("compact_gather", "compact_scatter"):
            idx = torch.arange(mb // 2, device=dev)
            if what == "compact_gather":
                return E.build_compact_gather(), ((cache, x), idx)
            small = (gather_cache_slots(cache, idx), x[:mb // 2].clone())
            return (E.build_compact_scatter(), ((cache, x), small, idx),
                    StateSpec(before=lambda args: list(args[0][0]),
                              after=lambda out, args: list(out[0])))
        xp = torch.zeros((1, _SERVE_SHAPE["bucket"], cfg.hidden_size), dtype=torch.float32,
                         device=dev)
        return (E.build_prefill(cfg, mesh), (cache, params, xp, 0, _SERVE_SHAPE["bucket"]),
                _cache_state(lambda t: t[0]))

    return build


def _decode_act_bytes() -> int:
    """One decode step's ``[max_batch, 1, qkv_width]`` f32 activations."""
    return _SERVE_SHAPE["max_batch"] * 3 * _TINY_MODEL["hidden_size"] * 4


def _decode_step_target(dp: int = 2, tp: int = 4) -> AuditTarget:
    """The decode step: only the per-token tp row sums, each within one
    step's activations (a cache regather fails the byte axis), the cache
    updated in place."""
    act_bytes = _decode_act_bytes()
    cache_dev = _serve_cache_bytes_per_device(dp, tp)
    return AuditTarget(
        name="serve/engine.py::decode_step[dp,tp]",
        build=_serve_build(dp, tp, "decode"),
        expectation=TargetExpectation(
            allowed=plan_expected_kinds(dp=dp, tp=tp, decode=True),
            required_any={"all-reduce"},
            min_required=1,
            max_bytes_per_instr=int(act_bytes * 1.25),
            expect_donation=True,
            max_peak_bytes=int(1.3 * (_tiny_params_bytes() // tp + cache_dev)) + 16 * act_bytes,
            donated_bytes_expected=cache_dev,
        ),
        min_devices=dp * tp,
    )


def _prefill_target(dp: int = 2, tp: int = 4) -> AuditTarget:
    act_bytes = _SERVE_SHAPE["bucket"] * 3 * _TINY_MODEL["hidden_size"] * 4
    cache_dev = _serve_cache_bytes_per_device(dp, tp)
    return AuditTarget(
        name="serve/engine.py::prefill[dp,tp]",
        build=_serve_build(dp, tp, "prefill"),
        expectation=TargetExpectation(
            allowed=plan_expected_kinds(dp=dp, tp=tp, decode=True),
            required_any={"all-reduce"},
            min_required=1,
            max_bytes_per_instr=int(act_bytes * 1.25),
            expect_donation=True,
            max_peak_bytes=int(1.3 * (_tiny_params_bytes() // tp + cache_dev)) + 8 * act_bytes,
            donated_bytes_expected=cache_dev,
        ),
        min_devices=dp * tp,
    )


def _scan_target(what: str, label: str, dp: int = 2, tp: int = 4, k: int = 4,
                 num_layers: Optional[int] = None) -> AuditTarget:
    """The fused decode scans and the draft scan: ``decode_scan_expectation``
    at trip count ``k``."""
    act_bytes = _decode_act_bytes()
    cache_dev = _serve_cache_bytes_per_device(dp, tp, num_layers=num_layers)
    exp = decode_scan_expectation(dp, tp, k, act_bytes)
    exp.max_peak_bytes = int(1.3 * (_tiny_params_bytes() // tp + cache_dev)) + 16 * act_bytes
    exp.donated_bytes_expected = cache_dev
    return AuditTarget(name=f"serve/engine.py::{label}", build=_serve_build(dp, tp, what, k=k),
                       expectation=exp, min_devices=dp * tp)


def _verify_step_target(dp: int = 2, tp: int = 4, gamma: int = 4) -> AuditTarget:
    act_bytes = _decode_act_bytes()
    cache_dev = _serve_cache_bytes_per_device(dp, tp)
    exp = verify_step_expectation(dp, tp, gamma, act_bytes)
    exp.max_peak_bytes = int(
        1.3 * (_tiny_params_bytes() // tp + cache_dev)) + 16 * (gamma + 1) * act_bytes
    exp.donated_bytes_expected = cache_dev
    return AuditTarget(name=f"serve/engine.py::verify_step[gamma{gamma},dp,tp]",
                       build=_serve_build(dp, tp, "verify", k=gamma), expectation=exp,
                       min_devices=dp * tp)


def _prefill_chunk_target(dp: int = 2, tp: int = 4) -> AuditTarget:
    chunk = _SERVE_SHAPE["block_size"]
    act_bytes = chunk * 3 * _TINY_MODEL["hidden_size"] * 4
    cache_dev = _serve_cache_bytes_per_device(dp, tp)
    return AuditTarget(
        name="serve/engine.py::prefill_chunk[dp,tp]",
        build=_serve_build(dp, tp, "prefill_chunk"),
        expectation=TargetExpectation(
            allowed=plan_expected_kinds(dp=dp, tp=tp, decode=True),
            required_any={"all-reduce"},
            min_required=1,
            max_bytes_per_instr=int(act_bytes * 1.25),
            expect_donation=True,
            max_peak_bytes=int(1.3 * (_tiny_params_bytes() // tp + cache_dev)) + 12 * act_bytes,
            donated_bytes_expected=cache_dev,
        ),
        min_devices=dp * tp,
    )


def _compact_target(what: str, tp: int = 4) -> AuditTarget:
    """Slot compaction (dp = 1): local data movement, zero collectives."""
    exp = compact_expectation()
    cache_dev = _serve_cache_bytes_per_device(1, tp)
    exp.max_peak_bytes = int((2.2 if what == "compact_gather" else 2.8) * cache_dev)
    if what == "compact_scatter":
        exp.donated_bytes_expected = cache_dev
    return AuditTarget(name=f"serve/engine.py::{what}[tp]", build=_serve_build(1, tp, what),
                       expectation=exp, min_devices=tp)


def _prefix_attach_target(tp: int = 4) -> AuditTarget:
    """The shared-prefix attach (dp = 1): zero collectives."""
    exp = compact_expectation()
    cache_dev = _serve_cache_bytes_per_device(1, tp)
    exp.max_peak_bytes = int(2.2 * cache_dev)
    exp.donated_bytes_expected = cache_dev
    return AuditTarget(name="serve/engine.py::prefix_attach[tp]",
                       build=_serve_build(1, tp, "prefix_attach"), expectation=exp,
                       min_devices=tp)


def _decode_quant_target(tp: int = 4) -> AuditTarget:
    """The int8-KV decode step (dp = 1): the decode contract, the state
    priced from the quantised layout."""
    act_bytes = _decode_act_bytes()
    cache_q = _serve_cache_bytes_per_device(1, tp, kv_quantization="int8")
    fp_layer = 4 * cache_q // _TINY_MODEL["num_layers"]
    carry_extra = _SERVE_SHAPE["max_batch"] * (_TINY_MODEL["hidden_size"] * 4 + 4)
    return AuditTarget(
        name="serve/engine.py::decode_step[int8,tp]",
        build=_serve_build(1, tp, "decode_quant"),
        expectation=TargetExpectation(
            allowed=plan_expected_kinds(dp=1, tp=tp, decode=True),
            required_any={"all-reduce"},
            min_required=1,
            max_bytes_per_instr=int(act_bytes * 1.25),
            expect_donation=True,
            max_peak_bytes=int(1.3 * (_tiny_params_bytes() // tp + cache_q + fp_layer))
            + 16 * act_bytes,
            donated_bytes_expected=cache_q + carry_extra,
        ),
        min_devices=tp,
    )


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def registry_op_targets() -> list[AuditTarget]:
    """One target per registry collective; the collective-matmul micro-ops
    one per schedule, the compressed ones one per wire dtype."""
    from dlbb_tpu_torch.comm.ops import COMPRESSED_OPS, MATMUL_OPS, OPERATIONS

    targets = [_registry_op_target(name) for name in sorted(OPERATIONS)
               if name not in MATMUL_OPS and name not in COMPRESSED_OPS]
    targets += [_collective_matmul_target(name, schedule) for name in MATMUL_OPS
                for schedule in ("fused", "ring", "bidir")]
    targets += [_compressed_op_target(name, compression) for name in COMPRESSED_OPS
                for compression in ("int8", "fp8")]
    return targets


def model_targets() -> list[AuditTarget]:
    """The forwards (tp, tp overlapped, sp) and the train steps (ZeRO 0 and
    1, tp overlapped, compressed)."""
    return [
        _tp_forward_target(),
        _tp_overlap_forward_target("ring"),
        _tp_overlap_forward_target("bidir"),
        _cp_forward_target("ring"),
        _cp_forward_target("ulysses"),
        _train_step_target(zero_stage=0),
        _train_step_target(zero_stage=1),
        _tp_overlap_train_target("ring"),
        _compressed_train_target("int8"),
    ]


def serving_targets() -> list[AuditTarget]:
    """The 11 serving programs."""
    return [
        _decode_step_target(),
        _prefill_target(),
        _scan_target("decode_fused", "decode_fused[k4,dp,tp]"),
        _scan_target("decode_fused_token", "decode_fused_token[k4,dp,tp]"),
        _verify_step_target(),
        _scan_target("draft_scan", "draft_scan[gamma4,dp,tp]", num_layers=1),
        _prefill_chunk_target(),
        _compact_target("compact_gather"),
        _compact_target("compact_scatter"),
        _prefix_attach_target(),
        _decode_quant_target(),
    ]


def default_targets() -> list[AuditTarget]:
    """The standing audit surface, JAX's 41 targets in JAX's order: every
    registry collective and the barrier, the forwards, the train steps and
    the serving programs."""
    return (registry_op_targets() + [_barrier_target()] + model_targets()
            + serving_targets())


def default_tier(device=None) -> str:
    """The cost-model tier of ``device`` (``analysis/costmodel.py``'s):
    ``cpu-sim`` on the CPU, ``cuda`` on the card."""
    import torch

    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu-sim"
    return "cpu-sim" if torch.device(device).type == "cpu" else "cuda"


def run_hlo_audit(
    targets: Optional[Sequence[AuditTarget]] = None,
    verbose: bool = False,
    passes: Sequence[str] = ("hlo",),
    device=None,
    metas: Optional[dict] = None,
) -> AnalysisReport:
    """Audit ``targets`` (default: ``default_targets()``) on this rank of
    the world (one rank without a process group), every rank of which
    calls this with the same targets.  A target needing more ranks than
    the world has is recorded as skipped.  ``passes`` other than "hlo"
    raise (part 15b).  ``metas``, when given, receives each audited
    target's meta (``audit_target``) by name.  Returns this rank's report:
    rank 0's is the run's."""
    import torch.distributed as dist

    _refuse(passes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    report = AnalysisReport()
    for target in targets if targets is not None else default_targets():
        if target.min_devices > world:
            report.skipped_targets.append({
                "target": target.name,
                "reason": f"needs {target.min_devices} devices, {world} available",
            })
            continue
        try:
            findings, meta = audit_target(target, passes=passes, device=device)
        except Exception as e:  # noqa: BLE001 — one target's failure is contained
            report.findings.append(Finding(
                pass_name="hlo", rule="audit-crash", severity=SEVERITY_ERROR,
                target=target.name, message=f"audit raised {type(e).__name__}: {e}",
            ))
            if verbose:
                print(f"[hlo] {target.name}: CRASH ({type(e).__name__})")
            continue
        report.findings.extend(findings)
        report.targets_audited.append(target.name)
        if metas is not None:
            metas[target.name] = meta
        if verbose and meta.get("on_mesh", True):
            status = "FAIL" if findings else "ok"
            kinds = sorted({c["kind"] for c in meta["collectives"]})
            print(f"[hlo] {target.name}: {status} ({meta['num_collectives']} "
                  f"collective(s) {kinds}, {meta['total_wire_bytes']} wire B)", flush=True)
    return report


def _audit_rank(verbose: bool, device, names: Optional[Sequence[str]] = None):
    """One rank of ``cli analyze hlo --simulate N`` (``bench/launch.py``
    runs it on each): the audit over the default targets (or those named
    ``names``); rank 0 returns its report, the others None."""
    import torch.distributed as dist

    targets = default_targets()
    if names is not None:
        targets = [t for t in targets if t.name in set(names)]
    report = run_hlo_audit(targets, verbose=verbose and dist.get_rank() == 0, device=device)
    return report if dist.get_rank() == 0 else None
