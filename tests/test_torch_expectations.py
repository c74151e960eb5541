"""The analytic expected-collective model (ROADMAP Queue 1, Slice F, item
15, part 15a: ``dlbb_tpu_torch/analysis/expectations.py``) against JAX's
``dlbb_tpu.analysis.expectations`` over a grid of ops, sizes, rank counts
and compressions.

Kinds are compared through the kind vocabulary: a recorded ``c10d`` op maps
to JAX's HLO kind where XLA has one.  The rows of ``OP_EXPECTED_KINDS`` in
which the port issues a native rooted op where JAX composes a symmetric
one (broadcast, gather, scatter, reduce) are pinned by name; each row's
``cost_kind`` is JAX's lowering of the op.
"""

import dataclasses
import itertools
from pathlib import Path

import pytest
import torch

from dlbb_tpu.analysis import expectations as jx
from dlbb_tpu.analysis import hlo_parse as jax_hlo_parse
from dlbb_tpu_torch.analysis import expectations as pt
from dlbb_tpu_torch.comm import compression as pt_comp
from dlbb_tpu_torch.obs import corpus as pt_corpus
from dlbb_tpu_torch.stats import stats1d as pt_stats1d

OPS = ("allreduce", "allreduce_hierarchical", "allgather", "broadcast", "gather",
       "scatter", "reduce", "alltoall", "sendrecv", "reducescatter", "barrier",
       "allreduce_q", "reducescatter_q", "ag_matmul", "matmul_rs", "unknown")
SIZES = (0, 1, 7, 255, 256, 257, 1000, 4096, 65537)
RANKS = (1, 2, 3, 4, 8, 16)
COMPRESSIONS = (None, "int8", "fp8")
# the rows in which the port issues the native c10d op (module docstring)
NATIVE_ROOTED = {"broadcast": "broadcast", "gather": "gather", "scatter": "scatter",
                 "reduce": "reduce"}


def _fields(exp):
    return dataclasses.asdict(exp)


def test_wire_constants_are_jax_and_have_one_home():
    for name in ("COMPRESSIONS", "COMPRESSED_WIRE_ITEM_BYTES", "SCALE_CHUNK_ELEMS",
                 "SCALE_ITEM_BYTES"):
        assert getattr(pt, name) == getattr(jx, name), name
    assert pt.COLLECTIVE_KINDS == jax_hlo_parse.COLLECTIVE_KINDS
    # stats1d, the corpus and the compressed rings read the one copy
    assert pt_stats1d.op_wire_bytes is pt.op_wire_bytes
    assert pt_corpus.op_wire_bytes is pt.op_wire_bytes
    assert pt_comp.COMPRESSIONS is pt.COMPRESSIONS
    assert "def op_wire_bytes" not in Path(pt_stats1d.__file__).read_text()


@pytest.mark.parametrize("n", SIZES)
def test_scale_bytes_and_padded_elems_are_jax(n):
    assert pt.scale_bytes(n) == jx.scale_bytes(n)
    assert pt.padded_elems(n) == jx.padded_elems(n)


@pytest.mark.parametrize("op", OPS)
def test_op_wire_bytes_is_jax(op):
    for n, p, b, comp in itertools.product(SIZES, RANKS, (1, 2, 4), COMPRESSIONS):
        assert pt.op_wire_bytes(op, n, p, b, compression=comp) == \
            jx.op_wire_bytes(op, n, p, b, compression=comp), (op, n, p, b, comp)


@pytest.mark.parametrize("kind", sorted(jx.AXIS_EXPECTED_KINDS["dp"] | {
    "collective-permute", "all-to-all", "other"}))
def test_wire_bytes_of_jax_kinds_is_jax(kind):
    for nbytes, p in itertools.product((0, 1, 4, 1000, 65536, 12345), (None, 1, 2, 3, 8)):
        assert pt.wire_bytes(kind, nbytes, p) == jx.wire_bytes(kind, nbytes, p)


@pytest.mark.parametrize("op", sorted(NATIVE_ROOTED))
def test_port_kinds_wire_is_what_op_wire_bytes_charges(op):
    """A native rooted op's recorded result (the gathered buffer for
    gather, the received row for scatter, the buffer otherwise) prices at
    the volume ``op_wire_bytes`` charges the registry op."""
    for n, p, b in itertools.product((1, 256, 4096), (2, 4, 8), (2, 4)):
        result = p * n * b if op == "gather" else n * b
        assert pt.wire_bytes(NATIVE_ROOTED[op], result, p) == \
            jx.op_wire_bytes(op, n, p, b) == pt.op_wire_bytes(op, n, p, b)


def test_kind_vocabulary_maps_c10d_ops_to_jax_kinds():
    want = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
            "allgather_": "all-gather", "_reduce_scatter_base_": "reduce-scatter",
            "reduce_scatter_": "reduce-scatter", "alltoall_base_": "all-to-all",
            "alltoall_": "all-to-all", "send": "collective-permute",
            "recv_": "collective-permute", "broadcast_": "broadcast", "gather_": "gather",
            "scatter_": "scatter", "reduce_": "reduce", "barrier": "barrier"}
    for op, kind in want.items():
        assert pt.C10D_KINDS[op] == kind
    assert set(pt.C10D_KINDS.values()) <= set(jx.AXIS_EXPECTED_KINDS["dp"]) | {
        "collective-permute", "all-to-all"} | set(pt.PORT_KINDS)
    assert not set(pt.PORT_KINDS) & set(pt.COLLECTIVE_KINDS)


def test_op_expected_kinds_rows_pinned_against_jax():
    assert set(pt.OP_EXPECTED_KINDS) == set(jx.OP_EXPECTED_KINDS)
    differing = set()
    for op, row in pt.OP_EXPECTED_KINDS.items():
        jrow = jx.OP_EXPECTED_KINDS[op]
        # cost_kind: JAX's lowering (its required kind or first required_any)
        jkind = jrow.get("required") or sorted(jrow["required_any"])[0]
        assert row["cost_kind"] == jkind, op
        if {k: v for k, v in row.items() if k != "cost_kind"} != jrow:
            differing.add(op)
    assert differing == set(NATIVE_ROOTED)
    for op, kind in NATIVE_ROOTED.items():
        row = pt.OP_EXPECTED_KINDS[op]
        assert row["required"] == kind and row["allowed"] == {kind}
    # the corpus prices every op as JAX's corpus does
    for op in list(OPS) + ["allreduce_q"]:
        for variant in ("default", "overlap_ring", "compress_int8"):
            jrow = jx.OP_EXPECTED_KINDS.get(op, {})
            jkind = jrow.get("required") or (sorted(jrow["required_any"])[0]
                                             if jrow.get("required_any") else None)
            if variant.startswith("overlap_") or op.endswith("_q") or jkind is None:
                jkind = "collective-permute"
            assert pt_corpus.hlo_kind(op, variant) == jkind, (op, variant)


@pytest.mark.parametrize("op", sorted(jx.OP_EXPECTED_KINDS))
def test_op_expectation_is_jax(op):
    for nbytes, slack in ((1024, 1.25), (8192, 1.0), (4, 2.0)):
        got, want = _fields(pt.op_expectation(op, nbytes, slack)), \
            _fields(jx.op_expectation(op, nbytes, slack))
        if op in NATIVE_ROOTED:
            want["allowed"] = want["required_any"] = {NATIVE_ROOTED[op]}
        assert got == want


def test_plan_expected_kinds_is_jax():
    grid = itertools.product((1, 2, 8), (1, 2, 4), (1, 2), (1, 2), (1, 2),
                             ("full", "ring", "ulysses"), (0, 1, 3),
                             ("off", "ring"), ("none", "int8"))
    for dp, tp, sp, pp, ep, att, zero, overlap, comp in grid:
        kwargs = dict(dp=dp, tp=tp, sp=sp, pp=pp, ep=ep, attention=att, zero_stage=zero,
                      tp_overlap=overlap, compression=comp)
        assert pt.plan_expected_kinds(**kwargs) == jx.plan_expected_kinds(**kwargs)
    for dp, tp in itertools.product((1, 2), (1, 2, 4)):
        assert pt.plan_expected_kinds(dp=dp, tp=tp, decode=True) == \
            jx.plan_expected_kinds(dp=dp, tp=tp, decode=True)
    with pytest.raises(ValueError, match="decode=True"):
        pt.plan_expected_kinds(sp=2, decode=True)


@pytest.mark.parametrize("op", ("allreduce_q", "reducescatter_q"))
def test_compressed_op_expectation_is_jax(op):
    for p, n, comp, ratio in itertools.product((2, 4, 8), (1, 256, 4096, 5000),
                                               ("int8", "fp8"), (0.55, 0.7)):
        assert _fields(pt.compressed_op_expectation(op, p, n, comp, ratio=ratio)) == \
            _fields(jx.compressed_op_expectation(op, p, n, comp, ratio=ratio))
    with pytest.raises(ValueError, match="not a compressed"):
        pt.compressed_op_expectation("allreduce", 2, 16)


def test_scan_verify_compact_overlap_expectations_are_jax():
    for dp, tp, k, act in itertools.product((1, 2), (1, 2, 4), (1, 4), (256, 3072)):
        assert _fields(pt.decode_scan_expectation(dp, tp, k, act)) == \
            _fields(jx.decode_scan_expectation(dp, tp, k, act))
        assert _fields(pt.verify_step_expectation(dp, tp, k, act)) == \
            _fields(jx.verify_step_expectation(dp, tp, k, act))
    for p, chunk in itertools.product((2, 4, 8), (16, 8192)):
        assert _fields(pt.overlap_op_expectation(p, chunk)) == \
            _fields(jx.overlap_op_expectation(p, chunk))
    assert _fields(pt.compact_expectation()) == _fields(jx.compact_expectation())
    assert pt.compression_wire_ceiling(1000, 700) == jx.compression_wire_ceiling(1000, 700)
    assert [f.name for f in dataclasses.fields(pt.TargetExpectation)] == \
        [f.name for f in dataclasses.fields(jx.TargetExpectation)]


@pytest.mark.parametrize("dtype,want", [("float32", "f32"), ("bfloat16", "bf16"),
                                        (torch.float32, "f32"), (torch.bfloat16, "bf16"),
                                        (torch.float16, "f16"), ("f64", "f64")])
def test_policy_dtype_for_takes_torch_dtypes(dtype, want):
    assert pt.policy_dtype_for(dtype) == want
    if isinstance(dtype, str):
        assert jx.policy_dtype_for(dtype) == want
    with pytest.raises(ValueError):
        pt.policy_dtype_for(torch.int8)
