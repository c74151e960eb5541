"""The port's quantised-wire collectives and compressed gradient training
(``dlbb_tpu_torch/comm/compression.py``, ``comm/ops.py``'s ``allreduce_q``
and ``reducescatter_q``, the ``compress_*`` variants, ``train/loop.py``'s
compressed step) against the JAX package's, on the CPU.

- The quantiser (int8, fp8; n = 1000 and 12295 for the chunk padding;
  magnitudes over five decades from a numpy seed): the wire bytes (as
  int8), the scales, ``dequantize_chunked`` and ``quantization_error``
  equal JAX's bit for bit.
- The rings, on 4 spawned gloo ranks (``tests/torch_compression_worker.py``,
  one group for the file) against JAX's ``shard_map`` on 4 CPU devices, on
  the same payloads (``make_payload``, equal bit for bit).  They are not
  equal bit for bit: with fp32 accumulation the outputs differ by one or
  two fp32 ulps of the partial sums (at most 1.5e-6 on sums of about 8,
  measured): XLA's CPU code fuses each hop's dequantise, add and
  re-quantise, and rounds there in the last bit otherwise than the port's
  separate torch ops (neither an unfused nor an FMA emulation of the hop
  in numpy reproduces XLA's output bit for bit); with bf16 accumulation by
  a few bf16 ulps (XLA's CPU code may keep bf16 sums in fp32 between ops).  A partial that lands on a rounding
  boundary of the wire can then round one wire step the other way, so the
  bound is one wire step per quantiser on an element's path (the p - 1 hops
  and the gather): ``p * A / QSTEP``, A the largest sum of |x| over the
  ranks, which bounds every partial; with bf16 accumulation plus a bf16
  ulp of A per hop.  Beside that bound, with fp32 accumulation at most
  ``FLIP_SHARE`` of the elements may differ by more than 8 fp32 ulps of A:
  a flatten or ring order other than JAX's moves nearly all of them.  Each
  output also holds JAX's own tolerance against the exact float64 sum
  (int8 0.04, fp8 0.15, int8 with bf16 accumulation 0.08 of the largest
  sum, ``tests/test_compression.py``), every rank of an all-reduce holds
  the same result, and the bytes counted on the way into
  ``torch.distributed`` equal ``op_wire_bytes``.
- Training at dp=4 (the JAX test model: hidden 32, 2 layers, 4 heads, FFN
  64, fp32, "full"; 8 rows, S=16; SGD at ``LR``, 3 steps) against JAX's
  ``make_train_step`` with ``grad_compression``: int8 and fp8 at ZeRO-0,
  int8 at ZeRO-2.  The local gradients differ from JAX's in the last fp32
  bits, so the same wire-step argument holds per step: a value passes at
  most 4 quantisers, each partial is at most 4 max|c| (``c_max``, measured
  by the ranks before each step), and the sum is divided by 4, so a
  reduced gradient element differs by at most ``4 * c_max / QSTEP``, and
  SGD moves a parameter by ``LR`` times that (``train_bound``, doubled for
  the drift of later gradients).  At most ``FLIP_SHARE`` of the parameters
  may differ by more than ``PARAM_ATOL``.  The residual rows (the local
  quantiser's error) differ by at most one wire step of ``c``, on at most
  ``FLIP_SHARE`` of the elements beyond ``PARAM_ATOL``.  Measured: at most
  3.7e-6 (int8) and 1.9e-5 (fp8) on 6 of 17152 parameters, the residual on
  at most 4 elements; losses within 1.2e-7 relative (``LOSS_RTOL`` 1e-5).
- Every refusal of JAX's envelope, with JAX's message; the residual's
  ``moments_dtype`` cast; a checkpoint round trip of the residual, bit for
  bit, and the step after it.
- A sweep of the compressed ops under the three ``compress_*`` variants on
  the same group: each result records its ``compression``, and the stats'
  ``bytes_on_wire`` is JAX's wire model.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_compression_worker
from jax.sharding import NamedSharding, PartitionSpec as P

from dlbb_tpu.analysis import expectations as jax_expect
from dlbb_tpu.comm import MeshSpec as JaxMeshSpec
from dlbb_tpu.comm import build_mesh
from dlbb_tpu.comm import compression as jax_comp
from dlbb_tpu.comm import get_op as jax_get_op
from dlbb_tpu.comm import make_payload as jax_make_payload
from dlbb_tpu.comm.mesh import build_parallelism_mesh as jax_parallelism_mesh
from dlbb_tpu.comm.variants import VARIANTS as JAX_VARIANTS
from dlbb_tpu.compat import shard_map
from dlbb_tpu.models import configs as jax_configs
from dlbb_tpu.models import transformer as jax_tf
from dlbb_tpu.models.sharding import batch_spec
from dlbb_tpu.train import loop as jax_loop
from dlbb_tpu.train import optim as jax_optim
from dlbb_tpu_torch.analysis import expectations as pt_expect
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu_torch.comm import Mesh, MeshSpec, get_op
from dlbb_tpu_torch.comm import compression as pt_comp
from dlbb_tpu_torch.comm import variants as pt_variants
from dlbb_tpu_torch.models import ModelConfig, params_from_jax
from dlbb_tpu_torch.stats import stats1d as pt_stats1d
from dlbb_tpu_torch.train import loop as pt_loop
from dlbb_tpu_torch.train import optim as pt_optim

torch.set_num_threads(1)

WORLD = 4
MODEL = dict(hidden_size=32, num_layers=2, num_heads=4, ffn_intermediate=64,
             attention="full", dtype="float32")
LR = 0.05
SGD = {"optimizer": "sgd", "momentum": None, "learning_rate": LR}
STEPS = 3
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
FLIP_SHARE = 1e-2
# the JAX tests' tolerances against the exact sum
RING_TOL = {("int8", "float32"): 0.04, ("fp8", "float32"): 0.15,
            ("int8", "bfloat16"): 0.08}
# the coarsest wire step, as a fraction of the chunk's amax: int8's amax /
# 127, fp8 e4m3's top binade [256, 448] spaced by 32
QSTEP = {"int8": 127.0, "fp8": 14.0}
JAX_ACCUM = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _ring(fn, n, comp, accum, world=WORLD, dtype="float32"):
    return {"fn": fn, "n": n, "comp": comp, "accum": accum, "world": world,
            "dtype": dtype}


RING_CASES = {
    f"{fn}/{comp}/{accum}/n{n}": _ring(fn, n, comp, accum)
    for fn in ("psum", "reduce_scatter")
    for comp, accum in RING_TOL
    for n in (1000, 4099)
}
RING_CASES.update({
    "allreduce_q/int8/float32/n777/world2": _ring("allreduce_q", 777, "int8", "float32", 2),
    "reducescatter_q/fp8/float32/n300/world2": _ring("reducescatter_q", 300, "fp8",
                                                     "float32", 2),
    "allreduce_q/fp8/bfloat16/n513/bf16": _ring("allreduce_q", 513, "fp8", "bfloat16",
                                                dtype="bfloat16"),
})


def _train(comp, stage, **extra):
    return {"fields": MODEL, "train": SGD, "stage": stage, "comp": comp,
            "steps": STEPS, **extra}


TRAIN_CASES = {
    "int8/zero0": _train("int8", 0),
    "fp8/zero0": _train("fp8", 0),
    "int8/zero2": _train("int8", 2),
    "none/zero0": _train("none", 0),
    "int8/zero0/bf16-residual": _train("int8", 0, residual_dtype="bfloat16", steps=1),
}
COMPARED = ("int8/zero0", "fp8/zero0", "int8/zero2")
SWEEP_VARIANTS = ("compress_int8", "compress_fp8", "compress_int8_bf16acc")


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, jax_tf.init_params(
        jax_configs.ModelConfig(**MODEL), jax.random.key(0)))


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(7)
    return tuple(rng.standard_normal((8, 16, MODEL["hidden_size"]), dtype=np.float32)
                 for _ in range(2))


@pytest.fixture(scope="module")
def sweep_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("compressed_sweeps")


@pytest.fixture(scope="module")
def ranks(weights, batches, sweep_dir, tmp_path_factory):
    train = dict(TRAIN_CASES)
    train["int8/zero0/checkpoint"] = _train(
        "int8", 0, steps=2, checkpoint=str(tmp_path_factory.mktemp("ckpt")))
    return launch(torch_compression_worker.run_compression_cases, WORLD, "cpu",
                  args=(list(RING_CASES.items()), list(train.items()), weights, batches,
                        str(sweep_dir), SWEEP_VARIANTS),
                  timeout=300, group_timeout=120)


# ---------------------------------------------------------------------------
# the quantiser, bit for bit
# ---------------------------------------------------------------------------


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


@pytest.mark.parametrize("n", [1000, 12295])
@pytest.mark.parametrize("comp", ["int8", "fp8"])
def test_quantizer_matches_jax_bit_for_bit(comp, n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 2, n)).astype(np.float32)
    jq, js = jax_comp.quantize_chunked(jnp.asarray(x), comp)
    tq, ts = pt_comp.quantize_chunked(torch.from_numpy(x), comp)
    assert tq.dtype == {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[comp]
    assert tq.shape == jq.shape and ts.shape == js.shape
    np.testing.assert_array_equal(
        pt_comp._to_wire(tq, comp).numpy(),
        np.asarray(jax_comp._to_wire(jq, comp)))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    np.testing.assert_array_equal(
        _bits(pt_comp.dequantize_chunked(tq, ts, n).numpy()),
        _bits(jax_comp.dequantize_chunked(jq, js, n)))
    np.testing.assert_array_equal(
        _bits(pt_comp.quantization_error(torch.from_numpy(x), comp).numpy()),
        _bits(jax_comp.quantization_error(jnp.asarray(x), comp)))


def test_unknown_compression_fails_as_in_jax():
    with pytest.raises(ValueError) as want:
        jax_comp.quantize_chunked(jnp.zeros(8), "int4")
    with pytest.raises(ValueError) as got:
        pt_comp.quantize_chunked(torch.zeros(8), "int4")
    assert str(got.value) == str(want.value)


def test_wire_constants_are_jax_copies():
    assert pt_comp.COMPRESSIONS is pt_expect.COMPRESSIONS
    assert pt_comp.SCALE_CHUNK_ELEMS == pt_expect.SCALE_CHUNK_ELEMS
    assert pt_expect.COMPRESSIONS == jax_expect.COMPRESSIONS
    assert pt_expect.SCALE_CHUNK_ELEMS == jax_expect.SCALE_CHUNK_ELEMS
    assert pt_expect.COMPRESSED_WIRE_ITEM_BYTES == jax_expect.COMPRESSED_WIRE_ITEM_BYTES
    for n in (1, 255, 256, 257, 4099, 12295):
        assert pt_expect.scale_bytes(n) == jax_expect.scale_bytes(n)
        assert pt_expect.padded_elems(n) == jax_expect.padded_elems(n)


@pytest.mark.parametrize("op_name", ["allreduce", "allgather", "broadcast", "gather",
                                     "scatter", "reduce", "alltoall", "sendrecv",
                                     "reducescatter", "allreduce_q", "reducescatter_q",
                                     "ag_matmul"])
def test_op_wire_bytes_is_jax_model(op_name):
    for p in (1, 2, 4, 8):
        for n in (256, 1000, 4194304):
            for comp in (None, "int8", "fp8"):
                assert pt_stats1d.op_wire_bytes(op_name, n, p, 2, compression=comp) == \
                    jax_expect.op_wire_bytes(op_name, n, p, 2, compression=comp)


# ---------------------------------------------------------------------------
# the rings on 4 gloo ranks against shard_map on 4 CPU devices
# ---------------------------------------------------------------------------


def _jax_ring(spec):
    """JAX's global output and input of a ring case, as numpy."""
    p = spec["world"]
    mesh = build_mesh(JaxMeshSpec.ring(p), devices=jax.devices()[:p])
    kind = "allreduce" if spec["fn"] in ("psum", "allreduce_q") else "reducescatter"
    dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[spec["dtype"]]
    x = jax_make_payload(jax_get_op(kind), mesh, ("ranks",), spec["n"], dtype=dtype)
    kwargs = {"compression": spec["comp"], "accum_dtype": JAX_ACCUM[spec["accum"]]}
    if spec["fn"] in ("psum", "reduce_scatter"):
        body = (jax_comp.psum_compressed if spec["fn"] == "psum"
                else jax_comp.reduce_scatter_compressed)
        fn = jax.jit(shard_map(lambda xl: body(xl[0], "ranks", **kwargs)[None],
                               mesh=mesh, in_specs=P("ranks"), out_specs=P("ranks")))
    else:
        fn = jax_get_op(spec["fn"]).build(mesh, ("ranks",), **kwargs)
    out = np.asarray(fn(x)).astype(np.float32)
    return out.reshape(p, -1), np.asarray(x).astype(np.float64)


def _exact(spec, x):
    """The exact (float64) reduction of the global input, per rank."""
    if spec["fn"] in ("psum", "allreduce_q"):
        return np.broadcast_to(x.sum(0), x.shape)
    return x.sum(0).reshape(spec["world"], -1)  # rank k: the sum of rows k


def _port_ring(ranks, case_id, spec):
    rows = [r["ring"][case_id] for r in ranks[:spec["world"]]]
    return np.stack([o.reshape(-1) for o, _ in rows]), [b for _, b in rows]


def _ulp32(a):
    return float(np.spacing(np.float32(a)))


@pytest.mark.parametrize("case_id", sorted(RING_CASES))
def test_ring_matches_jax_within_a_wire_step(ranks, case_id):
    spec = RING_CASES[case_id]
    got, _ = _port_ring(ranks, case_id, spec)
    ref, x = _jax_ring(spec)
    p = spec["world"]
    a = np.abs(x).sum(0).max()  # bounds every partial sum of the ring
    bound = p * a / QSTEP[spec["comp"]]
    if spec["accum"] == "bfloat16" or spec["dtype"] == "bfloat16":
        bound += p * a * 2.0**-8
    diff = np.abs(got - ref)
    assert diff.max() <= bound, (diff.max(), bound)
    if spec["accum"] == "float32" and spec["dtype"] == "float32":
        assert (diff > 8 * _ulp32(a)).mean() <= FLIP_SHARE
    exact = _exact(spec, x).reshape(got.shape)
    tol = RING_TOL.get((spec["comp"], spec["accum"]), 0.15)
    assert np.abs(got - exact).max() <= tol * np.abs(exact).max()
    if spec["fn"] in ("psum", "allreduce_q"):
        assert (got == got[0]).all()  # every rank holds the same result


@pytest.mark.parametrize("case_id", sorted(RING_CASES))
def test_wire_bytes_counted_equal_op_wire_bytes(ranks, case_id):
    spec = RING_CASES[case_id]
    _, counted = _port_ring(ranks, case_id, spec)
    op = "allreduce_q" if spec["fn"] in ("psum", "allreduce_q") else "reducescatter_q"
    want = pt_stats1d.op_wire_bytes(op, spec["n"], spec["world"], 2,
                                    compression=spec["comp"])
    assert counted == [want] * spec["world"]


# ---------------------------------------------------------------------------
# the compressed train step at dp=4 against JAX's
# ---------------------------------------------------------------------------


def _jax_train(spec, weights, batches):
    cfg = jax_configs.ModelConfig(**spec["fields"])
    mesh = jax_parallelism_mesh(WORLD, 1, 1, 1, 1, devices=jax.devices()[:WORLD])
    step, state = jax_loop.make_train_step(
        cfg, mesh, jax_optim.build_optimizer(spec["train"]),
        jax.tree.map(jnp.asarray, weights), zero_stage=spec["stage"],
        grad_compression=spec["comp"])
    sharding = NamedSharding(mesh, batch_spec(mesh))
    x, t = (jax.device_put(jnp.asarray(a), sharding) for a in batches)
    losses = []
    for _ in range(spec["steps"]):
        state, loss = step(state, x, t)
        losses.append(float(loss))
    return (losses, jax.tree.map(np.asarray, state.params),
            np.asarray(state.opt_state[1].residual, np.float32))


def _leaves_by_path(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves_by_path(v, f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): tree}


def train_bound(comp, c_max, world=WORLD):
    """Per-element bound on |port - JAX| of a parameter after the steps
    (module docstring): ``LR`` x world x c_max / QSTEP per step, summed
    over the steps' ``c_max`` and doubled."""
    return 2 * LR * world * sum(c_max) / QSTEP[comp]


@pytest.mark.parametrize("case_id", COMPARED)
def test_compressed_train_step_matches_jax(ranks, weights, batches, case_id):
    spec = TRAIN_CASES[case_id]
    ref_losses, ref_params, ref_res = _jax_train(spec, weights, batches)
    got = [r["train"][case_id] for r in ranks]
    for other in got[1:]:
        assert other["losses"] == got[0]["losses"] and other["c_max"] == got[0]["c_max"]
        for a, b in zip(pt_optim.tree_leaves(other["params"]),
                        pt_optim.tree_leaves(got[0]["params"])):
            np.testing.assert_array_equal(a, b)  # the dp ranks agree bit for bit
    np.testing.assert_allclose(got[0]["losses"], ref_losses, rtol=LOSS_RTOL)
    port, ref = _leaves_by_path(got[0]["params"]), _leaves_by_path(ref_params)
    assert set(port) == set(ref)
    diff = np.concatenate([np.abs(port[k] - ref[k]).ravel() for k in sorted(port)])
    assert diff.max() <= train_bound(spec["comp"], got[0]["c_max"])
    assert (diff > PARAM_ATOL).mean() <= FLIP_SHARE
    step = max(got[0]["c_max"]) / QSTEP[spec["comp"]]
    for r in got:  # each rank's residual row against JAX's row of that rank
        res, row = r["residual"], ref_res[r["coords"]["dp"]]
        assert res.shape == row.shape and np.isfinite(res).all() and np.abs(res).max() > 0
        assert np.abs(res - row).max() <= step
        assert (np.abs(res - row) > PARAM_ATOL).mean() <= FLIP_SHARE


@pytest.mark.parametrize("comp,bound", [("int8", 0.02), ("fp8", 0.05)])
def test_compressed_train_tracks_uncompressed(ranks, comp, bound):
    """JAX's train-side gate on the port: each step's loss within int8 0.02
    or fp8 0.05 relative of the uncompressed run's."""
    base = ranks[0]["train"]["none/zero0"]["losses"]
    got = ranks[0]["train"][f"{comp}/zero0"]["losses"]
    div = max(abs(a - b) / max(abs(a), 1e-9) for a, b in zip(base, got))
    assert div <= bound, (div, base, got)
    assert got[-1] < got[0]


def test_residual_follows_moments_dtype(ranks):
    assert all(r["train"]["int8/zero0/bf16-residual"]["residual_dtype"] == "torch.bfloat16"
               for r in ranks)
    assert all(r["train"]["int8/zero0"]["residual_dtype"] == "torch.float32" for r in ranks)
    state = pt_optim.init_error_feedback({"a": torch.zeros(3, 2), "b": torch.zeros(5)},
                                         "bfloat16")
    assert state.residual.shape == (11,) and state.residual.dtype == torch.bfloat16


def test_residual_checkpoint_roundtrip(ranks):
    """The residual is saved and restored with the optimizer state, bit for
    bit, and the step after the restore equals the uninterrupted one."""
    for r in ranks:
        res = r["train"]["int8/zero0/checkpoint"]
        assert res["restored_step"] == 2
        np.testing.assert_array_equal(res["restored_residual"], res["residual"])
        assert np.abs(res["residual"]).max() > 0
        assert res["resumed_equal"]


def test_flatten_order_is_ravel_pytrees(weights):
    from jax.flatten_util import ravel_pytree

    flat, _ = ravel_pytree(jax.tree.map(jnp.asarray, weights))
    port = params_from_jax(weights, ModelConfig(**MODEL))
    np.testing.assert_array_equal(pt_optim.flatten_params(port).numpy(), np.asarray(flat))
    back = pt_optim.unflatten_params(pt_optim.flatten_params(port), port)
    for a, b in zip(pt_optim.tree_leaves(back), pt_optim.tree_leaves(port)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the envelope: JAX's refusals, with JAX's messages
# ---------------------------------------------------------------------------


def _fake_mesh(**axes):
    names = tuple(axes)
    return Mesh(MeshSpec(tuple(axes.values()), names), 0, None, {})


REFUSALS = {
    "unknown": dict(kwargs=dict(grad_compression="int4"), dp=4),
    "tp-axis": dict(kwargs=dict(grad_compression="int8"), dp=2, tp=2),
    "dp1": dict(kwargs=dict(grad_compression="int8"), dp=1),
    "zero1": dict(kwargs=dict(grad_compression="int8", zero_stage=1), dp=4),
    "zero3": dict(kwargs=dict(grad_compression="int8", zero_stage=3), dp=4),
    "grad-accum": dict(kwargs=dict(grad_compression="int8", grad_accum=2), dp=4),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_match_jax(name, weights):
    case = REFUSALS[name]
    dp, tp = case["dp"], case.get("tp", 1)
    params = jax.tree.map(jnp.asarray, weights)
    mesh = jax_parallelism_mesh(dp, 1, 1, tp, 1, devices=jax.devices()[:dp * tp])
    kwargs = dict(case["kwargs"])
    with pytest.raises(ValueError) as want:
        jax_loop.make_train_step(jax_configs.ModelConfig(**MODEL), mesh,
                                 jax_optim.build_optimizer(SGD), params, **kwargs)
    port_mesh = None if dp * tp == 1 else _fake_mesh(dp=dp, tp=tp)
    with pytest.raises(ValueError) as got:
        pt_loop.make_train_step(ModelConfig(**MODEL), pt_optim.build_optimizer(SGD),
                                params_from_jax(weights, ModelConfig(**MODEL)),
                                mesh=port_mesh, batch_size=8, **kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("what", ["moe-aux", "attention"])
def test_envelope_refusals_match_jax_messages(what):
    """The MoE aux loss (on a MoE model) and a non-dense attention, at dp=4:
    JAX refuses both when it builds the step, and the port with the same
    words."""
    fields = (dict(MODEL, num_experts=2, moe_top_k=1) if what == "moe-aux"
              else dict(MODEL, attention="ring"))
    aux = 0.01 if what == "moe-aux" else 0.0
    jcfg = jax_configs.ModelConfig(**fields)
    params = jax_tf.init_params(jcfg, jax.random.key(0))
    mesh = jax_parallelism_mesh(WORLD, 1, 1, 1, 1, devices=jax.devices()[:WORLD])
    with pytest.raises(ValueError) as want:
        jax_loop.make_train_step(jcfg, mesh, jax_optim.build_optimizer(SGD), params,
                                 moe_aux_weight=aux, grad_compression="int8")
    with pytest.raises(ValueError) as got:
        pt_loop.check_grad_compression("int8", ModelConfig(**fields),
                                       _fake_mesh(dp=WORLD, tp=1), 0, 1, aux)
    assert str(got.value) == str(want.value)


def _config(**training):
    return {
        "experiment": {"name": "train_compression"},
        "model": dict(MODEL),
        "parallelism": {"world_size": 1, "data_parallel": 1},
        "input": {"batch_size": 8, "sequence_length": 16, "seed": 42},
        "execution": {"warmup_iterations": 1, "benchmark_iterations": 2},
        "training": {"learning_rate": 1e-2, **training},
    }


@pytest.mark.parametrize("training", [
    {"grad_compression": "int8"},
    {"grad_compression": "lossy"},
    {"grad_compression": "int8", "compression_accum_dtype": "float16"},
], ids=["dp1", "unknown-mode", "unknown-accum"])
def test_run_train_refuses_as_jax(training, devices):
    with pytest.raises(ValueError) as want:
        jax_loop.run_train(_config(**training), verbose=False)
    with pytest.raises(ValueError) as got:
        pt_loop.run_train(_config(**training), device="cpu", verbose=False)
    assert str(got.value) == str(want.value)


def test_cli_train_grad_compression_at_world_1_is_refused(tmp_path):
    import yaml

    from dlbb_tpu_torch import cli

    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(_config()))
    with pytest.raises(ValueError, match="data_parallel=1"):
        cli.main(["train", "--config", str(path), "--device", "cpu",
                  "--grad-compression", "int8"])


# ---------------------------------------------------------------------------
# the registry, the variants and a compressed sweep
# ---------------------------------------------------------------------------


def test_compressed_ops_and_variants_are_ported():
    for name in ("allreduce_q", "reducescatter_q"):
        assert get_op(name).input_kind == jax_get_op(name).input_kind
        assert get_op(name).output_kind == jax_get_op(name).output_kind
    for name in SWEEP_VARIANTS:
        v, ref = pt_variants.get_variant(name), JAX_VARIANTS[name]
        assert (v.compression, v.accum_dtype) == (ref.compression, ref.accum_dtype)
    assert pt_variants.get_variant("nofuse").compression is None
    for name in ("combine4mb", "combine128mb"):
        with pytest.raises(NotImplementedError, match="item 8"):
            pt_variants.get_variant(name)


@pytest.mark.parametrize("variant", SWEEP_VARIANTS)
def test_compressed_sweep_records_its_wire(ranks, sweep_dir, variant):
    out = Path(sweep_dir) / variant
    files = sorted(p for p in out.glob("*.json") if p.name != "sweep_manifest.json")
    assert len(files) == 2
    want = JAX_VARIANTS[variant].compression
    for f in files:
        data = json.loads(f.read_text())
        assert data["compression"] == want and data["variant"] == variant
        assert data["implementation"] == f"torch_gloo_{variant}"
        row = pt_stats1d.process_file(f)
        assert row["bytes_on_wire"] == jax_expect.op_wire_bytes(
            data["operation"], data["num_elements"], WORLD, 2, compression=want)
