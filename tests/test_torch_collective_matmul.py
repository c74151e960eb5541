"""The port's overlapped tensor parallelism (``parallel/collective_matmul.py``,
``parallel/ring.py``, the ``tp_overlap`` routing of ``models/transformer.py``,
the sequence-chunk loss and gradient sums of ``train/loop.py``, the sweep
ops ``ag_matmul``/``matmul_rs`` with the ``overlap_*`` variants) against the
JAX package's, which runs on the CPU-simulated mesh of ``conftest.py``.

The port runs once per module on 8 spawned gloo ranks
(``tests/torch_seq_worker.py``), each case on the first ranks of its mesh;
the inputs are numpy-seeded arrays (or JAX ``init_params`` weights carried
across with ``params_from_jax``), which each rank cuts to its part.  It
mirrors ``tests/test_collective_matmul.py``:

- both primitives, forward and gradients of ``sum(z**2)``, ring and bidir,
  on the (dp, tp), flat tp and (dp, sp, tp) meshes: fp32, relative L2
  ``FP32_REL_L2`` = 1e-5 (the same products and ring additions as JAX's
  bodies, fp32 sums in another order).  The port's dw is the rank's own
  rows' (JAX psums it over dp and sp inside the ring; the port's train step
  sums it outside, once): the test sums the ranks' dw over dp and sp;
- the uneven-shard and schedule refusals, with JAX's messages;
- the model forward with ``tp_overlap`` against JAX's at dp=2 x tp=4 and at
  dp=2 x sp=2 x tp=2 (ring attention), each rank returning its chunk of the
  sequence: fp32 to ``FP32_REL_L2``; bf16 to ``bf16_bound(tp)`` of
  ``tests/test_torch_tp.py``, 1e-2 + 2 L (tp - 1) 2**-8: the ring's matmul-
  reduce-scatter rounds each partial product to bf16 and adds the tp
  partials in tp - 1 sequential bf16 additions, as many roundings as the
  all-reduce that bound argues (two such products per layer, L layers), and
  the two frameworks round the other products at slightly different places
  (the 1e-2);
- one SGD step at lr ``SGD_LR`` = 1024 (``tests/test_torch_zero.py`` argues
  it: ``(p0 - p1) / lr`` is the reduced gradient to about 6e-8) with
  ``tp_overlap`` at ZeRO 0-3 at dp=2 x tp=2 (ring; bidir at stage 1), and
  with ring attention at dp=2 x sp=2 x tp=2, against JAX's reduced gradient
  to ``GRAD_RTOL`` = 1e-5 of each leaf's largest gradient.  A missing tp sum
  of the LayerNorm and row-bias gradients halves them, a dp reduction done
  twice doubles every leaf: both fail here;
- the sweep ops under fused, ring and bidir at world 4 against the JAX
  builders on the same payload (fp32 to ``FP32_REL_L2``; bf16 to p 2**-8
  relative L2: each output is one product rounded once, plus, for
  ``matmul_rs``, p - 1 bf16 additions of the partials), each schedule's
  output against the fused one and ``plain_collective``; the weight shard
  against JAX's ``_synth_weight`` (bf16 bit for bit, fp32 within two ulps:
  torch's and XLA's fp32 cos round differently); and ``cli bench3d --variant
  overlap_ring|overlap_bidir`` at world 4, whose files carry the JAX names
  and keys.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_seq_worker
import yaml
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from test_torch_tp import bf16_bound

from dlbb_tpu.bench import Sweep3D as JaxSweep3D
from dlbb_tpu.bench import run_sweep as jax_run_sweep
from dlbb_tpu.bench.runner import _iter_configs as jax_iter_configs
from dlbb_tpu.bench.runner import _result_filename as jax_result_filename
from dlbb_tpu.comm import MeshSpec as JaxMeshSpec
from dlbb_tpu.comm import build_mesh
from dlbb_tpu.comm import get_op as jax_get_op
from dlbb_tpu.comm import make_payload as jax_make_payload
from dlbb_tpu.comm.mesh import build_parallelism_mesh as jax_parallelism_mesh
from dlbb_tpu.comm.ops import _synth_weight as jax_synth_weight
from dlbb_tpu.models import configs as jax_configs
from dlbb_tpu.models import transformer as jax_tf
from dlbb_tpu.models.sharding import batch_spec as jax_batch_spec
from dlbb_tpu.parallel import collective_matmul as jax_cm
from dlbb_tpu.parallel.plan import ParallelismPlan as JaxPlan
from dlbb_tpu.train import loop as jax_loop
from dlbb_tpu.train import optim as jax_optim
from dlbb_tpu_torch import cli
from dlbb_tpu_torch.bench import runner
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu_torch.comm import Mesh, MeshSpec, plain_collective
from dlbb_tpu_torch.comm.ops import _synth_weight
from dlbb_tpu_torch.models import ModelConfig
from dlbb_tpu_torch.models.sharding import unshard_params
from dlbb_tpu_torch.parallel import collective_matmul as cm
from dlbb_tpu_torch.parallel.plan import check_plan
from dlbb_tpu_torch.train import optim as pt_optim
from dlbb_tpu_torch.train import zero as pt_zero

FP32_REL_L2, GRAD_RTOL, SGD_LR, LR_CLI = 1e-5, 1e-5, 1024.0, 1e-3
BF16_U = 2.0**-8
# the JAX test's operands: x [4, 16, 16], w1 [16, 16], w2 [16, 16]
PRIM_MESHES = {"dp2xtp4": (2, 1, 4), "tp8": (1, 1, 8), "dp2xsp2xtp2": (2, 2, 2)}
SCHEDULES = ("ring", "bidir")
# the dryrun's test model at tp=4 (hidden 16 tp, ffn 32 tp), S=16
MODEL = dict(hidden_size=64, num_layers=2, num_heads=4, ffn_intermediate=128,
             attention="full", dtype="float32")
FWD_MESHES = {"dp2xtp4": ((2, 1, 4), "full"), "dp2xsp2xtp2": ((2, 2, 2), "ring")}
SGD = {"optimizer": "sgd", "momentum": None, "learning_rate": SGD_LR}
OPS_SHAPE = (2, 16, 64)  # the JAX test's micro-op payload
RING4 = ("grid", (4,), ("ranks",))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _forward_cases():
    cases = {}
    for mesh_name, (mesh, attention) in FWD_MESHES.items():
        for dtype in ("float32", "bfloat16"):
            for schedule in SCHEDULES:
                cases[f"{mesh_name}-{dtype}-{schedule}"] = {
                    "mesh": mesh, "batch": "dp2",
                    "fields": dict(MODEL, dtype=dtype, attention=attention,
                                   tp_overlap=schedule),
                    "weights": f"{dtype}"}
    return cases


FWD_CASES = _forward_cases()


def _sgd(mesh, stage, **model):
    return {"mesh": mesh, "fields": dict(MODEL, **model), "weights": "float32",
            "train": SGD, "stage": stage, "grad_accum": 1, "steps": 1, "batch": "dp2"}


SGD_CASES = {
    **{f"ring/dp2tp2/zero{z}": _sgd((2, 1, 2), z, tp_overlap="ring") for z in range(4)},
    "bidir/dp2tp2/zero1": _sgd((2, 1, 2), 1, tp_overlap="bidir"),
    "ring/dp2sp2tp2/zero1": _sgd((2, 2, 2), 1, tp_overlap="ring", attention="ring"),
}
OP_CASES = {f"{name}-{schedule}-{dtype}": {"mesh": RING4, "name": name, "schedule": schedule,
                                           "dtype": dtype, "shape": OPS_SHAPE}
            for name in ("ag_matmul", "matmul_rs") for schedule in ("fused", "ring", "bidir")
            for dtype in ("float32", "bfloat16")}


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(11)
    x, w1, w2 = (rng.standard_normal(shape, dtype=np.float32)
                 for shape in ((4, 16, 16), (16, 16), (16, 16)))
    weights = {dtype: jax.tree.map(lambda a: np.asarray(a, np.float32), jax_tf.init_params(
        jax_configs.ModelConfig(**dict(MODEL, dtype=dtype)), jax.random.key(1)))
        for dtype in ("float32", "bfloat16")}
    batch = tuple(rng.standard_normal((8, 16, 64), dtype=np.float32) for _ in range(2))
    return {"x": x, "w1": w1, "w2": w2, "weights": weights, "batches": {"dp2": batch}}


@pytest.fixture(scope="module")
def ranks(arrays):
    jobs = ([("matmul", f"{m}-{s}", {"mesh": mesh, "schedule": s})
             for m, mesh in PRIM_MESHES.items() for s in SCHEDULES]
            + [("forward", cid, spec) for cid, spec in FWD_CASES.items()]
            + [("sweep_op", cid, spec) for cid, spec in OP_CASES.items()]
            + [("train", cid, spec) for cid, spec in SGD_CASES.items()])
    return launch(torch_seq_worker.run_jobs, 8, "cpu", args=(jobs, arrays), timeout=600,
                  group_timeout=120)


def _members(ranks, case_id):
    return [r[case_id] for r in ranks if case_id in r]


def jax_mesh(dims):
    dp, sp, tp = dims
    return jax_parallelism_mesh(data_parallel=dp, sequence_parallel=sp, tensor_parallel=tp,
                                devices=jax.devices()[:dp * sp * tp])


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("mesh_name", sorted(PRIM_MESHES))
def test_primitives_and_gradients_match_jax(ranks, arrays, devices, mesh_name, schedule):
    dims = PRIM_MESHES[mesh_name]
    dp, sp, tp = dims
    mesh = jax_mesh(dims)
    x, w1, w2 = (jnp.asarray(arrays[k]) for k in ("x", "w1", "w2"))
    xs = jax.device_put(x, NamedSharding(mesh, jax_cm.activation_spec(mesh)))
    w1s = jax.device_put(w1, NamedSharding(mesh, P(None, "tp")))
    w2s = jax.device_put(w2, NamedSharding(mesh, P("tp", None)))

    def run(a, b, c):
        y = jax_cm.allgather_matmul(a, b, mesh, schedule=schedule)
        return y, jax_cm.matmul_reducescatter(y, c, mesh, schedule=schedule)

    y_ref, z_ref = (np.asarray(t) for t in jax.jit(run)(xs, w1s, w2s))
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(run(a, b, c)[1] ** 2),
                             argnums=(0, 1, 2)))(xs, w1s, w2s)
    dx_ref, dw1_ref, dw2_ref = (np.asarray(g) for g in grads)

    members = _members(ranks, f"{mesh_name}-{schedule}")
    assert len(members) == dp * sp * tp
    y, z, dx = np.zeros_like(y_ref), np.zeros_like(z_ref), np.zeros_like(dx_ref)
    dw1, dw2 = np.zeros_like(dw1_ref), np.zeros_like(dw2_ref)
    rows, n_seq, f = 4 // dp, 16 // (sp * tp), 16 // tp
    for m in members:
        c, (idx, count) = m["coords"], m["index"]
        assert count == sp * tp
        r, si, t = slice(c["dp"] * rows, (c["dp"] + 1) * rows), c.get("sp", 0), c["tp"]
        y[r, si * 16 // sp:(si + 1) * 16 // sp, t * f:(t + 1) * f] = m["y"]
        z[r, idx * n_seq:(idx + 1) * n_seq] = m["z"]
        dx[r, idx * n_seq:(idx + 1) * n_seq] = m["dx"]
        dw1[:, t * f:(t + 1) * f] += m["dw1"]  # the dp and sp sum
        dw2[t * f:(t + 1) * f] += m["dw2"]
    for name, got, ref in (("y", y, y_ref), ("z", z, z_ref), ("dx", dx, dx_ref),
                           ("dw1", dw1, dw1_ref), ("dw2", dw2, dw2_ref)):
        assert _rel_l2(got, ref) <= FP32_REL_L2, name


def _fake_mesh(shape, names, rank=0):
    return Mesh(MeshSpec(shape, names), rank, None, {})


def _jax_message(fn, *args, **kwargs):
    with pytest.raises(ValueError) as e:
        fn(*args, **kwargs)
    return str(e.value)


def test_uneven_shard_counts_rejected_with_the_jax_messages(devices):
    """The port cuts the sequence and the weights where JAX's global arrays
    are sharded (``seq_chunk``, ``weight_shard``) and raises there, with
    JAX's text; the schedule, the operand ranks and the tp axis are checked
    by both entry points."""
    jmesh = jax_mesh((2, 1, 4))
    port = _fake_mesh((2, 4), ("dp", "tp"))
    ones = np.ones
    want = _jax_message(jax_cm.allgather_matmul, jnp.ones((2, 10, 8)), jnp.ones((8, 12)), jmesh)
    assert "not divisible by the" in want
    got = _jax_message(cm.seq_chunk, torch.ones(2, 10, 8), port)
    assert got == want
    for w, col in (((8, 10), True), ((10, 8), False)):
        fn = jax_cm.allgather_matmul if col else jax_cm.matmul_reducescatter
        want = _jax_message(fn, jnp.ones((2, 16, 8)), jnp.ones(w), jmesh)
        assert _jax_message(cm.weight_shard, torch.from_numpy(ones(w)), port, col) == want
    want = _jax_message(jax_cm.allgather_matmul, jnp.ones((2, 16, 8)), jnp.ones((8, 16)),
                        jmesh, schedule="zigzag")
    assert _jax_message(cm.allgather_matmul, torch.ones(2, 4, 8), torch.ones(8, 4), port,
                        schedule="zigzag") == want
    want = _jax_message(jax_cm.allgather_matmul, jnp.ones((16, 8)), jnp.ones((8, 16)), jmesh)
    assert _jax_message(cm.allgather_matmul, torch.ones(16, 8), torch.ones(8, 16), port) == want
    want = _jax_message(jax_cm.allgather_matmul, jnp.ones((2, 16, 8)), jnp.ones((8, 16)),
                        build_mesh(JaxMeshSpec.ring(8)))
    assert "no 'tp' axis" in want
    assert _jax_message(cm.allgather_matmul, torch.ones(2, 16, 8), torch.ones(8, 16),
                        _fake_mesh((8,), ("ranks",))) == want
    # with sp: the rank's sp slice of 5 positions (S=10) does not split over tp=2
    jmesh = jax_mesh((2, 2, 2))
    want = _jax_message(jax_cm.allgather_matmul, jnp.ones((2, 10, 8)), jnp.ones((8, 12)), jmesh)
    sp_mesh = _fake_mesh((2, 2, 2), ("dp", "sp", "tp"))
    assert _jax_message(cm.seq_chunk, torch.ones(1, 5, 8), sp_mesh) == want
    # matmul_reducescatter's input is the sp slice gathered over tp
    assert _jax_message(cm.matmul_reducescatter, torch.ones(1, 5, 8), torch.ones(8, 8),
                        sp_mesh) == want


def test_activation_spec_names_the_jax_sequence_slice(devices):
    """Rank (dp, sp, tp)'s chunk is ``sp * tp + tp``-th of ``sp * tp``, the
    block JAX's ``P(dp, (sp, tp), None)`` places on that device."""
    dims = (2, 2, 2)
    jmesh = jax_mesh(dims)
    x = jnp.arange(4 * 16, dtype=jnp.float32).reshape(4, 16, 1)
    xs = jax.device_put(x, NamedSharding(jmesh, jax_cm.activation_spec(jmesh)))
    devices_grid = np.asarray(jmesh.devices)
    for shard in xs.addressable_shards:
        rank = int(np.argwhere(devices_grid == shard.device)[0] @ np.array([4, 2, 1]))
        mesh = _fake_mesh(dims, ("dp", "sp", "tp"), rank)
        idx, count = cm.activation_spec(mesh)
        assert count == 4 and shard.index[1] == slice(idx * 4, (idx + 1) * 4)
        b = mesh.coords["dp"]
        assert shard.index[0] == slice(b * 2, (b + 1) * 2)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _assemble(members, shape):
    """The global output from every rank's part; ranks that hold the same
    part (tp ranks without overlap) must agree bit for bit."""
    out, seen = np.full(shape, np.nan, np.float32), {}
    for m in members:
        (d, dp), (i, n) = m["rows"], m["seq"]
        key = (d, i)
        if key in seen:
            np.testing.assert_array_equal(m["y"], seen[key])
            continue
        seen[key] = m["y"]
        rows, cols = shape[0] // dp, shape[1] // n
        out[d * rows:(d + 1) * rows, i * cols:(i + 1) * cols] = m["y"]
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("case_id", sorted(FWD_CASES))
def test_overlapped_forward_matches_jax(ranks, arrays, devices, case_id):
    spec = FWD_CASES[case_id]
    dims = spec["mesh"]
    cfg = jax_configs.ModelConfig(**spec["fields"])
    mesh = jax_mesh(dims)
    dtype = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    params = jax_tf.shard_params(jax.tree.map(lambda a: jnp.asarray(a, dtype),
                                              arrays["weights"][spec["weights"]]), mesh)
    sharding = NamedSharding(mesh, jax_batch_spec(mesh))
    x = jax.device_put(jnp.asarray(arrays["batches"]["dp2"][0], dtype), sharding)
    ref = np.asarray(jax.jit(lambda p, a: jax_tf.forward(p, a, cfg, mesh=mesh),
                             out_shardings=sharding)(params, x), np.float32)
    got = _assemble(_members(ranks, case_id), ref.shape)
    bound = FP32_REL_L2 if cfg.dtype == "float32" else bf16_bound(dims[2])
    assert _rel_l2(got, ref) <= bound


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def full_params(ranks, case_id, spec, weights):
    """The full leaves (numpy) after a case from every rank's shards: dp
    shards joined at stage 3, equal across dp below it and across sp always
    (bit for bit); then the tp shards joined by ``unshard_params``."""
    dp, sp, tp = spec["mesh"]
    cfg = ModelConfig(**spec["fields"])
    by = {}
    for m in _members(ranks, case_id):
        c = m["coords"]
        key = (c["dp"], c["tp"])
        params = pt_optim.tree_map(torch.from_numpy, m["params"])
        if key in by:  # another sp rank: the same replica
            for a, b in zip(pt_optim.tree_leaves(by[key]), pt_optim.tree_leaves(params)):
                assert torch.equal(a, b), f"{case_id}: sp ranks disagree"
        by[key] = params
    assert len(by) == dp * tp
    tp_shards = []
    for j in range(tp):
        parts = [by[(i, j)] for i in range(dp)]
        if spec["stage"] == 3:
            from dlbb_tpu_torch.models import params_from_jax
            from dlbb_tpu_torch.models.sharding import shard_params

            local = shard_params(params_from_jax(weights[spec["weights"]], cfg), cfg, j, tp)
            tp_shards.append(pt_zero.unshard_tree(parts, pt_zero.dp_sharded_param_specs(local, dp)))
        else:
            for other in parts[1:]:
                for a, b in zip(pt_optim.tree_leaves(parts[0]), pt_optim.tree_leaves(other)):
                    assert torch.equal(a, b), f"{case_id}: dp ranks disagree"
            tp_shards.append(parts[0])
    return pt_optim.tree_map(lambda t: t.numpy(), unshard_params(tp_shards, cfg))


def jax_train(spec, weights, batches, tx=None):
    """(losses, full params as numpy) of JAX's ``make_train_step`` on the
    case's (dp, sp, tp) mesh."""
    cfg = jax_configs.ModelConfig(**spec["fields"])
    mesh = jax_mesh(spec["mesh"])
    params = jax.tree.map(jnp.asarray, weights[spec["weights"]])
    step, state = jax_loop.make_train_step(
        cfg, mesh, tx or jax_optim.build_optimizer(spec["train"]), params,
        zero_stage=spec["stage"], grad_accum=spec["grad_accum"])
    sharding = NamedSharding(mesh, jax_batch_spec(mesh))
    x, t = (jax.device_put(jnp.asarray(a), sharding) for a in batches[spec["batch"]])
    losses = []
    for _ in range(spec["steps"]):
        state, loss = step(state, x, t)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params)


def by_path(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in by_path(v, f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): tree}


def losses_of(ranks, case_id):
    losses = [m["losses"] for m in _members(ranks, case_id)]
    assert all(x == losses[0] for x in losses[1:]), f"{case_id}: ranks report other losses"
    return losses[0]


@pytest.mark.parametrize("case_id", sorted(SGD_CASES))
def test_one_sgd_step_gives_the_jax_reduced_gradient(ranks, arrays, devices, case_id):
    spec = SGD_CASES[case_id]
    ref_losses, ref = jax_train(spec, arrays["weights"], arrays["batches"])
    np.testing.assert_allclose(losses_of(ranks, case_id), ref_losses, rtol=1e-5)
    p0 = by_path(arrays["weights"][spec["weights"]])
    got = by_path(full_params(ranks, case_id, spec, arrays["weights"]))
    ref = by_path(ref)
    assert set(got) == set(ref) == set(p0)
    for name in p0:
        g_ref = (p0[name] - ref[name]) / SGD_LR
        g_got = (p0[name] - got[name]) / SGD_LR
        scale = np.abs(g_ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(g_got, g_ref, atol=GRAD_RTOL * scale, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# the sweep ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_shard_is_jax_synth_weight(devices, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    for rows, cols, ro, co in ((64, 16, 0, 16), (64, 64, 128, 0), (2048, 512, 0, 1024)):
        ref = np.asarray(jax_synth_weight(rows, cols, jdt, row_offset=ro, col_offset=co),
                         np.float32)
        got = _synth_weight(rows, cols, getattr(torch, dtype), "cpu", row_offset=ro,
                            col_offset=co).float().numpy()
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got, ref)
        else:  # torch's fp32 cos and XLA's round differently: 2 ulps at most
            np.testing.assert_array_max_ulp(got, ref, maxulp=2)


@pytest.mark.parametrize("case_id", sorted(OP_CASES))
def test_sweep_op_matches_jax_builder_and_plain(ranks, devices, mesh4, case_id):
    spec = OP_CASES[case_id]
    members = _members(ranks, case_id)
    assert len(members) == 4
    x = np.stack([m["x"] for m in members])
    got = np.stack([m["y"] for m in members])
    jdt = jnp.bfloat16 if spec["dtype"] == "bfloat16" else jnp.float32
    op = jax_get_op(spec["name"])
    jx = jax_make_payload(op, mesh4, ("ranks",), int(np.prod(OPS_SHAPE)), dtype=jdt,
                          shape=OPS_SHAPE)
    np.testing.assert_array_equal(x, np.asarray(jx, np.float32))
    ref = np.asarray(op.build(mesh4, ("ranks",), schedule=spec["schedule"])(jx), np.float32)
    plain = plain_collective(spec["name"], torch.from_numpy(x).to(getattr(torch, spec["dtype"])))
    bound = FP32_REL_L2 if spec["dtype"] == "float32" else 4 * BF16_U
    assert got.shape == ref.shape == tuple(plain.shape)
    assert _rel_l2(got, ref) <= bound
    assert _rel_l2(got, plain.float().numpy()) <= bound
    fused_id = case_id.replace(spec["schedule"], "fused", 1)
    fused = np.stack([m["y"] for m in _members(ranks, fused_id)])
    assert _rel_l2(got, fused) <= bound


OVERLAP_OPS, OVERLAP_SHAPE = ("ag_matmul", "matmul_rs"), ((2,), (8,), (16,))


def _bench3d(variant, out):
    return cli.main(["bench3d", "--device", "cpu", "--world", "4", "--ranks", "4",
                     "--variant", variant, "--ops", *OVERLAP_OPS,
                     "--batch", *map(str, OVERLAP_SHAPE[0]), "--seq", *map(str, OVERLAP_SHAPE[1]),
                     "--hidden", *map(str, OVERLAP_SHAPE[2]), "--warmup", "1", "--iters", "3",
                     "--output", str(out)])


def test_cli_bench3d_overlap_variants_write_the_jax_files(tmp_path, devices):
    jax_dir = tmp_path / "jax"
    jax_sweep = JaxSweep3D(operations=OVERLAP_OPS, batch_sizes=OVERLAP_SHAPE[0],
                           seq_lengths=OVERLAP_SHAPE[1], hidden_dims=OVERLAP_SHAPE[2],
                           rank_counts=(4,), warmup_iterations=1, measurement_iterations=3,
                           output_dir=str(jax_dir), variant="overlap_ring", pipeline=False,
                           compile_cache="off", journal=False)
    jax_run_sweep(jax_sweep, verbose=False)
    for variant in ("overlap_ring", "overlap_bidir"):
        out = tmp_path / variant
        assert _bench3d(variant, out) == 0
        impl = f"torch_gloo_{variant}"
        files = {p.name: json.loads(p.read_text()) for p in out.glob("*.json")
                 if p.name != "sweep_manifest.json"}
        assert set(files) == {jax_result_filename(jax_sweep, impl, 4, c)
                              for c in jax_iter_configs(jax_sweep)}
        for name, data in files.items():
            ref = json.loads((jax_dir / name.replace(impl, "xla_tpu_overlap_ring", 1)
                              .replace("bidir", "ring")).read_text())
            assert set(data) == set(ref), name
            assert data["variant"] == variant and data["implementation"] == impl
            t = np.asarray(data["timings"])
            assert t.shape == (4, 3) and np.all(np.isfinite(t)) and np.all(t > 0)


def test_overlap_variant_charges_no_fused_transient():
    """The memory estimate charges the fused schedule's transient (the
    gathered activation, P^2 x payload; the full partial product, P x) to
    ``default`` and none to an overlap variant (JAX's rule)."""
    config = {"operation": "ag_matmul", "batch": 2, "seq_len": 8, "hidden_dim": 16}
    n = 2 * 8 * 16 * 2  # bf16 bytes per rank
    est = {v: runner._estimate_global_bytes(runner.Sweep3D(variant=v), config, 4)
           for v in ("default", "overlap_ring")}
    assert est == {"default": (4 + 4 + 16) * n, "overlap_ring": (4 + 4) * n}
    rs = dict(config, operation="matmul_rs")
    assert runner._estimate_global_bytes(runner.Sweep3D(), rs, 4) == (4 + 4 + 4) * n


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cmd", ["e2e", "train"])
def test_cli_tp_overlap_overrides_the_config(tmp_path, cmd):
    """``--tp-overlap`` on ``cli e2e``/``train`` at world 2: the result
    records the schedule, the (dp, tp) mesh and how the ring hops moved."""
    config = {"experiment": {"name": "overlap"},
              "model": dict(MODEL, num_layers=1),
              "parallelism": {"world_size": 2, "data_parallel": 1},
              "input": {"batch_size": 2, "sequence_length": 8, "seed": 3},
              "training": {"learning_rate": LR_CLI},
              "execution": {"warmup_iterations": 1, "benchmark_iterations": 2}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(config))
    out = tmp_path / "out"
    assert cli.main([cmd, "--config", str(path), "--device", "cpu", "--output", str(out),
                     "--tp-overlap", "bidir"]) == 0
    (result,) = [json.loads(p.read_text()) for p in out.glob("*.json")]
    overlap = result["model"]["tp_overlap"] if cmd == "e2e" else result["tp_overlap"]
    assert overlap == "bidir" and result["transport"] == "device"
    assert result["mesh"] == {"dp": 1, "sp": 1, "pp": 1, "ep": 1, "tp": 2}


def test_plan_accepts_tp_overlap(devices):
    """``check_plan`` accepts ``tp_overlap`` with tp above 1, as JAX's plan
    does, and the sequence refusal is JAX's, word for word."""
    cfg = ModelConfig(**MODEL).with_(tp_overlap="ring")
    jcfg = jax_configs.ModelConfig(**MODEL).with_(tp_overlap="ring")
    config = {"parallelism": {"world_size": 4, "data_parallel": 2},
              "input": {"batch_size": 4, "sequence_length": 16}}
    assert check_plan(config, cfg, 8) == (2, 1, 1, 1, 4)
    assert JaxPlan.from_config(config, jcfg).tp_overlap == "ring"
    bad = {"parallelism": {"world_size": 4, "data_parallel": 2},
           "input": {"batch_size": 4, "sequence_length": 18}}
    want = _jax_message(JaxPlan.from_config, bad, jcfg)
    assert "sequence_length=18" in want
    assert _jax_message(check_plan, bad, cfg, 8) == want
