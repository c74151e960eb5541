"""The port's multi-rank training (``train/zero.py``, the tensor-parallel
gradients of ``models/transformer.py``, ``train/loop.py::make_train_step``
with a mesh) against the JAX package's ``make_train_step`` on the same mesh
of the CPU-simulated devices of ``conftest.py``.

The port runs on 8 spawned gloo ranks (``tests/torch_train_worker.py``),
each case on the first dp x tp of them; JAX weights come across with
``params_from_jax`` and are cut with ``shard_params``; the global batches
are seeded numpy arrays, each rank taking its rows of each global
micro-batch, as ``run_train`` lays them.  After the steps the
test reassembles the full leaves from every rank's shards (``unshard_tree``
over dp at stage 3, ``unshard_params`` over tp) and holds them against JAX's.

The cases:

- dryrun phases 1, 7, 8 and 10 of ``__graft_entry__.py::dryrun_multichip``
  at n=8 (dp=2 x tp=4, ``hidden_size`` 16 tp, 2 layers, 4 heads, ``ffn`` 32
  tp, fp32, "full", 4 rows per dp, S=16): tp/zero1, grad_accum=2/zero2,
  checkpoint/zero1 and adam-bf16m/dots-remat/zero1, two Adam steps at lr
  1e-3 each.  Losses to ``LOSS_RTOL`` = 1e-5 relative (fp32 sums in another
  order, the dp mean of the ranks' losses included).  Full leaves to
  ``ADAM_ATOL`` = 0.1 x lr absolute, the bound ``test_torch_train.py``
  argues: Adam steps every element by about lr whatever the size of its
  gradient, so where a gradient is near 0 its last-bit differences can
  turn the step; the elements whose gradient is within ``GRAD_RTOL`` of
  their leaf's largest of 0 at a step of JAX's trajectory (the qkv bias's
  K columns, 0 in exact arithmetic) are held to Adam's own bound instead
  (``torch_mesh_parity.hold_adam``);
- one SGD step without momentum at every ZeRO stage, at dp=2 x tp=2 and at
  dp=8, and with GQA at dp=2 x tp=4 with 4, 2 and 1 kv heads (tp=4 does not
  divide 2 or 1: the kv-copy gradient).  ``p1 = p0 - lr g``, so ``(p0 -
  p1) / lr`` is the reduced gradient on both sides.  lr = ``SGD_LR`` = 1024,
  a power of two: ``-lr g`` is exact, and the rounding of ``p0 - lr g``
  costs at most ``ulp(|p0| + lr |g|) / lr``, about 6e-8 of ``|p0| / lr +
  |g|``, far below the bound, ``GRAD_RTOL`` = 1e-5 of each leaf's largest
  gradient (the same fp32 arithmetic in another order, observed ~1e-7);
- adamw and sgd with momentum under ZeRO-1 at dp=2 x tp=4, two steps, to
  ``ADAM_ATOL`` and ``LOSS_RTOL``;
- the layout: the port's dp axis of every leaf equals JAX's
  ``dp_sharded_param_specs``, and at stage 1 and up each rank's Adam moments
  hold 1/dp of each sharded leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_train_worker
from jax.sharding import NamedSharding
from torch_mesh_parity import hold_adam, jax_adam_reference

from dlbb_tpu.comm.mesh import build_parallelism_mesh as jax_parallelism_mesh
from dlbb_tpu.models import configs as jax_configs
from dlbb_tpu.models import transformer as jax_tf
from dlbb_tpu.models.sharding import batch_spec, param_specs
from dlbb_tpu.train import loop as jax_loop
from dlbb_tpu.train import optim as jax_optim
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu_torch.models import ModelConfig, init_params, params_from_jax
from dlbb_tpu_torch.models.sharding import shard_params, unshard_params
from dlbb_tpu_torch.train import optim as pt_optim
from dlbb_tpu_torch.train import zero as pt_zero

torch.set_num_threads(1)

LR, SGD_LR = 1e-3, 1024.0
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5
# the dryrun's test model at tp=4: hidden 16 tp, ffn 32 tp
MODEL = dict(hidden_size=64, num_layers=2, num_heads=4, ffn_intermediate=128,
             dtype="float32", attention="full")
ADAM = {"learning_rate": LR}
SGD = {"optimizer": "sgd", "momentum": None, "learning_rate": SGD_LR}


def _spec(mesh, train, stage, batch, steps=2, grad_accum=1, weights="mha", **model):
    return {"mesh": mesh, "fields": dict(MODEL, **model), "weights": weights,
            "train": train, "stage": stage, "grad_accum": grad_accum, "steps": steps,
            "batch": batch}


DRYRUN = {
    "tp/zero1": _spec((2, 4), ADAM, 1, "dp2"),
    "grad_accum/zero2": _spec((2, 4), ADAM, 2, "dp2", grad_accum=2),
    "checkpoint/zero1": _spec((2, 4), ADAM, 1, "dp2"),
    "adam-bf16m/dots-remat/zero1": _spec(
        (2, 4), dict(ADAM, moments_dtype="bfloat16"), 1, "dp2", remat=True,
        remat_policy="dots"),
}
SGD_CASES = {f"sgd/dp{m[0]}tp{m[1]}/zero{z}": _spec(m, SGD, z, f"dp{m[0]}", steps=1)
             for m in ((2, 2), (8, 1)) for z in range(4)}
GQA_CASES = {f"sgd/gqa{kv}/zero{z}": _spec((2, 4), SGD, z, "dp2", steps=1,
                                            weights=f"gqa{kv}", num_kv_heads=kv)
             for kv in (4, 2, 1) for z in (1, 3)}
OPT_CASES = {
    "adamw/zero1": _spec((2, 4), {"optimizer": "adamw", "learning_rate": LR}, 1, "dp2"),
    "sgd-momentum/zero1": _spec((2, 4), {"optimizer": "sgd", "learning_rate": LR}, 1, "dp2"),
}
CASES = {**DRYRUN, **SGD_CASES, **GQA_CASES, **OPT_CASES}
KV = {"mha": None, "gqa4": 4, "gqa2": 2, "gqa1": 1}


@pytest.fixture(scope="module")
def weights():
    """The JAX parameters of each kv variant as float32 numpy."""
    return {key: jax.tree.map(np.asarray, jax_tf.init_params(
        jax_configs.ModelConfig(**dict(MODEL, num_kv_heads=kv)), jax.random.key(0)))
        for key, kv in KV.items()}


@pytest.fixture(scope="module")
def batches():
    """Global (x, targets) per dp degree: 2 rows per dp rank for the SGD
    cases at dp=8, 4 per rank at dp=2 (the dryrun's ``batch_rows``)."""
    rng = np.random.default_rng(7)
    out = {}
    for key, rows in (("dp2", 8), ("dp8", 16)):
        x, t = (rng.standard_normal((rows, 16, MODEL["hidden_size"]), dtype=np.float32)
                for _ in range(2))
        out[key] = (x, t)
    return out


@pytest.fixture(scope="module")
def ranks(weights, batches, tmp_path_factory):
    cases = dict(CASES)
    cases["checkpoint/zero1"] = dict(cases["checkpoint/zero1"],
                                     checkpoint=str(tmp_path_factory.mktemp("ckpt")))
    return launch(torch_train_worker.run_train_cases, 8, "cpu",
                  args=(list(cases.items()), weights, batches), timeout=600,
                  group_timeout=120)


def _torch(tree):
    return pt_optim.tree_map(torch.from_numpy, tree)


def full_params(ranks, case_id, spec, weights, key="params"):
    """The full leaves (numpy) from every rank's shards after a case: dp
    shards joined along their axis at stage 3, and checked equal, bit for
    bit, across dp below it; then tp shards joined by ``unshard_params``."""
    dp, tp = spec["mesh"]
    cfg = ModelConfig(**spec["fields"])
    by = {(r[case_id]["coords"]["dp"], r[case_id]["coords"]["tp"]): _torch(r[case_id][key])
          for r in ranks if case_id in r}
    assert len(by) == dp * tp
    tp_shards = []
    for j in range(tp):
        parts = [by[(i, j)] for i in range(dp)]
        if spec["stage"] == 3:
            local = shard_params(params_from_jax(weights[spec["weights"]], cfg), cfg, j, tp)
            tp_shards.append(pt_zero.unshard_tree(parts, pt_zero.dp_sharded_param_specs(local, dp)))
        else:
            for other in parts[1:]:
                for a, b in zip(pt_optim.tree_leaves(parts[0]), pt_optim.tree_leaves(other)):
                    assert torch.equal(a, b), f"{case_id}: dp ranks disagree"
            tp_shards.append(parts[0])
    return pt_optim.tree_map(lambda t: t.numpy(), unshard_params(tp_shards, cfg))


def _losses(ranks, case_id):
    losses = [r[case_id]["losses"] for r in ranks if case_id in r]
    assert all(l == losses[0] for l in losses[1:]), f"{case_id}: ranks report other losses"
    return losses[0]


def jax_run(spec, weights, batches):
    """(losses, full params as numpy) of JAX's ``make_train_step`` on the
    case's (dp, tp) mesh."""
    dp, tp = spec["mesh"]
    cfg = jax_configs.ModelConfig(**spec["fields"])
    mesh = jax_parallelism_mesh(dp, 1, 1, tp, 1, devices=jax.devices()[:dp * tp])
    params = jax.tree.map(jnp.asarray, weights[spec["weights"]])
    step, state = jax_loop.make_train_step(
        cfg, mesh, jax_optim.build_optimizer(spec["train"]), params,
        zero_stage=spec["stage"], grad_accum=spec["grad_accum"])
    sharding = NamedSharding(mesh, batch_spec(mesh))
    x, t = (jax.device_put(jnp.asarray(a), sharding) for a in batches[spec["batch"]])
    losses = []
    for _ in range(spec["steps"]):
        state, loss = step(state, x, t)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params)


def _by_path(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _by_path(v, f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): tree}


@pytest.mark.parametrize("case_id", sorted(DRYRUN) + sorted(OPT_CASES))
def test_train_steps_match_jax(ranks, weights, batches, case_id):
    spec = CASES[case_id]
    got = _by_path(full_params(ranks, case_id, spec, weights))
    assert len(got) == 14
    hold_adam(_losses(ranks, case_id), got, jax_adam_reference(spec, weights, batches), spec)
    assert all(r[case_id]["step"] == spec["steps"] for r in ranks if case_id in r)


def test_checkpoint_round_trip_continues_bit_for_bit(ranks):
    """checkpoint/zero1: one step, save, restore into a fresh state, and
    the second step from there equals the uninterrupted second step, bit
    for bit, on every rank."""
    case_id = "checkpoint/zero1"
    members = [r[case_id] for r in ranks if case_id in r]
    assert len(members) == 8
    for res in members:
        assert res["resumed_step"] == 1
        assert res["resumed_loss"] == res["losses"][-1]
        for a, b in zip(pt_optim.tree_leaves(res["resumed_params"]),
                        pt_optim.tree_leaves(res["params"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case_id", sorted(SGD_CASES) + sorted(GQA_CASES))
def test_one_sgd_step_gives_the_jax_reduced_gradient(ranks, weights, batches, case_id):
    spec = CASES[case_id]
    ref_losses, ref = jax_run(spec, weights, batches)
    np.testing.assert_allclose(_losses(ranks, case_id), ref_losses, rtol=LOSS_RTOL)
    p0 = _by_path(weights[spec["weights"]])
    got, ref = _by_path(full_params(ranks, case_id, spec, weights)), _by_path(ref)
    assert set(got) == set(ref) == set(p0)
    for name in p0:
        g_ref = (p0[name] - ref[name]) / SGD_LR
        g_got = (p0[name] - got[name]) / SGD_LR
        scale = np.abs(g_ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(g_got, g_ref, atol=GRAD_RTOL * scale, rtol=0, err_msg=name)


def _jax_axes(params, dp):
    specs = jax_loop.dp_sharded_param_specs(params, dp, base_specs=param_specs())
    return jax.tree.map(lambda s: s.index("dp") if "dp" in s else None, specs,
                        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("model", [
    MODEL, dict(MODEL, num_kv_heads=2), dict(MODEL, num_kv_heads=1),
    dict(hidden_size=96, num_layers=3, num_heads=6, ffn_intermediate=96),
    dict(hidden_size=32, num_layers=8, num_heads=2, ffn_intermediate=64, num_kv_heads=1),
], ids=["dryrun", "gqa2", "mqa1", "ffn_eq_hidden", "deep_narrow"])
@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("dp", [1, 2, 3, 8])
def test_dp_axis_of_every_leaf_matches_jax(model, tp, dp):
    """Each leaf's dp axis is the largest dimension that tp does not shard,
    that dp divides and that is above 1, the first on a tie (the QKV bias of
    the dryrun model shards on its layer axis); the port takes it on its tp
    shard's shape, JAX on the global shape."""
    jcfg = jax_configs.ModelConfig(**model)
    want = _jax_axes(jax.eval_shape(lambda: jax_tf.init_params(jcfg, jax.random.key(0))), dp)
    cfg = ModelConfig(**model)
    local = shard_params(init_params(cfg, 0, "cpu"), cfg, 0, tp)
    assert pt_zero.dp_sharded_param_specs(local, dp) == want


@pytest.mark.parametrize("case_id", ["tp/zero1", "grad_accum/zero2",
                                     "adam-bf16m/dots-remat/zero1", "adamw/zero1"])
def test_optimizer_state_holds_one_dp_share_of_each_sharded_leaf(ranks, weights, case_id):
    spec = CASES[case_id]
    dp, tp = spec["mesh"]
    cfg = ModelConfig(**spec["fields"])
    for r in ranks:
        res = r[case_id]
        local = shard_params(params_from_jax(weights[spec["weights"]], cfg), cfg,
                             res["coords"]["tp"], tp)
        axes = pt_zero.dp_sharded_param_specs(local, dp)
        want = pt_optim.tree_map(
            lambda t, ax: tuple(t.shape) if ax is None
            else tuple(n // dp if i == ax else n for i, n in enumerate(t.shape)), local, axes)
        assert res["opt_shapes"] == {"mu": want, "nu": want}
        assert any(ax is not None for ax in pt_optim.tree_leaves(axes))


def test_opt_state_specs_shard_only_what_mirrors_the_params():
    cfg = ModelConfig(**MODEL)
    params = init_params(cfg, 0, "cpu")
    axes = pt_zero.dp_sharded_param_specs(params, 2)
    none = pt_optim.tree_map(lambda _: None, axes)
    adam = pt_optim.build_optimizer({})
    specs = pt_zero.opt_state_specs(params, adam.init(params), True, 2)
    assert specs == pt_optim.AdamState(None, axes, axes)
    assert pt_zero.opt_state_specs(params, adam.init(params), False, 2) == \
        pt_optim.AdamState(None, none, none)
    adafactor = pt_optim.build_optimizer({"optimizer": "adafactor"})
    # no leaf of this model has two dimensions of 128 or more: adafactor
    # keeps full statistics ``v`` of every leaf, which mirror the params
    specs = pt_zero.opt_state_specs(params, adafactor.init(params), True, 2)
    assert specs == pt_optim.AdafactorState(None, none, none, axes)
    wide = ModelConfig(**dict(MODEL, hidden_size=128, ffn_intermediate=256))
    wide_params = init_params(wide, 0, "cpu")
    wide_none = pt_optim.tree_map(lambda _: None, wide_params)
    specs = pt_zero.opt_state_specs(wide_params, adafactor.init(wide_params), True, 2)
    # the [L, 128, 384] kernels are factored: their ``v`` is a [1]
    # placeholder, so no state subtree mirrors the params
    assert specs == pt_optim.AdafactorState(None, wide_none, wide_none, wide_none)
    sgd = pt_optim.build_optimizer({"optimizer": "sgd", "momentum": None})
    assert pt_zero.opt_state_specs(params, sgd.init(params), True, 2) == \
        pt_optim.SgdState(None, None)
