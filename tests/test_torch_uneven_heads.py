"""Plans the port refused where JAX runs (ROADMAP Queue 1, Slice D
remainder, items 19 and 20), against the JAX package on the CPU-simulated
mesh of ``conftest.py``:

- Ulysses where sp does not divide a tp rank's heads (item 19): the model
  gathers the heads over tp, all-to-alls all of them over sp and keeps its
  own (``models/transformer.py::_attention``), as GSPMD gathers them for
  JAX's ``shard_map``.  ``num_heads=4, tp=2, sp=4`` on 8 gloo ranks, MHA
  and GQA (kv 2, JAX's repeat fallback at sp=4);
- tp where it does not divide the heads (item 20): every sharded parameter
  dimension divides, the ranks hold contiguous column and row shards, the
  qkv activations are gathered over tp (``_uneven_attention``).  ROADMAP
  item 20's probe table: (hidden, heads, ffn, tp) = (96, 6, 384, 4), (96,
  4, 384, 3), (96, 6, 384, 3) run in JAX (forward and ``make_train_step``);
  (96, 6, 256, 3) is refused by JAX's pjit, and by the port naming the same
  leaf and dimension.  GQA (kv 2 at tp=4: a kv head serves two ranks' query
  heads), and Ulysses and ring at tp=3, sp=2;
- a checkpoint saved at dp=4 x tp=2, ZeRO-1, restored onto dp=2 x tp=4,
  ZeRO-3 and onto world 1 (item 20): the gathered state bit-equal to the
  saved one, and the next step's loss against JAX's second step on the new
  mesh from the same weights.

Tolerances: forwards fp32 relative L2 ``FP32_REL_L2`` = 1e-5 (the same fp32
arithmetic summed in another order); one SGD step at lr ``SGD_LR``: each
leaf's gradient within ``GRAD_RTOL`` = 1e-5 of its largest, losses to 1e-5
relative (``tests/test_torch_collective_matmul.py``'s bounds); Adam losses
to ``LOSS_RTOL`` = 1e-5 relative (``tests/test_torch_zero.py``'s); the
restored state exactly.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_seq_worker
from jax.sharding import NamedSharding
from test_torch_collective_matmul import (
    GRAD_RTOL,
    SGD_LR,
    by_path,
    full_params,
    jax_mesh,
    jax_train,
    losses_of,
)

from dlbb_tpu.comm.mesh import build_parallelism_mesh as jax_parallelism_mesh
from dlbb_tpu.models import configs as jax_configs
from dlbb_tpu.models import transformer as jax_tf
from dlbb_tpu.models.sharding import batch_spec as jax_batch_spec
from dlbb_tpu.parallel import ulysses_attention as jax_ulysses
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu_torch.comm import Mesh, MeshSpec
from dlbb_tpu_torch.models import ModelConfig, forward, init_params, params_from_jax
from dlbb_tpu_torch.models.sharding import shard_params, unshard_params
from dlbb_tpu_torch.parallel import plan as port_plan
from dlbb_tpu_torch.train import zero as pt_zero

FP32_REL_L2, LOSS_RTOL, ADAM_LR = 1e-5, 1e-5, 1e-3
SGD = {"optimizer": "sgd", "momentum": None, "learning_rate": SGD_LR}
BASE = dict(num_layers=2, dtype="float32", attention="full")
MODELS = {
    "n4": dict(BASE, hidden_size=64, num_heads=4, ffn_intermediate=128),
    "n4kv2": dict(BASE, hidden_size=64, num_heads=4, num_kv_heads=2, ffn_intermediate=128),
    "h96n6": dict(BASE, hidden_size=96, num_heads=6, ffn_intermediate=384),
    "h96n4": dict(BASE, hidden_size=96, num_heads=4, ffn_intermediate=384),
    "h96n6kv2": dict(BASE, hidden_size=96, num_heads=6, num_kv_heads=2, ffn_intermediate=384),
}
# (model, mesh (dp, sp, tp), attention)
FWD = {
    "ulysses-n4-tp2-sp4": ("n4", (1, 4, 2), "ulysses"),
    "ulysses-n4kv2-tp2-sp4": ("n4kv2", (1, 4, 2), "ulysses"),
    "full-h96n6-dp2tp4": ("h96n6", (2, 1, 4), "full"),
    "full-h96n4-tp3": ("h96n4", (1, 1, 3), "full"),
    "full-h96n6-tp3": ("h96n6", (1, 1, 3), "full"),
    "full-h96n6kv2-dp2tp4": ("h96n6kv2", (2, 1, 4), "full"),
    "simplified-h96n6-dp2tp4": ("h96n6", (2, 1, 4), "simplified"),
    "ulysses-h96n4-sp2tp3": ("h96n4", (1, 2, 3), "ulysses"),
    "ring-h96n4-sp2tp3": ("h96n4", (1, 2, 3), "ring"),
}
FWD_CASES = {cid: {"mesh": mesh, "batch": "h" + str(MODELS[m]["hidden_size"]), "weights": m,
                   "fields": dict(MODELS[m], attention=att)}
             for cid, (m, mesh, att) in FWD.items()}
# one SGD step: (model, mesh, attention, ZeRO stage)
SGD_STEPS = {
    "ulysses-n4-tp2-sp4/zero1": ("n4", (1, 4, 2), "ulysses", 1),
    "ulysses-n4kv2-tp2-sp4/zero1": ("n4kv2", (1, 4, 2), "ulysses", 1),
    "h96n6-dp2tp4/zero1": ("h96n6", (2, 1, 4), "full", 1),
    "h96n6-dp2tp4/zero3": ("h96n6", (2, 1, 4), "full", 3),
    "h96n4-tp3/zero0": ("h96n4", (1, 1, 3), "full", 0),
    "h96n6kv2-dp2tp4/zero2": ("h96n6kv2", (2, 1, 4), "full", 2),
}
SGD_CASES = {cid: {"mesh": mesh, "fields": dict(MODELS[m], attention=att), "weights": m,
                   "train": SGD, "stage": stage, "grad_accum": 1, "steps": 1,
                   "batch": "h" + str(MODELS[m]["hidden_size"])}
             for cid, (m, mesh, att, stage) in SGD_STEPS.items()}
RESTORES = ((2, 4, 3), (1, 1, 0))


def _reshard_spec(directory):
    return {"fields": MODELS["n4"], "weights": "n4", "batch": "h64", "steps": 1,
            "train": {"learning_rate": ADAM_LR}, "save": (4, 2, 1), "restore": RESTORES,
            "directory": directory}


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(19)
    weights = {m: jax.tree.map(np.asarray, jax_tf.init_params(
        jax_configs.ModelConfig(**fields), jax.random.key(i)))
        for i, (m, fields) in enumerate(MODELS.items())}
    batches = {f"h{h}": tuple(rng.standard_normal((8, 16, h), dtype=np.float32)
                              for _ in range(2)) for h in (64, 96)}
    return {"weights": weights, "batches": batches}


@pytest.fixture(scope="module")
def ranks(arrays, tmp_path_factory):
    jobs = ([("forward", cid, spec) for cid, spec in FWD_CASES.items()]
            + [("train", cid, spec) for cid, spec in SGD_CASES.items()]
            + [("reshard", "reshard", _reshard_spec(str(tmp_path_factory.mktemp("ckpt"))))])
    return launch(torch_seq_worker.run_jobs, 8, "cpu", args=(jobs, arrays), timeout=600,
                  group_timeout=120)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _members(ranks, case_id):
    return [r[case_id] for r in ranks if case_id in r]


def _assemble(members, shape):
    out, seen = np.full(shape, np.nan, np.float32), {}
    for m in members:
        (d, dp), (i, n) = m["rows"], m["seq"]
        if (d, i) in seen:  # the tp ranks of one slice agree bit for bit
            np.testing.assert_array_equal(m["y"], seen[(d, i)])
            continue
        seen[(d, i)] = m["y"]
        rows, cols = shape[0] // dp, shape[1] // n
        out[d * rows:(d + 1) * rows, i * cols:(i + 1) * cols] = m["y"]
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("case_id", sorted(FWD_CASES))
def test_forward_where_the_port_refused_matches_jax(ranks, arrays, devices, case_id):
    spec = FWD_CASES[case_id]
    cfg = jax_configs.ModelConfig(**spec["fields"])
    mesh = jax_mesh(spec["mesh"])
    params = jax_tf.shard_params(jax.tree.map(jnp.asarray, arrays["weights"][spec["weights"]]),
                                 mesh)
    sharding = NamedSharding(mesh, jax_batch_spec(mesh))
    x = jax.device_put(jnp.asarray(arrays["batches"][spec["batch"]][0]), sharding)
    ref = np.asarray(jax.jit(lambda p, a: jax_tf.forward(p, a, cfg, mesh=mesh),
                             out_shardings=sharding)(params, x))
    members = _members(ranks, case_id)
    assert len(members) == int(np.prod(spec["mesh"]))
    assert _rel_l2(_assemble(members, ref.shape), ref) <= FP32_REL_L2


@pytest.mark.parametrize("case_id", sorted(SGD_CASES))
def test_one_sgd_step_gives_the_jax_gradient(ranks, arrays, devices, case_id):
    """JAX's ``make_train_step`` on the same mesh and ZeRO stage: the
    reduced gradient of every leaf from one SGD step."""
    spec = SGD_CASES[case_id]
    ref_losses, ref = jax_train(spec, arrays["weights"], arrays["batches"])
    np.testing.assert_allclose(losses_of(ranks, case_id), ref_losses, rtol=LOSS_RTOL)
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


def _jax_message(fn, *args, **kwargs):
    with pytest.raises(ValueError) as e:
        fn(*args, **kwargs)
    return str(e.value)


def test_ulysses_refuses_heads_that_sp_does_not_divide_with_the_jax_message(devices):
    """JAX's two refusals stay: ``num_heads % sp`` (the model reaches it;
    ``kv_heads % sp`` falls back to JAX's repeat there) and ``kv_heads %
    sp`` on the function, word for word."""
    jmesh = jax_parallelism_mesh(1, 4, 1, 1, 1, devices=jax.devices()[:4])
    pmesh = Mesh(MeshSpec((1, 4, 1), ("dp", "sp", "tp")), 0, None, {"tp": None})
    for heads, kvh in ((6, 6), (4, 2)):
        want = _jax_message(jax_ulysses, jnp.zeros((1, heads, 16, 8)),
                            jnp.zeros((1, kvh, 16, 8)), jnp.zeros((1, kvh, 16, 8)), jmesh)
        from dlbb_tpu_torch.parallel import ulysses_attention
        got = _jax_message(ulysses_attention, torch.zeros(1, heads, 4, 8),
                           torch.zeros(1, kvh, 4, 8), torch.zeros(1, kvh, 4, 8), pmesh)
        assert got == want
    cfg = ModelConfig(hidden_size=48, num_layers=1, num_heads=6, ffn_intermediate=96,
                      attention="ulysses", dtype="float32")
    with torch.inference_mode():
        got = _jax_message(forward, init_params(cfg, 0, "cpu"), torch.zeros(1, 4, 48), cfg,
                           mesh=pmesh)
    assert got.startswith("ulysses needs num_heads (6) divisible by sp=4")


@pytest.mark.parametrize("model,tp", [({"ffn_intermediate": 256}, 3),
                                      ({"num_kv_heads": 2, "ffn_intermediate": 384}, 3)])
def test_uneven_parameter_dimension_is_refused_as_jax_refuses_it(devices, model, tp):
    """(96, 6, 256, tp=3): JAX's pjit refuses ``ffn_down``'s kernel, dimension
    1; (96, 6, kv 2, 384, tp=3): the qkv width 160.  JAX's plan passes both;
    its ``init_params_sharded`` and ``make_train_step`` raise, and the
    port's plan names the same leaf and dimension."""
    fields = dict(MODELS["h96n6"], **model)
    config = {"model": fields, "input": {"batch_size": 8, "sequence_length": 16},
              "parallelism": {"world_size": tp, "data_parallel": 1}}
    jcfg = jax_configs.ModelConfig(**fields)
    jmesh = jax_parallelism_mesh(1, 1, 1, tp, 1, devices=jax.devices()[:tp])
    want = _jax_message(jax_tf.init_params_sharded, jcfg, jax.random.key(0), jmesh)
    m = re.search(r"key path result\['layers'\]\['(\w+)'\]\['(\w+)'\].*its dimension (\d+) "
                  r"should be divisible by (\d+), but it is equal to (\d+)", want)
    assert m, want
    from dlbb_tpu.train import loop as jax_loop
    from dlbb_tpu.train import optim as jax_optim
    with pytest.raises(ValueError, match="should be divisible by"):
        jax_loop.make_train_step(jcfg, jmesh, jax_optim.build_optimizer({}),
                                 jax_tf.init_params(jcfg, jax.random.key(0)))
    got = _jax_message(port_plan.check_plan, config, ModelConfig(**fields), tp)
    group, leaf, dim, div, size = m.groups()
    assert got.startswith(f"layers.{group}.{leaf} ")
    assert f"dimension {dim} should be divisible by the tensor-parallel degree {div}, " \
        f"but it is equal to {size}" in got


def test_plans_jax_runs_are_accepted():
    """The probe table's three running rows and Ulysses at num_heads=4,
    tp=2, sp=4 pass the port's plan (``validate_sp_heads`` is gone)."""
    for fields, par, want in (
            (MODELS["h96n6"], {"world_size": 4}, (1, 1, 1, 1, 4)),
            (MODELS["h96n4"], {"world_size": 3}, (1, 1, 1, 1, 3)),
            (MODELS["h96n6"], {"world_size": 3}, (1, 1, 1, 1, 3)),
            (dict(MODELS["n4"], attention="ulysses"),
             {"world_size": 2, "sequence_parallel": 4}, (1, 4, 1, 1, 2))):
        config = {"model": fields, "input": {"batch_size": 8, "sequence_length": 16},
                  "parallelism": {"data_parallel": 1, **par}}
        assert port_plan.check_plan(config, ModelConfig(**fields), int(np.prod(want))) == want


# ---------------------------------------------------------------------------
# a checkpoint restored onto another mesh and ZeRO stage
# ---------------------------------------------------------------------------


def _global_state(members, dp, tp, stage, weights):
    """Every rank's state snapshot of a (dp, tp) mesh at a ZeRO stage,
    joined: dp shards by each leaf's dp axis (the parameters at stage 3,
    Adam's moments from stage 1), then the tp shards (``unshard_params``).
    Returns ``{path: array}`` with the paths of a world-1 snapshot."""
    cfg = ModelConfig(**MODELS["n4"])
    by = {(m["coords"]["dp"], m["coords"]["tp"]): m["state"] for m in members}
    assert len(by) == dp * tp
    out = {}
    prefixes = sorted({k.rsplit("/layers/", 1)[0] if "/layers/" in k
                       else k.rsplit("/ln_f/", 1)[0] for k in by[(0, 0)]})
    for prefix in prefixes:
        sharded = stage == 3 if prefix == "params" else stage >= 1
        parts = []
        for j in range(tp):
            local = shard_params(params_from_jax(weights, cfg), cfg, j, tp)
            axes = pt_zero.dp_sharded_param_specs(local, dp)
            trees = [_tree(by[(i, j)], prefix, local) for i in range(dp)]
            if sharded:
                parts.append(pt_zero.unshard_tree(trees, axes))
            else:
                for other in trees[1:]:
                    for a, b in zip(_leaves(trees[0]), _leaves(other)):
                        assert torch.equal(a, b)
                parts.append(trees[0])
        full = unshard_params(parts, cfg)
        out.update(_flat(full, prefix))
    return out


def _tree(snapshot, prefix, like):
    return {"layers": {g: {leaf: torch.from_numpy(snapshot[f"{prefix}/layers/{g}/{leaf}"])
                           for leaf in sub} for g, sub in like["layers"].items()},
            "ln_f": {leaf: torch.from_numpy(snapshot[f"{prefix}/ln_f/{leaf}"])
                     for leaf in like["ln_f"]}}


def _leaves(tree):
    return [t for sub in tree["layers"].values() for t in sub.values()] + \
        list(tree["ln_f"].values())


def _flat(tree, prefix):
    out = {f"{prefix}/layers/{g}/{leaf}": t.numpy() for g, sub in tree["layers"].items()
           for leaf, t in sub.items()}
    out.update({f"{prefix}/ln_f/{leaf}": t.numpy() for leaf, t in tree["ln_f"].items()})
    return out


def _jax_second_loss(arrays, dp, tp, stage):
    spec = {"mesh": (dp, 1, tp), "fields": MODELS["n4"], "weights": "n4",
            "train": {"learning_rate": ADAM_LR}, "stage": stage, "grad_accum": 1,
            "steps": 2, "batch": "h64"}
    return jax_train(spec, arrays["weights"], arrays["batches"])[0][1]


@pytest.mark.parametrize("target", ["2x4/zero3", "1x1/zero0"])
def test_checkpoint_restores_onto_another_mesh_and_zero_stage(ranks, arrays, devices, target):
    """Saved at dp=4 x tp=2, ZeRO-1 after one Adam step; restored onto
    ``target``: the step, and the parameters and Adam moments gathered,
    equal the saved ones bit for bit; the next step's loss matches JAX's
    second step on the target mesh (and the uninterrupted one) to
    ``LOSS_RTOL``."""
    weights = arrays["weights"]["n4"]
    saved = [r["reshard"]["save"] for r in ranks]
    ref = _global_state(saved, 4, 2, 1, weights)
    dp, tp, stage = (int(x) for x in re.match(r"(\d+)x(\d+)/zero(\d+)", target).groups())
    members = [r["reshard"][f"restore/{target}"] for r in ranks
               if f"restore/{target}" in r["reshard"]]
    assert len(members) == dp * tp
    assert all(m["step"] == 1 for m in members)
    got = _global_state(members, dp, tp, stage, weights)
    assert set(got) == set(ref) and len(ref) == 42
    for path, a in ref.items():
        np.testing.assert_array_equal(got[path], a, err_msg=path)
    losses = {m["loss"] for m in members}
    assert len(losses) == 1
    jax_loss = _jax_second_loss(arrays, dp, tp, stage)
    np.testing.assert_allclose(losses.pop(), jax_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(saved[0]["loss"], jax_loss, rtol=LOSS_RTOL)
