"""The port's pipeline parallelism (``parallel/pipeline.py``: GPipe and 1F1B)
against the JAX package's.

Single process: ``schedule_1f1b``'s tables against JAX's over a grid of
(pp, m), ``validate_pipeline``'s messages against JAX's, the plan's
microbatch resolution and JAX's refusals, and a checkpoint's refusal to
restore onto another pp layout.

On 8 gloo ranks (``tests/torch_pipe_worker.py``), against JAX on the same
mesh of the CPU-simulated devices, fp32:

- the GPipe forward at pp=2 and 4, pp=2 x tp=2 and dp=2 x pp=2 x tp=2, and
  with its aux on a MoE model at pp=2 and pp=2 x ep=2, against JAX's
  pipelined ``forward``, to ``FWD_TOL`` = 1e-5 (the same fp32 arithmetic in
  another order);
- the 1F1B loss and gradients against JAX's ``pipeline_1f1b_grads``
  (dense and MoE with the aux loss), the loss to ``LOSS_RTOL`` and each leaf
  to ``GRAD_RTOL`` of its largest gradient, and the GPipe loss and
  gradients (autograd through ``forward``) against the same, to the same
  bounds (``tests/test_torch_zero.py`` argues them); the stage inputs a
  1F1B rank held at once never exceed 2 pp - 1 (stage s of pp holds
  ``min(m, 2 (pp - 1 - s) + 1)``);
- dryrun phases 2 and 2b of ``__graft_entry__.py::dryrun_multichip(8)``
  (``pp/zero1``, ``pp-1f1b/zero1``: dp=2 x pp=2 x tp=2, ZeRO-1, m=4, the
  dryrun's model at tp=2), two Adam steps, losses to ``LOSS_RTOL`` and full
  leaves to ``ADAM_ATOL``; one SGD step at ZeRO-3 under both schedules,
  with gradient accumulation, on a MoE model at pp=2 x ep=2 x tp=2 and at
  dp=2 x pp=2 with the aux loss, and at dp=4 x pp=2 on microbatches of 2
  rows (two ranks of each stage hold none), whose reduced gradients must
  be JAX's to ``GRAD_RTOL``;
- ``run_e2e`` and ``run_train`` on pipeline and expert-parallel configs
  (the YAML keys ``pipeline_parallel``, ``num_microbatches``,
  ``pipeline_schedule``, ``expert_parallel``, ``num_experts``,
  ``moe_dispatch``, ``moe_aux_loss_weight``): finite results that record
  the mesh and the schedule.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_pipe_worker
from torch_mesh_parity import (
    ADAM,
    GRAD_RTOL,
    LOSS_RTOL,
    SGD,
    by_path,
    check_adam_case,
    check_sgd_case,
    jax_mesh,
)

from dlbb_tpu.models import configs as jax_configs
from dlbb_tpu.models import transformer as jax_tf
from dlbb_tpu.parallel import pipeline as jax_pipe
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu_torch.models import ModelConfig
from dlbb_tpu_torch.models.sharding import unshard_params
from dlbb_tpu_torch.parallel import pipeline as pt_pipe
from dlbb_tpu_torch.parallel import plan as pt_plan
from dlbb_tpu_torch.train import optim as pt_optim

torch.set_num_threads(1)

FWD_TOL = 1e-5
DENSE = dict(hidden_size=32, num_layers=4, num_heads=4, ffn_intermediate=64,
             dtype="float32", attention="full")
MOE = dict(DENSE, num_experts=4, moe_top_k=2)
# the dryrun's model at tp=2: hidden 16 tp, ffn 32 tp, 2 layers
DRYRUN = dict(DENSE, num_layers=2)
AUX = 0.01


def _jax_weights(fields):
    return jax.tree.map(np.asarray, jax_tf.init_params(
        jax_configs.ModelConfig(**fields), jax.random.key(0)))


@pytest.mark.parametrize("pp", [1, 2, 3, 4])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 8])
def test_schedule_1f1b_matches_jax(pp, m):
    pairs, fwd, bwd = pt_pipe.schedule_1f1b(pp, m)
    j_pairs, j_fwd, j_bwd = jax_pipe.schedule_1f1b(pp, m)
    assert pairs == j_pairs
    np.testing.assert_array_equal(fwd, j_fwd)
    np.testing.assert_array_equal(bwd, j_bwd)
    assert fwd.dtype == j_fwd.dtype and bwd.dtype == j_bwd.dtype


@pytest.mark.parametrize("fields,pp,batch,m", [
    (DENSE, 3, 8, None), (DENSE, 2, 8, 3), (DENSE, 2, 8, 0), (DENSE, 2, 8, -1),
    (dict(DENSE, attention="ring"), 2, 8, None), (dict(DENSE, attention="ulysses"), 2, 8, 4),
    (dict(DENSE, attention="flash"), 2, 8, 2), (DENSE, 2, 8, None), (DENSE, 2, 8, 4),
    (dict(DENSE, attention="simplified"), 4, 8, 8), (dict(DENSE, attention="dense"), 1, 3, 3),
], ids=["layers", "batch", "zero", "negative", "ring", "ulysses", "flash", "default",
        "m4", "simplified", "pp1"])
def test_validate_pipeline_matches_jax(fields, pp, batch, m):
    def outcome(validate, cfg):
        try:
            return validate(cfg, pp, batch, m)
        except ValueError as e:
            return f"ValueError: {e}"

    want = outcome(jax_pipe.validate_pipeline, jax_configs.ModelConfig(**fields))
    assert outcome(pt_pipe.validate_pipeline, ModelConfig(**fields)) == want


def _config(par, model=None, batch=8):
    return {"model": dict(DENSE, **(model or {})), "parallelism": dict(par),
            "input": {"batch_size": batch, "sequence_length": 16}}


@pytest.mark.parametrize("par,model,want,m", [
    ({"pipeline_parallel": 2}, None, (1, 1, 2, 1, 1), 2),
    ({"pipeline_parallel": 2, "num_microbatches": 4, "world_size": 2,
      "data_parallel": 2}, None, (2, 1, 2, 1, 2), 4),
    ({"expert_parallel": 2, "world_size": 2}, {"num_experts": 4}, (1, 1, 1, 2, 2), None),
    ({"pipeline_parallel": 2, "expert_parallel": 2, "world_size": 2},
     {"num_experts": 4}, (1, 1, 2, 2, 2), 2),
])
def test_plan_resolves_pipeline_and_expert_parallelism(par, model, want, m):
    config = _config(par, model)
    cfg = ModelConfig.from_dict(config["model"])
    assert pt_plan.check_plan(config, cfg, int(np.prod(want))) == want
    assert pt_plan.microbatches(config, cfg) == m


@pytest.mark.parametrize("name", ["rows", "layers", "experts", "aux"])
def test_pipeline_and_expert_refusals(name):
    """JAX's refusals (uneven layers over pp, experts over ep; the aux
    weight without a MoE model), and what JAX plans where the port used to
    refuse: microbatches that dp does not divide (``rows``: 8 rows in 4
    microbatches of 2 over dp=4) and the aux loss with dp above 1 under a
    pipeline or accumulation (``aux``).  The port's steps on both are held
    against JAX's below (``rows/dp4pp2/m4``, ``sgd/moe/dp2pp2-1f1b/aux``) and
    in ``tests/test_torch_reshard.py``."""
    if name == "rows":
        from dlbb_tpu.parallel.plan import ParallelismPlan as JaxPlan

        config = _config({"pipeline_parallel": 2, "num_microbatches": 4,
                          "data_parallel": 4}, batch=8)
        jplan = JaxPlan.from_config(config, jax_configs.ModelConfig(**config["model"]))
        want = (jplan.dp, jplan.sp, jplan.pp, jplan.ep, jplan.tp)
        assert pt_plan.check_plan(config, ModelConfig.from_dict(config["model"]), 8) == want
        assert pt_plan.microbatches(config, ModelConfig.from_dict(config["model"])) == \
            jplan.num_microbatches == 4
    elif name == "layers":
        config = _config({"pipeline_parallel": 3})
        with pytest.raises(ValueError, match="num_layers=4 not divisible by pipeline_parallel=3"):
            pt_plan.check_plan(config, ModelConfig.from_dict(config["model"]), 3)
    elif name == "experts":
        config = _config({"expert_parallel": 3}, {"num_experts": 4})
        with pytest.raises(ValueError, match="num_experts=4 not divisible by expert_parallel=3"):
            pt_plan.check_plan(config, ModelConfig.from_dict(config["model"]), 3)
    else:
        from dlbb_tpu_torch.train.loop import check_moe_aux

        with pytest.raises(ValueError, match="requires a MoE model"):
            check_moe_aux(AUX, ModelConfig(**DENSE))
        check_moe_aux(AUX, ModelConfig(**MOE))
        check_moe_aux(0.0, ModelConfig(**DENSE))


def test_checkpoint_refuses_another_pipeline_layout(tmp_path):
    from dlbb_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer
    from dlbb_tpu_torch.train.loop import TrainState

    state = TrainState({"w": torch.ones(3)}, (), 1)
    saved = {"mesh": {"dp": 1, "sp": 1, "pp": 2, "ep": 1, "tp": 1}, "zero_stage": 1}
    with Checkpointer(CheckpointConfig(str(tmp_path)), layout=saved) as ckpt:
        ckpt.maybe_save(state, force=True)
    for other in ({"pp": 1}, {"pp": 2, "ep": 2}):
        layout = {"mesh": dict(saved["mesh"], **other), "zero_stage": 1}
        with Checkpointer(CheckpointConfig(str(tmp_path)), layout=layout) as ckpt:
            with pytest.raises(ValueError, match="restores only onto the mesh"):
                ckpt.restore(state)
    with Checkpointer(CheckpointConfig(str(tmp_path)), layout=saved) as ckpt:
        assert ckpt.restore(state).step == 1


# ---- pipelines on 8 gloo ranks ---------------------------------------------

def _model(mesh, kind, weights="dense", **kw):
    return dict(mesh=mesh, fields=MOE if weights == "moe" else DENSE, weights=weights,
                batch="b8", kind=kind, **kw)


FORWARDS = {
    "pp2/m4": _model((1, 1, 2, 1, 1), "forward", microbatches=4),
    "pp4/m-default": _model((1, 1, 4, 1, 1), "forward"),
    "pp2tp2/m2": _model((1, 1, 2, 1, 2), "forward", microbatches=2),
    "dp2pp2tp2/m2": _model((2, 1, 2, 1, 2), "forward", microbatches=2),
    "moe/pp2/m4": _model((1, 1, 2, 1, 1), "forward", "moe", microbatches=4, with_aux=True),
    "moe/pp2ep2/m2": _model((1, 1, 2, 2, 1), "forward", "moe", microbatches=2,
                            with_aux=True),
}
GRADS = {f"{kind}/{name}": _model(mesh, kind, w, microbatches=m, aux=aux)
         for kind in ("1f1b", "gpipe")
         for name, mesh, w, m, aux in (("pp2/m4", (1, 1, 2, 1, 1), "dense", 4, 0.0),
                                       ("pp4/m8", (1, 1, 4, 1, 1), "dense", 8, 0.0),
                                       ("pp2tp2/m4", (1, 1, 2, 1, 2), "dense", 4, 0.0),
                                       ("moe/pp2ep2/m4", (1, 1, 2, 2, 1), "moe", 4, AUX))}
MODEL_CASES = {**FORWARDS, **GRADS}


def _train(mesh, train, stage, weights="dryrun", steps=1, grad_accum=1, **kw):
    fields = {"dryrun": DRYRUN, "dense": DENSE, "moe": MOE}[weights]
    return {"mesh": mesh, "fields": fields, "weights": weights, "train": train,
            "stage": stage, "grad_accum": grad_accum, "steps": steps, "batch": "b8", **kw}


DRYRUN_CASES = {
    "pp/zero1": _train((2, 1, 2, 1, 2), ADAM, 1, steps=2, microbatches=4),
    "pp-1f1b/zero1": _train((2, 1, 2, 1, 2), ADAM, 1, steps=2, microbatches=4,
                            schedule="1f1b"),
}
SGD_CASES = {
    "sgd/pp2/zero3": _train((2, 1, 2, 1, 2), SGD, 3, "dense", microbatches=2),
    "sgd/pp2-1f1b/zero3": _train((2, 1, 2, 1, 2), SGD, 3, "dense", microbatches=2,
                                 schedule="1f1b"),
    "sgd/pp2-1f1b/ga2/zero2": _train((2, 1, 2, 1, 1), SGD, 2, "dense", grad_accum=2,
                                     microbatches=2, schedule="1f1b"),
    "sgd/moe/pp2ep2tp2-1f1b/aux": _train((1, 1, 2, 2, 2), SGD, 1, "moe", microbatches=2,
                                         schedule="1f1b", aux=AUX),
    # microbatches of 2 rows over dp=4: ranks with no rows in a pipeline
    "rows/dp4pp2/m4": _train((4, 1, 2, 1, 1), SGD, 1, "dense", microbatches=4),
    # each dp rank's half of each global microbatch: JAX's routing statistics
    "sgd/moe/dp2pp2-1f1b/aux": _train((2, 1, 2, 1, 1), SGD, 1, "moe", microbatches=2,
                                      schedule="1f1b", aux=AUX),
}
TRAIN = {**DRYRUN_CASES, **SGD_CASES}


@pytest.fixture(scope="module")
def weights():
    return {"dense": _jax_weights(DENSE), "moe": _jax_weights(MOE),
            "dryrun": _jax_weights(DRYRUN)}


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(13)
    return {"b8": tuple(rng.standard_normal((8, 16, 32), dtype=np.float32)
                        for _ in range(2))}


@pytest.fixture(scope="module")
def ranks(weights, batches):
    return launch(torch_pipe_worker.run_cases, 8, "cpu",
                  args=(list(MODEL_CASES.items()), list(TRAIN.items()), weights, batches),
                  timeout=600, group_timeout=120)


def _records(ranks, case_id):
    return [r[0][case_id] for r in ranks if case_id in r[0]]


@pytest.mark.parametrize("case_id", sorted(FORWARDS))
def test_gpipe_forward_matches_jax(ranks, weights, batches, case_id):
    spec = FORWARDS[case_id]
    cfg = jax_configs.ModelConfig(**spec["fields"])
    mesh = jax_mesh(spec["mesh"])
    x = jnp.asarray(batches["b8"][0])
    aux = spec.get("with_aux", False)
    out = jax.jit(lambda p, a: jax_tf.forward(p, a, cfg, mesh=mesh,
                                              num_microbatches=spec.get("microbatches"),
                                              with_aux=aux))(
        jax_tf.shard_params(jax.tree.map(jnp.asarray, weights[spec["weights"]]), mesh), x)
    y = np.asarray(out[0] if aux else out)
    dp = spec["mesh"][0]
    recs = _records(ranks, case_id)
    assert len(recs) == np.prod(spec["mesh"])
    for rec in recs:
        rows = slice(rec["coords"]["dp"] * 8 // dp, (rec["coords"]["dp"] + 1) * 8 // dp)
        np.testing.assert_allclose(rec["y"], y[rows], atol=FWD_TOL, rtol=FWD_TOL)
        if aux:
            assert rec["aux"] == pytest.approx(float(out[1]), rel=1e-6)


def _port_grads(ranks, case_id):
    spec = GRADS[case_id]
    _, _, pp, ep, tp = spec["mesh"]
    recs = {(r["coords"].get("pp", 0), r["coords"].get("ep", 0), r["coords"]["tp"]): r
            for r in _records(ranks, case_id)}
    losses = {r["loss"] for r in recs.values()}
    assert len(losses) == 1, f"{case_id}: ranks report other losses {losses}"
    parts = [pt_optim.tree_map(torch.from_numpy, recs[k]["grads"]) for k in sorted(recs)]
    full = unshard_params(parts, ModelConfig(**spec["fields"]), pp, ep)
    return losses.pop(), by_path(pt_optim.tree_map(lambda t: t.numpy(), full)), recs


def _jax_1f1b(spec, weights, batches):
    cfg = jax_configs.ModelConfig(**spec["fields"])
    mesh = jax_mesh(spec["mesh"])
    x, t = (jnp.asarray(a) for a in batches["b8"])
    loss, grads = jax.jit(lambda p, a, b: jax_pipe.pipeline_1f1b_grads(
        p, a, b, cfg, mesh, num_microbatches=spec["microbatches"],
        moe_aux_weight=spec["aux"]))(
        jax_tf.shard_params(jax.tree.map(jnp.asarray, weights[spec["weights"]]), mesh), x, t)
    return float(loss), by_path(jax.tree.map(np.asarray, grads))


def _hold(loss, grads, ref_loss, ref, label):
    assert loss == pytest.approx(ref_loss, rel=LOSS_RTOL), label
    assert set(grads) == set(ref), label
    for name, g in grads.items():
        scale = np.abs(ref[name]).max()
        np.testing.assert_allclose(g, ref[name], atol=GRAD_RTOL * scale, rtol=0,
                                   err_msg=f"{label}: {name}")


@pytest.mark.parametrize("case_id", sorted(GRADS))
def test_pipeline_grads_match_jax_1f1b(ranks, weights, batches, case_id):
    ref_loss, ref = _jax_1f1b(GRADS[case_id], weights, batches)
    loss, grads, _ = _port_grads(ranks, case_id)
    _hold(loss, grads, ref_loss, ref, case_id)


@pytest.mark.parametrize("case_id", sorted(k for k in GRADS if k.startswith("1f1b")))
def test_1f1b_equals_gpipe(ranks, case_id):
    loss, grads, _ = _port_grads(ranks, case_id)
    g_loss, g_grads, _ = _port_grads(ranks, "gpipe/" + case_id.split("/", 1)[1])
    _hold(loss, grads, g_loss, g_grads, case_id)


@pytest.mark.parametrize("case_id", sorted(k for k in GRADS if k.startswith("1f1b")))
def test_1f1b_holds_at_most_2pp_minus_1_stage_inputs(ranks, case_id):
    spec = GRADS[case_id]
    pp, m = spec["mesh"][2], spec["microbatches"]
    _, _, recs = _port_grads(ranks, case_id)
    for (s, _, _), rec in recs.items():
        assert rec["max_live_inputs"] <= 2 * pp - 1
        assert rec["max_live_inputs"] == min(m, 2 * (pp - 1 - s) + 1)


@pytest.mark.parametrize("case_id", sorted(DRYRUN_CASES))
def test_dryrun_pipeline_phases_match_jax(ranks, weights, batches, case_id):
    check_adam_case([r[1] for r in ranks], weights, batches, case_id, TRAIN[case_id])


@pytest.mark.parametrize("case_id", sorted(SGD_CASES))
def test_pipeline_sgd_step_gives_the_jax_gradient(ranks, weights, batches, case_id):
    check_sgd_case([r[1] for r in ranks], weights, batches, case_id, TRAIN[case_id])


# ---- the entry points ---------------------------------------------------------

ENTRY_BASE = {
    "experiment": {"name": "pp_ep_entry"},
    "model": dict(DENSE),
    "input": {"batch_size": 8, "sequence_length": 16, "seed": 3},
    "execution": {"warmup_iterations": 1, "benchmark_iterations": 2},
    "training": {"learning_rate": 1e-3},
}
ENTRY = {
    "gpipe": ({"world_size": 2, "pipeline_parallel": 2, "num_microbatches": 4},
              {}, {"pipeline_schedule": "gpipe"}),
    "1f1b-moe": ({"pipeline_parallel": 2, "expert_parallel": 2, "num_microbatches": 2},
                 {"num_experts": 4, "moe_top_k": 2, "moe_dispatch": "capacity"},
                 {"pipeline_schedule": "1f1b", "moe_aux_loss_weight": AUX}),
    "ep-moe-zero3": ({"expert_parallel": 2, "data_parallel": 2},
                     {"num_experts": 4, "moe_top_k": 2},
                     {"moe_aux_loss_weight": AUX, "zero_stage": 3}),
}


def _entry_config(name):
    par, model, train = ENTRY[name]
    config = copy.deepcopy(ENTRY_BASE)
    config["parallelism"] = dict(par)
    config["model"].update(model)
    config["training"].update(train)
    return config


@pytest.fixture(scope="module")
def entry_runs():
    return {name: launch(torch_pipe_worker.run_entry_points, 4, "cpu",
                         args=(_entry_config(name),), timeout=300, group_timeout=120)
            for name in ENTRY}


@pytest.mark.parametrize("name", sorted(ENTRY))
def test_entry_points_run_pipeline_and_expert_configs(entry_runs, name):
    config = _entry_config(name)
    par = config["parallelism"]
    e2e, train = entry_runs[name][0]
    mesh = {"dp": par.get("data_parallel", 1), "sp": 1, "pp": par.get("pipeline_parallel", 1),
            "ep": par.get("expert_parallel", 1), "tp": par.get("world_size", 1)}
    assert e2e["mesh"] == train["mesh"] == mesh
    assert e2e["config"] == train["config"] == config
    assert train["pipeline_schedule"] == (config["training"].get("pipeline_schedule")
                                          if mesh["pp"] > 1 else None)
    assert np.isfinite(e2e["forward_time"]["mean"]) and np.all(np.isfinite(train["losses"]))
    assert len({tuple(r[1]["losses"]) for r in entry_runs[name]}) == 1


@pytest.mark.parametrize("moe,pp,ep,tp", [
    (False, 2, 1, 1), (False, 2, 1, 2), (True, 2, 1, 1), (True, 2, 1, 2),
    (True, 1, 2, 1), (True, 1, 2, 2), (True, 2, 2, 2)])
@pytest.mark.parametrize("dp", [2, 4])
def test_zero_layout_skips_the_pp_and_ep_dimensions_as_jax(moe, pp, ep, tp, dp):
    """Each leaf's dp axis is JAX's ``dp_sharded_param_specs`` on the
    ``specs_for_mesh`` layout: never the layer dimension under pp or the
    expert dimension under ep (JAX's rule skips every axis its spec names),
    measured on the rank's part by the port and on the global shape by
    JAX."""
    from dlbb_tpu.models.sharding import param_specs
    from dlbb_tpu.train import loop as jax_loop
    from dlbb_tpu_torch.models import init_params
    from dlbb_tpu_torch.models.sharding import shard_params
    from dlbb_tpu_torch.train import zero as pt_zero

    fields = dict(MOE if moe else DENSE, num_layers=8, hidden_size=64, ffn_intermediate=64)
    shapes = jax.eval_shape(lambda: jax_tf.init_params(jax_configs.ModelConfig(**fields),
                                                       jax.random.key(0)))
    specs = jax_loop.dp_sharded_param_specs(
        shapes, dp, base_specs=param_specs("tp", "pp" if pp > 1 else None, moe=moe,
                                           ep_axis="ep" if ep > 1 else None))
    want = jax.tree.map(lambda s: s.index("dp") if "dp" in s else None, specs,
                        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    cfg = ModelConfig(**fields)
    local = shard_params(init_params(cfg, 0, "cpu"), cfg, 0, tp, 0, pp, 0, ep)
    assert pt_zero.dp_sharded_param_specs(local, dp, pp, ep) == want
