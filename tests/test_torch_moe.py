"""The port's MoE FFN and expert parallelism against the JAX package's.

Single process, fp32: the router's ``router_probs_gates``/``top_k_gates``,
``moe_aux_loss``, the dense and the capacity dispatch (``_moe_ffn``, with a
capacity small enough that slots overflow and routing slots are dropped),
the forward with its aux, ``num_parameters`` and ``forward_flops``, on
seeded numpy inputs and JAX weights carried across with
``params_from_jax``.  Bound: ``FWD_TOL`` = 1e-5, the same fp32 arithmetic
in another order (the port adds the ``ffn_down`` bias term apart from the
experts' products, which JAX adds per expert before the combine); the
routing is exact (the same fp32 softmax and selection).  Ties of top-k:
``jax.lax.top_k`` takes the lower index, and so must the port, on logits
with forced equal values, bit for bit.

On 8 gloo ranks (``tests/torch_pipe_worker.py``), against JAX on the same
mesh of the CPU-simulated devices: the forward with its aux at ep=2 and
ep=2 x tp=2 (dense and capacity), and with the capacity dispatch at sp=2
and sp=2 x ep=2 under ring attention (each rank's queues continue the
earlier chunks'), against JAX's; one SGD step with the aux loss at ep=2,
ep=2 x tp=2, dp=2 x ep=2 (the aux's token means over dp) and, with slots
overflowing, at sp=2 x ep=2,
whose reduced gradients must be JAX's to ``GRAD_RTOL``; and dryrun phases
5 and 6 of ``__graft_entry__.py::dryrun_multichip(8)`` (``ep/moe/zero3``
and ``ep/moe-capacity/zero3``: dp=2 x ep=2 x tp=2, 4 experts, top-2, the
dryrun's model at tp=2, ZeRO-3), two Adam steps, losses to ``LOSS_RTOL``
and every full leaf to ``ADAM_ATOL`` (``tests/test_torch_zero.py`` argues
both bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_pipe_worker
from torch_mesh_parity import (
    ADAM,
    SGD,
    check_adam_case,
    check_sgd_case,
    jax_mesh,
)

from dlbb_tpu.models import configs as jax_configs
from dlbb_tpu.models import transformer as jax_tf
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu_torch.data import batch_slice
from dlbb_tpu_torch.models import ModelConfig, init_params, params_from_jax
from dlbb_tpu_torch.models import transformer as pt_tf
from dlbb_tpu_torch.train import optim as pt_optim

torch.set_num_threads(1)

FWD_TOL = 1e-5
SMALL = dict(hidden_size=32, num_layers=2, num_heads=4, ffn_intermediate=64,
             dtype="float32", attention="full", num_experts=4, moe_top_k=2)
# the dryrun's model at tp=2 (hidden 16 tp, ffn 32 tp), with its MoE fields
DRYRUN_MOE = dict(hidden_size=32, num_layers=2, num_heads=4, ffn_intermediate=64,
                  dtype="float32", attention="full", num_experts=4, moe_top_k=2)
DISPATCH = {"dense": {}, "capacity": {"moe_dispatch": "capacity"},
            # 0.5 x 16 x 2 / 4 = 4 slots per expert for 8 routing slots on average
            "overflow": {"moe_dispatch": "capacity", "moe_capacity_factor": 0.5}}


def _jax_weights(fields, seed=0):
    return jax.tree.map(np.asarray, jax_tf.init_params(
        jax_configs.ModelConfig(**fields), jax.random.key(seed)))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("experts,k", [(4, 1), (4, 2), (8, 2), (8, 3)])
def test_router_gates_and_aux_match_jax(experts, k):
    logits = _x((2, 16, experts), 3)
    jp, jg = jax_tf.router_probs_gates(jnp.asarray(logits), k)
    pp, pg = pt_tf.router_probs_gates(torch.from_numpy(logits), k)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=1e-7, rtol=1e-6)
    assert np.array_equal(pg.numpy() > 0, np.asarray(jg) > 0)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(pt_tf.top_k_gates(torch.from_numpy(logits), k).numpy(),
                               np.asarray(jax_tf.top_k_gates(jnp.asarray(logits), k)),
                               atol=1e-7, rtol=1e-6)
    assert float(pt_tf.moe_aux_loss(pp, pg, k)) == pytest.approx(
        float(jax_tf.moe_aux_loss(jp, jg, k)), rel=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_top_k_ties_take_the_lower_index(dtype):
    """Equal logits give bit-equal probabilities; of those, JAX's top_k
    keeps the lower expert index, and so does the port."""
    rows = np.array([[0.0, 0.0, 0.0, 0.0], [1.0, 2.0, 2.0, 1.0], [3.0, 1.0, 3.0, 3.0],
                     [0.5, 0.5, 0.25, 0.5], [-1.0, 2.0, -1.0, 2.0]], dtype=np.float32)
    jt = jnp.asarray(rows, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    pt = torch.from_numpy(rows).to(getattr(torch, dtype))
    for k in (1, 2, 3):
        jg = np.asarray(jax_tf.top_k_gates(jt, k))
        pg = pt_tf.top_k_gates(pt, k).numpy()
        np.testing.assert_array_equal(pg, jg)
    chosen = [np.flatnonzero(r).tolist() for r in pt_tf.top_k_gates(pt, 2).numpy()]
    assert chosen == [[0, 1], [1, 2], [0, 2], [0, 1], [1, 3]]


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree["layers"])


@pytest.mark.parametrize("dispatch", sorted(DISPATCH))
def test_moe_ffn_matches_jax(dispatch):
    fields = dict(SMALL, **DISPATCH[dispatch])
    jcfg, pcfg = jax_configs.ModelConfig(**fields), ModelConfig(**fields)
    tree = _jax_weights(fields)
    y = _x((2, 16, 32), 5)
    jo, ja = jax_tf._moe_ffn(jnp.asarray(y), jax.tree.map(jnp.asarray, _layer(tree)), jcfg)
    params = params_from_jax(tree, pcfg)
    layer = {g: {p: t[0] for p, t in sub.items()} for g, sub in params["layers"].items()}
    po, pa = pt_tf._moe_ffn(torch.from_numpy(y), layer, pcfg, aux_groups=())
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=FWD_TOL, rtol=FWD_TOL)
    assert float(pa) == pytest.approx(float(ja), rel=1e-6)
    if dispatch == "overflow":
        # some routing slots claimed a slot past the capacity and were dropped
        logits = torch.from_numpy(y) @ layer["router"]["kernel"]
        mask = pt_tf.router_probs_gates(logits, 2)[1] > 0
        pos = torch.cumsum(mask.int(), dim=1) - 1
        cap = pt_tf.moe_capacity(pcfg, 16)
        assert cap == jax_tf.moe_capacity(jcfg, 16) == 4
        assert int((mask & (pos >= cap)).sum()) > 0


@pytest.mark.parametrize("dispatch", sorted(DISPATCH))
def test_moe_forward_with_aux_matches_jax(dispatch):
    fields = dict(SMALL, **DISPATCH[dispatch])
    jcfg, pcfg = jax_configs.ModelConfig(**fields), ModelConfig(**fields)
    tree = _jax_weights(fields)
    x = _x((2, 16, 32), 6)
    jy, ja = jax_tf.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jcfg,
                            with_aux=True)
    py, pa = pt_tf.forward(params_from_jax(tree, pcfg), torch.from_numpy(x), pcfg,
                           with_aux=True)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=FWD_TOL, rtol=FWD_TOL)
    assert float(pa) == pytest.approx(float(ja), rel=1e-6)
    # a dense FFN's aux is 0.0 on both sides
    dense = {k: v for k, v in SMALL.items() if k not in ("num_experts", "moe_top_k")}
    _, aux = pt_tf.forward(init_params(ModelConfig(**dense), 0, "cpu"),
                           torch.from_numpy(x), ModelConfig(**dense), with_aux=True)
    assert float(aux) == 0.0


@pytest.mark.parametrize("fields", [
    SMALL, dict(SMALL, moe_dispatch="capacity"),
    dict(SMALL, moe_dispatch="capacity", moe_capacity_factor=0.5, num_kv_heads=2),
    dict(SMALL, num_experts=8, moe_top_k=1, attention="simplified"),
    {"hidden_size": 2048, "num_layers": 24, "num_heads": 16, "ffn_intermediate": 8192,
     "num_experts": 4, "moe_top_k": 2},
], ids=["dense", "capacity", "capacity_gqa", "e8k1_simplified", "1b_e4"])
@pytest.mark.parametrize("batch,seq", [(2, 16), (8, 512)])
def test_moe_counts_match_jax(fields, batch, seq):
    jcfg, pcfg = jax_configs.ModelConfig(**fields), ModelConfig(**fields)
    assert pt_tf.num_parameters(pcfg) == jax_tf.num_parameters(jcfg)
    assert pt_tf.forward_flops(pcfg, batch, seq) == jax_tf.forward_flops(jcfg, batch, seq)
    assert pt_tf.moe_capacity(pcfg, seq) == jax_tf.moe_capacity(jcfg, seq)


def test_moe_init_params_has_the_jax_layout():
    """The MoE tree of ``init_params`` has JAX's leaves and shapes, and its
    parameter count is ``num_parameters``."""
    cfg = ModelConfig(**SMALL)
    mine = pt_optim.tree_map(lambda t: tuple(t.shape), init_params(cfg, 0, "cpu"))
    ref = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda: jax_tf.init_params(jax_configs.ModelConfig(**SMALL), jax.random.key(0))))
    assert mine == ref
    assert sum(int(np.prod(s)) for s in pt_optim.tree_leaves(mine)) == pt_tf.num_parameters(cfg)


# ---- expert parallelism on 8 gloo ranks --------------------------------------

def _model(mesh, fields, weights, kind="forward", **kw):
    return dict(mesh=mesh, fields=fields, weights=weights, batch="b4", kind=kind, **kw)


FORWARDS = {
    f"{name}/{dispatch}": _model(mesh, dict(SMALL, **DISPATCH[dispatch]), dispatch,
                                 with_aux=True)
    for name, mesh in (("ep2", (1, 1, 1, 2, 1)), ("ep2tp2", (1, 1, 1, 2, 2)))
    for dispatch in ("dense", "overflow")
}
# the sequence cut over sp: the capacity queues run over the whole sequence
FORWARDS.update({
    f"{name}/{dispatch}": _model(mesh, dict(SMALL, attention="ring", **DISPATCH[dispatch]),
                                 dispatch, with_aux=True)
    for name, mesh in (("sp2", (1, 2, 1, 1, 1)), ("sp2ep2", (1, 2, 1, 2, 1)))
    for dispatch in ("capacity", "overflow")
})


def _train(mesh, train, stage, weights, batch, steps=1, aux=0.0, **model):
    return {"mesh": mesh, "fields": dict(DRYRUN_MOE, **model), "weights": weights,
            "train": train, "stage": stage, "grad_accum": 1, "steps": steps,
            "batch": batch, "aux": aux}


DRYRUN = {
    "ep/moe/zero3": _train((2, 1, 1, 2, 2), ADAM, 3, "dense", "b8", steps=2),
    "ep/moe-capacity/zero3": _train((2, 1, 1, 2, 2), ADAM, 3, "capacity", "b8", steps=2,
                                    moe_dispatch="capacity"),
}
SGD_CASES = {
    "sgd/ep2/aux/zero1": _train((1, 1, 1, 2, 1), SGD, 1, "dense", "b4", aux=0.1),
    "sgd/ep2tp2/aux/zero3": _train((1, 1, 1, 2, 2), SGD, 3, "overflow", "b4", aux=0.1,
                                   moe_dispatch="capacity", moe_capacity_factor=0.5),
    "sgd/dp2ep2/aux/zero2": _train((2, 1, 1, 2, 1), SGD, 2, "dense", "b8", aux=0.1),
    "sgd/sp2ep2/aux/zero1": _train((1, 2, 1, 2, 1), SGD, 1, "overflow", "b4", aux=0.1,
                                   moe_dispatch="capacity", moe_capacity_factor=0.5,
                                   attention="ring"),
}
TRAIN = {**DRYRUN, **SGD_CASES}


@pytest.fixture(scope="module")
def weights():
    return {name: _jax_weights(dict(SMALL, **kw)) for name, kw in DISPATCH.items()}


@pytest.fixture(scope="module")
def batches():
    """Global (x, targets): 4 rows (dp=1 cases) and 8 rows (dp=2: the
    dryrun's 4 rows per dp rank), S=16."""
    rng = np.random.default_rng(11)
    return {key: tuple(rng.standard_normal((rows, 16, 32), dtype=np.float32)
                       for _ in range(2))
            for key, rows in (("b4", 4), ("b8", 8))}


@pytest.fixture(scope="module")
def ranks(weights, batches):
    return launch(torch_pipe_worker.run_cases, 8, "cpu",
                  args=(list(FORWARDS.items()), list(TRAIN.items()), weights, batches),
                  timeout=600, group_timeout=120)


@pytest.mark.parametrize("case_id", sorted(FORWARDS))
def test_expert_parallel_forward_matches_jax(ranks, weights, batches, case_id):
    spec = FORWARDS[case_id]
    cfg = jax_configs.ModelConfig(**spec["fields"])
    params = jax.tree.map(jnp.asarray, weights[spec["weights"]])
    x = jnp.asarray(batches[spec["batch"]][0])
    if cfg.attention == "ring":
        # ring attention runs on JAX's sp mesh only
        mesh = jax_mesh(spec["mesh"])
        jy, ja = jax.jit(lambda p, a: jax_tf.forward(p, a, cfg, mesh=mesh, with_aux=True))(
            jax_tf.shard_params(params, mesh), x)
    else:
        jy, ja = jax_tf.forward(params, x, cfg, with_aux=True)
    recs = [r[0][case_id] for r in ranks if case_id in r[0]]
    assert len(recs) == np.prod(spec["mesh"])
    for rec in recs:
        # a rank's output is its chunk of the sequence
        want = batch_slice(np.asarray(jy), sp_rank=rec["coords"].get("sp", 0),
                           sp=spec["mesh"][1])
        np.testing.assert_allclose(rec["y"], want, atol=FWD_TOL, rtol=FWD_TOL)
        assert rec["aux"] == pytest.approx(float(ja), rel=1e-6)


def test_expert_parallel_forward_on_the_jax_mesh(weights, batches):
    """JAX's GSPMD forward on the ep=2 x tp=2 mesh is the single-device
    one (the reference the port is held to above)."""
    fields = dict(SMALL)
    cfg = jax_configs.ModelConfig(**fields)
    mesh = jax_mesh((1, 1, 1, 2, 2))
    params = jax.tree.map(jnp.asarray, weights["dense"])
    x = jnp.asarray(batches["b4"][0])
    y0 = jax_tf.forward(params, x, cfg)
    y1 = jax.jit(lambda p, a: jax_tf.forward(p, a, cfg, mesh=mesh))(
        jax_tf.shard_params(params, mesh), x)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y0), atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("case_id", sorted(DRYRUN))
def test_dryrun_moe_phases_match_jax(ranks, weights, batches, case_id):
    check_adam_case([r[1] for r in ranks], weights, batches, case_id, TRAIN[case_id])


@pytest.mark.parametrize("case_id", sorted(SGD_CASES))
def test_expert_parallel_sgd_step_gives_the_jax_gradient(ranks, weights, batches, case_id):
    check_sgd_case([r[1] for r in ranks], weights, batches, case_id, TRAIN[case_id])
