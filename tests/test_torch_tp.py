"""The port's tensor-parallel forward (``models/sharding.py``,
``parallel/plan.py``, ``comm/mesh.py::build_parallelism_mesh``,
``bench/e2e.py`` at world > 1) against the JAX package's GSPMD forward, and
its gradients against ``jax.value_and_grad`` of the GSPMD loss
(``test_tp_gradients_match_jax``).

A small decoder (2 layers, H=256, 8 heads of 32, FFN 1024, B=4, S=64) gets
JAX ``init_params`` weights, carried across with ``params_from_jax`` and cut
with ``shard_params``.  The port runs on 4 spawned gloo ranks at tp=2 (the
first two ranks), tp=4 and dp=2 x tp=2; the JAX forward runs on the same
(dp, tp) mesh of the CPU-simulated devices of ``conftest.py``.  Attention
"simplified", "full" (dense on the CPU in both packages) and "dense"; MHA,
GQA with 4 kv heads (tp divides them) and with 2 and 1 (tp=4 and every tp
do not: each rank then runs one copy of its kv head per local q head).

Tolerances, relative L2 over the whole output:

- fp32, ``FP32_REL_L2`` = 1e-5: the same fp32 arithmetic summed in another
  order (the partial sums of a row-parallel product are added by the
  all-reduce) gives differences of a few 2**-24 per element;
- bf16, ``bf16_bound(tp)``.  At world 1 a row-parallel product's fp32 sum
  is rounded to bf16 once; at tp it is rounded once per partial sum, and
  the all-reduce's tp - 1 additions in bf16 round tp - 1 more times: tp - 1
  extra roundings of at most u = 2**-8 each, relative to the partials'
  magnitude, which for these random weights is about the sum's.  Two such
  products per layer, over L layers, add to the residual stream, which the
  final LayerNorm normalises: 2 L (tp - 1) u.  JAX and the port also round
  every other product and activation at slightly different places (the
  world-1 model tests hold the two at 5e-2 for that); on this model the
  two world-1 forwards differ by 5.2e-3 to 5.8e-3 relative L2, so the bound
  adds ``BF16_BASE`` = 1e-2 for it.  The bounds are 2.6e-2 at tp=2 and
  5.7e-2 at tp=4; the port at tp measured 5.6e-3 to 6.6e-3 from JAX and
  from its own world-1 forward.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_tp_worker
import yaml
from jax.sharding import NamedSharding
from test_torch_e2e import JAX_RESULT_KEYS

from dlbb_tpu.comm.mesh import build_parallelism_mesh as jax_parallelism_mesh
from dlbb_tpu.models import configs as jax_configs
from dlbb_tpu.models import transformer as jax_tf
from dlbb_tpu.models.sharding import batch_spec
from dlbb_tpu.parallel.plan import ParallelismPlan as JaxPlan
from dlbb_tpu.train import loop as jax_loop
from dlbb_tpu_torch import cli
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu_torch.data import SyntheticEmbeddingDataset
from dlbb_tpu_torch.models import ModelConfig, forward, init_params, params_from_jax
from dlbb_tpu_torch.models import sharding
from dlbb_tpu_torch.parallel import plan as port_plan
from dlbb_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

BASE = dict(hidden_size=256, num_layers=2, num_heads=8, ffn_intermediate=1024)
BATCH = (4, 64, 256)
MESHES = ((1, 2), (1, 4), (2, 2))
KV = {"mha": None, "gqa4": 4, "gqa2": 2, "mqa1": 1}
FP32_REL_L2 = 1e-5
BF16_BASE, BF16_U = 1e-2, 2.0**-8

CASE_KEYS = (
    [("float32", att, kv) for att in ("simplified", "full", "dense")
     for kv in ("mha", "gqa4", "gqa2")]
    + [("float32", "full", "mqa1")]
    + [("bfloat16", att, kv) for att in ("simplified", "full") for kv in ("gqa4", "mqa1")])
CASES = [(f"{dt}-{att}-{kv}", dict(BASE, attention=att, dtype=dt, num_kv_heads=KV[kv]),
          f"{dt}-{kv}") for dt, att, kv in CASE_KEYS]
PARAMS = [pytest.param(m, c, id=f"dp{m[0]}tp{m[1]}-{c[0]}") for m in MESHES for c in CASES]


def bf16_bound(tp):
    return BF16_BASE + 2 * BASE["num_layers"] * (tp - 1) * BF16_U


def _tol(dtype, tp):
    return FP32_REL_L2 if dtype == "float32" else bf16_bound(tp)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def weights():
    """The JAX parameters of each (dtype, kv) as float32 numpy (lossless
    for bf16), with every bias and LayerNorm scale drawn from a seeded
    normal instead of JAX's zeros and ones, so that a bias added on every
    rank, or a replicated leaf cut, shows."""
    rng = np.random.default_rng(1)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        leaf = path[-1].key
        if leaf == "bias":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if leaf == "scale":
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    out = {}
    for _, fields, key in CASES:
        if key not in out:
            tree = jax_tf.init_params(jax_configs.ModelConfig(**fields), jax.random.key(0))
            out[key] = jax.tree_util.tree_map_with_path(perturb, tree)
    return out


@pytest.fixture(scope="module")
def ranks(weights):
    """Each rank's outputs, by mesh: 4 gloo ranks, every mesh and case."""
    return launch(torch_tp_worker.run_tp_cases, 4, "cpu",
                  args=(MESHES, CASES, weights, BATCH), timeout=300)


def _jax_forward(mesh_shape, fields, w):
    dp, tp = mesh_shape
    cfg = jax_configs.ModelConfig(**fields)
    dtype = jnp.bfloat16 if fields["dtype"] == "bfloat16" else jnp.float32
    mesh = jax_parallelism_mesh(dp, 1, 1, tp, 1, devices=jax.devices()[:dp * tp])
    params = jax_tf.shard_params(jax.tree.map(lambda a: jnp.asarray(a, dtype), w), mesh)
    batch = np.random.default_rng(42).standard_normal(BATCH, dtype=np.float32)
    x = jax.device_put(jnp.asarray(batch, dtype),
                       NamedSharding(mesh, batch_spec(mesh)))
    y = jax.jit(lambda p, x: jax_tf.forward(p, x, cfg, mesh=mesh))(params, x)
    return np.asarray(y.astype(jnp.float32))


def _port_output(ranks, mesh_shape, case_id):
    """The global output: each dp slice from its tp ranks, which must agree
    bit for bit (the all-reduce gives every rank the same sums)."""
    dp, _ = mesh_shape
    slices = []
    for i in range(dp):
        outs = [r[mesh_shape][case_id] for r in ranks
                if mesh_shape in r and r[mesh_shape]["coords"]["dp"] == i]
        assert outs and all(np.array_equal(o, outs[0]) for o in outs[1:])
        slices.append(outs[0])
    return np.concatenate(slices)


@pytest.mark.parametrize("mesh_shape,case", PARAMS)
def test_tp_forward_matches_jax(ranks, weights, mesh_shape, case):
    case_id, fields, key = case
    got = _port_output(ranks, mesh_shape, case_id)
    ref = _jax_forward(mesh_shape, fields, weights[key])
    assert got.shape == ref.shape == BATCH
    assert _rel_l2(got, ref) <= _tol(fields["dtype"], mesh_shape[1])


@pytest.mark.parametrize("mesh_shape,case", PARAMS)
def test_tp_forward_matches_world_one(ranks, weights, mesh_shape, case):
    case_id, fields, key = case
    cfg = ModelConfig(**fields)
    x = SyntheticEmbeddingDataset(*BATCH, seed=42,
                                  dtype=getattr(torch, fields["dtype"])).get_batch()
    with torch.inference_mode():
        ref = forward(params_from_jax(weights[key], cfg), x, cfg).float().numpy()
    got = _port_output(ranks, mesh_shape, case_id)
    assert _rel_l2(got, ref) <= _tol(fields["dtype"], mesh_shape[1])


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: f"dp{m[0]}tp{m[1]}")
def test_mesh_groups_follow_the_jax_axis_order(ranks, mesh_shape):
    """Global rank = row-major index in the (dp, tp) grid, as the JAX mesh
    lays its devices out; each axis group is the ranks that differ only
    along that axis."""
    dp, tp = mesh_shape
    ids = np.vectorize(lambda d: d.id)(
        jax_parallelism_mesh(dp, 1, 1, tp, 1, devices=jax.devices()[:dp * tp]).devices)
    members = [r for r in ranks if mesh_shape in r]
    assert len(members) == dp * tp
    for rank, r in enumerate(members):
        i, j = r[mesh_shape]["coords"]["dp"], r[mesh_shape]["coords"]["tp"]
        assert ids[i, j] == rank
        assert r[mesh_shape]["groups"] == {"dp": sorted(ids[:, j].tolist()),
                                           "tp": sorted(ids[i, :].tolist())}


@pytest.mark.parametrize("kv", ["mha", "gqa4", "gqa2", "mqa1"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shards_concatenate_to_the_full_parameters(kv, tp):
    cfg = ModelConfig(**BASE, num_kv_heads=KV[kv], dtype="float32")
    full = init_params(cfg, 3, "cpu")
    shards = [sharding.shard_params(full, cfg, r, tp) for r in range(tp)]
    lay = full["layers"]
    h, d, kvh = cfg.hidden_size, cfg.head_dim, cfg.kv_heads
    local_kvh = sharding.local_kv_heads(cfg, tp)
    hl = h // tp

    def cat(group, leaf, dim):
        return torch.cat([s["layers"][group][leaf] for s in shards], dim)

    for group, leaf, dim in (("out", "kernel", 1), ("ffn_up", "kernel", 2),
                             ("ffn_up", "bias", 1), ("ffn_down", "kernel", 1)):
        assert torch.equal(cat(group, leaf, dim), lay[group][leaf])
    replicated = [("ln1", "scale"), ("ln1", "bias"), ("ln2", "scale"), ("ln2", "bias"),
                  ("out", "bias"), ("ffn_down", "bias")]
    for s in shards:
        for group, leaf in replicated:
            assert s["layers"][group][leaf] is lay[group][leaf]
        assert s["ln_f"] == full["ln_f"]
    qkv = [s["layers"]["qkv"]["kernel"] for s in shards]
    assert all(q.shape[-1] == hl + 2 * local_kvh * d for q in qkv)
    assert torch.equal(torch.cat([q[..., :hl] for q in qkv], -1), lay["qkv"]["kernel"][..., :h])
    k_full = lay["qkv"]["kernel"][..., h:h + kvh * d]
    k_parts = [q[..., hl:hl + local_kvh * d] for q in qkv]
    if kvh % tp == 0:
        assert torch.equal(torch.cat(k_parts, -1), k_full)
    else:  # one copy of its kv head per local q head
        g = cfg.num_heads // kvh
        heads = [j // g for j in range(cfg.num_heads)]
        want = torch.cat([k_full[..., i * d:(i + 1) * d] for i in heads], -1)
        assert torch.equal(torch.cat(k_parts, -1), want)


def test_qkv_shard_takes_head_aligned_columns():
    """8 heads of 32 with 4 kv heads at tp=2: rank 1 holds q heads 4-7 and
    kv heads 2-3, in its own [q | k | v] order."""
    cfg = ModelConfig(**BASE, num_kv_heads=4)
    cols = sharding.qkv_columns(cfg, 1, 2).tolist()
    q = list(range(128, 256))
    k = list(range(256 + 64, 256 + 128))
    v = list(range(256 + 128 + 64, 256 + 256))
    assert cols == q + k + v
    # MQA at tp=4: rank 3's two q heads (6 and 7) each take kv head 0
    mqa = ModelConfig(**BASE, num_kv_heads=1)
    cols = sharding.qkv_columns(mqa, 3, 4).tolist()
    assert cols == list(range(192, 256)) + 2 * list(range(256, 288)) + 2 * list(range(288, 320))


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_init_draws_the_world_one_model(tp):
    """The same seed gives the same model at every tp: each rank's init is
    its shard of the world-1 init, bit for bit."""
    cfg = ModelConfig(**BASE, num_kv_heads=2, dtype="bfloat16")
    full = init_params(cfg, 11, "cpu")
    for r in range(tp):
        got = init_params(cfg, 11, "cpu", tp_rank=r, tp=tp)
        want = sharding.shard_params(full, cfg, r, tp)
        for group in want["layers"]:
            for leaf in want["layers"][group]:
                assert torch.equal(got["layers"][group][leaf], want["layers"][group][leaf])


def test_local_config_is_the_ranks_share():
    cfg = ModelConfig(**BASE, num_kv_heads=2)
    loc = sharding.local_config(cfg, 4)
    assert (loc.hidden_size, loc.num_heads, loc.kv_heads, loc.ffn_intermediate,
            loc.head_dim) == (64, 2, 2, 256, 32)
    assert sharding.local_config(cfg, 2).kv_heads == 1
    assert sharding.local_config(cfg, 1) is cfg


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_dataset_dp_slices_partition_the_global_batch(dp):
    full = SyntheticEmbeddingDataset(*BATCH, seed=42, dtype=torch.float32).get_batch()
    parts = [SyntheticEmbeddingDataset(*BATCH, seed=42, dtype=torch.float32, dp_rank=r,
                                       dp=dp).get_batch() for r in range(dp)]
    assert torch.equal(torch.cat(parts), full)


def test_dataset_refuses_a_batch_dp_does_not_divide():
    with pytest.raises(ValueError, match="batch_size=4 not divisible by data_parallel=3"):
        SyntheticEmbeddingDataset(*BATCH, dp_rank=0, dp=3)


GRAD_MESHES = ((1, 2), (1, 4))
GRAD_CASES = [c for c in CASES if c[1]["dtype"] == "float32" and c[1]["attention"] != "simplified"]


@pytest.fixture(scope="module")
def grad_ranks(weights):
    """Each rank's loss and gradients, by mesh: 4 gloo ranks, the fp32
    cases at tp=2 and tp=4."""
    return launch(torch_tp_worker.run_tp_grads, 4, "cpu",
                  args=(GRAD_MESHES, GRAD_CASES, weights, BATCH), timeout=300)


@pytest.mark.parametrize("tp", [m[1] for m in GRAD_MESHES])
@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_tp_gradients_match_jax(grad_ranks, weights, tp, case):
    """The tensor-parallel loss and gradients (``copy_to_tp`` and
    ``reduce_from_tp`` in autograd, kv copies summed into their source
    columns) against ``jax.value_and_grad`` of the GSPMD loss on the same
    mesh: the loss to 1e-6 relative and each full leaf, reassembled with
    ``unshard_params``, to 1e-5 of its largest gradient, fp32 sums in
    another order (the bound ``test_torch_train.py`` holds the world-1
    gradients to)."""
    case_id, fields, key = case
    members = [r[(1, tp)] for r in grad_ranks if (1, tp) in r]
    assert len(members) == tp
    losses = [m[case_id][0] for m in members]
    assert all(x == losses[0] for x in losses)
    cfg = ModelConfig(**fields)
    shards = sorted(((m["coords"]["tp"], m[case_id][1]) for m in members), key=lambda p: p[0])
    got = sharding.unshard_params(
        [jax.tree.map(torch.from_numpy, g) for _, g in shards], cfg)

    jcfg = jax_configs.ModelConfig(**fields)
    mesh = jax_parallelism_mesh(1, 1, 1, tp, 1, devices=jax.devices()[:tp])
    params = jax_tf.shard_params(jax.tree.map(jnp.asarray, weights[key]), mesh)
    x, t = (jax.device_put(jnp.asarray(np.random.default_rng(seed).standard_normal(
        BATCH, dtype=np.float32)), NamedSharding(mesh, batch_spec(mesh))) for seed in (42, 43))
    loss, ref = jax.jit(jax.value_and_grad(
        lambda p: jax_loop.mse_loss(p, x, t, jcfg, mesh)))(params)
    np.testing.assert_allclose(losses[0], float(loss), rtol=1e-6)
    ref = jax.tree.map(np.asarray, ref)
    for group in ref["layers"]:
        for leaf, r in ref["layers"][group].items():
            g = got["layers"][group][leaf].numpy()
            np.testing.assert_allclose(g, r, atol=1e-5 * np.abs(r).max(), rtol=0,
                                       err_msg=f"{group}.{leaf}")
    for leaf, r in ref["ln_f"].items():
        np.testing.assert_allclose(got["ln_f"][leaf].numpy(), np.asarray(r),
                                   atol=1e-5 * np.abs(r).max(), rtol=0, err_msg=leaf)


def _plan_config(model=None, **par):
    return {"model": dict(BASE, **(model or {})), "input": {"batch_size": 4,
                                                            "sequence_length": 64},
            "parallelism": {"world_size": 1, "data_parallel": 1, **par}}


def _jax_error(config, n):
    cfg = jax_configs.ModelConfig.from_dict(config["model"])
    try:
        JaxPlan.from_config(config, cfg, devices=jax.devices()[:n])
    except ValueError as e:
        return str(e)
    return None


def test_preflight_refuses_too_few_devices_with_the_jax_message():
    config = _plan_config(world_size=4, data_parallel=2)
    cfg = ModelConfig.from_dict(config["model"])
    with pytest.raises(ValueError) as e:
        port_plan.ParallelismPlan.from_config(config, cfg)
    assert str(e.value) == _jax_error(config, 1)
    assert "config needs 8 devices (tp=4 x dp=2" in str(e.value)


# configs JAX refuses: the port refuses them with the same message
JAX_REFUSALS = {
    "sp_without_ring": ({}, {"sequence_parallel": 2}),
    "ring_without_sp": ({"attention": "ring"}, {}),
    "ep_without_moe": ({}, {"expert_parallel": 2}),
    "ep_not_dividing_experts": ({"num_experts": 3}, {"expert_parallel": 2}),
    "tp_overlap_without_tp": ({"tp_overlap": "ring"}, {}),
    "tp_overlap_uneven_seq": ({"tp_overlap": "ring"}, {"world_size": 8}),
    "microbatches_without_pp": ({}, {"num_microbatches": 4}),
    "pp_uneven_layers": ({"num_layers": 3}, {"pipeline_parallel": 2}),
    "pp_uneven_batch": ({}, {"pipeline_parallel": 2, "num_microbatches": 3}),
    "pp_ring": ({"attention": "flash"}, {"pipeline_parallel": 2}),
}


@pytest.mark.parametrize("name", sorted(JAX_REFUSALS))
def test_plan_refuses_what_jax_refuses_with_its_message(name):
    model, par = JAX_REFUSALS[name]
    config = _plan_config(model, **par)
    if name == "tp_overlap_uneven_seq":
        config["input"]["sequence_length"] = 60
    cfg = ModelConfig.from_dict(config["model"])
    with pytest.raises(ValueError) as e:
        port_plan.check_plan(config, cfg, 8)
    assert str(e.value) == _jax_error(config, 8)


# configs JAX runs that the port refused until Slice D items 5 and 6 (pp and
# ep) were ported; the test keeps its name from then.  Both plans accept them
# now, on exactly the mesh's ranks (tests/test_torch_pipeline.py and
# tests/test_torch_moe.py run them)
NOT_PORTED = {
    "pp": ({}, {"pipeline_parallel": 2}, (1, 1, 2, 1, 1)),
    "ep": ({"num_experts": 4}, {"expert_parallel": 2}, (1, 1, 1, 2, 1)),
}


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_plan_refuses_unported_parallelism(name):
    model, par, want = NOT_PORTED[name]
    config = _plan_config(model, **par)
    n = int(np.prod(want))
    assert _jax_error(config, n) is None
    assert port_plan.check_plan(config, ModelConfig.from_dict(config["model"]), n) == want


@pytest.mark.parametrize("leaf,model,tp", [
    ("out.kernel", {"hidden_size": 250, "num_heads": 5, "ffn_intermediate": 1000}, 4),
    ("qkv.bias", {"hidden_size": 96, "num_heads": 6, "num_kv_heads": 2,
                  "ffn_intermediate": 384}, 3),
    ("ffn_down.kernel", {"ffn_intermediate": 1002}, 4),
])
def test_plan_refuses_uneven_shards(leaf, model, tp):
    """A parameter dimension that tp does not divide: JAX's plan passes it,
    but its pjit refuses to lay out the parameters (GSPMD pads no
    parameter), naming the first such leaf; the port's plan names the same
    leaf.  Heads that tp does not divide run in both
    (``tests/test_torch_uneven_heads.py``)."""
    config = _plan_config(model, world_size=tp)
    assert _jax_error(config, 8 if tp < 8 else tp) is None
    mesh = jax_parallelism_mesh(1, 1, 1, tp, 1, devices=jax.devices()[:tp])
    with pytest.raises(ValueError, match="['layers']['{}']['{}']".format(
            *leaf.split(".")).replace("[", r"\[").replace("]", r"\]")):
        jax_tf.init_params_sharded(jax_configs.ModelConfig.from_dict(config["model"]),
                                   jax.random.key(0), mesh)
    with pytest.raises(ValueError, match=f"^layers.{leaf} "):
        port_plan.check_plan(config, ModelConfig.from_dict(config["model"]), tp)


def test_plan_refuses_more_ranks_than_the_mesh():
    config = _plan_config(world_size=2)
    with pytest.raises(ValueError, match="one rank per mesh position"):
        port_plan.check_plan(config, ModelConfig.from_dict(config["model"]), 4)


def test_cli_e2e_runs_the_baseline_at_world_4_on_the_cpu(tmp_path):
    """The port's copy of the reference's baseline experiment (7B, tp=4,
    "simplified"), its depth cut to one layer and its batch to one short
    sequence so that it runs in seconds on the CPU, through ``cli e2e
    --world 4``: one result file, in the JAX schema, with the tp=4 mesh."""
    config = load_config("dlbb_tpu_torch/configs/baseline_config.yaml")
    config["model"]["num_layers"] = 1
    config["input"].update(batch_size=1, sequence_length=16)
    config["execution"].update(warmup_iterations=1, benchmark_iterations=2)
    path = tmp_path / "baseline.yaml"
    path.write_text(yaml.safe_dump(config))
    out = tmp_path / "out"
    assert cli.main(["e2e", "--config", str(path), "--world", "4", "--device", "cpu",
                     "--output", str(out)]) == 0
    files = list(out.glob("*.json"))
    assert [f.name for f in files] == ["torch_cuda_baseline_7b_world4.json"]
    result = json.loads(files[0].read_text())
    assert JAX_RESULT_KEYS <= set(result)
    assert result["mesh"] == {"dp": 1, "sp": 1, "pp": 1, "ep": 1, "tp": 4}
    assert len(result["per_host_means_s"]) == 4
    assert result["forward_time"]["count"] == 2
    assert result["system_info"]["world_size"] == 4
