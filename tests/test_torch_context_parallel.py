"""The port's sequence parallelism (``parallel/ring_attention.py``,
``parallel/ulysses.py``, the sp route of ``models/transformer.py``, the sp
slice of ``data/synthetic.py`` and the sp sums of ``train/loop.py``)
against the JAX package's, which runs on the CPU-simulated mesh of
``conftest.py``.  It mirrors ``tests/test_context_parallel.py``.

The port runs once per module on 8 spawned gloo ranks
(``tests/torch_seq_worker.py``); every input is a numpy-seeded array (or
JAX ``init_params`` weights carried across with ``params_from_jax``) that
each rank cuts to its rows and sequence block.

- ``ring_attention`` and ``ulysses_attention`` on the (dp=2, sp=4) mesh of
  the JAX test, causal and not, MHA and GQA (kv heads 4 and, for ring, 2 <
  sp), forward and the gradients of ``sum(out * cot)`` for a seeded
  cotangent, against the JAX functions and ``jax.grad``: fp32, relative L2
  ``FP32_REL_L2`` = 1e-5 (the same online-softmax recurrence over the same
  block order, or the same dense attention, in fp32 sums of another
  order).  Without the gradient shift of the K/V ring, dk and dv would
  stay on the rank that computed them: the gradient cases fail;
- the divisibility and mesh refusals, with JAX's messages;
- the model forward with ring and Ulysses at sp=4 (dp=2) and at sp=2 on
  each rank's tp heads (dp=2 x tp=2), MHA and GQA (kv 2: Ulysses at sp=4
  takes JAX's repeat fallback), causal and not, against JAX's forward on
  the same mesh: fp32 to ``FP32_REL_L2``;
- dryrun phases 3 and 4 of ``__graft_entry__.py::dryrun_multichip``
  (``sp/ring/zero1``, ``sp/ulysses/zero1`` at dp=2 x sp=2 x tp=2, hidden
  16 tp, 2 layers, 4 heads, ffn 32 tp, fp32, 4 rows per dp, S=16): two Adam
  steps at lr 1e-3 against JAX's ``make_train_step``, losses to
  ``LOSS_RTOL`` and leaves to ``ADAM_ATOL``, the bounds
  ``tests/test_torch_zero.py`` argues (a missing sp sum of the gradients
  halves the step of every leaf).  One exception: the key bias, whose exact
  gradient is zero (it adds the same q . b to every logit of a query, which
  the softmax ignores), so both packages take Adam's step on rounding noise,
  up to lr per step in either direction; the two agree to 1e-8 everywhere
  else, and the key bias is held to ``2 x steps x lr``;
- the plan accepts sp with ring and Ulysses, also where sp does not divide
  a tp rank's heads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_seq_worker
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from test_torch_collective_matmul import (
    by_path,
    full_params,
    jax_mesh,
    jax_train,
    losses_of,
)

from dlbb_tpu.comm.mesh import MeshSpec as JaxMeshSpec
from dlbb_tpu.comm.mesh import build_mesh
from dlbb_tpu.models import configs as jax_configs
from dlbb_tpu.models import transformer as jax_tf
from dlbb_tpu.models.sharding import batch_spec as jax_batch_spec
from dlbb_tpu.parallel import ring_attention as jax_ring
from dlbb_tpu.parallel import ulysses_attention as jax_ulysses
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu_torch.comm import Mesh, MeshSpec
from dlbb_tpu_torch.data import batch_slice
from dlbb_tpu_torch.models import ModelConfig, forward, init_params
from dlbb_tpu_torch.parallel import ring_attention, ulysses_attention
from dlbb_tpu_torch.parallel.plan import check_plan

FP32_REL_L2, LR = 1e-5, 1e-3
LOSS_RTOL, ADAM_ATOL = 1e-5, 0.1 * LR
B, N, S, D = 2, 8, 64, 16  # the JAX test's shapes
SP_GRID = ("grid", (2, 4), ("dp", "sp"))
ATTN_CASES = {
    f"{fn}-kv{kvh}-{'causal' if causal else 'bidir'}": {
        "mesh": SP_GRID, "fn": fn, "kvh": kvh, "causal": causal}
    for fn, kvh, causal in (("ring", 8, True), ("ring", 8, False), ("ring", 4, True),
                            ("ring", 2, True), ("ring", 4, False), ("ulysses", 8, True),
                            ("ulysses", 8, False), ("ulysses", 4, True))}
MODEL = dict(hidden_size=64, num_layers=2, num_heads=4, ffn_intermediate=128,
             dtype="float32")
FWD_CASES = {
    f"{mode}-{kv}-sp{dims[1]}tp{dims[2]}": {
        "mesh": dims, "batch": "fwd", "weights": kv,
        "fields": dict(MODEL, attention=mode, num_kv_heads=None if kv == "mha" else 2)}
    for mode in ("ring", "ulysses") for kv in ("mha", "gqa2")
    for dims in ((2, 4, 1), (2, 2, 2))}
FWD_CASES["ring-mha-sp4tp1-noncausal"] = {
    "mesh": (2, 4, 1), "batch": "fwd", "weights": "noncausal",
    "fields": dict(MODEL, attention="ring", causal=False)}
# the dryrun's model at tp=2 (hidden 16 tp, ffn 32 tp)
DRYRUN_MODEL = dict(hidden_size=32, num_layers=2, num_heads=4, ffn_intermediate=64,
                    dtype="float32")
DRYRUN = {f"sp/{mode}/zero1": {
    "mesh": (2, 2, 2), "fields": dict(DRYRUN_MODEL, attention=mode), "weights": "dryrun",
    "train": {"learning_rate": LR}, "stage": 1, "grad_accum": 1, "steps": 2,
    "batch": "dryrun"} for mode in ("ring", "ulysses")}


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(5)
    out = {key: rng.standard_normal((B, N, S, D), dtype=np.float32)
           for key in ("q", "k", "v", "cot")}

    def init(fields, seed):
        return jax.tree.map(np.asarray, jax_tf.init_params(
            jax_configs.ModelConfig(**fields), jax.random.key(seed)))

    out["weights"] = {
        "mha": init(MODEL, 1), "gqa2": init(dict(MODEL, num_kv_heads=2), 3),
        "noncausal": init(dict(MODEL, causal=False), 5), "dryrun": init(DRYRUN_MODEL, 0)}
    out["batches"] = {
        "fwd": (rng.standard_normal((4, 32, 64), dtype=np.float32),) * 2,
        "dryrun": tuple(rng.standard_normal((8, 16, 32), dtype=np.float32) for _ in range(2))}
    return out


def _attn_inputs(arrays, kvh):
    """q, k, v, cot with k and v cut to ``kvh`` heads."""
    return arrays["q"], arrays["k"][:, :kvh], arrays["v"][:, :kvh], arrays["cot"]


@pytest.fixture(scope="module")
def ranks(arrays):
    jobs = []
    for cid, spec in ATTN_CASES.items():
        q, k, v, cot = _attn_inputs(arrays, spec["kvh"])
        jobs.append(("attention", cid, dict(spec, q=q, k=k, v=v, cot=cot)))
    jobs += [("forward", cid, spec) for cid, spec in FWD_CASES.items()]
    jobs += [("train", cid, spec) for cid, spec in DRYRUN.items()]
    return launch(torch_seq_worker.run_jobs, 8, "cpu", args=(jobs, arrays), timeout=600,
                  group_timeout=120)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _members(ranks, case_id):
    return [r[case_id] for r in ranks if case_id in r]


@pytest.fixture(scope="module")
def sp_mesh(devices):
    return build_mesh(JaxMeshSpec.grid((2, 4), ("dp", "sp")))


@pytest.mark.parametrize("case_id", sorted(ATTN_CASES))
def test_attention_and_gradients_match_jax(ranks, arrays, sp_mesh, case_id):
    spec = ATTN_CASES[case_id]
    q, k, v, cot = (jnp.asarray(a) for a in _attn_inputs(arrays, spec["kvh"]))
    sharding = NamedSharding(sp_mesh, P("dp", None, "sp", None))
    qs, ks, vs, cs = (jax.device_put(t, sharding) for t in (q, k, v, cot))
    fn = jax_ring if spec["fn"] == "ring" else jax_ulysses

    def attend(a, b, c):
        return fn(a, b, c, sp_mesh, causal=spec["causal"])

    out_ref = np.asarray(jax.jit(attend)(qs, ks, vs))
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(attend(a, b, c) * cs),
                             argnums=(0, 1, 2)))(qs, ks, vs)
    refs = {"out": out_ref, **{n: np.asarray(g) for n, g in zip(("dq", "dk", "dv"), grads)}}
    members = _members(ranks, case_id)
    assert len(members) == 8
    for name, ref in refs.items():
        got = np.full(ref.shape, np.nan, np.float32)
        for m in members:
            b = m["batch"]
            rows, cols = B // b["dp"], S // b["sp"]
            got[b["dp_rank"] * rows:(b["dp_rank"] + 1) * rows, :,
                b["sp_rank"] * cols:(b["sp_rank"] + 1) * cols] = m[name]
        assert not np.isnan(got).any()
        assert _rel_l2(got, ref) <= FP32_REL_L2, name


def _message(fn, *args, **kwargs):
    with pytest.raises(ValueError) as e:
        fn(*args, **kwargs)
    return str(e.value)


def test_divisibility_and_mesh_refusals_carry_the_jax_messages(sp_mesh):
    """Ulysses' head checks run on the heads the rank holds; the sequence
    split is the batch slice's (JAX's ring_attention text); a mesh with no
    sp axis is refused by name."""
    port = Mesh(MeshSpec((2, 4), ("dp", "sp")), 0, None, {})
    q = np.zeros((B, N, S, D), np.float32)
    for heads, kvh in ((N, 2), (6, 6)):
        want = _message(jax_ulysses, jnp.zeros((B, heads, S, D)),
                        jnp.zeros((B, kvh, S, D)), jnp.zeros((B, kvh, S, D)), sp_mesh)
        got = _message(ulysses_attention, torch.zeros(B, heads, S // 4, D),
                       torch.zeros(B, kvh, S // 4, D), torch.zeros(B, kvh, S // 4, D), port)
        assert got == want
    want = _message(jax_ring, jnp.zeros((B, N, S, D)), jnp.zeros((B, 3, S, D)),
                    jnp.zeros((B, 3, S, D)), sp_mesh)
    assert _message(ring_attention, torch.zeros(B, N, 16, D), torch.zeros(B, 3, 16, D),
                    torch.zeros(B, 3, 16, D), port) == want
    want = _message(jax_ring, jnp.zeros((B, N, 62, D)), jnp.zeros((B, N, 62, D)),
                    jnp.zeros((B, N, 62, D)), sp_mesh)
    assert _message(batch_slice, np.moveaxis(q[:, :, :62], 2, 1), 0, 2, 0, 4) == want
    no_sp = build_mesh(JaxMeshSpec.ring(8))
    flat = Mesh(MeshSpec((8,), ("ranks",)), 0, None, {})
    for jfn, pfn in ((jax_ring, ring_attention), (jax_ulysses, ulysses_attention)):
        want = _message(jfn, jnp.zeros((B, N, S, D)), jnp.zeros((B, N, S, D)),
                        jnp.zeros((B, N, S, D)), no_sp)
        assert _message(pfn, *(torch.zeros(B, N, S, D),) * 3, flat) == want


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
def test_sequence_parallel_forward_matches_jax(ranks, arrays, devices, case_id):
    spec = FWD_CASES[case_id]
    cfg = jax_configs.ModelConfig(**spec["fields"])
    mesh = jax_mesh(spec["mesh"])
    params = jax_tf.shard_params(jax.tree.map(jnp.asarray, arrays["weights"][spec["weights"]]),
                                 mesh)
    sharding = NamedSharding(mesh, jax_batch_spec(mesh))
    x = jax.device_put(jnp.asarray(arrays["batches"]["fwd"][0]), sharding)
    ref = np.asarray(jax.jit(lambda p, a: jax_tf.forward(p, a, cfg, mesh=mesh),
                             out_shardings=sharding)(params, x))
    got = _assemble(_members(ranks, case_id), ref.shape)
    assert _rel_l2(got, ref) <= FP32_REL_L2


@pytest.mark.parametrize("case_id", sorted(DRYRUN))
def test_dryrun_sequence_phases_match_jax(ranks, arrays, devices, case_id):
    spec = DRYRUN[case_id]
    ref_losses, ref = jax_train(spec, arrays["weights"], arrays["batches"])
    np.testing.assert_allclose(losses_of(ranks, case_id), ref_losses, rtol=LOSS_RTOL)
    got = by_path(full_params(ranks, case_id, spec, arrays["weights"]))
    ref = by_path(ref)
    assert set(got) == set(ref) and len(got) == 14
    h = spec["fields"]["hidden_size"]
    for name, p in got.items():
        if name == "layers/qkv/bias":  # [q | k | v]; the k bias: docstring
            key = slice(h, 2 * h)
            np.testing.assert_allclose(p[:, key], ref[name][:, key],
                                       atol=2 * spec["steps"] * LR, rtol=0, err_msg=name)
            p, r = np.delete(p, np.s_[h:2 * h], 1), np.delete(ref[name], np.s_[h:2 * h], 1)
        else:
            r = ref[name]
        np.testing.assert_allclose(p, r, atol=ADAM_ATOL, rtol=0, err_msg=name)
    assert all(m["step"] == 2 for m in _members(ranks, case_id))


def test_forward_without_a_sequence_mesh_raises_the_jax_message(devices):
    cfg = ModelConfig(hidden_size=64, num_layers=1, num_heads=4, ffn_intermediate=128,
                      attention="ring", dtype="float32")
    params = init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        forward(params, torch.zeros(1, 16, 64), cfg)
    # "flash" does not partition the sequence: JAX's message on an sp mesh
    sp2 = Mesh(MeshSpec((1, 2, 1), ("dp", "sp", "tp")), 0, None, {"tp": None})
    with torch.inference_mode(), pytest.raises(ValueError, match="does not partition"):
        forward(params, torch.zeros(1, 8, 64), cfg.with_(attention="flash"), mesh=sp2)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_plan_accepts_sequence_parallelism(mode):
    config = {"model": dict(MODEL, attention=mode),
              "parallelism": {"world_size": 2, "data_parallel": 2, "sequence_parallel": 2},
              "input": {"batch_size": 8, "sequence_length": 16}}
    assert check_plan(config, ModelConfig.from_dict(config["model"]), 8) == (2, 2, 1, 1, 2)


def test_plan_accepts_ulysses_that_tp_heads_cannot_split():
    """JAX's Ulysses needs only num_heads % sp: 4 heads at tp=4 (one per
    rank) go over sp=2 once the model gathers them over tp
    (``tests/test_torch_uneven_heads.py`` holds that case against JAX)."""
    config = {"model": dict(MODEL, attention="ulysses"),
              "parallelism": {"world_size": 4, "data_parallel": 1, "sequence_parallel": 2},
              "input": {"batch_size": 2, "sequence_length": 16}}
    assert check_plan(config, ModelConfig.from_dict(config["model"]), 8) == (1, 2, 1, 1, 4)
