"""The port's train step against the JAX package's, on the same weights.

Weights come from the JAX ``init_params`` and are carried across with
``params_from_jax``; seeded numpy batches and gradients go into both sides.
On the CPU the JAX "flash" mode runs the Pallas kernels in interpret mode and
the port's runs the kernels' plain versions through its autograd Function.

Tolerances (each with its reason):

- loss and gradients, fp32: the same fp32 arithmetic in another order
  (observed ~1e-6 relative), held to 1e-5 of each leaf's scale;
- loss and gradients, bf16: every activation and product is rounded to bf16
  (2**-8 relative) at slightly different places in the two frameworks, and
  each gradient leaf sums those over 256 tokens and two layers; the loss
  (an fp32 mean) to 1e-3 relative, each leaf to relative L2 5e-2 (observed
  ~1.4e-2);
- the optimizer alone, same gradients in: it follows optax's roundings, so
  the states and parameters agree to one unit in the last place of their
  dtype (fp32 ``b ** count`` is the only power taken by another library);
- three train steps: Adam divides each gradient element by its own running
  RMS, so every element steps by about lr whatever the size of its
  gradient, and where an element's gradient is near 0 the gradients'
  last-bit differences can turn its step.  fp32 params to 0.1 x lr absolute
  (observed 0.05 x lr).  In bf16 a gradient can be rounding noise in both
  frameworks (the key bias: its exact gradient is 0, as a constant shift of
  a row's keys cancels in the softmax), so an element may step the other
  way in each of the 3 steps: bf16 params to 6 x lr absolute plus 2**-7
  relative (a step that crosses a bf16 rounding boundary lands one ulp
  apart), and the change of all parameters together, p3 - p0, to relative
  L2 0.1 (observed 0.05).  Losses to 1e-5 (fp32) and 1e-3 (bf16) relative.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlbb_tpu.data.synthetic import create_dataset_from_config as jax_dataset
from dlbb_tpu.models import configs as jax_configs
from dlbb_tpu.models import transformer as jax_tf
from dlbb_tpu.parallel.plan import ParallelismPlan
from dlbb_tpu.train import loop as jax_loop
from dlbb_tpu.train import optim as jax_optim
from dlbb_tpu_torch import cli
from dlbb_tpu_torch.data import create_dataset_from_config
from dlbb_tpu_torch.models import configs as pt_configs
from dlbb_tpu_torch.models import transformer as pt_tf
from dlbb_tpu_torch.models.weights import params_from_jax
from dlbb_tpu_torch.ops import flash_attention as fa
from dlbb_tpu_torch.train import loop as pt_loop
from dlbb_tpu_torch.train import optim as pt_optim
from dlbb_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _small(dtype="float32", attention="dense", **kw):
    kw = dict(hidden_size=128, num_layers=2, num_heads=4, ffn_intermediate=256,
              attention=attention, dtype=dtype, **kw)
    return jax_configs.ModelConfig(**kw), pt_configs.ModelConfig(**kw)


def _jax_tree(cfg, seed=1):
    return jax.tree.map(np.asarray, jax_tf.init_params(cfg, jax.random.key(seed)))


def _batch(seed, b=2, s=128, h=128):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h), dtype=np.float32),
            rng.standard_normal((b, s, h), dtype=np.float32))


def _by_path(tree) -> dict:
    """Leaves of a JAX pytree (or the port's nested dict) by "a/b/c" path."""
    if isinstance(tree, dict) and not hasattr(tree, "shape"):
        return {f"{k}/{p}" if p else k: leaf for k, v in tree.items()
                for p, leaf in _by_path(v).items()}
    return {"": tree}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _port_loss_and_grads(tree, x, t, pcfg):
    params = params_from_jax(tree, pcfg)
    leaves = pt_optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    td = TD[pcfg.dtype]
    loss = pt_loop.mse_loss(params, torch.from_numpy(x).to(td),
                            torch.from_numpy(t).to(td), pcfg)
    grads = iter(torch.autograd.grad(loss, leaves))
    return float(loss), pt_optim.tree_map(lambda _: next(grads), params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_loss_and_grads_match_jax_value_and_grad(attention, dtype):
    jcfg, pcfg = _small(dtype, attention)
    tree = _jax_tree(jcfg)
    x, t = _batch(0)
    jd = JD[dtype]
    loss_j, grads_j = jax.value_and_grad(jax_loop.mse_loss)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x, jd), jnp.asarray(t, jd), jcfg)
    loss_t, grads_t = _port_loss_and_grads(tree, x, t, pcfg)
    np.testing.assert_allclose(loss_t, float(loss_j), rtol=1e-6 if dtype == "float32" else 1e-3)
    ref, got = _by_path(grads_j), _by_path(grads_t)
    assert set(ref) == set(got) and len(got) == 14
    for name, g in got.items():
        assert g.dtype == TD[dtype], name
        g, r = _np(g), _np(ref[name])
        if dtype == "float32":
            np.testing.assert_allclose(g, r, atol=1e-5 * np.abs(r).max(), rtol=1e-5,
                                       err_msg=name)
        else:
            rel = np.linalg.norm(g - r) / np.linalg.norm(r)
            assert rel <= 5e-2, (name, rel)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_remat_policies_give_the_same_gradients(attention, monkeypatch):
    """none/full/dots: the same loss and gradients; under remat the flash
    forward runs again in the backward (2 per layer, as in JAX, where a
    pallas_call output is not a dot), the backward once per layer."""
    jcfg, _ = _small("float32", attention)
    tree = _jax_tree(jcfg)
    x, t = _batch(5, s=64)
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

    def spy_fwd(*a, **kw):
        calls["fwd"] += 1
        return real_fwd(*a, **kw)

    def spy_bwd(*a, **kw):
        calls["bwd"] += 1
        return real_bwd(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_fwd", spy_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", spy_bwd)
    results = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        _, pcfg = _small("float32", attention, remat=remat, remat_policy=policy)
        calls.update(fwd=0, bwd=0)
        results[(remat, policy)] = _port_loss_and_grads(tree, x, t, pcfg)
        if attention == "flash":
            layers = pcfg.num_layers
            assert calls == {"fwd": (2 if remat else 1) * layers, "bwd": layers}
    loss0, grads0 = results[(False, "full")]
    for key, (loss, grads) in results.items():
        assert loss == loss0, key
        for name, g in _by_path(grads).items():
            torch.testing.assert_close(g, _by_path(grads0)[name], atol=1e-7, rtol=1e-6,
                                       msg=f"{key} {name}")


def _optimizer_inputs(dtype, seed=3):
    rng = np.random.default_rng(seed)
    shapes = {"w": (64, 32), "b": (32,), "s": (16,)}
    params = {k: rng.standard_normal(v, dtype=np.float32) * 0.5 for k, v in shapes.items()}
    params["s"] += 1.0
    grads = [{k: rng.standard_normal(v, dtype=np.float32) * 10.0 ** rng.integers(-6, 0)
              for k, v in shapes.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mdt", [None, "bfloat16"])
def test_adam_update_matches_optax_on_the_same_gradients(dtype, mdt):
    cfg = {"learning_rate": 1e-3, "optimizer": "adam"}
    if mdt is not None:
        cfg["moments_dtype"] = mdt
    params, grads = _optimizer_inputs(dtype)
    opt_j, opt_t = jax_optim.build_optimizer(cfg), pt_optim.build_optimizer(cfg)
    pj = {k: jnp.asarray(v, JD[dtype]) for k, v in params.items()}
    pt = {k: torch.from_numpy(v).to(TD[dtype]) for k, v in params.items()}
    sj, st = opt_j.init(pj), opt_t.init(pt)
    for g in grads:
        uj, sj = opt_j.update({k: jnp.asarray(v, JD[dtype]) for k, v in g.items()}, sj, pj)
        pj = optax.apply_updates(pj, uj)
        ut, st = opt_t.update({k: torch.from_numpy(v).to(TD[dtype]) for k, v in g.items()},
                              st, pt)
        pt = pt_optim.apply_updates(pt, ut)
    adam_j, adam_t = sj[0], st
    assert adam_t.count == int(adam_j.count) == 3
    ulp = np.finfo(np.float32).eps if dtype == "float32" else 2.0 ** -7
    for k in params:
        assert pt[k].dtype == TD[dtype]
        np.testing.assert_allclose(_np(pt[k]), _np(pj[k]), rtol=ulp, atol=0, err_msg=k)
        for name, mine, ref in (("mu", adam_t.mu[k], adam_j.mu[k]),
                                ("nu", adam_t.nu[k], adam_j.nu[k])):
            assert str(mine.dtype).split(".")[-1] == str(ref.dtype), (name, k)
            m_ulp = np.finfo(np.float32).eps if mine.dtype == torch.float32 else 2.0 ** -7
            np.testing.assert_allclose(_np(mine), _np(ref), rtol=m_ulp, atol=0,
                                       err_msg=f"{name}[{k}]")


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "adafactor"])
def test_cast_moments_updates_piece_by_piece_as_the_whole_tree(name, monkeypatch):
    """``cast_moments`` updates a leaf at a time, and an elementwise
    optimizer's large leaf a few rows of dim 0 at a time (here ``w`` in
    pieces of 2 and 1 layers, ``m`` of 354 and 158 rows): bit for bit the
    update of the whole tree upcast at once, its state and its count."""
    monkeypatch.setattr(pt_optim, "PIECE_ELEMENTS", 2 * 160 * 144)
    rng = np.random.default_rng(5)
    shapes = {"layers": {"w": (3, 160, 144), "b": (3, 144)}, "s": (16,), "m": (512, 130)}

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)

    params = {"layers": {k: draw(v) for k, v in shapes["layers"].items()},
              "s": draw(shapes["s"]), "m": draw(shapes["m"])}
    inner = pt_optim.build_optimizer({"optimizer": name})
    opt = pt_optim.cast_moments(inner, "bfloat16")
    state = opt.init(params)
    for _ in range(2):
        grads = pt_optim.tree_map(lambda p: draw(p.shape), params)
        updates, new_state = opt.update(grads, state, params)
        ref_updates, ref_state = inner.update(
            grads, pt_optim._cast_state(state, torch.float32), params)
        ref_state = pt_optim._cast_state(ref_state, torch.bfloat16)
        assert type(new_state) is type(ref_state) and new_state[0] == ref_state[0]
        for got, ref in zip(pt_optim.tree_leaves(updates), pt_optim.tree_leaves(ref_updates)):
            assert got.dtype == ref.dtype and torch.equal(got, ref)
        for got, ref in zip(new_state[1:], ref_state[1:]):
            if ref is None:
                assert got is None
                continue
            for a, b in zip(pt_optim.tree_leaves(got), pt_optim.tree_leaves(ref)):
                assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
        state, params = new_state, pt_optim.apply_updates(params, updates)


def _optax_field(state, name):
    """The first ``name`` field of the (Named)tuples of an optax chain's
    state."""
    if name in getattr(state, "_fields", ()):
        return getattr(state, name)
    for child in state if isinstance(state, tuple) else ():
        found = _optax_field(child, name)
        if found is not None:
            return found
    return None


OPT_CASES = {
    "adamw": {"optimizer": "adamw"},
    "adamw_wd0.1_bf16m": {"optimizer": "adamw", "weight_decay": 0.1, "moments_dtype": "bfloat16"},
    "sgd_momentum": {"optimizer": "sgd"},
    "sgd_none": {"optimizer": "sgd", "momentum": None},
    "sgd_bf16m": {"optimizer": "sgd", "momentum": 0.5, "moments_dtype": "bfloat16"},
    "adafactor": {"optimizer": "adafactor"},
    "adafactor_warmup_cosine": {"optimizer": "adafactor", "schedule": "warmup_cosine",
                                "warmup_steps": 1, "decay_steps": 4},
    "adam_cosine": {"optimizer": "adam", "schedule": "cosine", "decay_steps": 2},
    "adam_warmup_cosine": {"optimizer": "adam", "schedule": "warmup_cosine",
                           "warmup_steps": 1, "decay_steps": 3},
    "sgd_cosine_default_steps": {"optimizer": "sgd", "schedule": "cosine"},
}
# each optimizer's state fields besides the count, named as in optax
STATE_FIELDS = {"AdamState": ("mu", "nu"), "SgdState": ("trace",),
                "AdafactorState": ("v_row", "v_col", "v")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPT_CASES))
def test_optimizers_and_schedules_match_optax_on_the_same_gradients(dtype, name):
    """Three updates from the same gradients.  The elementwise optimizers
    (adam, adamw, sgd) and the schedules follow optax's roundings, so states
    and parameters agree to one unit in the last place, as the adam test's.
    Adafactor divides by RMS statistics: means over whole leaves and their
    rows and columns that XLA and torch sum in different orders, which agree
    to a few units in the last place (``ADAFACTOR_STAT_ULPS``; the full
    statistics ``v`` of an unfactored leaf are elementwise and agree to
    one); its parameters to one ulp plus ``ADAFACTOR_UPDATE_ULPS`` ulps of
    the update.  The (160, 130) leaf is the one adafactor factors."""
    cfg = dict(OPT_CASES[name], learning_rate=1e-3)
    params, grads = _optimizer_inputs(dtype)
    rng = np.random.default_rng(11)
    params["f"] = rng.standard_normal((160, 130), dtype=np.float32) * 0.5
    for g in grads:
        g["f"] = rng.standard_normal((160, 130), dtype=np.float32) * 1e-2
    opt_j, opt_t = jax_optim.build_optimizer(cfg), pt_optim.build_optimizer(cfg)
    pj = {k: jnp.asarray(v, JD[dtype]) for k, v in params.items()}
    pt = {k: torch.from_numpy(v).to(TD[dtype]) for k, v in params.items()}
    sj, st = opt_j.init(pj), opt_t.init(pt)
    for g in grads:
        uj, sj = opt_j.update({k: jnp.asarray(v, JD[dtype]) for k, v in g.items()}, sj, pj)
        pj = optax.apply_updates(pj, uj)
        ut, st = opt_t.update({k: torch.from_numpy(v).to(TD[dtype]) for k, v in g.items()},
                              st, pt)
        pt = pt_optim.apply_updates(pt, ut)
    assert st.count == int(_optax_field(sj, "count")) == 3
    ulp = np.finfo(np.float32).eps if dtype == "float32" else 2.0 ** -7
    factored = cfg["optimizer"] == "adafactor"
    for k in params:
        assert pt[k].dtype == TD[dtype]
        # one ulp of the parameter, or of the update where the parameter is
        # near 0 and the update's last place shows
        update = np.abs(_np(pj[k]) - _np(jnp.asarray(params[k], JD[dtype]))).max()
        atol = (ADAFACTOR_UPDATE_ULPS if factored else 1) * ulp * update
        np.testing.assert_allclose(_np(pt[k]), _np(pj[k]), rtol=ulp, atol=atol, err_msg=k)
    for field in STATE_FIELDS[type(st).__name__]:
        mine, ref = getattr(st, field), _optax_field(sj, field)
        if ref is None or (hasattr(ref, "__len__") and len(ref) == 0):
            assert mine is None, field
            continue
        for k in params:
            a, r = mine[k], ref[k]
            assert str(a.dtype).split(".")[-1] == str(r.dtype), (field, k)
            m_ulp = np.finfo(np.float32).eps if a.dtype == torch.float32 else 2.0 ** -7
            if field in ("v_row", "v_col"):
                m_ulp *= ADAFACTOR_STAT_ULPS
            np.testing.assert_allclose(_np(a), _np(r), rtol=m_ulp, atol=0,
                                       err_msg=f"{field}[{k}]")


ADAFACTOR_STAT_ULPS, ADAFACTOR_UPDATE_ULPS = 4, 8


def test_schedules_match_optax_values():
    """The learning rate at every count of a run and around the warmup and
    decay boundaries against optax's fp32 values: the same fp32 operations
    in the same order, but XLA's cos and numpy's may differ in the last bit
    (2**-24 at most for a value of magnitude below 1), which ``0.5 * (1 +
    cos)`` times the peak carries to at most 2**-25 of the peak, plus the
    result's own rounding: two units in the last place of the peak."""
    for cfg in ({"schedule": "cosine", "decay_steps": 7, "learning_rate": 3e-4},
                {"schedule": "warmup_cosine", "warmup_steps": 3, "decay_steps": 10},
                {"schedule": "warmup_cosine", "warmup_steps": 0, "decay_steps": 5},
                {"schedule": "constant", "learning_rate": 0.1}):
        ref, got = jax_optim.build_schedule(cfg), pt_optim.build_schedule(cfg)
        peak = pt_optim.learning_rate(cfg)
        for count in range(14):
            np.testing.assert_allclose(
                np.float32(got(count)), np.float32(ref(jnp.asarray(count, jnp.int32))),
                rtol=0, atol=2.0 ** -23 * peak, err_msg=f"{cfg} {count}")
    with pytest.raises(ValueError):
        jax_optim.build_schedule({"schedule": "warmup_cosine", "warmup_steps": 5,
                                  "decay_steps": 5})
    with pytest.raises(ValueError, match="positive decay_steps"):
        pt_optim.build_schedule({"schedule": "warmup_cosine", "warmup_steps": 5,
                                 "decay_steps": 5})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradient_accumulation_matches_jax_grad_accum(devices, dtype):
    """grad_accum=2 at world 1: two micro-batches' gradients accumulated in
    fp32, their mean cast to the param dtype, one SGD update (momentum None,
    lr 1024, so that ``(p0 - p1) / lr`` is the mean gradient; the reasoning
    of ``test_torch_zero.py``), against JAX's ``make_train_step(grad_accum=
    2)``: fp32 to 1e-5 of each leaf's largest gradient, bf16 by relative L2
    5e-2 per leaf (the bound of the bf16 gradients above); the loss to 1e-5
    (fp32) and 1e-3 (bf16) relative.  The accumulated mean equals the
    full-batch gradient of the port to the same bounds."""
    lr = 1024.0
    train_cfg = {"optimizer": "sgd", "momentum": None, "learning_rate": lr}
    jcfg, pcfg = _small(dtype)
    tree = _jax_tree(jcfg)
    x, t = _batch(4, b=4, s=32)
    jd, td = JD[dtype], TD[dtype]
    jstep, jstate = jax_loop.make_train_step(
        jcfg, _mesh(jcfg), jax_optim.build_optimizer(train_cfg),
        jax.tree.map(jnp.array, tree), zero_stage=0, grad_accum=2)
    jstate, jloss = jstep(jstate, jnp.asarray(x, jd), jnp.asarray(t, jd))
    results = {}
    for ga in (2, 1):
        pstep, pstate = pt_loop.make_train_step(
            pcfg, pt_optim.build_optimizer(train_cfg), params_from_jax(tree, pcfg),
            grad_accum=ga, batch_size=x.shape[0])
        pstate, ploss = pstep(pstate, torch.from_numpy(x).to(td), torch.from_numpy(t).to(td))
        results[ga] = (float(ploss), _by_path(pstate.params))
    rtol = 1e-5 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(results[2][0], float(jloss), rtol=rtol)
    np.testing.assert_allclose(results[2][0], results[1][0], rtol=rtol)
    p0, ref = _by_path(tree), _by_path(jstate.params)
    for name in p0:
        g_ref = (_np(p0[name]) - _np(ref[name])) / lr
        for ga in (2, 1):
            g = (_np(p0[name]) - _np(results[ga][1][name])) / lr
            if dtype == "float32":
                np.testing.assert_allclose(g, g_ref, atol=1e-5 * np.abs(g_ref).max(), rtol=0,
                                           err_msg=f"grad_accum={ga} {name}")
            else:
                rel = np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref)
                assert rel <= 5e-2, (ga, name, rel)


@pytest.mark.parametrize("attention", ["full", "simplified", "flash", "ring", "ulysses"])
def test_gradient_accumulation_refuses_a_split_dp_does_not_divide(devices, attention):
    """JAX's rule for a micro-batch that dp does not divide, with its texts:
    JAX's ``make_train_step`` at dp=2 (sp=2 for ring and Ulysses), batch 6,
    ``grad_accum`` 2, warns under "full" and "simplified" (the port's
    measured pair lies under ``results/torch/`` and its table under
    ``stats/torch/``) and refuses under the modes that lay the batch over dp
    themselves; the port's ``check_accumulation`` does the same, and
    refuses a batch that the micro-batches do not divide.  The resharded
    step itself is held against JAX in ``tests/test_torch_reshard.py``."""
    import warnings

    from dlbb_tpu.comm.mesh import build_parallelism_mesh

    sp = 2 if attention in ("ring", "ulysses") else 1
    jcfg = jax_configs.ModelConfig(hidden_size=32, num_layers=1, num_heads=2,
                                   ffn_intermediate=64, dtype="float32", attention=attention)
    mesh = build_parallelism_mesh(2, sp, 1, 1, 1, devices=devices[:2 * sp])
    step, state = jax_loop.make_train_step(jcfg, mesh, jax_optim.build_optimizer({}),
                                           jax_tf.init_params(jcfg, jax.random.key(0)),
                                           grad_accum=2)
    x = jnp.zeros((6, 128, 32))
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        try:
            step(state, x, x)
            jerr = None
        except ValueError as e:
            jerr = str(e)
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        try:
            pt_loop.check_accumulation(6, 2, 2, attention)
            perr = None
        except ValueError as e:
            perr = str(e)
    assert perr == jerr
    if attention in ("full", "simplified"):
        assert jerr is None and len(jw) == len(pw) == 1
        assert str(pw[0].message) == str(jw[0].message).replace(
            "results/parallelism/", "results/torch/parallelism/").replace(
            "stats/parallelism/", "stats/torch/parallelism/")
        assert "results/torch/parallelism/train_ddp_ga2_{divisible_b16,reshard_b20}.json" in str(
            pw[0].message)
    else:
        assert "cannot reshard a smaller micro-batch" in perr and not pw
    with pytest.raises(ValueError, match="batch_size=6 not divisible by gradient_accumulation=4"):
        pt_loop.check_accumulation(6, 4, 1, attention)
    pt_loop.check_accumulation(8, 2, 2, attention)


@pytest.mark.parametrize("rank,rows", [(0, 4), (1, 2)])
def test_train_step_refuses_a_batch_laid_out_another_way(rank, rows):
    """Batch 6 in 2 micro-batches over dp=2: rank 0 holds 2 rows of each, rank
    1 one (``data.batch_slice`` with ``step_chunks``), and the step takes
    exactly that many; each rank's 3-row dp slice of the whole batch is
    refused before any collective, and a step without ``batch_size`` cannot
    be built."""
    import warnings

    from dlbb_tpu_torch.comm.mesh import Mesh, MeshSpec
    from dlbb_tpu_torch.data import batch_slice

    cfg = pt_configs.ModelConfig(hidden_size=32, num_layers=1, num_heads=2,
                                 ffn_intermediate=64, dtype="float32")
    mesh = Mesh(MeshSpec((2, 1), ("dp", "tp")), rank, None, {"dp": None, "tp": None})
    x = torch.zeros(6, 16, 32)
    assert batch_slice(x, rank, 2, chunks=pt_loop.step_chunks(2, None)).shape[0] == rows
    params = pt_tf.init_params(cfg, 0, "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # JAX's reshard warning: held above
        step, state = pt_loop.make_train_step(cfg, pt_optim.build_optimizer({}), params,
                                              mesh=mesh, grad_accum=2, batch_size=6)
    slice_ = batch_slice(x, rank, 2)
    with pytest.raises(ValueError, match=f"batch has 3 rows; its part of a global batch of "
                                         f"6 in 2 micro-batches over dp=2 has {rows}"):
        step.grads(state, slice_, slice_)
    with pytest.raises(TypeError, match="batch_size"):
        pt_loop.make_train_step(cfg, pt_optim.build_optimizer({}), params)


def _mesh(jcfg):
    conf = {"parallelism": {"world_size": 1, "data_parallel": 1},
            "input": {"batch_size": 2, "sequence_length": 64}}
    return ParallelismPlan.from_config(conf, jcfg).mesh


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mdt", [None, "bfloat16"])
def test_three_adam_steps_match_jax_make_train_step(devices, dtype, mdt):
    lr = 1e-3
    train_cfg = {"learning_rate": lr}
    if mdt is not None:
        train_cfg["moments_dtype"] = mdt
    jcfg, pcfg = _small(dtype)
    tree = _jax_tree(jcfg)
    x, t = _batch(9, s=64)
    jd, td = JD[dtype], TD[dtype]
    jstep, jstate = jax_loop.make_train_step(
        jcfg, _mesh(jcfg), jax_optim.build_optimizer(train_cfg),
        jax.tree.map(jnp.array, tree), zero_stage=0)
    pstep, pstate = pt_loop.make_train_step(
        pcfg, pt_optim.build_optimizer(train_cfg), params_from_jax(tree, pcfg),
        batch_size=x.shape[0])
    losses_j, losses_t = [], []
    for _ in range(3):
        jstate, loss = jstep(jstate, jnp.asarray(x, jd), jnp.asarray(t, jd))
        losses_j.append(float(loss))
        pstate, loss = pstep(pstate, torch.from_numpy(x).to(td), torch.from_numpy(t).to(td))
        losses_t.append(float(loss))
    assert pstate.step == int(jstate.step) == 3
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5 if dtype == "float32" else 1e-3)
    ref, start = _by_path(jstate.params), _by_path(tree)
    moved_t, moved_j = [], []
    for name, p in _by_path(pstate.params).items():
        assert p.dtype == td
        if dtype == "float32":
            np.testing.assert_allclose(_np(p), _np(ref[name]), atol=0.1 * lr, rtol=0,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(_np(p), _np(ref[name]), atol=6 * lr,
                                       rtol=2.0 ** -7, err_msg=name)
        moved_t.append((_np(p) - _np(start[name])).ravel())
        moved_j.append((_np(ref[name]) - _np(start[name])).ravel())
    moved_t, moved_j = np.concatenate(moved_t), np.concatenate(moved_j)
    assert np.linalg.norm(moved_t - moved_j) <= 0.1 * np.linalg.norm(moved_j)
    # the stored moments keep the dtype optax stores them in
    want = {str(leaf.dtype) for leaf in jax.tree.leaves(jstate.opt_state)
            if jnp.issubdtype(leaf.dtype, jnp.floating)}
    adam = pstate.opt_state
    got = {str(m.dtype).split(".")[-1] for m in
           pt_optim.tree_leaves(adam.mu) + pt_optim.tree_leaves(adam.nu)}
    assert got == want == {mdt or dtype}


def _train_config(**over):
    cfg = {
        "experiment": {"name": "train_smoke"},
        "model": {"hidden_size": 32, "num_layers": 2, "num_heads": 4,
                  "ffn_intermediate": 64, "attention": "full", "dtype": "float32"},
        "parallelism": {"world_size": 1, "data_parallel": 1},
        "input": {"batch_size": 2, "sequence_length": 16, "seed": 42},
        "execution": {"warmup_iterations": 1, "benchmark_iterations": 3},
        "training": {"learning_rate": 1e-3},
    }
    cfg.update(over)
    return cfg


def test_run_train_schema_and_flops_match_jax(devices, tmp_path):
    ref = jax_loop.run_train(_train_config(), verbose=False)
    got = pt_loop.run_train(_train_config(), device="cpu", output_dir=str(tmp_path),
                            verbose=False)
    assert set(ref) <= set(got)
    assert set(got) - set(ref) == {"device", "kernel_launches_per_step", "per_host_means_s",
                                   "cross_host_variance", "cross_host_cv", "transport"}
    assert len(got["per_host_means_s"]) == 1 and got["cross_host_cv"] == 0.0
    assert got["transport"] is None  # no ring hop at world 1
    assert got["backend"] == "torch_cuda" and got["timing_mode"] == "per_iter"
    for key in ("mode", "zero_stage", "mesh", "optimizer", "schedule", "learning_rate",
                "moments_dtype", "gradient_accumulation", "remat", "remat_policy",
                "num_params", "forward_flops", "model_flops_per_step",
                "recompute_flops_per_step", "final_step", "grad_compression",
                "pipeline_schedule", "preempted"):
        assert got[key] == ref[key], key
    assert got["kernel_launches_per_step"] == {
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert len(got["losses"]) == 3 and all(np.isfinite(got["losses"]))
    assert (tmp_path / "train_ddp_train_smoke.json").exists()


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_flops_accounting_matches_jax(policy):
    for size in ("1B", "7B"):
        j = jax_configs.MODEL_CONFIGS[size].with_(remat=True, remat_policy=policy)
        p = pt_configs.MODEL_CONFIGS[size].with_(remat=True, remat_policy=policy)
        assert pt_tf.num_parameters(p) == jax_tf.num_parameters(j)
        assert pt_tf.forward_flops(p, 8, 512) == jax_tf.forward_flops(j, 8, 512)
    assert pt_loop.OPTIMIZER_FLOPS_PER_PARAM == jax_loop.OPTIMIZER_FLOPS_PER_PARAM
    assert pt_loop.MODE_NAMES == jax_loop.MODE_NAMES


def test_run_train_remat_full_counts_the_recompute(devices):
    model = dict(_train_config()["model"], remat=True, remat_policy="full")
    ref = jax_loop.run_train(_train_config(model=model), verbose=False)
    got = pt_loop.run_train(_train_config(model=model), device="cpu", verbose=False)
    assert got["recompute_flops_per_step"] == ref["recompute_flops_per_step"] > 0
    assert got["recompute_note"] == ref["recompute_note"]


def test_run_train_without_cuda_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_loop.run_train(_train_config(), verbose=False)


@pytest.mark.parametrize("over,match", [
    pytest.param({"training": {"grad_compression": "int8"}}, "data_parallel=1",
                 id="over0-grad_compression.*item 7"),
    ({"training": {"moe_aux_loss_weight": 0.01}}, "moe_aux_loss_weight requires a MoE model"),
])
def test_unported_training_options_are_refused(over, match):
    """Gradient compression is ported (tests/test_torch_compression.py) and,
    at world 1, refused with JAX's own ValueError, as is the MoE aux loss
    (tests/test_torch_moe.py) on this dense model."""
    with pytest.raises(ValueError, match=match) as got:
        pt_loop.run_train(_train_config(**over), device="cpu", verbose=False)
    with pytest.raises(ValueError) as want:
        jax_loop.run_train(_train_config(**over), verbose=False)
    assert str(got.value) == str(want.value)


def test_unknown_names_raise_as_in_jax():
    for cfg in ({"optimizer": "lion"}, {"schedule": "linear"},
                {"moments_dtype": "int8"}):
        with pytest.raises(ValueError):
            jax_optim.build_optimizer(cfg)
        with pytest.raises(ValueError):
            pt_optim.build_optimizer(cfg)
    assert pt_optim.resolve_names({}) == jax_optim.resolve_names({})
    assert pt_optim.learning_rate({}) == jax_optim.learning_rate({})
    for args in ((False, None), (True, None), (False, 2)):
        assert pt_loop.resolve_zero_stage(*args) == jax_loop.resolve_zero_stage(*args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_targets_batch_is_the_seed_plus_one_batch_of_jax(dtype):
    cfg = {"model": {"hidden_size": 32}, "input": {"batch_size": 2,
                                                  "sequence_length": 8, "seed": 42}}
    ref = _np(jax_dataset(cfg, dtype=JD[dtype], seed_offset=1).get_batch())
    got = create_dataset_from_config(cfg, dtype=TD[dtype], seed_offset=1).get_batch()
    np.testing.assert_array_equal(_np(got), ref)
    base = create_dataset_from_config(cfg, dtype=TD[dtype]).get_batch()
    assert not torch.equal(base, got)


def test_cli_train_on_cpu(tmp_path):
    import yaml

    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(_train_config()))
    assert cli.main(["train", "--config", str(path), "--device", "cpu",
                     "--output", str(tmp_path / "out")]) == 0
    assert (tmp_path / "out" / "train_ddp_train_smoke.json").exists()


def _bench_train_config() -> dict:
    """``bench.py::_train_step_bench``'s config dict, read from its source."""
    tree = ast.parse((REPO / "bench.py").read_text())
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Tuple):
            names = [n.id for n in node.targets[0].elts]
            if "E2E_BATCH" in names:
                consts.update(zip(names, ast.literal_eval(node.value)))
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "_train_step_bench")
    assign = next(n for n in fn.body if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "config")
    return eval(compile(ast.Expression(assign.value), "bench.py", "eval"), {}, consts)


def test_shipped_train_config_is_the_bench_extra_verbatim():
    cfg = load_config(REPO / "dlbb_tpu_torch" / "configs" / "train_1b_adam_bf16m.yaml")
    assert cfg == _bench_train_config()
    model = pt_configs.ModelConfig.from_dict(cfg["model"])
    assert model == pt_configs.MODEL_CONFIGS["1B"].with_(
        attention="full", remat=True, remat_policy="dots")
