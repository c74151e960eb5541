"""The port's decoder against the JAX package's, on the same weights.

Weights come from the JAX ``init_params``, are carried across with
``params_from_jax``, and one seeded numpy batch goes through both forwards.
On the CPU the JAX "full" mode is dense and "flash" runs the Pallas kernel
in interpret mode; the port's "full" is dense and "flash" runs the kernel's
plain version.

Tolerances: fp32 1e-4 (the same fp32 arithmetic in another order).  bf16 is
compared in float32 at 5e-2: every product and activation is rounded to bf16
(8 mantissa bits) at slightly different places by the two frameworks, and two
residual layers carry a few such roundings into the normalised output.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlbb_tpu.models import configs as jax_configs
from dlbb_tpu.models import transformer as jax_tf
from dlbb_tpu_torch.models import configs as pt_configs
from dlbb_tpu_torch.models import transformer as pt_tf
from dlbb_tpu_torch.models.weights import params_from_jax

torch.set_num_threads(2)

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _small(dtype="float32", attention="full", kvh=None):
    kw = dict(hidden_size=128, num_layers=2, num_heads=4, ffn_intermediate=256,
              attention=attention, dtype=dtype, num_kv_heads=kvh)
    return jax_configs.ModelConfig(**kw), pt_configs.ModelConfig(**kw)


def _jax_params_np(cfg, seed=0):
    tree = jax_tf.init_params(cfg, jax.random.key(seed))
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("size", ["1B", "7B", "13B"])
def test_model_config_table_matches_jax(size):
    j, p = jax_configs.MODEL_CONFIGS[size], pt_configs.MODEL_CONFIGS[size]
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    for prop in ("head_dim", "kv_heads", "qkv_width", "is_moe"):
        assert getattr(j, prop) == getattr(p, prop)


def test_model_config_fields_and_dict_parsing_match_jax():
    assert ([f.name for f in dataclasses.fields(jax_configs.ModelConfig)]
            == [f.name for f in dataclasses.fields(pt_configs.ModelConfig)])
    d = {"size": "7B", "attention": "flash", "num_kv_heads": 8, "dtype": "float32"}
    assert (dataclasses.asdict(jax_configs.ModelConfig.from_dict(d))
            == dataclasses.asdict(pt_configs.ModelConfig.from_dict(d)))


@pytest.mark.parametrize("bad", [
    dict(num_heads=5), dict(attention="sparse"), dict(num_kv_heads=3),
    dict(tp_overlap="zigzag"), dict(remat_policy="some"),
])
def test_model_config_rejects_what_jax_rejects(bad):
    kw = dict(hidden_size=128, num_layers=2, num_heads=4, ffn_intermediate=256)
    kw.update(bad)
    with pytest.raises(ValueError):
        jax_configs.ModelConfig(**kw)
    with pytest.raises(ValueError):
        pt_configs.ModelConfig(**kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(dtype):
    jcfg, pcfg = _small(dtype, kvh=2)
    tree = _jax_params_np(jcfg)
    params = params_from_jax(tree, pcfg)
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_j) == 14
    for path, leaf in flat_j:
        node = params
        for key in path:
            node = node[key.key]
        assert node.dtype == pt_tf.DTYPES[dtype]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.float().numpy(), leaf.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvh", [None, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("attention", ["simplified", "full", "dense", "flash"])
def test_forward_matches_jax(attention, kvh, dtype):
    jcfg, pcfg = _small(dtype, attention, kvh)
    tree = _jax_params_np(jcfg, seed=3)
    x = np.random.default_rng(11).standard_normal((2, 64, 128), dtype=np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    y_j = np.asarray(jax_tf.forward(jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(x, jd), jcfg), np.float32)
    params = params_from_jax(tree, pcfg)
    y_t = pt_tf.forward(params, torch.from_numpy(x).to(pt_tf.DTYPES[dtype]), pcfg)
    assert y_t.dtype == pt_tf.DTYPES[dtype]
    np.testing.assert_allclose(y_t.float().numpy(), y_j, atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to approximate=True; the port must follow it,
    not torch's exact default."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    tanh = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    np.testing.assert_allclose(tanh.numpy(), ref, atol=1e-6)
    assert np.abs(exact.numpy() - ref).max() > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x, scale, bias = (rng.standard_normal(shape, dtype=np.float32) * 3 + 1
                      for shape in ((4, 8, 64), (64,), (64,)))
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = pt_tf.DTYPES[dtype]
    y_j = np.asarray(jax_tf._layernorm(*(jnp.asarray(t, jd) for t in (x, scale, bias))),
                     np.float32)
    y_t = pt_tf._layernorm(*(torch.from_numpy(t).to(td) for t in (x, scale, bias)))
    np.testing.assert_allclose(y_t.float().numpy(), y_j, atol=TOL[dtype] / 5,
                               rtol=TOL[dtype] / 5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_into_out_is_bit_equal(dtype):
    """``_layernorm(..., out=x)`` (the per-step decode writes its output
    into its input's storage) rounds as the returned tensor does."""
    rng = np.random.default_rng(3)
    x, scale, bias = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 3 + 1)
                      .to(pt_tf.DTYPES[dtype]) for shape in ((4, 1, 64), (64,), (64,)))
    want = pt_tf._layernorm(x, scale, bias)
    storage = x.untyped_storage().data_ptr()
    got = pt_tf._layernorm(x, scale, bias, out=x)
    assert got is x and x.untyped_storage().data_ptr() == storage
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("size", ["1B", "7B", "13B"])
def test_parameter_and_flop_counts_match_jax(size):
    for attention in ("simplified", "full"):
        j = jax_configs.MODEL_CONFIGS[size].with_(attention=attention)
        p = pt_configs.MODEL_CONFIGS[size].with_(attention=attention)
        assert pt_tf.num_parameters(p) == jax_tf.num_parameters(j)
        for b, s in ((8, 512), (1, 8192)):
            assert pt_tf.forward_flops(p, b, s) == jax_tf.forward_flops(j, b, s)


def test_init_params_is_seeded_and_shaped_like_jax():
    jcfg, pcfg = _small("float32", kvh=2)
    a = pt_tf.init_params(pcfg, 7, "cpu")
    b = pt_tf.init_params(pcfg, 7, "cpu")
    tree = _jax_params_np(jcfg)
    for name, group in tree["layers"].items():
        for p, leaf in group.items():
            assert tuple(a["layers"][name][p].shape) == leaf.shape
            assert torch.equal(a["layers"][name][p], b["layers"][name][p])
    # the JAX init's distribution: kernel std 1/sqrt(fan_in)
    std = a["layers"]["ffn_down"]["kernel"].std().item()
    assert abs(std * np.sqrt(256) - 1.0) < 0.05


def test_unported_model_options_raise():
    """Every model option of the JAX package is ported now (the name is
    from when MoE was refused): remat (tests/test_torch_train.py),
    ring/Ulysses attention and tp_overlap (tests/test_torch_context_parallel.py,
    tests/test_torch_collective_matmul.py) and MoE (tests/test_torch_moe.py)
    build their parameters, MoE with JAX's leaves and shapes."""
    jcfg, pcfg = _small()
    moe = pt_tf.init_params(pcfg.with_(num_experts=4), 0, "cpu")
    ref = jax.eval_shape(lambda: jax_tf.init_params(jcfg.with_(num_experts=4),
                                                    jax.random.key(0)))
    assert {g: {p: tuple(t.shape) for p, t in sub.items()}
            for g, sub in moe["layers"].items()} == {
        g: {p: tuple(a.shape) for p, a in sub.items()} for g, sub in ref["layers"].items()}
    for kw in (dict(attention="ring"), dict(attention="ulysses"), dict(tp_overlap="ring")):
        pt_tf.init_params(pcfg.with_(**kw), 0, "cpu")
