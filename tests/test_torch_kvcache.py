"""The serving foundations of the port (ROADMAP Queue 1, Slice E, item 10)
against the JAX package, on the CPU, from the same numpy-seeded inputs.

- ``models/configs.py``: ``kv_cache_bytes*`` and ``validate_serving``,
  values and refusal messages equal;
- ``data/synthetic.py``: the serving inputs bit-equal (fp32, and bf16 after
  the same round-to-nearest-even cast);
- ``serve/traffic.py``: every arrival kind and option, the trace's dict and
  its JSON file byte-equal, the corrupt-trace refusal;
- ``serve/kvcache.py``: the caches, slot gather/scatter and the int8
  quantiser (codes, scales and dequantised values bit-equal, all-zero
  blocks included), ``shard_cache`` equal to JAX's addressable shards on a
  dp=2 x tp=2 mesh of host devices, and ``PrefixTrie``/``BlockLedger`` over
  the operation sequences of ``tests/test_prefix.py`` and
  ``tests/test_serve.py``: every return value, exception and stats dict
  equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlbb_tpu.comm.mesh import build_parallelism_mesh
from dlbb_tpu.data import synthetic as jax_synth
from dlbb_tpu.models import configs as jax_configs
from dlbb_tpu.resilience import inject as jax_inject
from dlbb_tpu.serve import kvcache as jax_kv
from dlbb_tpu.serve import traffic as jax_traffic
from dlbb_tpu_torch.data import synthetic as pt_synth
from dlbb_tpu_torch.models import configs as pt_configs
from dlbb_tpu_torch.resilience import inject as pt_inject
from dlbb_tpu_torch.serve import kvcache as pt_kv
from dlbb_tpu_torch.serve import traffic as pt_traffic

TINY = dict(hidden_size=64, num_layers=2, num_heads=4, ffn_intermediate=128,
            dtype="float32", attention="full")


def _configs(**kw):
    return jax_configs.ModelConfig(**kw), pt_configs.ModelConfig(**kw)


def _same_outcome(jax_call, pt_call):
    """Both calls return the same value, or both raise the same exception
    type with the same message."""
    outcomes = []
    for call in (jax_call, pt_call):
        try:
            outcomes.append(("ok", call()))
        except Exception as e:  # noqa: BLE001 — compared below
            outcomes.append((type(e).__name__, str(e)))
    assert outcomes[0] == outcomes[1]
    return outcomes[0]


# ---------------------------------------------------------------------------
# models/configs.py: the cache's bytes and the serving envelope
# ---------------------------------------------------------------------------

BYTES_CASES = [
    # (model, max_batch, max_seq, dp, tp, kv_quantization, block_size)
    (dict(size="1B"), 32, 2048, 1, 1, "none", None),
    (dict(size="1B"), 32, 2048, 1, 1, "int8", 16),
    (dict(size="7B"), 16, 4096, 2, 4, "int8", 32),
    (dict(size="13B", dtype="float32"), 8, 1024, 4, 2, "none", None),
    (dict(TINY, num_kv_heads=2), 6, 48, 3, 2, "int8", 8),
    (dict(TINY, dtype="float16", num_kv_heads=1), 4, 32, 2, 1, "none", 8),
    (dict(size="1B"), 32, 2048, 1, 1, "fp8", 16),        # unknown mode
    (dict(size="1B"), 32, 2048, 1, 1, "int8", None),     # no block size
    (dict(size="1B"), 32, 2000, 1, 1, "int8", 16),       # blocks do not tile
]


@pytest.mark.parametrize("case", BYTES_CASES, ids=lambda c: f"{c}")
def test_kv_cache_bytes_match_jax(case):
    model, b, s, dp, tp, mode, bs = case
    jcfg = jax_configs.ModelConfig.from_dict(model)
    pcfg = pt_configs.ModelConfig.from_dict(model)
    _same_outcome(
        lambda: jax_configs.kv_cache_bytes_raw(jcfg.num_layers, b, s, jcfg.kv_heads,
                                               jcfg.head_dim, jcfg.dtype, mode, bs),
        lambda: pt_configs.kv_cache_bytes_raw(pcfg.num_layers, b, s, pcfg.kv_heads,
                                              pcfg.head_dim, pcfg.dtype, mode, bs))
    _same_outcome(lambda: jax_configs.kv_cache_bytes(jcfg, b, s, mode, bs),
                  lambda: pt_configs.kv_cache_bytes(pcfg, b, s, mode, bs))
    _same_outcome(
        lambda: jax_configs.kv_cache_bytes_per_device(jcfg, b, s, dp, tp, mode, bs),
        lambda: pt_configs.kv_cache_bytes_per_device(pcfg, b, s, dp, tp, mode, bs))


def test_the_1b_serving_cache_is_twelve_gib():
    """The cache chip_smoke.py's phase kv builds: 1B, 32 slots of 2048
    tokens, 16-token blocks."""
    cfg = pt_configs.MODEL_CONFIGS["1B"]
    assert pt_configs.kv_cache_bytes(cfg, 32, 2048) == 2 * 6_442_450_944 == 12 * 2**30
    assert pt_configs.kv_cache_bytes(cfg, 32, 2048, "int8", 16) == (
        2 * 24 * 32 * 2048 * 16 * 128 + 2 * 24 * 32 * 128 * 16 * 4)


SERVING_CASES = {
    "ok": (dict(TINY), dict(max_batch=4, max_seq=32, block_size=8, dp=2, tp=4)),
    "simplified": (dict(TINY, attention="simplified"), dict(max_batch=4, max_seq=32, block_size=8)),
    "ring": (dict(TINY, attention="ring"), dict(max_batch=4, max_seq=32, block_size=8)),
    "moe": (dict(TINY, num_experts=4), dict(max_batch=4, max_seq=32, block_size=8)),
    "tp_overlap": (dict(TINY, tp_overlap="ring"), dict(max_batch=4, max_seq=32, block_size=8)),
    "no_slots": (dict(TINY), dict(max_batch=0, max_seq=32, block_size=8)),
    "ragged_blocks": (dict(TINY), dict(max_batch=4, max_seq=30, block_size=8)),
    "dp_slots": (dict(TINY), dict(max_batch=3, max_seq=32, block_size=8, dp=2)),
    "gqa_tp": (dict(TINY, num_kv_heads=2), dict(max_batch=4, max_seq=32, block_size=8, tp=4)),
    "bad_quant": (dict(TINY), dict(max_batch=4, max_seq=32, block_size=8,
                                   kv_quantization="int4")),
    "over_budget": (dict(TINY), dict(max_batch=64, max_seq=512, block_size=16, dp=2,
                                     hbm_budget_bytes=2**20)),
    "int8_fits": (dict(TINY), dict(max_batch=64, max_seq=512, block_size=16, dp=2,
                                   hbm_budget_bytes=5 * 2**20, kv_quantization="int8")),
    "int8_over": (dict(TINY), dict(max_batch=64, max_seq=512, block_size=16,
                                   hbm_budget_bytes=2**20, kv_quantization="int8")),
    "1b_bf16_budget": (dict(size="1B"), dict(max_batch=32, max_seq=2048, block_size=16,
                                             hbm_budget_bytes=8 * 2**30)),
}


@pytest.mark.parametrize("name", sorted(SERVING_CASES))
def test_validate_serving_matches_jax(name):
    model, kw = SERVING_CASES[name]
    jcfg, pcfg = (jax_configs.ModelConfig.from_dict(model),
                  pt_configs.ModelConfig.from_dict(model))
    outcome = _same_outcome(lambda: jax_configs.validate_serving(jcfg, **kw),
                            lambda: pt_configs.validate_serving(pcfg, **kw))
    assert (outcome[0] == "ok") == (name in ("ok", "int8_fits"))


@pytest.mark.parametrize("draft", [dict(TINY, num_layers=1), dict(TINY, num_kv_heads=1,
                                                                  num_layers=1)])
def test_validate_serving_prices_the_draft_model_as_jax(draft):
    model = dict(TINY, num_kv_heads=2)
    jcfg, pcfg = _configs(**model)
    jd, pd = _configs(**draft)
    for budget in (None, 2**20, 2**24):
        _same_outcome(
            lambda: jax_configs.validate_serving(jcfg, 8, 64, 8, tp=2, draft_config=jd,
                                                 hbm_budget_bytes=budget),
            lambda: pt_configs.validate_serving(pcfg, 8, 64, 8, tp=2, draft_config=pd,
                                                hbm_budget_bytes=budget))


# ---------------------------------------------------------------------------
# data/synthetic.py: the serving inputs
# ---------------------------------------------------------------------------

REQUEST_CASES = {
    "plain": dict(seed=7, prompt_len=13, hidden_size=32),
    "padded": dict(seed=8, prompt_len=5, hidden_size=32, pad_to=16),
    "period": dict(seed=9, prompt_len=21, hidden_size=16, period=4),
    "prefix": dict(seed=10, prompt_len=24, hidden_size=16, prefix_len=9, prefix_seed=99),
    "prefix_period": dict(seed=11, prompt_len=24, hidden_size=16, period=3,
                          prefix_len=10, prefix_seed=5, pad_to=32),
}


@pytest.mark.parametrize("name", sorted(REQUEST_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_request_embeddings_bit_equal(name, dtype):
    kw = REQUEST_CASES[name]
    ref = np.asarray(jax_synth.request_embeddings(**kw, dtype=getattr(jnp, dtype)),
                     dtype=np.float32)
    got = pt_synth.request_embeddings(**kw, dtype=getattr(torch, dtype), device="cpu")
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    ids = {k: v for k, v in kw.items() if k != "pad_to"}
    assert pt_synth.prompt_token_ids(**ids) == jax_synth.prompt_token_ids(**ids)


def test_request_embeddings_refusals_match_jax():
    for kw in (dict(seed=1, prompt_len=8, hidden_size=4, pad_to=4),
               dict(seed=1, prompt_len=8, hidden_size=4, period=0),
               dict(seed=1, prompt_len=8, hidden_size=4, prefix_len=8, prefix_seed=2)):
        outcome = _same_outcome(lambda: jax_synth.request_embeddings(**kw) and None,
                                lambda: pt_synth.request_embeddings(**kw) and None)
        assert outcome[0] == "ValueError"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_token_embedding_table_bit_equal(dtype):
    ref = np.asarray(jax_synth.token_embedding_table(48, dtype=getattr(jnp, dtype)),
                     dtype=np.float32)
    got = pt_synth.token_embedding_table(48, dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(got.float().numpy(), ref)


# ---------------------------------------------------------------------------
# serve/traffic.py
# ---------------------------------------------------------------------------

TRACE_CASES = {
    "poisson": dict(kind="poisson", num_requests=40, seed=3),
    "bursty": dict(kind="bursty", num_requests=40, seed=4, rate=50.0, burst_factor=4.0),
    "diurnal": dict(kind="diurnal", num_requests=40, seed=5, period_s=2.0, depth=0.5),
    "deadline_period": dict(kind="poisson", num_requests=12, seed=6, deadline_s=0.25,
                            prompt_period=4),
    "prefix_groups": dict(kind="bursty", num_requests=16, seed=7, prompt_range=(65, 80),
                          output_range=(4, 8), prefix_groups=3, prefix_len=64),
    "equal_bounds": dict(kind="diurnal", num_requests=5, seed=8, prompt_range=(9, 9)),
}


@pytest.mark.parametrize("name", sorted(TRACE_CASES))
def test_generate_trace_and_its_json_match_jax(name, tmp_path):
    ref = jax_traffic.generate_trace(**TRACE_CASES[name])
    got = pt_traffic.generate_trace(**TRACE_CASES[name])
    assert got.to_dict() == ref.to_dict()
    assert (got.horizon_s, got.max_total_tokens, got.max_prompt_len, len(got)) == (
        ref.horizon_s, ref.max_total_tokens, ref.max_prompt_len, len(ref))
    a, b = ref.save(tmp_path / "jax.json"), got.save(tmp_path / "port.json")
    assert a.read_bytes() == b.read_bytes()
    assert pt_traffic.TrafficTrace.load(a) == got
    assert jax_traffic.TrafficTrace.load(b) == ref


@pytest.mark.parametrize("kw", [dict(kind="uniform", num_requests=4),
                                dict(kind="poisson", num_requests=0),
                                dict(kind="poisson", num_requests=4, rate=0.0),
                                dict(kind="poisson", num_requests=4, deadline_s=-1.0),
                                dict(kind="poisson", num_requests=4, prefix_len=3),
                                dict(kind="poisson", num_requests=4, prefix_groups=2,
                                     prompt_range=(1, 8)),
                                dict(kind="diurnal", num_requests=4, depth=1.0),
                                dict(kind="poisson", num_requests=4, output_range=(5, 4))],
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_generate_trace_refusals_match_jax(kw):
    outcome = _same_outcome(lambda: jax_traffic.generate_trace(**kw),
                            lambda: pt_traffic.generate_trace(**kw))
    assert outcome[0] == "ValueError"


def test_corrupt_trace_is_refused_as_jax(tmp_path):
    path = jax_traffic.generate_trace("poisson", 6, seed=1).save(tmp_path / "t.json")
    plan = "serve-trace-corrupt:1"
    with jax_inject.plan_scope(plan), pytest.raises(ValueError) as ref:
        jax_traffic.TrafficTrace.load(path)
    with pt_inject.plan_scope(plan), pytest.raises(ValueError) as got:
        pt_traffic.TrafficTrace.load(path)
    assert str(got.value) == str(ref.value)
    (tmp_path / "other.json").write_text('{"schema": "other"}')
    _same_outcome(lambda: jax_traffic.TrafficTrace.load(tmp_path / "other.json"),
                  lambda: pt_traffic.TrafficTrace.load(tmp_path / "other.json"))


# ---------------------------------------------------------------------------
# serve/kvcache.py: the device half
# ---------------------------------------------------------------------------

CACHE_MODEL = dict(TINY, num_kv_heads=2)
B, NB, BS = 4, 3, 4


def _np(x):
    return np.asarray(jnp.asarray(x, dtype=jnp.float32)) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def _tnp(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _assert_same_cache(got, ref):
    assert type(got).__name__ == type(ref).__name__
    for name in ref._fields:
        r, g = getattr(ref, name), getattr(got, name)
        assert str(g.dtype).split(".")[-1] == str(r.dtype), name
        np.testing.assert_array_equal(_tnp(g), _np(r), err_msg=name)
    assert (got.max_batch, got.num_blocks, got.block_size, got.max_seq) == (
        ref.max_batch, ref.num_blocks, ref.block_size, ref.max_seq)


@pytest.mark.parametrize("quant", [False, True], ids=["kv", "int8"])
def test_create_cache_matches_jax(quant):
    jcfg, pcfg = _configs(**CACHE_MODEL)
    if quant:
        ref = jax_kv.create_quant_kv_cache(jcfg, B, NB, BS)
        got = pt_kv.create_quant_kv_cache(pcfg, B, NB, BS, device="cpu")
    else:
        ref = jax_kv.create_kv_cache(jcfg, B, NB, BS)
        got = pt_kv.create_kv_cache(pcfg, B, NB, BS, device="cpu")
    _assert_same_cache(got, ref)


def test_create_cache_without_cuda_raises(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_kv.create_kv_cache(pt_configs.ModelConfig(**CACHE_MODEL), B, NB, BS)


def _filled(quant=False, seed=0):
    """The same random cache in both packages (fp32 data)."""
    cfg = pt_configs.ModelConfig(**CACHE_MODEL)
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, B, NB, BS, cfg.kv_heads, cfg.head_dim)
    lengths = rng.integers(0, NB * BS, size=B).astype(np.int32)
    if quant:
        k, v = (rng.integers(-127, 128, size=shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.01, 2.0, size=shape[:3] + shape[4:5]).astype(np.float32)
                  for _ in range(2))
        host = (k, v, ks, vs, lengths)
        return (jax_kv.QuantKVCache(*map(jnp.asarray, host)),
                pt_kv.QuantKVCache(*(torch.from_numpy(a.copy()) for a in host)))
    k, v = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
    host = (k, v, lengths)
    return (jax_kv.KVCache(*map(jnp.asarray, host)),
            pt_kv.KVCache(*(torch.from_numpy(a.copy()) for a in host)))


@pytest.mark.parametrize("idx", [[2, 0], [3, 1, 0, 2], [1]])
def test_gather_scatter_match_jax(idx):
    ref, got = _filled(seed=len(idx))
    jidx, pidx = jnp.asarray(idx, jnp.int32), torch.tensor(idx)
    small_ref = jax_kv.gather_cache_slots(ref, jidx)
    small = pt_kv.gather_cache_slots(got, pidx)
    _assert_same_cache(small, small_ref)
    # write the gathered slots back in another order
    perm = list(reversed(idx))
    back_ref = jax_kv.scatter_cache_slots(ref, small_ref, jnp.asarray(perm, jnp.int32))
    back = pt_kv.scatter_cache_slots(got, small, torch.tensor(perm))
    assert back is got  # in place, as the donated JAX cache
    _assert_same_cache(back, back_ref)


def test_gather_then_scatter_is_the_identity():
    _, got = _filled(seed=5)
    before = [t.clone() for t in got]
    idx = torch.tensor([3, 0, 2])
    pt_kv.scatter_cache_slots(got, pt_kv.gather_cache_slots(got, idx), idx)
    for a, b in zip(got, before):
        assert torch.equal(a, b)


def _blocks(dtype, seed):
    """Paged K/V blocks ``[L, B, NB, BS, kvh, d]`` over five decades of
    magnitude, with all-zero blocks and one all-zero head of a block."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, B, NB, BS, 2, 16), dtype=np.float32)
    x *= (10.0 ** rng.integers(-3, 3, size=(2, B, NB, 1, 2, 1))).astype(np.float32)
    x[0, 1, 2] = 0.0
    x[1, 3, 0, :, 1] = 0.0
    x[1, 0, 1, 2, 0, 5] = 1e-30  # a lone subnormal-scale element
    ref = jnp.asarray(x, dtype=getattr(jnp, dtype))
    return ref, torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_dequantize_bit_equal_to_jax(dtype, seed):
    ref_x, x = _blocks(dtype, seed)
    ref_q, ref_s = jax_kv.quantize_kv_blocks(ref_x)
    q, s = pt_kv.quantize_kv_blocks(x)
    assert (q.dtype, s.dtype) == (torch.int8, torch.float32)
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    assert bool((s[0, 1, 2] == 1.0).all()) and bool((q[0, 1, 2] == 0).all())
    for out in ("bfloat16", "float32"):
        ref_d = jax_kv.dequantize_kv_blocks(ref_q, ref_s, getattr(jnp, out))
        d = pt_kv.dequantize_kv_blocks(q, s, getattr(torch, out))
        np.testing.assert_array_equal(_tnp(d), _np(ref_d))


def test_requantizing_a_dequantized_cache_reproduces_its_codes():
    _, x = _blocks("bfloat16", 2)
    q, s = pt_kv.quantize_kv_blocks(x)
    q2, s2 = pt_kv.quantize_kv_blocks(pt_kv.dequantize_kv_blocks(q, s, torch.float32))
    assert torch.equal(q2, q)
    # the scales move by at most an fp32 ulp
    torch.testing.assert_close(s2, s, rtol=2**-22, atol=0.0)


@pytest.fixture(scope="module")
def dp2_tp2(devices):
    return build_parallelism_mesh(data_parallel=2, tensor_parallel=2,
                                  devices=devices[:4])


@pytest.mark.parametrize("quant", [False, True], ids=["kv", "int8"])
def test_shard_cache_is_jaxs_addressable_shard(dp2_tp2, quant):
    ref, got = _filled(quant=quant, seed=11)
    shardings = (jax_kv.quant_cache_shardings if quant else jax_kv.cache_shardings)(dp2_tp2)
    placed = jax.device_put(ref, shardings)
    names = dp2_tp2.axis_names
    seen = 0
    for pos, device in np.ndenumerate(dp2_tp2.devices):
        coords = dict(zip(names, pos))
        shard = pt_kv.shard_cache(got, coords["dp"], 2, coords["tp"], 2)
        for name in ref._fields:
            (jshard,) = [s for s in getattr(placed, name).addressable_shards
                         if s.device == device]
            np.testing.assert_array_equal(_tnp(getattr(shard, name)),
                                          np.asarray(jshard.data), err_msg=name)
            assert getattr(shard, name).is_contiguous()
        seen += 1
    assert seen == 4


def test_shard_cache_refuses_uneven_cuts():
    _, got = _filled()
    with pytest.raises(ValueError, match="dp=3"):
        pt_kv.shard_cache(got, 0, 3, 0, 1)
    with pytest.raises(ValueError, match="tp=4"):
        pt_kv.shard_cache(got, 0, 1, 0, 4)


# ---------------------------------------------------------------------------
# serve/kvcache.py: the host half, over the JAX tests' operation sequences
# ---------------------------------------------------------------------------

def _chain(*vals):
    return [tuple(range(v * 10, v * 10 + 4)) for v in vals]


def _replay(make, ops):
    """Apply ``ops`` (method name, args) to ``make()``; each step's return
    value or exception, and the object's observable state after it."""
    obj, log = make(), []
    for name, args in ops:
        try:
            out = getattr(obj, name)(*args)
        except Exception as e:  # noqa: BLE001 — compared
            out = (type(e).__name__, str(e))
        state = (obj.stats() if hasattr(obj, "stats")
                 else (obj.num_nodes, obj.total_refs(),
                       [obj.shared_depth(s) for s in range(4)]))
        log.append((name, out, state))
    return log


def _snapshotting(factory):
    """A factory of objects whose ``snapshot()`` keeps the snapshot and
    whose ``restore()`` restores the last one kept, so both steps fit in an
    operation sequence."""
    def build():
        obj = factory()
        snaps = []
        real_snapshot, real_restore = obj.snapshot, obj.restore
        obj.snapshot = lambda: snaps.append(real_snapshot())
        obj.restore = lambda: real_restore(snaps[-1])
        return obj
    return build


TRIE_OPS = [
    ("match", (_chain(1, 2),)), ("extend", (0, _chain(1, 2))),
    ("match", (_chain(1, 2, 3),)), ("attach", (1, _chain(1, 2), 2)),
    ("attach", (1, _chain(1, 2), 2)), ("extend", (1, _chain(1, 2, 9))),
    ("release", (0,)), ("match", (_chain(1, 2, 9),)), ("release", (1,)),
    ("release", (1,)), ("snapshot", ()), ("extend", (2, _chain(4))), ("restore", ()),
    ("match", (_chain(4),)),
]

LEDGER_OPS = {
    # tests/test_serve.py::test_block_ledger_accounting
    "accounting": ((8, 4, False), [
        ("blocks_for", (1,)), ("blocks_for", (4,)), ("blocks_for", (5,)),
        ("reserve", (0, 9)), ("append", (0, 5)), ("append", (0, 4)), ("append", (0, 3)),
        ("append", (0,)), ("free", (0,)), ("free", (0,)), ("reserve", (1, 32)),
        ("can_reserve", (1,)), ("reserve", (2, 1)), ("append", (7,)),
        ("match_prefix", (_chain(1),)), ("register", (1, _chain(1))),
        ("reserve", (3, 1, _chain(1), 1))]),
    # tests/test_prefix.py::test_ledger_shared_blocks_counted_once
    "shared_once": ((8, 4, True), [
        ("reserve", (0, 12, None, 0)), ("register", (0, _chain(1, 2))),
        ("match_prefix", (_chain(1, 2, 5),)), ("can_reserve", (12, 2)),
        ("reserve", (1, 12, _chain(1, 2), 2)), ("register", (1, _chain(1, 2))),
        ("append", (0, 8)), ("append", (1, 8)), ("free", (0,)), ("free", (1,)),
        ("note_cow", (3,))]),
    # tests/test_prefix.py::test_ledger_register_overflow_fails_closed
    "register_overflow": ((4, 4, True), [
        ("reserve", (0, 4)), ("register", (0, _chain(1, 2))), ("register", (5, _chain(1))),
        ("reserve", (0, 4))]),
    # tests/test_prefix.py::test_ledger_snapshot_restores_trie_and_refcounts
    "snapshot_restore": ((16, 4, True), [
        ("reserve", (0, 12)), ("register", (0, _chain(1, 2))), ("snapshot", ()),
        ("reserve", (1, 12, _chain(1, 2), 2)), ("register", (1, _chain(1, 2))),
        ("free", (0,)), ("restore", ()), ("reserve", (1, 12, _chain(1, 2), 2)),
        ("register", (1, _chain(1, 2))), ("free", (0,)), ("free", (1,))]),
}


def test_prefix_trie_matches_jax():
    ref = _replay(_snapshotting(jax_kv.PrefixTrie), TRIE_OPS)
    got = _replay(_snapshotting(pt_kv.PrefixTrie), TRIE_OPS)
    assert got == ref
    assert ref[1][1] == (2, 2) and ref[2][1] == (2, 0)  # the JAX test's values


@pytest.mark.parametrize("name", sorted(LEDGER_OPS))
def test_block_ledger_matches_jax(name):
    args, ops = LEDGER_OPS[name]
    ref = _replay(_snapshotting(lambda: jax_kv.BlockLedger(*args)), ops)
    got = _replay(_snapshotting(lambda: pt_kv.BlockLedger(*args)), ops)
    assert got == ref


@pytest.mark.parametrize("sizes", [(0, 4), (4, 0)])
def test_block_ledger_refuses_empty_pools_as_jax(sizes):
    _same_outcome(lambda: jax_kv.BlockLedger(*sizes), lambda: pt_kv.BlockLedger(*sizes))
