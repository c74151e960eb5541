"""The serving engine's core (ROADMAP Queue 1, Slice E, item 11, part 11a:
``dlbb_tpu_torch/serve/engine.py``) against the JAX package, on the CPU.

- ``ServingConfig``: buckets, ``to_dict``/``from_dict``, the derived
  ladders, and ``validate``'s outcome (value or message) equal to JAX's over
  a table of envelopes;
- the device programs, TINY at world 1 (MHA and GQA, fp32 and bf16): after
  each prefill and each decode step, ``y_last``, ``y``, the cache planes and
  ``lengths`` against JAX's ``build_prefill``/``build_decode_step`` (and the
  greedy token step and injects) on the same inputs and weights; lengths
  and tokens exact, an inactive slot's planes untouched bit for bit;
- ``tests/test_serve.py``'s equivalence case (prefill, then decode with the
  true next inputs, against the one-shot forward) at dp=2 x tp=4 in fp32
  and bf16 and at tp=2 with GQA, on gloo ranks (``tests/torch_serve_worker.py``,
  one spawn per world size), held against JAX's forward and the port's;
- the whole engine against JAX's on a trace whose admission does not depend
  on timing (every arrival at t=0, ``queue_capacity`` above its length,
  ``max_batch`` below it): per-request tokens, outcomes, request counts and
  the journal's (event, rid) sequence identical, at world 1 in both token
  modes and at dp=2 x tp=4 in "greedy" (JAX's engine with its host
  uploads copied, ``_CopyingJnp``: uncopied, its active mask can race the
  host);
- the three engine tests of ``tests/test_serve.py``, mirrored on the port;
- ranks agree at dp=2 on a Poisson trace whose admission depends on time;
- every knob of parts 11b, 11c and 11d engaging
  (``tests/test_torch_serve_fastpath.py``, ``tests/test_torch_spec.py`` and
  ``tests/test_torch_serve_resilience.py`` hold them against JAX), and the
  hook of item 13 refused with a ``ValueError`` citing its ROADMAP item
  (``tests/test_torch_fleet.py`` holds item 12's fleet hooks, once refused,
  against JAX).
"""

import dataclasses
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_serve_worker
from test_torch_comm import _names_a_roadmap_item

from dlbb_tpu.comm.mesh import build_parallelism_mesh as jax_parallelism_mesh
from dlbb_tpu.data import synthetic as jax_synth
from dlbb_tpu.models import configs as jax_configs
from dlbb_tpu.models import transformer as jax_tf
from dlbb_tpu.resilience.journal import SweepJournal as JaxJournal
from dlbb_tpu.resilience.journal import read_journal as jax_read_journal
from dlbb_tpu.serve import engine as jax_engine
from dlbb_tpu.serve import kvcache as jax_kv
from dlbb_tpu.serve import traffic as jax_traffic
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu_torch.data import synthetic as pt_synth
from dlbb_tpu_torch.models import ModelConfig, params_from_jax
from dlbb_tpu_torch.obs import spans
from dlbb_tpu_torch.resilience import inject as pt_inject
from dlbb_tpu_torch.resilience.preempt import PreemptionGuard
from dlbb_tpu_torch.resilience.journal import SweepJournal, read_journal
from dlbb_tpu_torch.serve import engine as pt_engine
from dlbb_tpu_torch.serve import kvcache as pt_kv
from dlbb_tpu_torch.serve.traffic import TrafficTrace, generate_trace
from dlbb_tpu_torch.utils.config import save_json

torch.set_num_threads(1)

TINY = dict(hidden_size=64, num_layers=2, num_heads=4, ffn_intermediate=128,
            dtype="float32", attention="full")
GQA = dict(TINY, num_kv_heads=2)

# fp32 programs, port against JAX on the same inputs and weights: the same
# math in the same order of operations, but XLA's CPU dots and torch's sum
# their products in other orders (and XLA fuses the softmax), each a few
# fp32 ulps (2^-24 relative) on unit-scale layernormed outputs and K/V
# rows; two layers, two prefills and four decode steps compound that to
# about 2e-6 (observed 1.7e-6 to 2.0e-6 over y, x and the planes), so
# 1e-5 leaves five times that.
PROGRAM_F32_TOL = 1e-5
# bf16 programs: both round every product's output to bf16 (8 mantissa
# bits), so where the fp32 sums differ by an ulp one side can round one
# bf16 step (2^-8 relative, ~4e-3 at unit scale) away from the other, and
# two layers carry such flips to the output: JAX's BF16_TOL reasoning
# (tests/test_serve.py), 0.05 absolute on unit-scale values (observed
# 0.023).
PROGRAM_BF16_TOL = 0.05
# the equivalence case's bounds, JAX's (tests/test_serve.py:226-231,
# :287-291): the cached path against the one-shot forward, which
# partitions and orders the [S, S] and [1, S] contractions differently
F32_TOL = 1e-5
BF16_TOL = 0.05


def _configs(fields):
    return jax_configs.ModelConfig(**fields), ModelConfig(**fields)


def _jax_weights(fields, seed=0):
    return jax.tree.map(np.asarray, jax_tf.init_params(jax_configs.ModelConfig(**fields),
                                                       jax.random.key(seed)))


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


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _max_diff(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


class _CopyingJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy argument first.

    JAX's engine uploads its host mask with ``jnp.asarray(active_np)``; on
    the CPU, JAX takes a 64-byte-aligned numpy buffer without a copy, and
    the engine then clears a completing slot in ``active_np`` while that
    step is still running asynchronously, so the step may read the slot as
    inactive and emit another last token (reproduced by forcing the
    alignment: ``[53, 44]`` against ``[53, 53]`` for request 0 of
    ``_t0_trace``).  Which run hits it depends on where numpy places the
    buffer and on the host's load.  The JAX package stays as it is; the
    reference runs here with its uploads copied, which is its own math
    without the race."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kwargs):
        return jnp.asarray(a.copy() if isinstance(a, np.ndarray) else a, *args, **kwargs)


def _margin(y: torch.Tensor) -> float:
    """The smallest gap between the top two values over the rows of ``y``
    ``[..., H]``: how near a greedy argmax is to a tie."""
    top = torch.topk(y.float().reshape(-1, y.shape[-1]), 2, dim=-1).values
    return float((top[:, 0] - top[:, 1]).min())


# ---------------------------------------------------------------------------
# ServingConfig
# ---------------------------------------------------------------------------


def test_serving_config_buckets_and_dict_match_jax():
    for kw in (dict(max_batch=4, block_size=8, max_seq=64),
               dict(max_batch=32, block_size=16, max_seq=2048),
               dict(max_batch=4, block_size=8, max_seq=64, prefill_buckets=(64, 16, 16, 32)),
               dict(max_batch=8, block_size=16, max_seq=256, decode_horizon=8,
                    speculation="ngram", spec_gamma=5, blocks_budget=40)):
        j, p = jax_engine.ServingConfig(**kw), pt_engine.ServingConfig(**kw)
        assert p.prefill_buckets == j.prefill_buckets
        assert (p.num_blocks, p.total_blocks) == (j.num_blocks, j.total_blocks)
        assert p.to_dict() == j.to_dict()
        assert dataclasses.asdict(pt_engine.ServingConfig.from_dict(p.to_dict())) == \
            dataclasses.asdict(jax_engine.ServingConfig.from_dict(j.to_dict()))
        assert (p.fused_horizons, p.spec_gammas, p.spec_drafting) == (
            j.fused_horizons, j.spec_gammas, j.spec_drafting)
        for n in (1, 8, 9, 64, 65, 2048, 2049):
            _same_outcome(lambda: j.bucket_for(n), lambda: p.bucket_for(n))
    jcfg, pcfg = _configs(GQA)
    sv = dict(speculation="draft-model", spec_gamma=2, spec_draft_layers=1,
              spec_draft_kv_heads=1)
    assert dataclasses.asdict(pt_engine.ServingConfig(**sv).draft_model_config(pcfg)) == \
        dataclasses.asdict(jax_engine.ServingConfig(**sv).draft_model_config(jcfg))
    assert pt_engine.SERVING_REPORT_SCHEMA == jax_engine.SERVING_REPORT_SCHEMA
    assert pt_engine.SPECULATION_MODES == jax_engine.SPECULATION_MODES


ENVELOPES = {
    # name: (serving kwargs, model fields, dp, tp)
    "ok": (dict(max_batch=4, block_size=8, max_seq=32, hbm_budget_gb=None), TINY, 2, 4),
    "1b_card": (dict(max_batch=32, block_size=16, max_seq=2048, queue_capacity=64,
                     hbm_budget_gb=70.0), dict(size="1B"), 1, 1),
    "1b_default_budget": (dict(max_batch=32, block_size=16, max_seq=2048),
                          dict(size="1B"), 1, 1),
    "1b_over_budget": (dict(max_batch=64, block_size=16, max_seq=2048),
                       dict(size="1B"), 1, 1),
    "bad_speculation": (dict(speculation="eagle"), TINY, 1, 1),
    "simplified": (dict(hbm_budget_gb=None), dict(TINY, attention="simplified"), 1, 1),
    "bad_bucket": (dict(max_batch=4, block_size=8, max_seq=64, prefill_buckets=(12,)),
                   TINY, 1, 1),
    "queue": (dict(queue_capacity=0), TINY, 1, 1),
    "hedge": (dict(hedge_factor=1.0), TINY, 1, 1),
    "blocks_budget": (dict(blocks_budget=0), TINY, 1, 1),
    "horizon": (dict(decode_horizon=0), TINY, 1, 1),
    "window": (dict(inflight_window=2), TINY, 1, 1),
    "chunk_ragged": (dict(prefill_chunk=24), TINY, 1, 1),
    "chunk_divides": (dict(prefill_chunk=96), TINY, 1, 1),
    "compact_range": (dict(compact_threshold=0.75, decode_horizon=4), TINY, 1, 1),
    "compact_per_step": (dict(compact_threshold=0.5), TINY, 1, 1),
    "compact_dp": (dict(compact_threshold=0.5, decode_horizon=4), TINY, 2, 1),
    "retries": (dict(max_dispatch_retries=-1), TINY, 1, 1),
    "deadline_min": (dict(dispatch_deadline_min_s=0.0), TINY, 1, 1),
    "gamma_missing": (dict(speculation="ngram"), TINY, 1, 1),
    "gamma_off": (dict(spec_gamma=2), TINY, 1, 1),
    "prefix_no_chunk": (dict(prefix_caching=True), TINY, 1, 1),
    "int8_greedy": (dict(kv_quantization="int8", speculation="greedy"), TINY, 1, 1),
    "temperature_greedy": (dict(temperature=0.5, speculation="greedy"), TINY, 1, 1),
    "sample_seed": (dict(sample_seed=3), TINY, 1, 1),
    "gqa_tp": (dict(hbm_budget_gb=None), dict(TINY, num_kv_heads=2), 1, 4),
}


@pytest.mark.parametrize("name", sorted(ENVELOPES))
def test_validate_matches_jax(name):
    kw, model, dp, tp = ENVELOPES[name]
    jcfg = jax_configs.ModelConfig.from_dict(model)
    pcfg = ModelConfig.from_dict(model)
    outcome = _same_outcome(
        lambda: jax_engine.ServingConfig(**kw).validate(jcfg, dp=dp, tp=tp),
        lambda: pt_engine.ServingConfig(**kw).validate(pcfg, dp=dp, tp=tp))
    assert (outcome[0] == "ok") == (name in ("ok", "1b_card", "1b_default_budget"))


# ---------------------------------------------------------------------------
# the device programs at world 1
# ---------------------------------------------------------------------------

PROGRAM_CASES = {"mha_f32": TINY, "gqa_f32": GQA, "gqa_bf16": dict(GQA, dtype="bfloat16")}
# (slot, prompt_len, request seed): two prefills into different slots at
# two buckets, the first padded
PREFILLS = ((1, 11, 3), (3, 5, 4))
# decode steps' active masks: slot 0 never, slot 2 only in the last step
ACTIVE = ((False, True, False, True),) * 3 + ((False, True, True, True),)


def _both_prompts(fields, seed, prompt, bucket):
    dtype = fields["dtype"]
    jx = jax_synth.request_embeddings(seed, prompt, fields["hidden_size"],
                                      dtype=jnp.bfloat16 if dtype == "bfloat16"
                                      else jnp.float32, pad_to=bucket)
    px = pt_synth.request_embeddings(seed, prompt, fields["hidden_size"],
                                     dtype=torch.bfloat16 if dtype == "bfloat16"
                                     else torch.float32, pad_to=bucket)
    return jx, px


@pytest.mark.parametrize("case", sorted(PROGRAM_CASES))
def test_programs_match_jax(case):
    fields = PROGRAM_CASES[case]
    tol = PROGRAM_BF16_TOL if fields["dtype"] == "bfloat16" else PROGRAM_F32_TOL
    jcfg, pcfg = _configs(fields)
    jmesh = jax_parallelism_mesh(devices=jax.devices()[:1])
    weights = _jax_weights(fields)
    jparams = jax.tree.map(jnp.asarray, weights)
    pparams = params_from_jax(weights, pcfg)
    sv = pt_engine.ServingConfig(max_batch=4, block_size=8, max_seq=32, hbm_budget_gb=None)
    jcache = jax_kv.create_kv_cache(jcfg, sv.max_batch, sv.num_blocks, sv.block_size,
                                    mesh=jmesh)
    pcache = pt_kv.create_kv_cache(pcfg, sv.max_batch, sv.num_blocks, sv.block_size,
                                   device="cpu")
    jprefill = jax_engine.build_prefill(jcfg, jmesh)
    pprefill = pt_engine.build_prefill(pcfg)

    def same_cache():
        assert np.array_equal(np.asarray(jcache.lengths), pcache.lengths.numpy())
        for j, p in ((jcache.k, pcache.k), (jcache.v, pcache.v)):
            assert _max_diff(j, p) <= tol

    jx = jnp.zeros((sv.max_batch, 1, pcfg.hidden_size), jcache.k.dtype)
    px = torch.zeros((sv.max_batch, 1, pcfg.hidden_size), dtype=pcache.k.dtype)
    for slot, prompt, seed in PREFILLS:
        bucket = sv.bucket_for(prompt)
        jxp, pxp = _both_prompts(fields, seed, prompt, bucket)
        jcache, jy = jprefill(jcache, jparams, jxp, np.int32(slot), np.int32(prompt))
        pcache, py = pprefill(pcache, pparams, pxp, slot, prompt)
        assert _max_diff(jy, py) <= tol
        same_cache()
        (jcache, jx) = jax_engine._inject_token((jcache, jx), np.int32(slot), jy)
        (pcache, px) = pt_engine._inject_token((pcache, px), slot, py)
        assert _max_diff(jx, px) <= tol

    jdecode = jax_engine.build_decode_step(jcfg, jmesh)
    pdecode = pt_engine.build_decode_step(pcfg)
    for act in ACTIVE:
        before = [(plane[:, s].clone(), plane, s) for plane in (pcache.k, pcache.v)
                  for s in range(sv.max_batch) if not act[s]]
        (jcache, jx), jy = jdecode((jcache, jx), jparams, jnp.asarray(act))
        (pcache, px), py = pdecode((pcache, px), pparams, torch.tensor(act))
        assert _max_diff(jy, py) <= tol
        assert _max_diff(jx, px) <= tol
        same_cache()
        for old, plane, s in before:
            assert torch.equal(plane[:, s], old), f"inactive slot {s} changed"
    assert pcache.lengths.tolist() == [0, 11 + 4, 1, 5 + 4]


def test_greedy_programs_match_jax_tokens_exactly():
    """The greedy inject and token step: token ids equal, inputs within
    the fp32 bound, on the GQA model with three slots in flight."""
    fields = GQA
    jcfg, pcfg = _configs(fields)
    jmesh = jax_parallelism_mesh(devices=jax.devices()[:1])
    weights = _jax_weights(fields, seed=1)
    jparams = jax.tree.map(jnp.asarray, weights)
    pparams = params_from_jax(weights, pcfg)
    sv = pt_engine.ServingConfig(max_batch=4, block_size=8, max_seq=32, hbm_budget_gb=None)
    jtable = jax_synth.token_embedding_table(pcfg.hidden_size, jnp.float32)
    ptable = pt_synth.token_embedding_table(pcfg.hidden_size, torch.float32)
    jcache = jax_kv.create_kv_cache(jcfg, 4, sv.num_blocks, sv.block_size, mesh=jmesh)
    pcache = pt_kv.create_kv_cache(pcfg, 4, sv.num_blocks, sv.block_size, device="cpu")
    jcarry = (jcache, jnp.zeros((4, 1, 64), jnp.float32))
    pcarry = (pcache, torch.zeros((4, 1, 64)))
    jprefill = jax_engine.build_prefill(jcfg, jmesh)
    pprefill = pt_engine.build_prefill(pcfg)
    margins = []
    for slot, prompt, seed in ((0, 9, 5), (2, 16, 6), (3, 3, 7)):
        bucket = sv.bucket_for(prompt)
        jxp, pxp = _both_prompts(fields, seed, prompt, bucket)
        jc, jy = jprefill(jcarry[0], jparams, jxp, np.int32(slot), np.int32(prompt))
        pc, py = pprefill(pcarry[0], pparams, pxp, slot, prompt)
        margins.append(_margin(py))
        jcarry, jtok = jax_engine._inject_token_greedy((jc, jcarry[1]), np.int32(slot),
                                                       jy, jtable)
        pcarry, ptok = pt_engine._inject_token_greedy((pc, pcarry[1]), slot, py, ptable)
        assert int(jtok) == int(ptok), f"smallest top-1/top-2 margin {min(margins)}"
        assert ptok.dtype == torch.int32
    jstep = jax_engine.build_decode_token_step(jcfg, jmesh)
    pstep = pt_engine.build_decode_token_step(pcfg)
    act = (True, False, True, True)
    for _ in range(5):
        jcarry, jtok = jstep(jcarry, jparams, jtable, jnp.asarray(act))
        pcarry, ptok = pstep(pcarry, pparams, ptable, torch.tensor(act))
        assert np.asarray(jtok).tolist() == ptok.tolist(), \
            f"smallest top-1/top-2 margin {min(margins)}"
        assert _max_diff(jcarry[1], pcarry[1]) <= PROGRAM_F32_TOL
        assert _max_diff(jcarry[0].k, pcarry[0].k) <= PROGRAM_F32_TOL
    assert pcarry[0].lengths.tolist() == np.asarray(jcarry[0].lengths).tolist()


def test_decode_writes_no_slot_at_capacity():
    """A slot at max_seq is not written and an inactive one not advanced,
    as JAX's ``where(pos == length & active)`` leaves them."""
    pcfg = ModelConfig(**TINY)
    params = params_from_jax(_jax_weights(TINY), pcfg)
    cache = pt_kv.create_kv_cache(pcfg, 2, 2, 4, device="cpu")
    cache.k.normal_()
    cache.lengths.copy_(torch.tensor([8, 3], dtype=torch.int32))
    k0 = cache.k.clone()
    (cache, _), _ = pt_engine.build_decode_step(pcfg)(
        (cache, torch.randn(2, 1, 64)), params, torch.tensor([True, False]))
    assert torch.equal(cache.k, k0)
    assert cache.lengths.tolist() == [9, 3]


# ---------------------------------------------------------------------------
# the equivalence case and the engine on gloo ranks
# ---------------------------------------------------------------------------

SEQ, PROMPT, SLOT = 24, 11, 2


def _x_full(hidden, dtype="float32"):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, SEQ, hidden), dtype=np.float32)
    # the bf16 case starts from the bf16-rounded input on both sides
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32) if dtype == "bfloat16" else x


def _jax_forward(fields, weights, x_full):
    cfg = jax_configs.ModelConfig(**fields)
    dtype = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    y = jax_tf.forward(jax.tree.map(jnp.asarray, weights), jnp.asarray(x_full, dtype), cfg)
    return np.asarray(jnp.asarray(y, jnp.float32))[0, PROMPT - 1:]


EQUIV_8 = {"f32": TINY, "bf16": dict(TINY, dtype="bfloat16")}
ENGINE_SERVING = dict(max_batch=4, block_size=8, max_seq=32, queue_capacity=64,
                      hbm_budget_gb=None)


def _t0_trace(n=12, seed=5):
    """A trace whose admission does not depend on timing: every arrival at
    t=0, the queue above its length, ``max_batch`` below it."""
    trace = jax_traffic.generate_trace("poisson", n, seed=seed, rate=10.0,
                                       prompt_range=(4, 16), output_range=(2, 8))
    return dataclasses.replace(trace, requests=tuple(
        dataclasses.replace(r, arrival_s=0.0) for r in trace.requests))


@pytest.fixture(scope="module")
def weights():
    return {name: _jax_weights(f) for name, f in
            (("f32", TINY), ("bf16", EQUIV_8["bf16"]), ("gqa", GQA))}


@pytest.fixture(scope="module")
def jax_engine_2x4(mesh2x4):
    """JAX's engine on a dp=2 x tp=4 mesh in the greedy token mode, and its
    report on the t=0 trace."""
    engine = jax_engine.ServingEngine(
        jax_configs.ModelConfig(**TINY),
        jax_engine.ServingConfig(**ENGINE_SERVING, speculation="greedy"),
        mesh2x4, verbose=False, capture_tokens=True, seed=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "jnp", _CopyingJnp())
        return engine, engine.run_trace(_t0_trace())


@pytest.fixture(scope="module")
def world8(weights, jax_engine_2x4):
    cases = {name: (fields, weights[name], _x_full(64, fields["dtype"]), PROMPT, SLOT)
             for name, fields in EQUIV_8.items()}
    jweights = jax.tree.map(np.asarray, jax_engine_2x4[0].params)
    engine_case = (TINY, ENGINE_SERVING, jweights, _t0_trace().to_dict())
    return launch(torch_serve_worker.run_world8, 8, "cpu", args=(cases, engine_case),
                  timeout=300, group_timeout=120)


DP2_SERVING = dict(max_batch=4, block_size=8, max_seq=64, queue_capacity=3,
                   hbm_budget_gb=None)
DP2_TRACE = dict(kind="poisson", num_requests=24, seed=9, rate=400.0,
                 prompt_range=(4, 16), output_range=(2, 8))


@pytest.fixture(scope="module")
def world2(weights):
    gqa = (GQA, weights["gqa"], _x_full(64), PROMPT, SLOT)
    trace = generate_trace(**DP2_TRACE).to_dict()
    return launch(torch_serve_worker.run_world2, 2, "cpu",
                  args=(gqa, (TINY, DP2_SERVING, weights["f32"], trace), ("off", "greedy")),
                  timeout=300, group_timeout=120)


def _check_equivalence(ranks, name, fields, weights, tol):
    owners = [r[name] for r in ranks if r[name]["owner"]]
    # the dp rank holding slot 2 (of 4 slots: the second half at dp=2)
    assert len(owners) == len(ranks) // (2 if len(ranks) == 8 else 1)
    want = _jax_forward(fields, weights, _x_full(64, fields["dtype"]))
    for out in owners:
        assert np.abs(out["outputs"] - want).max() <= tol
        assert np.abs(out["outputs"] - out["forward"]).max() <= tol
        assert np.array_equal(out["outputs"], owners[0]["outputs"])
    for r in ranks:
        # every rank advanced slot 2 to the sequence, left the others empty
        assert r[name]["lengths"].tolist() == [0, 0, SEQ, 0]
        assert r[name]["others_zero"]
        assert np.abs(r[name]["forward"] - want).max() <= tol


@pytest.mark.parametrize("name", sorted(EQUIV_8))
def test_prefill_decode_matches_forward_dp2_tp4(world8, weights, name):
    """(dp, tp) = (2, 4), full MHA: the cached path against JAX's one-shot
    forward and the port's own on the mesh, fp32 and bf16."""
    _check_equivalence(world8, name, EQUIV_8[name], weights[name],
                       BF16_TOL if name == "bf16" else F32_TOL)


def test_prefill_decode_matches_forward_tp2_gqa(world2, weights):
    """tp=2 with GQA (kv_heads=2 < num_heads=4): the cache's kv-head shard
    holds one head per rank."""
    _check_equivalence(world2, "gqa_tp2", GQA, weights["gqa"], F32_TOL)


def test_engine_dp2_tp4_matches_jax_engine(world8, jax_engine_2x4):
    """Greedy tokens, outcomes and counts at dp=2 x tp=4 equal to JAX's
    engine on the same mesh, on every rank."""
    _, ref = jax_engine_2x4
    for r in world8:
        got = r["engine"]
        assert got["completed_tokens"] == ref["completed_tokens"]
        assert got["requests"] == ref["requests"]
        assert got["cache"] == ref["cache"]
        assert (got["decode_steps"], got["generated_tokens"]) == (
            ref["decode_steps"], ref["generated_tokens"])


@pytest.mark.parametrize("mode", ["off", "greedy"])
def test_ranks_agree_at_dp2(world2, mode):
    """A Poisson trace at 400 req/s with a queue of 3: admission depends on
    the clock, which rank 0 broadcasts, so both ranks admit, reject and
    complete the same requests and gather the same tokens."""
    a, b = (r[f"dp2/{mode}"] for r in world2)
    assert a["requests"] == b["requests"]
    assert a["completed_tokens"] == b["completed_tokens"]
    assert a["cache"] == b["cache"] and a["cache"]["blocks_reserved"] == 0
    req = a["requests"]
    assert req["arrived"] == DP2_TRACE["num_requests"]
    assert req["completed"] + req["rejected"] == req["arrived"]
    assert sorted(a["completed_tokens"]) == sorted(
        rid for rid, o in req["outcomes"].items() if o == "completed")


# ---------------------------------------------------------------------------
# the whole engine against JAX's at world 1
# ---------------------------------------------------------------------------


def _journal_sequence(events):
    return [(e["event"], e["config"]) for e in events if e["event"].startswith("request-")]


@pytest.mark.parametrize("mode", ["greedy", "off"])
def test_engine_matches_jax_engine(mode, tmp_path, monkeypatch):
    """Per-request tokens, the outcome map, the request counts and the
    journal's (event, rid) sequence identical to JAX's engine on the t=0
    trace.  On a token mismatch the message gives the smallest top-1/top-2
    margin the port saw, so that a near tie can be told from a fault."""
    trace = _t0_trace()
    jcfg, pcfg = _configs(TINY)
    sv = dict(ENGINE_SERVING, speculation=mode)
    jmesh = jax_parallelism_mesh(devices=jax.devices()[:1])
    jjournal = JaxJournal(tmp_path / "jax")
    jeng = jax_engine.ServingEngine(jcfg, jax_engine.ServingConfig(**sv), jmesh,
                                    journal=jjournal, verbose=False, capture_tokens=True)
    with monkeypatch.context() as mp:
        mp.setattr(jax_engine, "jnp", _CopyingJnp())
        ref = jeng.run_trace(trace)
    jjournal.close()

    margins = []
    math_ = pt_engine._decode_step_math

    def recording(carry, params, active, config, mesh=None):
        (cache, y), out = math_(carry, params, active, config, mesh)
        if bool(active.any()):
            margins.append(_margin(y[active]))
        return (cache, y), out

    monkeypatch.setattr(pt_engine, "_decode_step_math", recording)
    pjournal = SweepJournal(tmp_path / "port")
    peng = pt_engine.ServingEngine(
        pcfg, pt_engine.ServingConfig(**sv),
        params=params_from_jax(jax.tree.map(np.asarray, jeng.params), pcfg),
        journal=pjournal, verbose=False, capture_tokens=True, device="cpu")
    got = peng.run_trace(TrafficTrace.from_dict(trace.to_dict()))
    pjournal.close()

    assert got["completed_tokens"] == ref["completed_tokens"], \
        f"smallest top-1/top-2 margin {min(margins, default=math.nan):.3e}"
    assert got["requests"] == ref["requests"]
    assert (got["decode_steps"], got["generated_tokens"], got["cache"]) == (
        ref["decode_steps"], ref["generated_tokens"], ref["cache"])
    jevents, _ = jax_read_journal(tmp_path / "jax")
    pevents, _ = read_journal(tmp_path / "port")
    assert _journal_sequence(pevents) == _journal_sequence(jevents)
    # the report carries JAX's keys, section by section
    assert set(got) == set(ref)
    for section in ("requests", "fast_path", "speculation", "resilience", "prefix",
                    "ttft", "cache", "timeseries", "trace", "model", "mesh", "serving"):
        assert set(got[section]) == set(ref[section]), section
    for section in ("fast_path", "speculation", "resilience", "prefix", "serving",
                    "model", "mesh", "trace"):
        assert got[section] == ref[section], section


# ---------------------------------------------------------------------------
# tests/test_serve.py's engine tests, mirrored
# ---------------------------------------------------------------------------

SMOKE_SERVING = dict(max_batch=8, block_size=8, max_seq=64, queue_capacity=64,
                     hbm_budget_gb=None)


@pytest.fixture(scope="module")
def smoke_engine(weights):
    cfg = ModelConfig(**TINY)
    return pt_engine.ServingEngine(cfg, pt_engine.ServingConfig(**SMOKE_SERVING),
                                   params=params_from_jax(weights["f32"], cfg),
                                   verbose=False, device="cpu")


def test_engine_serves_poisson_trace_clean(smoke_engine, tmp_path):
    """A seeded 30-request Poisson mini-trace completes with no rejection, a
    valid span trace, the journaled request lifecycle and its rebuilt
    timeline, the registry's counters in ``metrics.prom``, and finite
    metrics (the queue holds the whole trace, so a rejection is a fault)."""
    engine = smoke_engine
    trace = generate_trace("poisson", 30, seed=7, rate=200.0, prompt_range=(4, 16),
                           output_range=(2, 8))
    span_path = tmp_path / "serve_trace.json"
    journal = SweepJournal(tmp_path, meta={"mode": "serve"}, sink=spans.journal_sink)
    engine.journal = journal
    try:
        with spans.tracing(span_path):
            report = engine.run_trace(trace)
    finally:
        engine.journal = None
        journal.close()

    req = report["requests"]
    assert req["arrived"] == 30 and req["completed"] == 30
    assert req["rejected"] == 0 and req["rejected_rids"] == []
    assert report["goodput_tokens_per_s"] > 0
    assert math.isfinite(report["goodput_tokens_per_s"])
    for block in ("ttft", "per_token_latency", "prefill_time", "decode_step_time",
                  "e2e_latency"):
        for q in ("median", "p95", "p99", "p999"):
            assert math.isfinite(report[block][q]), (block, q)
    assert report["ttft"]["count"] == 30
    assert report["completed_output_tokens"] == sum(r.output_len for r in trace)
    assert report["compile_time_s"] > 0
    series = report["timeseries"]
    n = len(series["t_s"])
    assert n > 0 and all(len(v) == n for v in series.values())
    assert series["t_s"] == sorted(series["t_s"])
    assert max(series["blocks_in_use"]) <= pt_engine.ServingConfig(**SMOKE_SERVING).total_blocks
    assert report["cache"]["blocks_reserved"] == 0
    payload = spans.load_trace(span_path)
    assert spans.validate_trace_events(payload["traceEvents"]) == []
    names = {e["name"] for e in payload["traceEvents"]}
    assert {"serve-admission", "serve-prefill", "serve-decode"} <= names
    decode_spans = [e for e in payload["traceEvents"]
                    if e["name"] == "serve-decode" and e["ph"] == "B"]
    assert len(decode_spans) == report["decode_units"] == report["decode_steps"]
    events, torn = read_journal(tmp_path)
    assert torn == 0
    kinds = {e["event"] for e in events}
    assert {"request-arrived", "request-admitted", "request-prefill",
            "request-completed"} <= kinds
    assert len([e for e in events if e["event"] == "request-completed"]) == 30
    timeline, _n, torn2 = spans.journal_to_trace(tmp_path, tmp_path / "timeline.json")
    assert torn2 == 0
    req_spans = [e for e in spans.load_trace(timeline)["traceEvents"] if e["ph"] == "X"]
    assert len(req_spans) == 30
    assert all(e["cat"] == "config-completed" for e in req_spans)
    reg = engine.registry
    done_total = int(reg.get("serve_requests", outcome="completed"))
    assert done_total >= 30
    prom = reg.write_textfile(tmp_path / "metrics.prom").read_text()
    assert f'dlbb_serve_requests_total{{outcome="completed"}} {done_total}' in prom
    assert "dlbb_serve_decode_steps_total" in prom
    assert "dlbb_serve_decode_batch_occupancy" in prom


def test_engine_bounded_queue_rejects_under_overload(smoke_engine):
    """A queue bound of 1 under a burst sheds load: rejections counted,
    journaled as queue-full, and the rest of the trace completes."""
    engine = smoke_engine
    trace = generate_trace("poisson", 12, seed=3, rate=5000.0, prompt_range=(4, 16),
                           output_range=(4, 8))
    original = engine.serving
    engine.serving = dataclasses.replace(original, queue_capacity=1)
    try:
        report = engine.run_trace(trace)
    finally:
        engine.serving = original
    req = report["requests"]
    assert req["rejected"] > 0
    assert req["completed"] == 12 - req["rejected"]
    assert len(req["rejected_rids"]) == req["rejected"]
    assert all(d["reason"] == "queue-full" for d in req["rejected_detail"])
    assert max(report["timeseries"]["queue_depth"]) <= 1


def test_engine_rejects_infeasible_trace_upfront(smoke_engine):
    """A request that cannot fit the envelope fails before the run, with
    JAX's message; so does an empty trace; with ``reject_infeasible`` it is
    rejected and journaled instead."""
    engine = smoke_engine
    bad = generate_trace("poisson", 4, seed=1, rate=10.0, prompt_range=(40, 60),
                         output_range=(30, 40))
    with pytest.raises(ValueError, match="max_seq"):
        engine.run_trace(bad)
    with pytest.raises(ValueError, match="empty trace"):
        engine.run_trace(TrafficTrace(kind="poisson", seed=0, params={}))
    original = engine.serving
    engine.serving = dataclasses.replace(original, reject_infeasible=True)
    try:
        with pytest.raises(ValueError, match="every request in the trace is infeasible"):
            engine.run_trace(bad)
        mixed = TrafficTrace(kind="poisson", seed=0, params={}, requests=(
            bad.requests[0], dataclasses.replace(bad.requests[1], prompt_len=8,
                                                 output_len=4)))
        report = engine.run_trace(mixed)
    finally:
        engine.serving = original
    assert report["requests"]["outcomes"] == {"0": "rejected[infeasible]",
                                              "1": "completed"}
    assert report["requests"]["shed_rate"] == 0.0


# ---------------------------------------------------------------------------
# refused knobs
# ---------------------------------------------------------------------------

# parts 11b's and 11c's knobs, each with the report's evidence that it
# engaged
ENGAGED = {
    "decode_horizon": (dict(decode_horizon=4),
                       lambda r: r["fast_path"]["fused_scans"] > 0),
    # the window acts on fused units only
    "inflight_window": (dict(decode_horizon=4, inflight_window=2),
                        lambda r: r["fast_path"]["fused_scans"] > 0),
    "prefill_chunk": (dict(prefill_chunk=16),
                      lambda r: r["fast_path"]["prefill_chunks"] > 0),
    "compact_threshold": (dict(decode_horizon=4, compact_threshold=0.5),
                          lambda r: r["fast_path"]["compacted_scans"] > 0),
    "prefix_caching": (dict(prefill_chunk=16, prefix_caching=True),
                       lambda r: r["prefix"]["hits"] > 0),
    "kv_int8": (dict(kv_quantization="int8"),
                lambda r: r["prefix"]["kv_quantization"] == "int8"),
}
ENGAGED_11C = {
    "ngram": (dict(speculation="ngram", spec_gamma=2),
              lambda r: r["speculation"]["verify_units"] > 0),
    "draft_model": (dict(speculation="draft-model", spec_gamma=2),
                    lambda r: r["speculation"]["verify_units"] > 0
                    and r["speculation"]["mode"] == "draft-model"),
    "temperature": (dict(speculation="ngram", spec_gamma=2, temperature=0.7),
                    lambda r: r["speculation"]["sampled"]
                    and r["speculation"]["verify_units"] > 0),
}


def _engaged_report(kw, weights):
    """The engine with knobs ``kw`` (JAX's envelope accepts them) on a t=0
    trace of 8 requests in 8 slots, two groups sharing a 32-token prefix;
    every request completes.  Returns the report and the engine."""
    cfg = ModelConfig(**TINY)
    sv = pt_engine.ServingConfig(**SMOKE_SERVING, **kw)
    jax_engine.ServingConfig(**SMOKE_SERVING, **kw).validate(jax_configs.ModelConfig(**TINY))
    engine = pt_engine.ServingEngine(cfg, sv, params=params_from_jax(weights["f32"], cfg),
                                     verbose=False, device="cpu")
    trace = generate_trace("poisson", 8, seed=3, prompt_range=(33, 48), output_range=(4, 12),
                           prefix_groups=2, prefix_len=32)
    trace = dataclasses.replace(trace, requests=tuple(
        dataclasses.replace(r, arrival_s=0.0) for r in trace.requests))
    report = engine.run_trace(trace)
    assert report["requests"]["completed"] == 8
    return report, engine


@pytest.mark.parametrize("name", sorted(ENGAGED))
def test_11b_knob_engages(name, weights):
    """Each knob of part 11b is served and the report shows it engaged;
    int8 puts int8 planes in the carry."""
    kw, engaged = ENGAGED[name]
    report, engine = _engaged_report(kw, weights)
    assert engaged(report), report["fast_path"] | report["prefix"]
    carry = engine._fresh_carry()
    assert isinstance(carry[0], pt_kv.QuantKVCache) == (name == "kv_int8")
    if name == "kv_int8":
        assert carry[0].k.dtype == torch.int8 and carry[0].k_scale.dtype == torch.float32


@pytest.mark.parametrize("name", sorted(ENGAGED_11C))
def test_11c_knob_engages(name, weights):
    """Each knob of part 11c, once refused, is served: verify units ran
    (the draft model's, or sampled ones) and every request completed
    (``tests/test_torch_spec.py`` holds them against JAX)."""
    kw, engaged = ENGAGED_11C[name]
    report, _engine = _engaged_report(kw, weights)
    assert engaged(report), report["speculation"]
    assert report["cache"]["blocks_reserved"] == 0


# the run hooks once refused; "capture" is ported since item 13, part 13b
# the run hooks once refused, each now run (the test keeps its earlier name)
RUN_HOOKS = ("capture",)


@pytest.mark.parametrize("what", RUN_HOOKS)
def test_unported_run_hooks_are_refused(smoke_engine, what, tmp_path):
    """The hooks once refused run (the name is the one the test had then):
    ``capture_device_traces`` after a run captures one prefill and one
    decode step on fresh state, JAX's metas with their phases
    (``tests/test_torch_devtrace.py`` parses them)."""
    trace = generate_trace("poisson", 3, seed=1, prompt_range=(4, 8), output_range=(2, 4))
    smoke_engine.run_trace(trace)
    calls = {"capture": lambda: smoke_engine.capture_device_traces(tmp_path / "dev")}
    metas = calls[what]()
    assert [m["phase"] for m in metas] == ["prefill", "decode"]
    assert all("error" not in m and m["excluded_from_stats"] for m in metas)
    assert metas[1]["decode_steps_per_scan"] == 1


def _requested_guard():
    guard = PreemptionGuard()
    guard.request()
    return guard


# part 11d's knobs and hooks, once refused, each with the report's evidence
# that it engaged (tests/test_torch_serve_resilience.py holds them against
# JAX): (serving knobs, fault plan, run_trace arguments, deadline, check)
ENGAGED_11D = {
    "watchdog": (dict(dispatch_deadline_factor=50.0, dispatch_deadline_min_s=0.3),
                 "serve-decode-hang:@1,hang_seconds=1", {}, None,
                 lambda r: r["resilience"]["hung_dispatches"] == 1),
    "guard": ({}, None, dict(guard=_requested_guard), None,
              lambda r: r["preempted"] and len(r["remaining_rids"]) == 3),
    # 1e-9 s has passed by the first boundary: every request is shed
    "deadline": ({}, None, {}, 1e-9, lambda r: r["requests"]["deadline_shed"] == 3),
    "fault_plan": ({}, "serve-decode-fail:1", {}, None,
                   lambda r: r["resilience"]["retries"] == 1
                   and r["requests"]["completed"] == 3),
}


@pytest.mark.parametrize("name", sorted(ENGAGED_11D))
def test_11d_knob_engages(weights, name):
    """Each knob and hook of part 11d, once refused, is served and the
    report shows it engaged."""
    kw, plan, run_kw, deadline, engaged = ENGAGED_11D[name]
    cfg = ModelConfig(**TINY)
    sv = pt_engine.ServingConfig(**SMOKE_SERVING, **kw)
    jax_engine.ServingConfig(**SMOKE_SERVING, **kw).validate(jax_configs.ModelConfig(**TINY))
    engine = pt_engine.ServingEngine(cfg, sv, params=params_from_jax(weights["f32"], cfg),
                                     verbose=False, device="cpu")
    trace = generate_trace("poisson", 3, seed=1, prompt_range=(4, 8), output_range=(2, 4),
                           deadline_s=deadline)
    with pt_inject.plan_scope(plan):
        report = engine.run_trace(trace, **{k: f() for k, f in run_kw.items()})
    assert engaged(report), report["requests"] | report["resilience"]
    assert report["cache"]["blocks_reserved"] == 0


def test_hedge_factor_is_accepted_and_ignored(weights):
    cfg = ModelConfig(**TINY)
    sv = pt_engine.ServingConfig(**SMOKE_SERVING, hedge_factor=2.0)
    engine = pt_engine.ServingEngine(cfg, sv, params=params_from_jax(weights["f32"], cfg),
                                     verbose=False, device="cpu")
    report = engine.run_trace(generate_trace("poisson", 3, seed=2, prompt_range=(4, 8),
                                             output_range=(2, 4)))
    assert report["requests"]["completed"] == 3
    assert report["serving"]["hedge_factor"] == 2.0


def test_engine_needs_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_engine.ServingEngine(ModelConfig(**TINY),
                                pt_engine.ServingConfig(**SMOKE_SERVING))


def test_report_is_json(smoke_engine):
    report = smoke_engine.run_trace(generate_trace("poisson", 4, seed=4, rate=1000.0,
                                                   prompt_range=(4, 8),
                                                   output_range=(2, 3)),
                                    collect_raw=True)
    json.dumps(report, allow_nan=False)
    assert len(report["raw_samples"]["ttft_s"]) == 4


# ---------------------------------------------------------------------------
# the harness, the report and the entry point (item 12, part 12a)
# ---------------------------------------------------------------------------


def test_serving_bench_writes_artifact_set(tmp_path):
    """``serve/bench.py`` end to end at dp=2 x tp=4 on gloo ranks: rank 0
    writes the result, the replayable trace, the manifest, ``metrics.prom``
    and the journal, all parseable."""
    from dlbb_tpu_torch.serve.bench import serve_worker

    config = {
        "experiment": {"name": "smoke"},
        "model": dict(TINY),
        "parallelism": {"data_parallel": 2, "world_size": 4},
        "serving": {"max_batch": 8, "block_size": 8, "max_seq": 32,
                    "prefill_buckets": [16], "hbm_budget_gb": None},
    }
    trace = generate_trace("poisson", 4, seed=7, rate=200.0, prompt_range=(4, 16),
                           output_range=(2, 6))
    reports = launch(serve_worker, 8, "cpu",
                     args=(config, trace, str(tmp_path), False, None, "cpu"),
                     timeout=300, group_timeout=120)
    assert all(r["requests"] == reports[0]["requests"] for r in reports)
    assert reports[0]["requests"]["completed"] == 4
    result = json.loads((tmp_path / "serving_smoke.json").read_text())
    assert result["schema"] == "dlbb_serving_report_v1"
    assert result["mesh"] == {"dp": 2, "sp": 1, "pp": 1, "ep": 1, "tp": 4}
    manifest = json.loads((tmp_path / "serving_manifest.json").read_text())
    assert manifest["schema"] == "dlbb_serving_manifest_v1"
    assert manifest["requests"]["completed"] == 4
    assert manifest["topology"]["process_count"] == 8
    assert len(TrafficTrace.load(tmp_path / "trace_smoke.json")) == 4
    assert "dlbb_serve_requests_total" in (tmp_path / "metrics.prom").read_text()
    assert (tmp_path / "sweep_journal.jsonl").exists()


def test_serving_report_writer(tmp_path):
    from test_torch_serve_resilience import write_both_reports

    from dlbb_tpu_torch.stats.serving_report import write_serving_report

    fake = {
        "schema": "dlbb_serving_report_v1",
        "trace": {"kind": "poisson", "num_requests": 10},
        "requests": {"completed": 9, "rejected": 1},
        "mesh": {"dp": 2, "tp": 4, "sp": 1, "pp": 1, "ep": 1},
        "serving": {"max_batch": 8, "block_size": 16, "max_seq": 256},
        "goodput_tokens_per_s": 123.4,
        "throughput_tokens_per_s": 150.0,
        "ttft": {"median": 0.01, "p99": 0.02, "p999": 0.03},
        "per_token_latency": {"median": 0.001, "p99": 0.002, "p999": 0.003},
        "cache": {"peak_blocks_in_use": 12},
        "timeseries": {"queue_depth": [0, 3, 1]},
        "decode_steps": 42,
        "wall_seconds": 1.5,
    }
    rows, md, csv_text = write_both_reports(tmp_path, {"run1": fake})
    assert len(rows) == 1
    assert rows[0]["name"] == "run1" and rows[0]["mesh"] == "dp2xtp4"
    assert rows[0]["ttft_p999_ms"] == 30.0 and rows[0]["peak_queue_depth"] == 3
    assert "run1" in md and "poisson" in md
    assert csv_text.startswith("name,trace,")
    # an empty tree reports nothing and writes nothing
    assert write_serving_report(tmp_path / "nothing", tmp_path / "stats2") == []
    assert not (tmp_path / "stats2").exists()


def test_serving_report_folds_capacity_json(tmp_path):
    """An existing ``capacity.json`` next to the report is folded into
    ``SERVING.md`` read-only, as JAX's writer folds it."""
    from test_torch_serve_resilience import write_both_reports

    cap = {"slo_s": 0.5, "trace": {"kind": "poisson", "num_requests": 64, "seed": 42},
           "user_rate_req_per_s": 0.1, "mean_output_tokens": 80,
           "plans": [{"plan": "dp1xtp1", "predicted_goodput_tokens_per_s": 400.0,
                      "measured_goodput_tokens_per_s": 380.0, "predicted_ttft_s": 0.2,
                      "measured_ttft_p50_s": 0.25, "completed": 64, "total": 64,
                      "slo_attainable": True,
                      "curve": [{"users": 10, "replicas_predicted": 1,
                                 "replicas_measured": None}]}]}
    for side in ("jax", "port"):
        save_json(cap, tmp_path / side / "capacity.json")
    report = {"schema": "dlbb_serving_report_v1", "trace": {"kind": "poisson"},
              "requests": {}, "ttft": {}, "per_token_latency": {}}
    _rows, md, _csv = write_both_reports(tmp_path, {"c": report})
    assert "## Fleet capacity curve" in md and "| dp1xtp1 | 400 | 380 |" in md
    assert json.loads((tmp_path / "port" / "capacity.json").read_text()) == cap


def test_cli_serve_on_cpu_at_world_2(tmp_path, capsys):
    """``cli serve --device cpu --world 2``: two gloo ranks (tp=2 by JAX's
    auto-plan), every request served, the artifact set written."""
    from dlbb_tpu_torch import cli

    out = tmp_path / "s"
    assert cli.main(["serve", "--device", "cpu", "--world", "2", "--requests", "6",
                     "--rate", "200", "--max-seq", "64", "--output", str(out)]) == 0
    assert "goodput" in capsys.readouterr().out
    result = json.loads((out / "serving_poisson_6req_seed42.json").read_text())
    assert result["requests"]["completed"] == 6
    assert result["mesh"]["tp"] == 2 and result["backend"] == "torch_cpu"
    for name in ("serving_manifest.json", "metrics.prom", "sweep_journal.jsonl",
                 "trace_poisson_6req_seed42.json"):
        assert (out / name).is_file(), name


@pytest.mark.parametrize("argv,item", [
    (["--xplane-trace", "d"], "item 13"), (["--device-trace", "d"], "item 13")])
def test_cli_serve_refuses_unported_flags(tmp_path, argv, item):
    """The flags once refused (the name is the one the test had then) run
    since ``item`` (part 13b), which ROADMAP.md lists as ported with them:
    ``--xplane-trace`` writes the run's ``torch.profiler`` trace,
    ``--device-trace`` the report's captures."""
    from dlbb_tpu_torch import cli

    flag, where = argv[0], tmp_path / argv[1]
    out = tmp_path / "s"
    assert cli.main(["serve", "--device", "cpu", "--requests", "4", "--rate", "200",
                     "--max-seq", "64", "--output", str(out), flag, str(where)]) == 0
    result = json.loads((out / "serving_poisson_4req_seed42.json").read_text())
    if flag == "--xplane-trace":
        assert (where / "perfetto_trace.json.gz").is_file()
        assert "observability" not in result
    else:
        metas = result["observability"]["device_captures"]
        assert [m["phase"] for m in metas] == ["prefill", "decode"]
        assert result["observability"]["device_trace_dir"] == str(where)
    roadmap = (Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()
    part = roadmap.split(f"{item[5:]}. **", 1)[1].split("Part 13c", 1)[0]
    assert "ported in PR 19" in part and flag in roadmap


def test_serve_1b_config_is_the_card_envelope():
    """``configs/serve_1b.yaml``: the 1B at full width and depth and
    ``chip_smoke.py``'s serving envelope, which JAX's validate accepts."""
    from dlbb_tpu_torch.utils.config import load_config

    config = load_config("dlbb_tpu_torch/configs/serve_1b.yaml")
    model = ModelConfig.from_dict(config["model"])
    assert (model.hidden_size, model.num_layers) == (2048, 24)
    sv = pt_engine.ServingConfig.from_dict(config["serving"])
    assert (sv.max_batch, sv.block_size, sv.max_seq, sv.queue_capacity) == (32, 16, 2048, 64)
    _same_outcome(
        lambda: jax_engine.ServingConfig.from_dict(config["serving"]).validate(
            jax_configs.ModelConfig.from_dict(config["model"])),
        lambda: sv.validate(model))
