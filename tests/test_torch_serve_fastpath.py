"""The serving engine's fast path and capacity levers (ROADMAP Queue 1,
Slice E, item 11, part 11b: ``dlbb_tpu_torch/serve/engine.py``) against
the JAX package, on the CPU.

- the programs, TINY at world 1 (MHA and GQA, fp32 and bf16), against
  JAX's on the same inputs and weights: ``build_prefill_chunk`` chunk by
  chunk, ``build_decode_fused`` and ``build_decode_fused_token`` with
  budgets that end slots mid-scan, ``build_prefix_attach``, and compaction
  (gather, fused scan, scatter);
- the int8 layout: every code and scale the port writes (prefill, chunks,
  attach, decode steps) bit-equal to JAX's quantiser and to JAX's decode
  rule (the whole layer dequantised, the row written, every active slot
  requantised) applied to the same values; across the two frameworks,
  whose fp32 K/V differ by ulps, outputs within the fp32 bound and
  dequantised planes within it plus one quantisation step;
- whole engines against JAX's engines on traces with every arrival at
  t=0 (admission independent of timing): per-request tokens, outcomes,
  counters and the journal's (event, rid) order identical, at world 1, at
  tp=2 and at dp=2 x tp=4 on gloo ranks (``tests/torch_serve_worker.py``,
  one spawn per world size), JAX's engine with its host uploads copied
  (``_CopyingJnp``); compaction is held against JAX's non-compacted
  engine;
- ``tests/test_serve_fastpath.py``'s and ``tests/test_prefix.py``'s engine
  tests, mirrored;
- ranks agree at dp=2 on a Poisson trace whose scan horizon reads the
  clock;
- the tests that waited for part 11d and item 12: a degraded attach after
  a failed decode unit against JAX's engine, the fast path's and the
  prefix cache's artifact sets through ``serve/bench.py``, and the serving
  report's shed columns byte-equal to JAX's writer.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_serve_worker
from test_torch_serve import (
    GQA,
    PROGRAM_BF16_TOL,
    PROGRAM_F32_TOL,
    TINY,
    _both_prompts,
    _CopyingJnp,
    _configs,
    _jax_weights,
    _max_diff,
)

from dlbb_tpu.comm.mesh import build_parallelism_mesh as jax_parallelism_mesh
from dlbb_tpu.data import synthetic as jax_synth
from dlbb_tpu.models import configs as jax_configs
from dlbb_tpu.resilience import inject as jax_inject
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
from dlbb_tpu_torch.resilience.journal import SweepJournal, read_journal
from dlbb_tpu_torch.serve import engine as pt_engine
from dlbb_tpu_torch.serve import kvcache as pt_kv
from dlbb_tpu_torch.serve.traffic import Request, TrafficTrace, generate_trace

torch.set_num_threads(1)

PROGRAM_CASES = {"mha_f32": TINY, "gqa_f32": GQA, "gqa_bf16": dict(GQA, dtype="bfloat16")}
SV = dict(max_batch=4, block_size=8, max_seq=32, hbm_budget_gb=None)
CHUNK = 8
# (slot, prompt_len, request seed): three chunks (the last partial) into
# slot 1, one into slot 3
CHUNKED = ((1, 19, 3), (3, 8, 4))


def _tol(fields):
    return PROGRAM_BF16_TOL if fields["dtype"] == "bfloat16" else PROGRAM_F32_TOL


def _dtypes(fields):
    if fields["dtype"] == "bfloat16":
        return jnp.bfloat16, torch.bfloat16
    return jnp.float32, torch.float32


class _Both:
    """One model on both sides: JAX's config, mesh, params and programs'
    builders beside the port's, from one set of JAX weights."""

    def __init__(self, fields, seed=0):
        self.fields = fields
        self.jcfg, self.pcfg = _configs(fields)
        self.jmesh = jax_parallelism_mesh(devices=jax.devices()[:1])
        weights = _jax_weights(fields, seed)
        self.jparams = jax.tree.map(jnp.asarray, weights)
        self.pparams = params_from_jax(weights, self.pcfg)
        self.jdtype, self.pdtype = _dtypes(fields)
        self.sv = pt_engine.ServingConfig(**SV)

    def caches(self, quantized=False):
        sv = self.sv
        if quantized:
            return (jax_kv.create_quant_kv_cache(self.jcfg, sv.max_batch, sv.num_blocks,
                                                 sv.block_size, mesh=self.jmesh),
                    pt_kv.create_quant_kv_cache(self.pcfg, sv.max_batch, sv.num_blocks,
                                                sv.block_size, device="cpu"))
        return (jax_kv.create_kv_cache(self.jcfg, sv.max_batch, sv.num_blocks, sv.block_size,
                                       mesh=self.jmesh),
                pt_kv.create_kv_cache(self.pcfg, sv.max_batch, sv.num_blocks, sv.block_size,
                                      device="cpu"))

    def xs(self):
        h = self.pcfg.hidden_size
        return (jnp.zeros((SV["max_batch"], 1, h), self.jdtype),
                torch.zeros((SV["max_batch"], 1, h), dtype=self.pdtype))

    def chunked_prefills(self, jcache, pcache, check=None, quantized=False):
        """``CHUNKED`` through both sides' chunk programs; ``check(jcache,
        pcache, jprefix, pprefix, jy, py)`` after every chunk.  Returns the
        caches and each request's last ``y_last``."""
        outs = []
        for slot, prompt, seed in CHUNKED:
            n_chunks = -(-prompt // CHUNK)
            jx, px = _both_prompts(self.fields, seed, prompt, n_chunks * CHUNK)
            jprefix = jax_engine.create_prefix(self.jcfg, self.jmesh)
            pprefix = pt_engine.create_prefix(self.pcfg, device="cpu")
            for ci in range(n_chunks):
                jprog = jax_engine.build_prefill_chunk(self.jcfg, self.jmesh, CHUNK, ci * CHUNK,
                                                       quantized=quantized)
                pprog = pt_engine.build_prefill_chunk(self.pcfg, chunk_len=CHUNK, start=ci * CHUNK)
                window = slice(ci * CHUNK, (ci + 1) * CHUNK)
                jcache, jprefix, jy = jprog(jcache, jprefix, self.jparams, jx[:, window],
                                            np.int32(slot), np.int32(prompt))
                pcache, pprefix, py = pprog(pcache, pprefix, self.pparams, px[:, window],
                                            slot, prompt)
                if check is not None:
                    check(jcache, pcache, jprefix, pprefix, jy, py)
            outs.append((slot, jy, py))
        return jcache, pcache, outs


def _same_fp_cache(jcache, pcache, tol):
    assert np.array_equal(np.asarray(jcache.lengths), pcache.lengths.numpy())
    assert _max_diff(jcache.k, pcache.k) <= tol
    assert _max_diff(jcache.v, pcache.v) <= tol


# ---------------------------------------------------------------------------
# the programs against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(PROGRAM_CASES))
def test_prefill_chunks_match_jax(case):
    """Chunk by chunk: the cache planes, the prefix carry, ``y_last`` and
    the lengths (exact) against JAX's ``build_prefill_chunk``."""
    both = _Both(PROGRAM_CASES[case])
    tol = _tol(both.fields)

    def check(jcache, pcache, jprefix, pprefix, jy, py):
        _same_fp_cache(jcache, pcache, tol)
        assert tuple(pprefix[0].shape) == tuple(jprefix[0].shape)
        assert _max_diff(jprefix[0], pprefix[0]) <= tol
        assert _max_diff(jprefix[1], pprefix[1]) <= tol
        assert _max_diff(jy, py) <= tol

    jcache, pcache = both.caches()
    _, pcache, _ = both.chunked_prefills(jcache, pcache, check)
    assert pcache.lengths.tolist() == [0, 19, 0, 8]


def test_chunked_prefill_matches_monolithic():
    """``tests/test_serve_fastpath.py``'s case on the port: chunk-by-chunk
    prefill writes the cache and returns the last-token output of the
    monolithic bucketed prefill (the offset-causal prefix-carry attention
    is the same math), within 1e-5 in fp32."""
    cfg = ModelConfig(**TINY)
    params = params_from_jax(_jax_weights(TINY), cfg)
    prompt, slot, chunk = 19, 1, 8
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 24, 64), dtype=np.float32))
    sv = pt_engine.ServingConfig(max_batch=8, block_size=8, max_seq=64, hbm_budget_gb=None)
    cache_a = pt_kv.create_kv_cache(cfg, sv.max_batch, sv.num_blocks, sv.block_size, device="cpu")
    xa = torch.zeros((1, sv.bucket_for(prompt), 64))
    xa[:, :prompt] = x[:, :prompt]
    cache_a, ya = pt_engine.build_prefill(cfg)(cache_a, params, xa, slot, prompt)
    cache_b = pt_kv.create_kv_cache(cfg, sv.max_batch, sv.num_blocks, sv.block_size, device="cpu")
    prefix = pt_engine.create_prefix(cfg, device="cpu")
    n_chunks = -(-prompt // chunk)
    xb = torch.zeros((1, n_chunks * chunk, 64))
    xb[:, :prompt] = x[:, :prompt]
    for ci in range(n_chunks):
        cache_b, prefix, yb = pt_engine.build_prefill_chunk(cfg, chunk_len=chunk, start=ci * chunk)(
            cache_b, prefix, params, xb[:, ci * chunk:(ci + 1) * chunk], slot, prompt)
    assert float((ya - yb).abs().max()) <= 1e-5
    ka = cache_a.k[:, slot].reshape(2, -1, 4, 16)[:, :prompt]
    kb = cache_b.k[:, slot].reshape(2, -1, 4, 16)[:, :prompt]
    assert float((ka - kb).abs().max()) <= 1e-5
    assert int(cache_b.lengths[slot]) == prompt and int(cache_b.lengths[0]) == 0
    assert tuple(prefix[0].shape) == (2, n_chunks * chunk, 4, 16)


# remaining budgets per fused call: slot 0 inactive, slot 2 ends after one
# trip, slot 3 one trip before the end
def _remaining(k):
    return (0, k, 1, k - 1)


ACTIVE_FUSED = (False, True, True, True)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("mode", ["off", "greedy"])
@pytest.mark.parametrize("case", sorted(PROGRAM_CASES))
def test_decode_fused_matches_jax(case, mode, k):
    """Two fused calls of ``k`` trips after the chunked prefills, with
    budgets that end slots mid-scan: ``ys`` (token ids exactly in
    "greedy"), the carry's ``x``, the planes and the lengths (exact)
    against JAX's fused programs."""
    both = _Both(PROGRAM_CASES[case], seed=1)
    tol = _tol(both.fields)
    jcache, pcache = both.caches()
    jcache, pcache, outs = both.chunked_prefills(jcache, pcache)
    jx, px = both.xs()
    jcarry, pcarry = (jcache, jx), (pcache, px)
    if mode == "greedy":
        jtable = jax_synth.token_embedding_table(64, both.jdtype)
        ptable = pt_synth.token_embedding_table(64, both.pdtype)
    for slot, jy, py in outs:
        if mode == "greedy":
            jcarry, _ = jax_engine._inject_token_greedy(jcarry, np.int32(slot), jy, jtable)
            pcarry, _ = pt_engine._inject_token_greedy(pcarry, slot, py, ptable)
        else:
            jcarry = jax_engine._inject_token(jcarry, np.int32(slot), jy)
            pcarry = pt_engine._inject_token(pcarry, slot, py)
    act = np.asarray(ACTIVE_FUSED)
    rem = np.asarray(_remaining(k), np.int32)
    lengths0 = pcarry[0].lengths.clone()
    if mode == "greedy":
        jprog = jax_engine.build_decode_fused_token(both.jcfg, both.jmesh, k)
        pprog = pt_engine.build_decode_fused_token(both.pcfg, k=k)
    else:
        jprog = jax_engine.build_decode_fused(both.jcfg, both.jmesh, k)
        pprog = pt_engine.build_decode_fused(both.pcfg, k=k)
    for _ in range(2):
        if mode == "greedy":
            jcarry, jys = jprog(jcarry, both.jparams, jtable, jnp.asarray(act), jnp.asarray(rem))
            pcarry, pys = pprog(pcarry, both.pparams, ptable, torch.from_numpy(act),
                                torch.from_numpy(rem))
            assert np.asarray(jys).tolist() == pys.tolist()
            assert pys.shape == (k, 4) and pys.dtype == torch.int32
        else:
            jcarry, jys = jprog(jcarry, both.jparams, jnp.asarray(act), jnp.asarray(rem))
            pcarry, pys = pprog(pcarry, both.pparams, torch.from_numpy(act),
                                torch.from_numpy(rem))
            assert pys.shape == (k, 4, 1, 64)
            assert _max_diff(jys, pys) <= tol
        assert _max_diff(jcarry[1], pcarry[1]) <= tol
        _same_fp_cache(jcarry[0], pcarry[0], tol)
    assert pcarry[0].lengths.tolist() == (lengths0 + 2 * torch.from_numpy(act * rem)).tolist()


@pytest.mark.parametrize("case", sorted(PROGRAM_CASES))
def test_prefix_attach_matches_jax(case):
    """After the chunked prefills, slot 1's first chunk attached into slot
    2 (and slot 3 onto itself, the warm-up's identity): the planes and the
    prefix carry against JAX's ``build_prefix_attach``; the copied blocks
    equal the donor's bit for bit and the carry is those blocks."""
    both = _Both(PROGRAM_CASES[case], seed=2)
    tol = _tol(both.fields)
    jcache, pcache = both.caches()
    jcache, pcache, _ = both.chunked_prefills(jcache, pcache)
    jattach = jax_engine.build_prefix_attach(both.jcfg, both.jmesh, CHUNK, SV["block_size"])
    pattach = pt_engine.build_prefix_attach(both.pcfg, matched_len=CHUNK,
                                            block_size=SV["block_size"])
    for src, dst in ((1, 2), (3, 3)):
        before = pcache.k.clone()
        jcache, jprefix = jattach(jcache, np.int32(src), np.int32(dst))
        pcache, pprefix = pattach(pcache, src, dst)
        _same_fp_cache(jcache, pcache, tol)
        assert _max_diff(jprefix[0], pprefix[0]) <= tol
        assert _max_diff(jprefix[1], pprefix[1]) <= tol
        assert torch.equal(pcache.k[:, dst, :1], before[:, src, :1])
        assert torch.equal(pcache.k[:, dst, 1:], before[:, dst, 1:])
        assert torch.equal(pprefix[0], before[:, src, :1].reshape(pprefix[0].shape))


@pytest.mark.parametrize("case", sorted(PROGRAM_CASES))
def test_compaction_programs_match_jax(case):
    """Gather slots (3, 1) (an active slot padded with a free one, out of
    order), a 4-trip fused scan on the half batch, and the scatter back:
    the big carry's planes, ``x``, lengths and ``ys`` against JAX's
    programs; the slots not gathered untouched bit for bit."""
    both = _Both(PROGRAM_CASES[case], seed=3)
    tol = _tol(both.fields)
    jcache, pcache = both.caches()
    jcache, pcache, outs = both.chunked_prefills(jcache, pcache)
    jcarry, pcarry = (jcache, both.xs()[0]), (pcache, both.xs()[1])
    for slot, jy, py in outs:
        jcarry = jax_engine._inject_token(jcarry, np.int32(slot), jy)
        pcarry = pt_engine._inject_token(pcarry, slot, py)
    idx = np.asarray([3, 1])
    s_act, s_rem = np.asarray([True, False]), np.asarray([3, 0], np.int32)
    untouched = [pcarry[0].k[:, s].clone() for s in (0, 2)]
    jsmall = jax_engine.build_compact_gather(both.jmesh)(jcarry, jnp.asarray(idx, jnp.int32))
    psmall = pt_engine.build_compact_gather()(pcarry, torch.from_numpy(idx))
    jsmall, jys = jax_engine.build_decode_fused(both.jcfg, both.jmesh, 4)(
        jsmall, both.jparams, jnp.asarray(s_act), jnp.asarray(s_rem))
    psmall, pys = pt_engine.build_decode_fused(both.pcfg, k=4)(
        psmall, both.pparams, torch.from_numpy(s_act), torch.from_numpy(s_rem))
    assert _max_diff(jys, pys) <= tol
    jcarry = jax_engine.build_compact_scatter(both.jmesh)(jcarry, jsmall,
                                                          jnp.asarray(idx, jnp.int32))
    pcarry = pt_engine.build_compact_scatter()(pcarry, psmall, torch.from_numpy(idx))
    _same_fp_cache(jcarry[0], pcarry[0], tol)
    assert _max_diff(jcarry[1], pcarry[1]) <= tol
    assert pcarry[0].lengths.tolist() == [0, 19, 0, 8 + 3]
    for s, old in zip((0, 2), untouched):
        assert torch.equal(pcarry[0].k[:, s], old)


# ---------------------------------------------------------------------------
# the int8 layout
# ---------------------------------------------------------------------------


def _jax_quantized(blocks: torch.Tensor):
    """JAX's quantiser on the port's values."""
    q, s = jax_kv.quantize_kv_blocks(jnp.asarray(blocks.float().numpy()))
    return torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s))


def _assert_planes_quantise(qcache, fcache):
    """Every code and scale of the int8 cache is JAX's quantiser applied to
    the fp cache's blocks (a zero block: codes 0, scale 1.0)."""
    for plane in ("k", "v"):
        q, s = _jax_quantized(getattr(fcache, plane))
        assert torch.equal(getattr(qcache, plane), q)
        assert torch.equal(getattr(qcache, f"{plane}_scale"), s)
    assert torch.equal(qcache.lengths, fcache.lengths)


def _jax_decode_rule(codes, scales, new, rows, blk, off, write, dtype):
    """JAX's int8 decode step on one layer (``dlbb_tpu/serve/engine.py:
    1196-1224``) on the same inputs: the whole layer dequantised in fp32,
    the new row written where the slot writes, attention's read cast to the
    compute dtype, and every active slot's whole layer requantised (a slot
    writes exactly when it is active here: no slot is at ``max_seq``)."""
    b, nb, bs, kvh, d = codes.shape
    jq, js = jnp.asarray(codes.numpy()), jnp.asarray(scales.numpy())
    fp = jax_kv.dequantize_kv_blocks(jq, js, jnp.float32).reshape(b, nb * bs, kvh, d)
    at = (blk * bs + off).numpy()
    mask = (np.arange(nb * bs)[None, :] == at[:, None]) & write.numpy()[:, None]
    fp = jnp.where(jnp.asarray(mask)[..., None, None],
                   jnp.asarray(new.float().numpy())[:, None], fp)
    read = fp.astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    kq, ks = jax_kv.quantize_kv_blocks(fp.reshape(b, nb, bs, kvh, d))
    sel = jnp.asarray(write.numpy())
    kq = jnp.where(sel[:, None, None, None, None], kq, jq)
    ks = jnp.where(sel[:, None, None], ks, js)
    return (np.asarray(read.astype(jnp.float32)).reshape(codes.shape), np.asarray(kq),
            np.asarray(ks))


ACTIVE_INT8 = ((False, True, True, True),) * 5 + ((True, True, False, True),) * 3


@pytest.mark.parametrize("case", sorted(PROGRAM_CASES))
def test_int8_programs_bit_equal_to_jax_rules(case, monkeypatch):
    """The int8 layout, codes and scales bit for bit: the prefill's and
    the chunks' blocks are JAX's quantiser applied to the fp programs'
    blocks (attention runs over the exact values, so the fp and int8
    programs compute the same K/V, and ``y_last`` is equal bit for bit);
    the attach copies codes and scales and carries them dequantised; and in
    each of 8 decode steps, for every layer and plane, what attention reads
    and the planes written are JAX's decode rule on the same inputs, for
    every slot, active or not (each slot at a block edge or mid-block, one
    slot idle for five steps and one crossing a block)."""
    both = _Both(PROGRAM_CASES[case], seed=4)
    cfg, params = both.pcfg, both.pparams
    sv = both.sv
    fcache = pt_kv.create_kv_cache(cfg, 4, sv.num_blocks, sv.block_size, device="cpu")
    qcache = pt_kv.create_quant_kv_cache(cfg, 4, sv.num_blocks, sv.block_size, device="cpu")
    prefill = pt_engine.build_prefill(cfg)
    for slot, prompt, seed in ((0, 9, 5), (2, 16, 6)):
        _, px = _both_prompts(both.fields, seed, prompt, sv.bucket_for(prompt))
        fcache, fy = prefill(fcache, params, px, slot, prompt)
        qcache, qy = prefill(qcache, params, px, slot, prompt)
        assert torch.equal(fy, qy)
        _assert_planes_quantise(qcache, fcache)
    for slot, prompt, seed in CHUNKED:
        n_chunks = -(-prompt // CHUNK)
        _, px = _both_prompts(both.fields, seed, prompt, n_chunks * CHUNK)
        fprefix = qprefix = pt_engine.create_prefix(cfg, device="cpu")
        for ci in range(n_chunks):
            prog = pt_engine.build_prefill_chunk(cfg, chunk_len=CHUNK, start=ci * CHUNK)
            x = px[:, ci * CHUNK:(ci + 1) * CHUNK]
            fcache, fprefix, fy = prog(fcache, fprefix, params, x, slot, prompt)
            qcache, qprefix, qy = prog(qcache, qprefix, params, x, slot, prompt)
            assert torch.equal(fy, qy) and torch.equal(fprefix[0], qprefix[0])
            _assert_planes_quantise(qcache, fcache)
    # slot 1's first chunk attached onto slot 0 (overwriting its prompt's
    # first block), then slot 2 onto itself
    attach = pt_engine.build_prefix_attach(cfg, matched_len=CHUNK, block_size=sv.block_size)
    for src, dst in ((1, 0), (2, 2)):
        before = {f: getattr(qcache, f).clone() for f in ("k", "v", "k_scale", "v_scale")}
        qcache, (pk, pv) = attach(qcache, src, dst)
        for f, old in before.items():
            assert torch.equal(getattr(qcache, f)[:, dst, :1], old[:, src, :1])
            assert torch.equal(getattr(qcache, f)[:, dst, 1:], old[:, dst, 1:])
        want = jax_kv.dequantize_kv_blocks(jnp.asarray(before["k"][:, src, :1].numpy()),
                                           jnp.asarray(before["k_scale"][:, src, :1].numpy()),
                                           both.jdtype)
        assert np.array_equal(np.asarray(jnp.asarray(want, jnp.float32)).reshape(pk.shape),
                              pk.float().numpy())
    qcache.lengths.copy_(torch.tensor([8, 19, 16, 8], dtype=torch.int32))

    calls = []
    append = pt_engine._append_rows_int8

    def held_to_jax(codes, scales, new, rows, blk, off, write, dtype):
        want = _jax_decode_rule(codes, scales, new, rows, blk, off, write, dtype)
        read = append(codes, scales, new, rows, blk, off, write, dtype)
        assert np.array_equal(read.float().numpy(), want[0])
        assert np.array_equal(codes.numpy(), want[1])
        assert np.array_equal(scales.numpy(), want[2])
        calls.append(int(write.sum()))
        return read

    monkeypatch.setattr(pt_engine, "_append_rows_int8", held_to_jax)
    step = pt_engine.build_decode_step(cfg)
    carry = (qcache, torch.randn((4, 1, 64), generator=torch.Generator().manual_seed(0))
             .to(both.pdtype))
    for act in ACTIVE_INT8:
        carry, _ = step(carry, params, torch.tensor(act))
    assert len(calls) == 2 * cfg.num_layers * len(ACTIVE_INT8)
    assert carry[0].lengths.tolist() == [8 + 3, 19 + 8, 16 + 5, 8 + 8]


@pytest.mark.parametrize("case", ["mha_f32", "gqa_f32"])
def test_int8_programs_match_jax(case):
    """JAX's and the port's int8 programs side by side (prefill, chunks,
    8 decode steps): outputs within the fp32 bound, lengths exact, and
    the dequantised planes within the fp32 bound plus one quantisation
    step.  The two frameworks' fp32 K/V differ by ulps, so a value within
    that distance of a rounding edge may take the neighbouring code, and a
    block's scale (its amax / 127) may differ in its last bits: the bit
    equality is the previous test's, on the same values."""
    both = _Both(PROGRAM_CASES[case], seed=5)
    sv = both.sv
    jcache, pcache = both.caches(quantized=True)
    jprefill = jax_engine.build_prefill(both.jcfg, both.jmesh, quantized=True)
    pprefill = pt_engine.build_prefill(both.pcfg)
    jx, px = both.xs()
    jcarry, pcarry = (jcache, jx), (pcache, px)
    for slot, prompt, seed in ((0, 9, 5), (2, 16, 6)):
        jxp, pxp = _both_prompts(both.fields, seed, prompt, sv.bucket_for(prompt))
        jc, jy = jprefill(jcarry[0], both.jparams, jxp, np.int32(slot), np.int32(prompt))
        pc, py = pprefill(pcarry[0], both.pparams, pxp, slot, prompt)
        assert _max_diff(jy, py) <= PROGRAM_F32_TOL
        jcarry = jax_engine._inject_token((jc, jcarry[1]), np.int32(slot), jy)
        pcarry = pt_engine._inject_token((pc, pcarry[1]), slot, py)
    jc, pc, outs = both.chunked_prefills(jcarry[0], pcarry[0], quantized=True)
    jcarry, pcarry = (jc, jcarry[1]), (pc, pcarry[1])
    for slot, jy, py in outs:
        jcarry = jax_engine._inject_token(jcarry, np.int32(slot), jy)
        pcarry = pt_engine._inject_token(pcarry, slot, py)
    jstep = jax_engine.build_decode_step(both.jcfg, both.jmesh, quantized=True)
    pstep = pt_engine.build_decode_step(both.pcfg)
    for act in ACTIVE_INT8:
        jcarry, jy = jstep(jcarry, both.jparams, jnp.asarray(act))
        pcarry, py = pstep(pcarry, both.pparams, torch.tensor(act))
        assert _max_diff(jy, py) <= PROGRAM_F32_TOL
    jq, pq = jcarry[0], pcarry[0]
    assert np.array_equal(np.asarray(jq.lengths), pq.lengths.numpy())
    for plane in ("k", "v"):
        jscale = np.asarray(getattr(jq, f"{plane}_scale"))
        pscale = getattr(pq, f"{plane}_scale").numpy()
        assert np.abs(jscale - pscale).max() <= PROGRAM_F32_TOL
        jdeq = np.asarray(jax_kv.dequantize_kv_blocks(getattr(jq, plane),
                                                      getattr(jq, f"{plane}_scale"),
                                                      jnp.float32))
        pdeq = pt_kv.dequantize_kv_blocks(getattr(pq, plane), getattr(pq, f"{plane}_scale"),
                                          torch.float32).numpy()
        step = np.maximum(jscale, pscale)[..., None, :, None]
        assert np.all(np.abs(jdeq - pdeq) <= step + PROGRAM_F32_TOL)


# ---------------------------------------------------------------------------
# whole engines against JAX's
# ---------------------------------------------------------------------------

FAST = dict(max_batch=4, block_size=8, max_seq=64, queue_capacity=64, hbm_budget_gb=None,
            decode_horizon=16, inflight_window=2, prefill_chunk=8)
PER_STEP = {k: v for k, v in FAST.items()
            if k not in ("decode_horizon", "inflight_window", "prefill_chunk")}
COMPACT = dict(PER_STEP, max_batch=8, decode_horizon=16, compact_threshold=0.5)
PREFIX = dict(max_batch=4, block_size=8, max_seq=96, queue_capacity=64, hbm_budget_gb=None,
              prefill_chunk=16)


def _at_t0(trace):
    return dataclasses.replace(trace, requests=tuple(
        dataclasses.replace(r, arrival_s=0.0) for r in trace.requests))


def _t0_trace(n=12, seed=7):
    """Prompts of one to three chunks, outputs long enough to fuse, every
    arrival at t=0, three times the slots."""
    return _at_t0(jax_traffic.generate_trace("poisson", n, seed=seed, rate=500.0,
                                             prompt_range=(4, 20), output_range=(2, 12)))


def _prefix_trace():
    """``tests/test_prefix.py``'s two-group shared-prefix trace at t=0."""
    return _at_t0(jax_traffic.generate_trace("poisson", 8, seed=3, rate=100.0,
                                             prompt_range=(65, 80), output_range=(4, 8),
                                             prefix_groups=2, prefix_len=64))


def _run_jax(fields, serving, trace, mesh, tmp_path, name, seed=0):
    """JAX's engine on ``trace`` with its host uploads copied; its report,
    journal sequence and weights (numpy)."""
    engine = jax_engine.ServingEngine(jax_configs.ModelConfig(**fields),
                                      jax_engine.ServingConfig(**serving), mesh,
                                      verbose=False, capture_tokens=True, seed=seed)
    journal = JaxJournal(tmp_path / name)
    engine.journal = journal
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "jnp", _CopyingJnp())
        report = engine.run_trace(trace)
    journal.close()
    events, _ = jax_read_journal(tmp_path / name)
    return report, _sequence(events), jax.tree.map(np.asarray, engine.params)


def _sequence(events):
    return [(e["event"], e["config"]) for e in events
            if e["event"].startswith(("request-", "prefix-"))]


def _run_port(fields, serving, trace, weights, tmp_path, name):
    cfg = ModelConfig(**fields)
    engine = pt_engine.ServingEngine(cfg, pt_engine.ServingConfig(**serving),
                                     params=params_from_jax(weights, cfg), verbose=False,
                                     capture_tokens=True, device="cpu")
    journal = SweepJournal(tmp_path / name)
    engine.journal = journal
    report = engine.run_trace(TrafficTrace.from_dict(trace.to_dict()))
    journal.close()
    events, _ = read_journal(tmp_path / name)
    return report, _sequence(events)


def _same_run(got, ref, counters=True):
    """Tokens, outcomes and request counts identical; with ``counters``
    also the unit counts, the fast-path and prefix sections and the
    ledger's."""
    assert got["completed_tokens"] == ref["completed_tokens"]
    assert got["requests"] == ref["requests"]
    if counters:
        assert (got["decode_steps"], got["decode_units"], got["generated_tokens"]) == (
            ref["decode_steps"], ref["decode_units"], ref["generated_tokens"])
        assert got["fast_path"] == ref["fast_path"]
        assert got["prefix"] == ref["prefix"]
        assert got["cache"] == ref["cache"]


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """JAX's engines at world 1 on the t=0 traces, and their weights."""
    tmp = tmp_path_factory.mktemp("jax_w1")
    mesh = jax_parallelism_mesh(devices=jax.devices()[:1])
    trace, ptrace = _t0_trace(), _prefix_trace()
    out = {"per_step": _run_jax(TINY, PER_STEP, trace, mesh, tmp, "per_step")}
    for mode in ("off", "greedy"):
        out[f"fast/{mode}"] = _run_jax(TINY, dict(FAST, speculation=mode), trace, mesh, tmp,
                                       f"fast_{mode}")
    out["per_step8"] = _run_jax(TINY, dict(COMPACT, decode_horizon=1, compact_threshold=None),
                                trace, mesh, tmp, "per_step8")
    for name, extra in (("chunked", {}), ("prefix", dict(prefix_caching=True)),
                        ("prefix_int8", dict(prefix_caching=True, kv_quantization="int8"))):
        out[name] = _run_jax(TINY, dict(PREFIX, **extra), ptrace, mesh, tmp, name)
    return out


@pytest.mark.parametrize("mode", ["off", "greedy"])
def test_fused_engine_matches_jax_engine(world1, mode, tmp_path):
    """The full fast path (fused scans up to k=16, window 2, 8-token
    chunks) against JAX's engine with the same knobs: tokens, outcomes,
    every counter and the journal's (event, rid) order identical; and its
    tokens those of the per-step engine, token for token."""
    ref, ref_seq, weights = world1[f"fast/{mode}"]
    got, seq = _run_port(TINY, dict(FAST, speculation=mode), _t0_trace(), weights, tmp_path,
                         "port")
    _same_run(got, ref)
    assert seq == ref_seq
    fp = got["fast_path"]
    assert fp["enabled"] and fp["fused_scans"] > 0 and fp["prefill_chunks"] > 0
    assert got["decode_units"] < got["decode_steps"]
    base, _ = _run_port(TINY, dict(PER_STEP, speculation=mode), _t0_trace(), weights,
                        tmp_path, "per_step")
    assert base["completed_tokens"] == got["completed_tokens"]
    assert base["fast_path"]["fused_scans"] == 0
    assert base["decode_units"] == base["decode_steps"]
    for r in _t0_trace():
        assert len(got["completed_tokens"][str(r.rid)]) == r.output_len


def test_compaction_engine_matches_non_compacted_jax_engine(world1, tmp_path):
    """Slot compaction (dp=1) on 8 slots: fused scans on the gathered half
    batch give the tokens and outcomes of JAX's per-step, non-compacted
    engine (JAX's own compaction test is flaky: ROADMAP Queue 3)."""
    ref, _, weights = world1["per_step8"]
    got, _ = _run_port(TINY, COMPACT, _t0_trace(), weights, tmp_path, "port")
    _same_run(got, ref, counters=False)
    assert got["fast_path"]["compacted_scans"] > 0
    assert got["cache"]["blocks_reserved"] == 0


def _two(rid0, rid1, seeds, prompt=6, outputs=(3, 12)):
    return TrafficTrace(kind="poisson", seed=0, params={}, requests=tuple(
        Request(rid=rid, arrival_s=0.0, prompt_len=prompt, output_len=out, seed=seed)
        for rid, out, seed in zip((rid0, rid1), outputs, seeds)))


def test_completion_mid_fused_scan(tmp_path):
    """A slot whose request completes mid-scan is inactive for the rest
    of it: exactly ``output_len`` tokens, the per-step engine's tokens, and
    its blocks free at scan exit; equal to JAX's engine."""
    trace = _two(0, 1, (11, 12))
    serving = dict(PER_STEP, max_batch=8, decode_horizon=8)
    mesh = jax_parallelism_mesh(devices=jax.devices()[:1])
    ref, ref_seq, weights = _run_jax(TINY, serving, trace, mesh, tmp_path, "jax")
    got, seq = _run_port(TINY, serving, trace, weights, tmp_path, "port")
    base, _ = _run_port(TINY, dict(PER_STEP, max_batch=8), trace, weights, tmp_path, "base")
    _same_run(got, ref)
    assert seq == ref_seq
    assert got["completed_tokens"] == base["completed_tokens"]
    assert len(got["completed_tokens"]["0"]) == 3 and len(got["completed_tokens"]["1"]) == 12
    assert got["fast_path"]["fused_steps"] >= 8
    assert got["cache"]["blocks_reserved"] == 0 and got["requests"]["completed"] == 2


def test_k_horizon_overshoots_every_remaining_length(tmp_path):
    """``decode_horizon`` far beyond every remaining output: the bucket
    clamps to the drain horizon, no token past ``output_len``, and exactly
    four trips; equal to JAX's engine."""
    trace = _two(0, 1, (31, 32), prompt=4, outputs=(3, 5))
    serving = dict(PER_STEP, max_batch=8, decode_horizon=64)
    mesh = jax_parallelism_mesh(devices=jax.devices()[:1])
    ref, ref_seq, weights = _run_jax(TINY, serving, trace, mesh, tmp_path, "jax")
    got, seq = _run_port(TINY, serving, trace, weights, tmp_path, "port")
    _same_run(got, ref)
    assert seq == ref_seq
    assert [len(got["completed_tokens"][r]) for r in ("0", "1")] == [3, 5]
    assert got["decode_steps"] == 4
    assert got["cache"]["blocks_reserved"] == 0


def test_admission_during_inflight_window(tmp_path):
    """Two slots, three requests at t=0, window 3: the third request waits
    for a slot while fused units are in flight, is admitted at the scan
    boundary after the window drains, and every token equals the per-step
    engine's and JAX's windowed engine's."""
    trace = TrafficTrace(kind="poisson", seed=0, params={}, requests=tuple(
        Request(rid=rid, arrival_s=0.0, prompt_len=8, output_len=out, seed=seed)
        for rid, out, seed in ((0, 24, 21), (1, 16, 22), (2, 8, 23))))
    serving = dict(PER_STEP, max_batch=2, decode_horizon=4, inflight_window=3)
    mesh = jax_parallelism_mesh(devices=jax.devices()[:1])
    ref, ref_seq, weights = _run_jax(TINY, serving, trace, mesh, tmp_path, "jax")
    got, seq = _run_port(TINY, serving, trace, weights, tmp_path, "port")
    base, _ = _run_port(TINY, dict(PER_STEP, max_batch=2), trace, weights, tmp_path, "base")
    _same_run(got, ref)
    assert seq == ref_seq
    assert got["completed_tokens"] == base["completed_tokens"]
    assert got["requests"]["completed"] == 3
    assert got["fast_path"]["fused_scans"] > 0


def test_fused_scan_emits_one_span_with_steps_attr(tmp_path):
    """A fused scan is ONE ``serve-decode`` span with a ``steps`` argument
    (never k per-step spans), and the journal's timeline stays whole when
    several requests complete in one scan."""
    cfg = ModelConfig(**TINY)
    engine = pt_engine.ServingEngine(
        cfg, pt_engine.ServingConfig(**PER_STEP, decode_horizon=8),
        params=params_from_jax(_jax_weights(TINY), cfg), verbose=False, device="cpu")
    trace = TrafficTrace(kind="poisson", seed=0, params={}, requests=tuple(
        Request(rid=i, arrival_s=0.0, prompt_len=6, output_len=6, seed=40 + i)
        for i in range(4)))
    span_path = tmp_path / "trace.json"
    journal = SweepJournal(tmp_path, meta={"mode": "serve"}, sink=spans.journal_sink)
    engine.journal = journal
    try:
        with spans.tracing(span_path):
            report = engine.run_trace(trace)
    finally:
        engine.journal = None
        journal.close()
    payload = spans.load_trace(span_path)
    assert spans.validate_trace_events(payload["traceEvents"]) == []
    decode_begins = [e for e in payload["traceEvents"]
                     if e["ph"] == "B" and e["name"] == "serve-decode"]
    assert len(decode_begins) == report["decode_units"]
    fused = [e for e in decode_begins if e["args"]["steps"] > 1]
    assert len(fused) == report["fast_path"]["fused_scans"] > 0
    assert sum(e["args"]["steps"] for e in decode_begins) == report["decode_steps"]
    events, torn = read_journal(tmp_path)
    assert torn == 0
    assert len([e for e in events if e["event"] == "request-completed"]) == 4
    timeline, _n, torn2 = spans.journal_to_trace(tmp_path, tmp_path / "timeline.json")
    assert torn2 == 0
    req_spans = [e for e in spans.load_trace(timeline)["traceEvents"] if e["ph"] == "X"]
    assert len(req_spans) == 4
    assert all(e["cat"] == "config-completed" for e in req_spans)
    assert int(engine.registry.get("serve_fused_scan_steps")) == report["fast_path"][
        "fused_steps"]


def test_prefix_and_int8_engines_match_jax(world1, tmp_path):
    """``tests/test_prefix.py``'s gate at t=0: the prefix-cached engine is
    token-identical to the no-sharing engine (attach copies the chunks'
    exact values), registers its hits (64 tokens each), drains every
    shared block, and
    equals JAX's engine in tokens, counters, the ledger and the journal
    (``prefix-attach`` events included); the int8 engine likewise against
    JAX's int8 engine."""
    ptrace = _prefix_trace()
    runs = {}
    for name, extra in (("chunked", {}), ("prefix", dict(prefix_caching=True)),
                        ("prefix_int8", dict(prefix_caching=True, kv_quantization="int8"))):
        ref, ref_seq, weights = world1[name]
        got, seq = _run_port(TINY, dict(PREFIX, **extra), ptrace, weights, tmp_path, name)
        _same_run(got, ref)
        assert seq == ref_seq
        runs[name] = got
    base, pfx, quant = runs["chunked"], runs["prefix"], runs["prefix_int8"]
    assert pfx["completed_tokens"] == base["completed_tokens"]
    hits = pfx["prefix"]["hits"]
    assert hits >= 2
    assert pfx["prefix"]["tokens_reused"] == hits * 64
    assert pfx["cache"]["peak_shared_blocks"] > 0
    assert pfx["cache"]["shared_blocks"] == pfx["cache"]["prefix_refs"] == 0
    assert pfx["cache"]["blocks_reserved"] == 0
    assert quant["requests"]["completed"] == len(ptrace)
    assert quant["prefix"]["kv_quantization"] == "int8" and quant["prefix"]["hits"] == hits


def test_prefix_copy_on_write_tail_matches_jax(tmp_path):
    """48-token chunks under the 64-token shared prefixes: an attach stops
    at the chunk floor (48 tokens, 6 blocks) and the trie's 2 deeper
    matched blocks are recomputed privately, the copy-on-write tail
    (``note_cow``, ``prefix-cow`` events); tokens, counters, the ledger's
    ``cow_blocks`` and the journal equal to JAX's engine."""
    serving = dict(PREFIX, prefill_chunk=48, prefix_caching=True)
    mesh = jax_parallelism_mesh(devices=jax.devices()[:1])
    ptrace = _prefix_trace()
    ref, ref_seq, weights = _run_jax(TINY, serving, ptrace, mesh, tmp_path, "jax")
    got, seq = _run_port(TINY, serving, ptrace, weights, tmp_path, "port")
    _same_run(got, ref)
    assert seq == ref_seq
    hits = got["prefix"]["hits"]
    assert hits >= 2 and got["prefix"]["tokens_reused"] == 48 * hits
    assert got["prefix"]["cow_blocks"] == got["cache"]["cow_blocks"] == 2 * hits
    assert sum(1 for event, _ in seq if event == "prefix-cow") == hits


# ---------------------------------------------------------------------------
# on gloo ranks
# ---------------------------------------------------------------------------

RANKS_TRACE = dict(kind="poisson", num_requests=24, seed=9, rate=400.0,
                   prompt_range=(4, 16), output_range=(2, 8))
RANKS_SERVING = dict(max_batch=4, block_size=8, max_seq=64, queue_capacity=3,
                     hbm_budget_gb=None, decode_horizon=4, inflight_window=2)
# (mesh (dp, tp), model, serving, trace): the world-2 runs
TP2_RUNS = {
    "tp2/fast": ((1, 2), GQA, FAST, "t0"),
    "tp2/compact": ((1, 2), GQA, COMPACT, "t0"),
    "tp2/prefix": ((1, 2), GQA, dict(PREFIX, prefix_caching=True), "prefix"),
    "tp2/prefix_int8": ((1, 2), GQA, dict(PREFIX, prefix_caching=True,
                                          kv_quantization="int8"), "prefix"),
}


def _trace_of(name):
    return {"t0": _t0_trace, "prefix": _prefix_trace}[name]()


@pytest.fixture(scope="module")
def jax_tp2(tmp_path_factory):
    """JAX's engines at tp=2 for ``TP2_RUNS`` (compaction's reference the
    non-compacted per-step engine)."""
    tmp = tmp_path_factory.mktemp("jax_tp2")
    mesh = jax_parallelism_mesh(tensor_parallel=2, devices=jax.devices()[:2])
    out = {}
    for name, (_, fields, serving, trace) in TP2_RUNS.items():
        if name == "tp2/compact":
            serving = dict(serving, decode_horizon=1, compact_threshold=None)
        out[name] = _run_jax(fields, serving, _trace_of(trace), mesh, tmp,
                             name.replace("/", "_"), seed=1)
    return out


@pytest.fixture(scope="module")
def world2(jax_tp2):
    runs = {name: (*meshes, fields, serving, jax_tp2[name][2], _trace_of(trace).to_dict())
            for name, (meshes, fields, serving, trace) in TP2_RUNS.items()}
    runs["dp2/agree"] = (2, 1, TINY, RANKS_SERVING, _jax_weights(TINY),
                         generate_trace(**RANKS_TRACE).to_dict())
    return launch(torch_serve_worker.run_engines, 2, "cpu", args=(runs,), timeout=300,
                  group_timeout=120)


@pytest.mark.parametrize("name", sorted(TP2_RUNS))
def test_engines_at_tp2_match_jax(world2, jax_tp2, name):
    """tp=2 with GQA (one kv head per rank) over gloo: the fast path, the
    compaction engine (against JAX's non-compacted one), the prefix cache
    and the int8 prefix cache, on both ranks equal to JAX's engine at
    tp=2."""
    ref, ref_seq, _ = jax_tp2[name]
    for rank in world2:
        got = rank[name]
        _same_run(got, ref, counters=name != "tp2/compact")
        if name != "tp2/compact":
            assert got["journal"] == ref_seq
    if name == "tp2/compact":
        assert world2[0][name]["fast_path"]["compacted_scans"] > 0


def test_ranks_agree_at_dp2_on_a_poisson_trace(world2):
    """dp=2, fused scans of up to 4 steps in a window of 2, a Poisson
    trace at 400 req/s with a queue of 3: admission and the scan horizon
    (steps to the next arrival, from the per-step EMA) read the clock, and
    rank 0's is broadcast, so both ranks admit, reject, fuse and complete
    alike and gather the same tokens."""
    a, b = (r["dp2/agree"] for r in world2)
    for key in ("requests", "completed_tokens", "cache", "decode_steps", "decode_units",
                "fast_path", "journal"):
        assert a[key] == b[key], key
    req = a["requests"]
    assert req["arrived"] == RANKS_TRACE["num_requests"]
    assert req["completed"] + req["rejected"] == req["arrived"]
    assert a["cache"]["blocks_reserved"] == 0
    assert a["fast_path"]["fused_scans"] > 0


@pytest.fixture(scope="module")
def dp2_tp4(mesh2x4, tmp_path_factory):
    """The fast path and window at dp=2 x tp=4: JAX's engine on its mesh,
    then the port on 8 gloo ranks with its weights."""
    tmp = tmp_path_factory.mktemp("jax_2x4")
    trace = _t0_trace(16, seed=11)
    serving = dict(FAST, speculation="greedy")
    ref = _run_jax(TINY, serving, trace, mesh2x4, tmp, "fast", seed=3)
    runs = {"fast": (2, 4, TINY, serving, ref[2], trace.to_dict())}
    return ref, launch(torch_serve_worker.run_engines, 8, "cpu", args=(runs,), timeout=300,
                       group_timeout=120)


def test_fast_engine_dp2_tp4_matches_jax_engine(dp2_tp4):
    """Greedy tokens, outcomes, counters and the journal's order at dp=2 x
    tp=4 equal to JAX's engine on the same mesh, on every rank."""
    (ref, ref_seq, _), ranks = dp2_tp4
    for rank in ranks:
        _same_run(rank["fast"], ref)
        assert rank["fast"]["journal"] == ref_seq
    assert ranks[0]["fast"]["fast_path"]["fused_scans"] > 0


# ---------------------------------------------------------------------------
# the tests that waited for part 11d and item 12
# ---------------------------------------------------------------------------


def test_degraded_attach_after_carry_reset_stays_correct(tmp_path):
    """``tests/test_prefix.py``'s gate: a decode unit that fails for good
    (no retries) fails the resident batch, and the prefix-cached engine's
    completed requests still equal the no-sharing engine's under the same
    plan; the prefix engine equals JAX's in tokens, outcomes, counters and
    journal, and nothing stays shared."""
    serving = dict(PREFIX, max_dispatch_retries=0)
    mesh = jax_parallelism_mesh(devices=jax.devices()[:1])
    ptrace = _prefix_trace()
    plan = "serve-decode-fail:@2"
    with jax_inject.plan_scope(plan):
        ref, ref_seq, weights = _run_jax(TINY, dict(serving, prefix_caching=True), ptrace,
                                         mesh, tmp_path, "jax")
    with pt_inject.plan_scope(plan):
        base, _ = _run_port(TINY, serving, ptrace, weights, tmp_path, "base")
    with pt_inject.plan_scope(plan):
        pfx, seq = _run_port(TINY, dict(serving, prefix_caching=True), ptrace, weights,
                             tmp_path, "pfx")
    _same_run(pfx, ref)
    assert seq == ref_seq
    assert pfx["resilience"]["failed_requests"] > 0
    done = {k for k, v in base["requests"]["outcomes"].items() if v == "completed"}
    assert done
    for rid in done:
        assert pfx["completed_tokens"].get(rid) == base["completed_tokens"].get(rid), rid
    assert pfx["cache"]["blocks_reserved"] == 0
    assert pfx["cache"]["shared_blocks"] == 0


def _serve_config(name, **serving):
    return {"experiment": {"name": name}, "model": dict(TINY),
            "parallelism": {"data_parallel": 1, "world_size": 1},
            "serving": dict(max_batch=8, block_size=8, max_seq=64, hbm_budget_gb=None,
                            **serving)}


def test_fastpath_artifact_set_schema_valid(tmp_path):
    """``serve/bench.py`` with the fast-path knobs: the artifact set stays
    schema-valid and carries the fast path's counters."""
    from dlbb_tpu_torch.serve.bench import run_serving

    config = _serve_config("fastsmoke", decode_horizon=8, inflight_window=2)
    trace = generate_trace("poisson", 6, seed=9, rate=500.0, prompt_range=(4, 16),
                           output_range=(4, 10))
    report = run_serving(config, trace, str(tmp_path), verbose=False, device="cpu")
    assert report["requests"]["completed"] == 6
    result = json.loads((tmp_path / "serving_fastsmoke.json").read_text())
    assert result["schema"] == "dlbb_serving_report_v1"
    assert result["fast_path"]["decode_horizon"] == 8
    assert result["serving"]["decode_horizon"] == 8
    prom = (tmp_path / "metrics.prom").read_text()
    for name in ("dlbb_serve_decode_steps_total", "dlbb_serve_fused_scan_steps_total",
                 "dlbb_serve_prefill_chunks_total", "dlbb_serve_decode_batch_occupancy"):
        assert name in prom


def test_prefix_run_artifacts_and_metrics(tmp_path):
    """``serve/bench.py`` with the prefix cache and int8 planes: the
    journal carries the ``prefix-attach`` events, ``journal_to_trace``
    renders them as prefix-cache instants, ``metrics.prom`` exports the hit
    counters, and the memory record prices the int8 layout."""
    from dlbb_tpu_torch.models.configs import kv_cache_bytes_per_device
    from dlbb_tpu_torch.serve.bench import run_serving

    serving = dict(max_batch=4, block_size=8, max_seq=96, hbm_budget_gb=None,
                   prefill_chunk=16, prefix_caching=True, kv_quantization="int8")
    config = {"experiment": {"name": "pfx"}, "model": dict(TINY),
              "parallelism": {"data_parallel": 1, "world_size": 1}, "serving": serving}
    trace = generate_trace("poisson", 6, seed=3, rate=100.0, prompt_range=(65, 80),
                           output_range=(4, 8), prefix_groups=2, prefix_len=64)
    report = run_serving(config, trace, str(tmp_path), verbose=False, device="cpu")
    assert report["requests"]["completed"] == 6
    hits = report["prefix"]["hits"]
    assert hits >= 1
    events, torn = read_journal(tmp_path)
    assert torn == 0
    attaches = [e for e in events if e["event"] == "prefix-attach"]
    assert len(attaches) == hits
    assert all(e["tokens"] == 64 and e["blocks"] == 8 for e in attaches)
    timeline, _n, _t = spans.journal_to_trace(tmp_path, tmp_path / "tl.json")
    pre = [e for e in spans.load_trace(timeline)["traceEvents"]
           if e.get("cat") == "prefix-cache"]
    assert len(pre) == hits and all(e["ph"] == "i" for e in pre)
    text = (tmp_path / "metrics.prom").read_text()
    assert f"dlbb_serve_prefix_hits_total {hits}" in text
    assert f"dlbb_serve_prefix_tokens_reused_total {hits * 64}" in text
    assert "dlbb_serve_prefix_hit_rate" in text
    assert 'dlbb_serve_cache_blocks{stat="peak_shared_blocks"}' in text
    hbm = json.loads((tmp_path / "serving_pfx.json").read_text())["hbm"]
    fp = kv_cache_bytes_per_device(ModelConfig(**TINY), 4, 96, dp=1, tp=1)
    assert hbm["kv_cache_bytes_per_device"] < fp / 3


def test_serving_report_shed_columns(tmp_path):
    from test_torch_serve_resilience import write_both_reports

    fake = {
        "schema": "dlbb_serving_report_v1",
        "trace": {"kind": "poisson", "num_requests": 10},
        "requests": {"arrived": 10, "completed": 8, "rejected": 2, "shed_rate": 0.2,
                     "rejected_detail": [
                         {"rid": 4, "reason": "queue-full", "queue_depth": 3,
                          "queue_wait_s": 0.05},
                         {"rid": 7, "reason": "queue-full", "queue_depth": 3,
                          "queue_wait_s": 0.15}]},
        "mesh": {"dp": 2, "tp": 4},
        "serving": {"max_batch": 8, "block_size": 16, "max_seq": 256},
        "fast_path": {"fused_steps": 64, "prefill_chunks": 5},
        "goodput_tokens_per_s": 100.0,
        "ttft": {"median": 0.01, "p99": 0.02, "p999": 0.03},
        "per_token_latency": {"median": 0.001, "p99": 0.002, "p999": 0.003},
        "cache": {"peak_blocks_in_use": 12},
        "timeseries": {"queue_depth": [0, 3]},
        "decode_steps": 42,
        "wall_seconds": 1.5,
    }
    rows, md, _csv = write_both_reports(tmp_path, {"fastrun": fake})
    assert len(rows) == 1
    assert rows[0]["shed_rate"] == 0.2
    assert rows[0]["rej_queue_wait_ms"] == 100.0  # mean of 50 and 150
    assert rows[0]["fused_steps"] == 64
    assert "20%" in md and "100.0" in md
