"""Speculative and sampled decoding (ROADMAP Queue 1, Slice E, item 11,
part 11c: ``dlbb_tpu_torch/serve/engine.py``) against the JAX package, on
the CPU.

- the programs, TINY at world 1 (MHA and GQA, fp32 and bf16), against
  JAX's on the same inputs, caches and weights: ``build_verify_step`` at
  γ = 1, 2, 4 with drafts that match the per-step tokens for a prefix and
  then differ and a budget that clamps the commits, ``build_verify_probs``
  at γ = 0 and 4 (lengths and ``x`` unchanged, a second call the same),
  ``build_spec_commit``, ``_inject_token_sampled`` and ``build_draft_scan``
  (its lengths overridden, the draft plane's rollback); token ids and
  commits equal, outputs and K/V within the case's bound;
- the host helpers (``_ngram_propose``, ``softmax_np``,
  ``residual_distribution``, ``speculative_sample``) equal to JAX's bit for
  bit, on generators seeded alike;
- ``tests/test_speculative.py``'s tests, mirrored on the port;
- whole engines against JAX's on the motif traces of ``_spec_trace`` with
  every arrival at t=0 and ``max_batch`` at least the trace's length (JAX's
  own trace arrives at a Poisson rate, which makes admission depend on
  timing), JAX's engine with its host uploads copied (``_CopyingJnp``):
  per-request tokens, the report's speculation section, the counters and
  the journal's (event, rid) order (``spec-verify`` included) identical,
  and the port's speculative tokens those of its own "greedy" oracle; at
  world 1, at tp=2 and at dp=2 x tp=4 on gloo ranks
  (``tests/torch_serve_worker.py``, one spawn per world size);
- the sampled run ("ngram", γ=4, temperature 0.8, ``sample_seed`` 3)
  token-identical to JAX's, replayable, and moved by another seed.

- ``test_decode_fail_during_verify_retries_cleanly`` (part 11d: the verify
  unit's retry) against JAX's engine and the oracle, and the serving
  report's speculation columns byte-equal to JAX's writer (item 12, part
  12a).  ``test_speculative_report_writer`` waits for part 12b (the
  ``BENCH_spec.json`` writers).
"""

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
from test_torch_serve_fastpath import PROGRAM_CASES, _at_t0, _same_run

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
from dlbb_tpu_torch.serve.traffic import TrafficTrace

torch.set_num_threads(1)

H = TINY["hidden_size"]
SV = dict(max_batch=4, block_size=8, max_seq=32, hbm_budget_gb=None)
# (slot, prompt_len, request seed): three resident slots, slot 0 idle
PREFILLS = ((1, 11, 3), (2, 5, 4), (3, 16, 5))
ACTIVE = (False, True, True, True)


def _tol(fields):
    return PROGRAM_BF16_TOL if fields["dtype"] == "bfloat16" else PROGRAM_F32_TOL


class _Both:
    """One model on both sides (JAX's config, mesh and params beside the
    port's, from one set of JAX weights), with the token table, and
    ``PREFILLS`` prefilled and injected through the greedy table."""

    def __init__(self, fields, seed=0):
        self.fields = fields
        self.jcfg, self.pcfg = _configs(fields)
        self.jmesh = jax_parallelism_mesh(devices=jax.devices()[:1])
        weights = _jax_weights(fields, seed)
        self.jparams = jax.tree.map(jnp.asarray, weights)
        self.pparams = params_from_jax(weights, self.pcfg)
        bf16 = fields["dtype"] == "bfloat16"
        self.jdtype = jnp.bfloat16 if bf16 else jnp.float32
        self.pdtype = torch.bfloat16 if bf16 else torch.float32
        self.jtable = jax_synth.token_embedding_table(H, self.jdtype)
        self.ptable = pt_synth.token_embedding_table(H, self.pdtype)
        self.sv = pt_engine.ServingConfig(**SV)

    def carries(self, cfgs=None, params=None):
        """Both sides' carries after ``PREFILLS`` (on ``cfgs``/``params``
        when given: the draft model's)."""
        jcfg, pcfg = cfgs or (self.jcfg, self.pcfg)
        jparams, pparams = params or (self.jparams, self.pparams)
        sv = self.sv
        jcache = jax_kv.create_kv_cache(jcfg, sv.max_batch, sv.num_blocks, sv.block_size,
                                        mesh=self.jmesh)
        pcache = pt_kv.create_kv_cache(pcfg, sv.max_batch, sv.num_blocks, sv.block_size,
                                       device="cpu")
        jcarry = (jcache, jnp.zeros((sv.max_batch, 1, H), self.jdtype))
        pcarry = (pcache, torch.zeros((sv.max_batch, 1, H), dtype=self.pdtype))
        jprefill = jax_engine.build_prefill(jcfg, self.jmesh)
        pprefill = pt_engine.build_prefill(pcfg)
        for slot, prompt, seed in PREFILLS:
            jx, px = _both_prompts(self.fields, seed, prompt, sv.bucket_for(prompt))
            jc, jy = jprefill(jcarry[0], jparams, jx, np.int32(slot), np.int32(prompt))
            pc, py = pprefill(pcarry[0], pparams, px, slot, prompt)
            jcarry, _ = jax_engine._inject_token_greedy((jc, jcarry[1]), np.int32(slot), jy,
                                                        self.jtable)
            pcarry, _ = pt_engine._inject_token_greedy((pc, pcarry[1]), slot, py, self.ptable)
        return jcarry, pcarry


def _clone(carry):
    cache, x = carry
    return cache._replace(**{f: getattr(cache, f).clone() for f in cache._fields}), x.clone()


def _same_carry(jcarry, pcarry, tol):
    assert np.array_equal(np.asarray(jcarry[0].lengths), pcarry[0].lengths.numpy())
    assert _max_diff(jcarry[0].k, pcarry[0].k) <= tol
    assert _max_diff(jcarry[0].v, pcarry[0].v) <= tol
    assert _max_diff(jcarry[1], pcarry[1]) <= tol


def _per_step_tokens(both, pcarry, steps):
    """The port's per-step greedy tokens ``[steps, B]`` from a copy of
    ``pcarry`` (the verify's oracle)."""
    step = pt_engine.build_decode_token_step(both.pcfg)
    carry, toks = _clone(pcarry), []
    for _ in range(steps):
        carry, tok = step(carry, both.pparams, both.ptable, torch.tensor(ACTIVE))
        toks.append(tok)
    return torch.stack(toks).numpy()


# ---------------------------------------------------------------------------
# the programs against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gamma", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(PROGRAM_CASES))
def test_verify_step_matches_jax(case, gamma):
    """Two verify units: the first with slot 1's drafts all the per-step
    tokens (its budget of 2 clamps the commits), slot 2's wrong from the
    first, slot 3's right for half of them; the second with drafts of
    zeros over the first's rejected rows.  Tokens and commits equal to
    JAX's, the committed tokens the per-step ones, the carry within the
    case's bound, lengths exact."""
    both = _Both(PROGRAM_CASES[case], seed=gamma)
    tol = _tol(both.fields)
    jcarry, pcarry = both.carries()
    oracle = _per_step_tokens(both, pcarry, gamma + 1)
    match = {1: gamma, 2: 0, 3: gamma // 2}
    drafts = np.zeros((4, gamma), np.int32)
    for s, m in match.items():
        drafts[s] = oracle[:gamma, s]
        drafts[s, m:] = (oracle[m:gamma, s] + 1) % H
    remaining = np.asarray([0, 2, 10, 10], np.int32)
    jverify = jax_engine.build_verify_step(both.jcfg, both.jmesh, gamma)
    pverify = pt_engine.build_verify_step(both.pcfg, gamma=gamma)
    lengths0 = pcarry[0].lengths.clone()
    for unit in range(2):
        jcarry, jtok, jcom = jverify(jcarry, both.jparams, both.jtable, jnp.asarray(drafts),
                                     jnp.asarray(ACTIVE), jnp.asarray(remaining))
        pcarry, ptok, pcom = pverify(pcarry, both.pparams, both.ptable,
                                     torch.from_numpy(drafts), torch.tensor(ACTIVE),
                                     torch.from_numpy(remaining))
        assert np.asarray(jtok).tolist() == ptok.tolist()
        assert np.asarray(jcom).tolist() == pcom.tolist()
        assert ptok.dtype == pcom.dtype == torch.int32 and tuple(ptok.shape) == (4, gamma + 1)
        _same_carry(jcarry, pcarry, tol)
        if unit == 0:
            want = [0] + [min(match[s] + 1, int(remaining[s])) for s in (1, 2, 3)]
            assert pcom.tolist() == want
            for s in (1, 2, 3):
                assert ptok[s, :want[s]].tolist() == oracle[:want[s], s].tolist()
            first = pcom.clone()
            remaining = remaining - first.numpy()
            drafts = np.zeros_like(drafts)
    assert pcarry[0].lengths.tolist() == (lengths0 + first + pcom).tolist()


def test_verify_writes_nothing_past_max_seq():
    """A verify whose window runs past ``max_seq`` writes the rows that fit
    and no other (JAX's one-hot write reaches no row past the end; an
    indexed write must not wrap), and an idle slot is left as it was."""
    cfg = ModelConfig(**TINY)
    params = params_from_jax(_jax_weights(TINY), cfg)
    cache = pt_kv.create_kv_cache(cfg, 2, 2, 4, device="cpu")
    cache.k.normal_()
    cache.lengths.copy_(torch.tensor([6, 3], dtype=torch.int32))
    k0 = cache.k.clone()
    table = pt_synth.token_embedding_table(H, torch.float32)
    (cache, _), _tok, commits = pt_engine.build_verify_step(cfg, gamma=4)(
        (cache, torch.randn(2, 1, H)), params, table, torch.zeros((2, 4), dtype=torch.int32),
        torch.tensor([True, False]), torch.tensor([1, 5], dtype=torch.int32))
    flat, flat0 = cache.k.reshape(2, 2, 8, 4, 16), k0.reshape(2, 2, 8, 4, 16)
    assert torch.equal(flat[:, 0, :6], flat0[:, 0, :6])
    assert not torch.equal(flat[:, 0, 6:], flat0[:, 0, 6:])
    assert torch.equal(flat[:, 1], flat0[:, 1])
    assert commits.tolist() == [1, 0] and cache.lengths.tolist() == [7, 3]


@pytest.mark.parametrize("gamma", [0, 4])
@pytest.mark.parametrize("case", sorted(PROGRAM_CASES))
def test_verify_probs_and_commit_match_jax(case, gamma):
    """The sampled verify's halves: ``verify_probs``' logits within the
    bound of JAX's, its carry's lengths and ``x`` unchanged, and a second
    call on the carry it returned the same bit for bit (cache included);
    then ``spec_commit`` with host-decided commits and ids, and the sampled
    inject into the idle slot, against JAX's."""
    both = _Both(PROGRAM_CASES[case], seed=10 + gamma)
    tol = _tol(both.fields)
    jcarry, pcarry = both.carries()
    drafts = np.random.default_rng(gamma).integers(0, H, (4, gamma), dtype=np.int32)
    jprobs = jax_engine.build_verify_probs(both.jcfg, both.jmesh, gamma)
    pprobs = pt_engine.build_verify_probs(both.pcfg, gamma=gamma)
    lengths0, x0 = pcarry[0].lengths.clone(), pcarry[1].clone()
    jcarry, jy = jprobs(jcarry, both.jparams, both.jtable, jnp.asarray(drafts),
                        jnp.asarray(ACTIVE))
    pcarry, py = pprobs(pcarry, both.pparams, both.ptable, torch.from_numpy(drafts),
                        torch.tensor(ACTIVE))
    assert tuple(py.shape) == (4, gamma + 1, H)
    assert _max_diff(jy, py) <= tol
    _same_carry(jcarry, pcarry, tol)
    assert torch.equal(pcarry[0].lengths, lengths0) and torch.equal(pcarry[1], x0)
    planes = (pcarry[0].k.clone(), pcarry[0].v.clone())
    pcarry, py2 = pprobs(pcarry, both.pparams, both.ptable, torch.from_numpy(drafts),
                         torch.tensor(ACTIVE))
    assert torch.equal(py2, py)
    assert torch.equal(pcarry[0].k, planes[0]) and torch.equal(pcarry[0].v, planes[1])
    commits = np.asarray([0, 1, min(2, gamma + 1), gamma + 1], np.int32)
    next_ids = np.asarray([0, 7, 19, 42], np.int32)
    jcarry = jax_engine.build_spec_commit(both.jcfg, both.jmesh)(
        jcarry, both.jtable, jnp.asarray(next_ids), jnp.asarray(commits), jnp.asarray(ACTIVE))
    pcarry = pt_engine.build_spec_commit(both.pcfg)(
        pcarry, both.ptable, torch.from_numpy(next_ids), torch.from_numpy(commits),
        torch.tensor(ACTIVE))
    _same_carry(jcarry, pcarry, tol)
    assert pcarry[0].lengths.tolist() == (lengths0 + torch.from_numpy(commits)).tolist()
    assert torch.equal(pcarry[1][1:, 0], both.ptable[next_ids[1:]])
    assert torch.equal(pcarry[1][0], x0[0])
    jcarry = jax_engine._inject_token_sampled(jcarry, np.int32(0), np.int32(33), both.jtable)
    pcarry = pt_engine._inject_token_sampled(pcarry, 0, 33, both.ptable)
    _same_carry(jcarry, pcarry, tol)
    assert torch.equal(pcarry[1][0, 0], both.ptable[33])


@pytest.mark.parametrize("case", sorted(PROGRAM_CASES))
def test_draft_scan_matches_jax(case):
    """The 1-layer draft model on its own cache: after the prefills, a
    4-step scan from the committed lengths, against JAX's (ids equal, the
    cache within the bound, lengths exact); then the scan again from the
    same committed lengths over the rows the first one wrote, the rollback
    after a full rejection, gives the same ids."""
    both = _Both(PROGRAM_CASES[case], seed=20)
    tol = _tol(both.fields)
    sv = pt_engine.ServingConfig(**SV, speculation="draft-model", spec_gamma=4)
    jdcfg = jax_engine.ServingConfig(**SV, speculation="draft-model",
                                     spec_gamma=4).draft_model_config(both.jcfg)
    pdcfg = sv.draft_model_config(both.pcfg)
    dweights = _jax_weights(dict(both.fields, num_layers=1), 21)
    jparams = jax.tree.map(jnp.asarray, dweights)
    pparams = params_from_jax(dweights, pdcfg)
    jdraft, pdraft = both.carries((jdcfg, pdcfg), (jparams, pparams))
    (_, jx), (_, px) = both.carries()
    lengths = np.asarray([0, 11, 5, 16], np.int32)
    jscan = jax_engine.build_draft_scan(jdcfg, both.jmesh, 4)
    pscan = pt_engine.build_draft_scan(pdcfg, gamma=4)
    jcache, jids = jscan(jdraft[0], jparams, both.jtable, jx, jnp.asarray(lengths),
                         jnp.asarray(ACTIVE))
    pcache, pids = pscan(pdraft[0], pparams, both.ptable, px, torch.from_numpy(lengths),
                         torch.tensor(ACTIVE))
    assert np.asarray(jids).tolist() == pids.tolist() and tuple(pids.shape) == (4, 4)
    _same_carry((jcache, jx), (pcache, px), tol)
    assert pcache.lengths.tolist() == (lengths + 4 * np.asarray(ACTIVE)).tolist()
    pcache, pids2 = pscan(pcache, pparams, both.ptable, px, torch.from_numpy(lengths),
                          torch.tensor(ACTIVE))
    assert torch.equal(pids2, pids)

# ---------------------------------------------------------------------------
# the host helpers against JAX's, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_helpers_match_jax_bit_for_bit(seed):
    """``_ngram_propose`` on random short-alphabet histories; ``softmax_np``
    on fp32 logits and on bf16 logits as each side hands them over (JAX's
    bfloat16 array, the port's ``y.float().cpu().numpy()``);
    ``residual_distribution`` and ``speculative_sample`` (one-hot and dense
    drafts) on two generators seeded alike: equal bit for bit, and the two
    generators still in step at the end."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        hist = rng.integers(0, int(rng.integers(2, 6)), int(rng.integers(1, 30))).tolist()
        gamma = int(rng.integers(1, 9))
        assert pt_engine._ngram_propose(list(hist), gamma) == \
            jax_engine._ngram_propose(list(hist), gamma)
    logits = (rng.standard_normal((6, H)) * 4).astype(np.float32)
    jbf = jnp.asarray(logits, jnp.bfloat16)
    pbf = torch.from_numpy(logits).to(torch.bfloat16)
    for t in (0.3, 0.8, 1.7):
        assert np.array_equal(pt_engine.softmax_np(logits, t), jax_engine.softmax_np(logits, t))
        assert np.array_equal(pt_engine.softmax_np(pbf.float().numpy(), t),
                              jax_engine.softmax_np(np.asarray(jbf), t))
    p = jax_engine.softmax_np(logits, 0.8)
    q = jax_engine.softmax_np(rng.standard_normal((6, H)), 1.0)
    for j in range(6):
        assert np.array_equal(pt_engine.residual_distribution(p[j], q[j]),
                              jax_engine.residual_distribution(p[j], q[j]))
    rng_p, rng_j = np.random.default_rng(seed + 100), np.random.default_rng(seed + 100)
    for _ in range(100):
        j, draft = int(rng.integers(0, 6)), int(rng.integers(0, H))
        onehot = np.zeros(H)
        onehot[draft] = 1.0
        for qd in (onehot, q[j]):
            assert pt_engine.speculative_sample(p[j], qd, draft, rng_p) == \
                jax_engine.speculative_sample(p[j], qd, draft, rng_j)
    assert rng_p.uniform() == rng_j.uniform()


# ---------------------------------------------------------------------------
# tests/test_speculative.py, mirrored on the port
# ---------------------------------------------------------------------------

MODEL = ModelConfig(**TINY)
SERVE = dict(max_batch=8, block_size=8, max_seq=96, hbm_budget_gb=None)


def test_spec_config_validation_ladder():
    with pytest.raises(ValueError, match="speculation"):
        pt_engine.ServingConfig(**SERVE, speculation="turbo").validate(MODEL)
    with pytest.raises(ValueError, match="spec_gamma"):
        pt_engine.ServingConfig(**SERVE, speculation="ngram").validate(MODEL)
    with pytest.raises(ValueError, match="drafting"):
        pt_engine.ServingConfig(**SERVE, spec_gamma=4).validate(MODEL)
    with pytest.raises(ValueError, match="drafting"):
        pt_engine.ServingConfig(**SERVE, speculation="greedy", spec_gamma=4).validate(MODEL)
    with pytest.raises(ValueError, match="exceed"):
        pt_engine.ServingConfig(**SERVE, speculation="ngram", spec_gamma=96).validate(MODEL)
    with pytest.raises(ValueError, match="spec_adaptive"):
        pt_engine.ServingConfig(**SERVE, spec_adaptive=True).validate(MODEL)
    with pytest.raises(ValueError, match="compact"):
        pt_engine.ServingConfig(**SERVE, speculation="ngram", spec_gamma=4, decode_horizon=16,
                                compact_threshold=0.5).validate(MODEL)
    with pytest.raises(ValueError, match="spec_draft_layers"):
        pt_engine.ServingConfig(**SERVE, speculation="draft-model", spec_gamma=4,
                                spec_draft_layers=0).validate(MODEL)


def test_ngram_propose_pure_and_cyclic():
    hist = [1, 2, 5, 6, 7, 5, 6, 7]
    got = pt_engine._ngram_propose(hist, gamma=5)
    assert got == [5, 6, 7, 5, 6]
    assert pt_engine._ngram_propose(list(hist), gamma=5) == got
    assert pt_engine._ngram_propose([1, 2, 3], gamma=4) is None
    assert pt_engine._ngram_propose([9, 4, 4, 8, 9, 4], gamma=2) == [4, 8]


def test_residual_distribution_degenerates_to_p():
    p = np.array([0.5, 0.3, 0.2])
    assert np.allclose(pt_engine.residual_distribution(p, np.ones(3)), p)
    r = pt_engine.residual_distribution(p, np.array([0.1, 0.6, 0.3]))
    assert np.isclose(r.sum(), 1.0)
    assert r[1] == 0.0 and r[2] == 0.0 and r[0] == 1.0


def test_speculative_sample_distribution_identity():
    """The accept/residual composite law is the target law: 20,000 draws
    within 1.5e-2 of ``p`` (4 sigma of a binomial at n = 20k on the largest
    cell is about 1.4e-2)."""
    rng = np.random.default_rng(0)
    p = np.array([0.45, 0.35, 0.15, 0.05])
    q = np.array([0.10, 0.60, 0.20, 0.10])
    n = 20000
    counts = np.zeros(4)
    for _ in range(n):
        draft = rng.choice(4, p=q)
        tok, _accepted = pt_engine.speculative_sample(p, q, draft, rng)
        counts[tok] += 1
    assert np.abs(counts / n - p).max() < 0.015


def test_sampled_validation_ladder():
    with pytest.raises(ValueError, match="requires a drafting"):
        pt_engine.ServingConfig(**SERVE, temperature=0.8).validate(MODEL)
    with pytest.raises(ValueError, match="decode_horizon=1"):
        pt_engine.ServingConfig(**SERVE, speculation="ngram", spec_gamma=4, temperature=0.8,
                                decode_horizon=16).validate(MODEL)
    with pytest.raises(ValueError, match="prefill_chunk"):
        pt_engine.ServingConfig(**SERVE, speculation="ngram", spec_gamma=4, temperature=0.8,
                                prefill_chunk=16).validate(MODEL)
    with pytest.raises(ValueError, match="requires temperature"):
        pt_engine.ServingConfig(**SERVE, sample_seed=3).validate(MODEL)
    with pytest.raises(ValueError, match=">= 0"):
        pt_engine.ServingConfig(**SERVE, temperature=-0.1).validate(MODEL)


# ---------------------------------------------------------------------------
# whole engines against JAX's
# ---------------------------------------------------------------------------


def _spec_trace(n=8, seed=7, out=(40, 56)):
    """``tests/test_speculative.py``'s motif trace (period-4 prompts warm
    the n-gram drafter from the first decode) with every arrival at t=0."""
    return _at_t0(jax_traffic.generate_trace("poisson", n, seed=seed, rate=500.0,
                                             prompt_range=(8, 16), output_range=out,
                                             prompt_period=4))


def _trace_of(name):
    if name == "t8":
        return _spec_trace()
    if name == "t6":
        return _spec_trace(n=6, out=(24, 32))
    if name == "mid":
        # period-4 prompts: the drafter is warm from the first decode, so
        # the first verify overshoots rid 0's 3-token budget
        return jax_traffic.TrafficTrace(kind="poisson", seed=0, params={}, requests=(
            jax_traffic.Request(rid=0, arrival_s=0.0, prompt_len=8, output_len=3, seed=11,
                                prompt_period=4),
            jax_traffic.Request(rid=1, arrival_s=0.0, prompt_len=8, output_len=24, seed=12,
                                prompt_period=4)))
    # random prompts (no period): the drafter is cold at admission
    return _at_t0(jax_traffic.generate_trace("poisson", 6, seed=13, rate=500.0,
                                             prompt_range=(4, 8), output_range=(30, 40)))


NGRAM = dict(speculation="ngram", spec_gamma=4)
DRAFT = dict(speculation="draft-model", spec_gamma=4, spec_draft_layers=1)
SAMPLED = dict(NGRAM, temperature=0.8, sample_seed=3)
# name: (serving knobs, trace)
W1_RUNS = {
    "ngram_fused": (dict(NGRAM, decode_horizon=16), "t8"),
    "greedy_fused": (dict(speculation="greedy", decode_horizon=16), "t8"),
    "ngram_g8": (dict(speculation="ngram", spec_gamma=8), "t8"),
    "adaptive": (dict(speculation="ngram", spec_gamma=8, spec_adaptive=True,
                      decode_horizon=16), "t8"),
    "draft": (DRAFT, "t6"),
    "mid": (dict(speculation="ngram", spec_gamma=8), "mid"),
    "cold": (NGRAM, "cold"),
    "sampled": (SAMPLED, "t6"),
}


def _sequence(events):
    return [(e["event"], e["config"]) for e in events
            if e["event"].startswith(("request-", "prefix-", "spec-"))]


def _run_jax(fields, knobs, trace, mesh, tmp_path, name):
    """JAX's engine on ``trace`` with its host uploads copied: its report,
    journal sequence, counters, and weights and draft weights (numpy)."""
    engine = jax_engine.ServingEngine(jax_configs.ModelConfig(**fields),
                                      jax_engine.ServingConfig(**SERVE, **knobs), mesh,
                                      verbose=False, capture_tokens=True)
    journal = JaxJournal(tmp_path / name)
    engine.journal = journal
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "jnp", _CopyingJnp())
        report = engine.run_trace(trace)
    journal.close()
    events, _ = jax_read_journal(tmp_path / name)
    draft = engine._draft_params
    return {"report": report, "journal": _sequence(events),
            "counters": torch_serve_worker.spec_counters(engine.registry),
            "weights": jax.tree.map(np.asarray, engine.params),
            "draft": None if draft is None else jax.tree.map(np.asarray, draft)}


def _run_port(fields, knobs, trace, ref, tmp_path, name):
    """The port at world 1 on ``trace`` with ``ref``'s weights."""
    cfg = ModelConfig(**fields)
    sv = pt_engine.ServingConfig(**SERVE, **knobs)
    draft = (None if ref.get("draft") is None
             else params_from_jax(ref["draft"], sv.draft_model_config(cfg)))
    engine = pt_engine.ServingEngine(cfg, sv, params=params_from_jax(ref["weights"], cfg),
                                     draft_params=draft, verbose=False, capture_tokens=True,
                                     device="cpu")
    journal = SweepJournal(tmp_path / name)
    engine.journal = journal
    report = engine.run_trace(TrafficTrace.from_dict(trace.to_dict()))
    journal.close()
    events, _ = read_journal(tmp_path / name)
    return {"report": report, "journal": _sequence(events),
            "counters": torch_serve_worker.spec_counters(engine.registry)}


def _spec_stats(report):
    return {k: v for k, v in report["speculation"].items() if k != "draft_overhead_s"}


def _same_spec_run(got, ref):
    """Tokens, outcomes, unit counts, the ledger, the speculation section
    (but its host wall time), the counters and the journal's order equal."""
    _same_run(got["report"], ref["report"])
    assert _spec_stats(got["report"]) == _spec_stats(ref["report"])
    assert got["counters"] == ref["counters"]
    assert got["journal"] == ref["journal"]


@pytest.fixture(scope="module")
def w1(tmp_path_factory):
    """JAX's engines at world 1 on ``W1_RUNS``, and the port's per-step
    "greedy" oracle on each trace with JAX's weights."""
    tmp = tmp_path_factory.mktemp("spec_w1")
    mesh = jax_parallelism_mesh(devices=jax.devices()[:1])
    out = {name: _run_jax(TINY, knobs, _trace_of(trace), mesh, tmp, name)
           for name, (knobs, trace) in W1_RUNS.items()}
    weights = {"weights": out["ngram_fused"]["weights"]}
    for trace in ("t8", "t6", "mid", "cold"):
        out[f"oracle/{trace}"] = _run_port(TINY, dict(speculation="greedy"), _trace_of(trace),
                                           weights, tmp, f"oracle_{trace}")
    return out


def _port_w1(w1, name, tmp_path):
    knobs, trace = W1_RUNS[name]
    ref = w1[name]
    got = _run_port(TINY, knobs, _trace_of(trace), ref, tmp_path, name)
    _same_spec_run(got, ref)
    oracle = w1[f"oracle/{trace}"]["report"]
    assert got["report"]["completed_tokens"] == oracle["completed_tokens"]
    return got["report"], oracle


def test_ngram_fused_matches_oracle(w1, tmp_path):
    """N-gram drafting on the fused fast path equal to JAX's engine and
    token-identical to the per-step greedy oracle, with verify traffic,
    accepted drafts, fewer units than steps and a clean ledger."""
    spec, base = _port_w1(w1, "ngram_fused", tmp_path)
    assert spec["requests"]["completed"] == base["requests"]["completed"] == 8
    s = spec["speculation"]
    assert s["mode"] == "ngram" and s["gamma"] == 4
    assert s["verify_units"] > 0
    assert s["proposed_tokens"] >= s["accepted_tokens"] > 0
    assert 0.0 < s["acceptance_rate"] <= 1.0
    assert spec["decode_units"] < spec["decode_steps"]
    assert spec["cache"]["blocks_reserved"] == 0


def test_draft_model_matches_oracle(w1, tmp_path):
    """The 1-layer draft model on its own cache (JAX's draft weights
    carried across) equal to JAX's engine and token-identical to the
    oracle."""
    spec, _ = _port_w1(w1, "draft", tmp_path)
    assert spec["speculation"]["verify_units"] > 0
    assert spec["speculation"]["mode"] == "draft-model"
    assert spec["cache"]["blocks_reserved"] == 0


def test_greedy_fused_and_ngram_per_step_match_oracle(w1, tmp_path):
    fused, _ = _port_w1(w1, "greedy_fused", tmp_path)
    assert fused["fast_path"]["fused_scans"] > 0
    perstep, _ = _port_w1(w1, "ngram_g8", tmp_path)
    assert perstep["speculation"]["verify_units"] > 0


def test_adaptive_gamma_matches_oracle(w1, tmp_path):
    """Adaptive γ changes which verify widths run (JAX's widths, by the
    journal's gamma arguments), never which tokens commit."""
    spec, _ = _port_w1(w1, "adaptive", tmp_path)
    assert spec["speculation"]["adaptive"] is True
    assert spec["speculation"]["verify_units"] > 0


def test_mid_verify_completion_clamps_commits(w1, tmp_path):
    report, _ = _port_w1(w1, "mid", tmp_path)
    assert len(report["completed_tokens"]["0"]) == 3
    assert len(report["completed_tokens"]["1"]) == 24
    assert report["requests"]["completed"] == 2
    assert report["cache"]["blocks_reserved"] == 0


def test_cold_drafter_falls_back_to_plain_decode(w1, tmp_path):
    report, _ = _port_w1(w1, "cold", tmp_path)
    assert report["speculation"]["fallback_units"] > 0


def test_sampled_run_matches_jax(w1, tmp_path):
    """The sampled run ("ngram", γ=4, temperature 0.8, seed 3) token for
    token JAX's: both draw from ``np.random.default_rng(3)`` in the same
    order over host softmaxes of logits that differ by fp32 ulps across the
    frameworks, so a token could flip only where a uniform draw lands
    within about 1e-6 of a cumulative-probability boundary."""
    ref = w1["sampled"]
    got = _run_port(TINY, SAMPLED, _trace_of("t6"), ref, tmp_path, "port")
    _same_spec_run(got, ref)
    s = got["report"]["speculation"]
    assert s["sampled"] is True and s["verify_units"] > 0
    assert got["counters"]["serve_sampled_tokens[]"] > 0


def test_sampled_run_replayable_and_seed_sensitive(w1, tmp_path):
    trace = _trace_of("t6")
    ref = w1["sampled"]
    a = _run_port(TINY, SAMPLED, trace, ref, tmp_path, "a")["report"]
    b = _run_port(TINY, SAMPLED, trace, ref, tmp_path, "b")["report"]
    c = _run_port(TINY, dict(SAMPLED, sample_seed=4), trace, ref, tmp_path, "c")["report"]
    assert a["requests"]["completed"] == len(trace)
    assert a["completed_tokens"] == b["completed_tokens"]
    assert a["completed_tokens"] != c["completed_tokens"]
    s = a["speculation"]
    assert s["sampled"] is True
    assert s["temperature"] == 0.8 and s["sample_seed"] == 3
    assert s["verify_units"] > 0
    assert a["cache"]["blocks_reserved"] == 0


def test_spec_verify_journal_events_and_metrics(w1, tmp_path):
    """One ``spec-verify`` journal event per slot and verify unit (gamma,
    accepted, committed in range), an un-torn journal, one ``serve-verify``
    span per verify unit, and the speculation counters in the registry's
    Prometheus text, equal to the report's."""
    knobs, trace = W1_RUNS["ngram_fused"]
    engine = pt_engine.ServingEngine(
        MODEL, pt_engine.ServingConfig(**SERVE, **knobs),
        params=params_from_jax(w1["ngram_fused"]["weights"], MODEL), verbose=False,
        device="cpu")
    journal = SweepJournal(tmp_path, meta={"mode": "serve"}, sink=spans.journal_sink)
    engine.journal = journal
    try:
        with spans.tracing(tmp_path / "trace.json"):
            report = engine.run_trace(TrafficTrace.from_dict(_trace_of(trace).to_dict()))
    finally:
        engine.journal = None
        journal.close()
    events, torn = read_journal(tmp_path)
    assert torn == 0
    verifies = [e for e in events if e["event"] == "spec-verify"]
    assert len(verifies) > 0
    for e in verifies:
        assert 1 <= e["gamma"] <= 4
        assert 0 <= e["accepted"] <= e["gamma"]
        assert 1 <= e["committed"] <= e["gamma"] + 1
    s = report["speculation"]
    begins = [e for e in spans.load_trace(tmp_path / "trace.json")["traceEvents"]
              if e["ph"] == "B"]
    assert sum(e["name"] == "serve-verify" for e in begins) == s["verify_units"]
    assert sum(e["name"] == "serve-decode" for e in begins) == \
        report["decode_units"] - s["verify_units"]
    prom = engine.registry.to_prometheus()
    for name in ("serve_spec_proposed_total", "serve_spec_accepted_total",
                 "serve_spec_acceptance_ema"):
        assert name in prom
    assert engine.registry.get("serve_spec_proposed_total", drafter="ngram") == \
        s["proposed_tokens"]
    assert engine.registry.get("serve_spec_accepted_total", drafter="ngram") == \
        s["accepted_tokens"]


@pytest.mark.parametrize("variant", ["tp2_gqa", "bf16"])
def test_identity_across_model_variants(variant, request, tmp_path):
    """Token identity under n-gram drafting on the fused scan, against the
    variant's own per-step greedy oracle (same weights, same mesh), with
    the ledger in the never-drafted state: a tp=2 GQA model on 2 gloo
    ranks (one kv head per rank), and the bf16 model at world 1."""
    if variant == "tp2_gqa":
        _refs, ranks = request.getfixturevalue("tp2")
        pairs = [(rank["ngram"], rank["oracle/t6"]) for rank in ranks]
    else:
        fields = dict(TINY, dtype="bfloat16")
        ref = {"weights": _jax_weights(fields)}
        trace = _trace_of("t6")
        base = _run_port(fields, dict(speculation="greedy"), trace, ref, tmp_path, "base")
        spec = _run_port(fields, dict(NGRAM, decode_horizon=16), trace, ref, tmp_path, "spec")
        pairs = [(spec["report"], base["report"])]
    for spec, base in pairs:
        assert spec["completed_tokens"] == base["completed_tokens"]
        assert spec["speculation"]["verify_units"] > 0
        for key in ("total_blocks", "blocks_reserved", "blocks_in_use"):
            assert spec["cache"][key] == base["cache"][key]


# ---------------------------------------------------------------------------
# on gloo ranks
# ---------------------------------------------------------------------------

# name: (serving knobs, trace); each also runs the port's "greedy" oracle
TP2_RUNS = {"ngram": (dict(NGRAM, decode_horizon=16), "t6"), "draft": (DRAFT, "t6")}
DP2_TP4_RUNS = {"ngram": (dict(NGRAM, decode_horizon=16), "t8"), "draft": (DRAFT, "t6"),
                "sampled": (SAMPLED, "t6")}


def _rank_runs(dp, tp, fields, runs, refs):
    """The worker's runs: each of ``runs`` with its JAX reference's weights,
    and the greedy oracle on each trace."""
    out = {}
    for name, (knobs, trace) in runs.items():
        ref = refs[name]
        out[name] = (dp, tp, fields, dict(SERVE, **knobs), ref["weights"],
                     _trace_of(trace).to_dict(), ref["draft"])
    for trace in {t for _, t in runs.values()}:
        out[f"oracle/{trace}"] = (dp, tp, fields, dict(SERVE, speculation="greedy"),
                                  refs[next(iter(runs))]["weights"], _trace_of(trace).to_dict())
    return out


def _same_rank_run(got, ref, oracle):
    _same_spec_run({"report": got, "journal": got["journal"], "counters": got["counters"]},
                   ref)
    assert got["completed_tokens"] == oracle["completed_tokens"]


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """tp=2 with GQA (one kv head per rank): JAX's engines on a 2-device
    mesh, then the port on 2 gloo ranks with their weights."""
    tmp = tmp_path_factory.mktemp("spec_tp2")
    mesh = jax_parallelism_mesh(tensor_parallel=2, devices=jax.devices()[:2])
    refs = {name: _run_jax(GQA, knobs, _trace_of(trace), mesh, tmp, name)
            for name, (knobs, trace) in TP2_RUNS.items()}
    ranks = launch(torch_serve_worker.run_engines, 2, "cpu",
                   args=(_rank_runs(1, 2, GQA, TP2_RUNS, refs),), timeout=300,
                   group_timeout=120)
    return refs, ranks


@pytest.mark.parametrize("name", sorted(TP2_RUNS))
def test_spec_engines_at_tp2_match_jax(tp2, name):
    """n-gram (fused) and draft-model speculation at tp=2, GQA, over gloo:
    on both ranks equal to JAX's engine at tp=2 and to the port's greedy
    oracle."""
    refs, ranks = tp2
    trace = TP2_RUNS[name][1]
    for rank in ranks:
        _same_rank_run(rank[name], refs[name], rank[f"oracle/{trace}"])
    assert ranks[0][name]["speculation"]["verify_units"] > 0


@pytest.fixture(scope="module")
def dp2_tp4(mesh2x4, tmp_path_factory):
    """dp=2 x tp=4: JAX's engines on its mesh, then the port on 8 gloo
    ranks with their weights."""
    tmp = tmp_path_factory.mktemp("spec_2x4")
    refs = {name: _run_jax(TINY, knobs, _trace_of(trace), mesh2x4, tmp, name)
            for name, (knobs, trace) in DP2_TP4_RUNS.items()}
    ranks = launch(torch_serve_worker.run_engines, 8, "cpu",
                   args=(_rank_runs(2, 4, TINY, DP2_TP4_RUNS, refs),), timeout=300,
                   group_timeout=120)
    return refs, ranks


@pytest.mark.parametrize("name", sorted(DP2_TP4_RUNS))
def test_spec_engines_dp2_tp4_match_jax(dp2_tp4, name):
    """At dp=2 x tp=4 every rank takes JAX's decisions: the verify's tokens
    and commits gathered over dp, the cold check over every slot's history,
    the sampled path's logits gathered so every rank draws alike; tokens,
    counters, the speculation section and the journal equal to JAX's engine
    on the same mesh (and, greedy, to the port's oracle) on all 8 ranks."""
    refs, ranks = dp2_tp4
    trace = DP2_TP4_RUNS[name][1]
    for rank in ranks:
        got = rank[name]
        if name == "sampled":
            _same_spec_run({"report": got, "journal": got["journal"],
                            "counters": got["counters"]}, refs[name])
        else:
            _same_rank_run(got, refs[name], rank[f"oracle/{trace}"])
    assert ranks[0][name]["speculation"]["verify_units"] > 0


# ---------------------------------------------------------------------------
# the tests that waited for part 11d and item 12
# ---------------------------------------------------------------------------


def test_decode_fail_during_verify_retries_cleanly(w1, tmp_path):
    """serve-decode-fail at the verify dispatch: the host rollback (both
    ledgers' snapshot and the slots' lengths) replays the unit, and the
    completed tokens equal the unfaulted oracle's; the run equals JAX's
    faulted run."""
    knobs = dict(NGRAM, decode_horizon=16)
    trace = _trace_of("t6")
    mesh = jax_parallelism_mesh(devices=jax.devices()[:1])
    with jax_inject.plan_scope("serve-decode-fail:1"):
        ref = _run_jax(TINY, knobs, trace, mesh, tmp_path, "jax")
    with pt_inject.plan_scope("serve-decode-fail:1"):
        got = _run_port(TINY, knobs, trace, {"weights": w1["ngram_fused"]["weights"]},
                        tmp_path, "port")
    _same_spec_run(got, ref)
    report = got["report"]
    assert report["resilience"] == {k: v for k, v in ref["report"]["resilience"].items()}
    assert report["resilience"]["retries"] >= 1
    assert report["requests"]["completed"] == len(trace)
    assert report["completed_tokens"] == w1["oracle/t6"]["report"]["completed_tokens"]
    assert report["speculation"]["verify_units"] > 0
    assert report["cache"]["blocks_reserved"] == 0


def test_serving_report_spec_columns(tmp_path):
    from test_torch_serve_resilience import write_both_reports

    fake = {
        "schema": "dlbb_serving_report_v1",
        "trace": {"kind": "poisson", "num_requests": 4},
        "requests": {"arrived": 4, "completed": 4, "rejected": 0, "shed_rate": 0.0,
                     "rejected_detail": []},
        "mesh": {"dp": 2, "tp": 4},
        "serving": {"max_batch": 8, "block_size": 8, "max_seq": 96},
        "speculation": {"mode": "ngram", "gamma": 4, "adaptive": False,
                        "verify_units": 10, "fallback_units": 2,
                        "proposed_tokens": 40, "accepted_tokens": 25,
                        "acceptance_rate": 0.625, "mean_accepted_len": 3.5,
                        "draft_overhead_s": 0.01},
        "goodput_tokens_per_s": 100.0,
        "ttft": {"median": 0.01, "p99": 0.02, "p999": 0.03},
        "per_token_latency": {"median": 0.001, "p99": 0.002, "p999": 0.003},
        "cache": {"peak_blocks_in_use": 12},
        "timeseries": {"queue_depth": [0, 1]},
        "decode_steps": 42,
        "wall_seconds": 1.5,
    }
    rows, md, _csv = write_both_reports(tmp_path, {"specrun": fake})
    assert len(rows) == 1
    assert rows[0]["speculation"] == "ngram" and rows[0]["spec_gamma"] == 4
    assert rows[0]["acceptance_rate"] == 0.625 and rows[0]["mean_accepted_len"] == 3.5
    assert "ngram" in md
