"""The port's flash attention forward against the JAX package's Pallas kernel.

The same numpy inputs (seeded) go through the JAX ``_fwd`` (the
``pallas_call`` of ``_fwd_kernel``, in interpret mode on the CPU as the JAX
package's own tests run it) and through the port's ``flash_attention_fwd``,
which on CPU tensors is the plain PyTorch version that ``chip_smoke.py``
holds the CUDA kernel against.

Tolerances: fp32 1e-4, as ``tests/test_flash_attention.py`` uses (both sides
compute in fp32; only the summation order differs).  bf16 outputs are
compared in float32 at 2e-2: both sides round P and o to bf16 (8 mantissa
bits), from statistics that may differ in the last fp32 bit, so a value can
land one bf16 ulp apart.  lse is fp32 on both sides: 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlbb_tpu.ops.flash_attention import _fwd, flash_attention as jax_flash
from dlbb_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_TOL = 1e-4


def _inputs(seed, b, n, kvh, s, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, s, d), dtype=np.float32),
            rng.standard_normal((b, kvh, sk, d), dtype=np.float32),
            rng.standard_normal((b, kvh, sk, d), dtype=np.float32))


def _jax_fwd(q, k, v, dtype, causal, block_q=1024):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    b, n, s, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    o, lse = _fwd(jnp.asarray(q, jd).reshape(b * n, s, d),
                  jnp.asarray(k, jd).reshape(b * kvh, sk, d),
                  jnp.asarray(v, jd).reshape(b * kvh, sk, d),
                  d ** -0.5, causal, block_q, 1024, True)
    return (np.asarray(o, np.float32).reshape(b, n, s, d),
            np.asarray(lse)[..., 0].reshape(b, n, s))


def _torch_fwd(q, k, v, dtype, causal):
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    o, lse = fa.flash_attention_fwd(*(torch.from_numpy(t).to(td) for t in (q, k, v)),
                                    causal=causal)
    assert o.dtype == td and lse.dtype == torch.float32
    return o.float().numpy(), lse.numpy()


CASES = [
    # (b, n, kvh, s, sk, d, causal)
    pytest.param(1, 4, kvh, 128, 128, 64, causal, id=f"kvh{kvh}-{'causal' if causal else 'full'}")
    for kvh in (1, 2, 4) for causal in (True, False)
] + [
    pytest.param(2, 4, 2, 96, 96, 64, True, id="ragged-s96"),
    pytest.param(1, 4, 4, 1, 128, 64, True, id="decode-s1-sk128"),
    pytest.param(1, 4, 1, 16, 256, 64, True, id="decode-s16-sk256-mqa"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,kvh,s,sk,d,causal", CASES)
def test_flash_fwd_matches_jax_kernel(b, n, kvh, s, sk, d, causal, dtype):
    q, k, v = _inputs(s * 31 + kvh, b, n, kvh, s, sk, d)
    o_j, lse_j = _jax_fwd(q, k, v, dtype, causal)
    o_t, lse_t = _torch_fwd(q, k, v, dtype, causal)
    np.testing.assert_allclose(o_t, o_j, atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(lse_t, lse_j, atol=LSE_TOL, rtol=LSE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_rows_are_zero(dtype):
    """Sk < S, causal: rows 0..S-Sk-1 see no key.  JAX gives o = 0 and
    lse = NEG_INF where its block skip covers those rows (block_q = 128
    here); the port gives that for every such row, at any tiling."""
    b, n, kvh, s, sk, d = 1, 2, 2, 256, 128, 64
    q, k, v = _inputs(5, b, n, kvh, s, sk, d)
    o_j, lse_j = _jax_fwd(q, k, v, dtype, True, block_q=128)
    o_t, lse_t = _torch_fwd(q, k, v, dtype, True)
    masked = s - sk
    assert (o_t[:, :, :masked] == 0).all() and (o_j[:, :, :masked] == 0).all()
    assert (lse_t[:, :, :masked] <= fa.NEG_INF / 2).all()
    np.testing.assert_allclose(o_t, o_j, atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(lse_t, lse_j, atol=LSE_TOL, rtol=LSE_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_public_flash_attention_matches_jax(causal):
    q, k, v = _inputs(9, 2, 4, 2, 64, 64, 32)
    o_j = np.asarray(jax_flash(*(jnp.asarray(t) for t in (q, k, v)), causal=causal,
                               interpret=True))
    o_t = fa.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal)
    np.testing.assert_allclose(o_t.numpy(), o_j, atol=1e-4, rtol=1e-4)


def test_cpu_tensors_take_the_plain_version_without_counting(monkeypatch):
    def no_kernel(*a, **kw):
        raise AssertionError("a CPU tensor reached the CUDA wrapper")

    monkeypatch.setattr(fa, "_flash_fwd_cuda", no_kernel)
    before = fa.flash_fwd_launches
    q, k, v = (torch.from_numpy(t) for t in _inputs(1, 1, 2, 2, 16, 16, 64))
    fa.flash_attention(q, k, v)
    assert fa.flash_fwd_launches == before


def test_cuda_wrapper_refuses_what_the_kernel_cannot_take():
    q, k, v = (torch.from_numpy(t).bfloat16() for t in _inputs(1, 1, 2, 2, 16, 16, 64))
    with pytest.raises(ValueError, match="CUDA device"):
        fa._flash_fwd_cuda(q, k, v, causal=True, sm_scale=0.125)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


@pytest.mark.parametrize("shape,dtype,ok", [
    ((1, 16, 512, 128), torch.bfloat16, True),
    ((1, 16, 512, 64), torch.bfloat16, True),
    ((1, 16, 512, 96), torch.bfloat16, False),
    ((1, 16, 512, 128), torch.float32, False),
])
def test_kernel_accepts(shape, dtype, ok):
    assert fa.kernel_accepts(shape, dtype) is ok


def test_shape_errors():
    q, k, v = (torch.from_numpy(t) for t in _inputs(1, 1, 3, 2, 16, 16, 8))
    with pytest.raises(ValueError, match="not divisible"):
        fa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="expected"):
        fa.flash_attention(q[0], k, v)


@pytest.mark.parametrize("s,sk", [(1, 1), (7, 7), (5, 12), (12, 5), (1, 64), (64, 1),
                                  (0, 4), (128, 384), (384, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_flops_count_the_visible_pairs(s, sk, causal):
    """``kernel_flops`` (the graph nodes' price) against a brute-force count
    of the mask's (row, key) pairs: key ``c`` visible to row ``r`` when
    ``c <= r + sk - s`` under the causal mask, every key otherwise."""
    mask = np.tril(np.ones((s, sk), dtype=bool), k=sk - s) if causal else \
        np.ones((s, sk), dtype=bool)
    pairs = int(mask.sum())
    assert fa.visible_pairs(s, sk, causal) == pairs
    b, n, d = 2, 3, 64
    for kernel, per_pair in (("fwd", 4), ("dq", 6), ("dkv", 8)):
        assert fa.kernel_flops(kernel, b, n, s, sk, d, causal) == per_pair * d * pairs * b * n
