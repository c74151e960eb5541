"""The port's flash attention backward against the JAX package's.

The same numpy inputs (seeded) go through the JAX flash attention (the
``pallas_call``s of ``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel``, in
interpret mode on the CPU as the JAX package's own tests run them) and
through the port, whose CPU path is the plain PyTorch version that
``chip_smoke.py`` holds the CUDA kernels against:

- end to end: ``jax.vjp`` of ``flash_attention`` against ``backward()``
  through the port's differentiable ``flash_attention`` (its
  ``torch.autograd.Function``), for one random output gradient;
- the backward alone: ``_bwd`` and ``flash_attention_bwd`` on the same
  ``(q, k, v, o, lse, dO)``.

Tolerances: fp32 1e-4, as ``tests/test_flash_attention.py`` uses (both sides
compute in fp32; only the summation order differs).  bf16 gradients are
compared in float32 at 3e-2 absolute and relative: both sides round p and
ds to bf16 before their products and the results to bf16 (8 mantissa bits,
4e-3 relative), from fp32 scores summed in another order, so a term can
land one bf16 ulp apart, and dk/dv sum such terms over S rows and the query
heads of a group; end to end each side also rounds its own forward output,
which enters delta = rowsum(dO * O).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlbb_tpu.ops.flash_attention import _bwd, _fwd, flash_attention as jax_flash
from dlbb_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, n, kvh, s, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, s, d), dtype=np.float32),
            rng.standard_normal((b, kvh, sk, d), dtype=np.float32),
            rng.standard_normal((b, kvh, sk, d), dtype=np.float32),
            rng.standard_normal((b, n, s, d), dtype=np.float32))


def _np(x):
    return np.asarray(x, np.float32)


def _jax_grads(q, k, v, do, dtype, causal, block=1024):
    jq, jk, jv, jdo = (jnp.asarray(t, JD[dtype]) for t in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b_, c: jax_flash(a, b_, c, causal=causal, block_q=block,
                                                 block_k=block, interpret=True), jq, jk, jv)
    return [_np(g) for g in vjp(jdo)]


def _torch_grads(q, k, v, do, dtype, causal):
    tq, tk, tv = (torch.from_numpy(t).to(TD[dtype]).requires_grad_(True) for t in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal=causal)
    o.backward(torch.from_numpy(do).to(TD[dtype]))
    for t in (tq, tk, tv):
        assert t.grad.dtype == TD[dtype]
    return [t.grad.float().numpy() for t in (tq, tk, tv)]


CASES = [
    # (b, n, kvh, s, sk, d, causal)
    pytest.param(1, 4, kvh, 128, 128, 64, causal, id=f"kvh{kvh}-{'causal' if causal else 'full'}")
    for kvh in (1, 2, 4) for causal in (True, False)
] + [
    pytest.param(2, 4, 2, 96, 96, 64, True, id="ragged-s96"),
    pytest.param(1, 4, 4, 1, 128, 64, True, id="decode-s1-sk128"),
    pytest.param(1, 4, 1, 16, 256, 64, True, id="decode-s16-sk256-mqa"),
    # at the edges of the CUDA kernels' tiles (128-row and 64-row Q tiles,
    # 64-key and 128-key K/V tiles), as chip_smoke.py's EDGE_CASES
    pytest.param(1, 4, 4, 130, 130, 64, True, id="ragged-s130"),
    pytest.param(1, 2, 2, 320, 320, 64, True, id="partial-q-tile-s320"),
    pytest.param(1, 2, 2, 64, 192, 64, False, id="noncausal-s64-sk192"),
    pytest.param(1, 8, 1, 128, 128, 64, True, id="gqa-g8"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,kvh,s,sk,d,causal", CASES)
def test_grads_match_jax_vjp(b, n, kvh, s, sk, d, causal, dtype):
    q, k, v, do = _inputs(s * 17 + kvh, b, n, kvh, s, sk, d)
    ref = _jax_grads(q, k, v, do, dtype, causal)
    got = _torch_grads(q, k, v, do, dtype, causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, atol=TOL[dtype], rtol=TOL[dtype], err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,kvh,s,sk,d,causal", CASES)
def test_bwd_matches_jax_bwd_on_the_same_residuals(b, n, kvh, s, sk, d, causal, dtype):
    q, k, v, do = _inputs(s * 29 + kvh, b, n, kvh, s, sk, d)
    scale = d ** -0.5
    fold = [jnp.asarray(t, JD[dtype]).reshape(-1, t.shape[2], d) for t in (q, k, v, do)]
    o, lse = _fwd(*fold[:3], scale, causal, 1024, 1024, True)
    ref = _bwd(scale, causal, 1024, 1024, True, (*fold[:3], o, lse), fold[3])
    o_t = torch.from_numpy(_np(o).reshape(b, n, s, d)).to(TD[dtype])
    lse_t = torch.from_numpy(_np(lse)[..., 0].reshape(b, n, s))
    got = fa.flash_attention_bwd(*(torch.from_numpy(t).to(TD[dtype]) for t in (q, k, v)),
                                 o_t, lse_t, torch.from_numpy(do).to(TD[dtype]),
                                 causal=causal, sm_scale=scale)
    for name, g, r, full in zip(("dq", "dk", "dv"), got, ref, (q, k, v)):
        assert g.dtype == TD[dtype]
        np.testing.assert_allclose(g.float().numpy(), _np(r).reshape(full.shape),
                                   atol=TOL[dtype], rtol=TOL[dtype], err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_rows_get_exactly_zero_dq(dtype):
    """Sk < S, causal: rows 0..S-Sk-1 see no key, so their dq is exactly 0
    and they add nothing to dk/dv.  JAX gives that where its block skip
    covers the rows (64-row blocks here), the port at any tiling."""
    b, n, kvh, s, sk, d = 1, 2, 2, 128, 64, 64
    q, k, v, do = _inputs(7, b, n, kvh, s, sk, d)
    ref = _jax_grads(q, k, v, do, dtype, True, block=64)
    got = _torch_grads(q, k, v, do, dtype, True)
    masked = s - sk
    assert (got[0][:, :, :masked] == 0).all() and (ref[0][:, :, :masked] == 0).all()
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g, r, atol=TOL[dtype], rtol=TOL[dtype], err_msg=name)
    # the masked rows' dO changes nothing
    do2 = do.copy()
    do2[:, :, :masked] = 1e3
    again = _torch_grads(q, k, v, do2, dtype, True)
    for g, g2 in zip(got[1:], again[1:]):
        np.testing.assert_array_equal(g, g2)


def test_flash_attention_output_carries_the_flash_backward():
    """The output of ``flash_attention`` has the Function's backward node (a
    CUDA output of the kernel without one would drop the gradient)."""
    q, k, v, _ = (torch.from_numpy(t).requires_grad_(True)
                  for t in _inputs(3, 1, 2, 2, 16, 16, 64))
    o = fa.flash_attention(q, k, v)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.inference_mode():
        o_inf = fa.flash_attention(q.detach(), k.detach(), v.detach())
    assert o_inf.grad_fn is None
    torch.testing.assert_close(o_inf, o.detach())


def test_strided_output_gradient_is_taken(monkeypatch):
    """dO arrives strided from the model's output transpose; the Function
    hands the backward a contiguous copy."""
    seen = []
    real = fa.flash_attention_bwd

    def spy(q, k, v, o, lse, do, **kw):
        seen.append(do.is_contiguous())
        return real(q, k, v, o, lse, do, **kw)

    monkeypatch.setattr(fa, "flash_attention_bwd", spy)
    q, k, v, _ = (torch.from_numpy(t).requires_grad_(True)
                  for t in _inputs(4, 1, 2, 2, 16, 16, 64))
    o = fa.flash_attention(q, k, v)
    (o.transpose(1, 2).reshape(1, 16, 128) ** 2).sum().backward()
    assert seen == [True]
    assert all(t.grad is not None for t in (q, k, v))


def test_cpu_backward_takes_the_plain_version_without_counting(monkeypatch):
    def no_kernel(*a, **kw):
        raise AssertionError("a CPU tensor reached a CUDA wrapper")

    monkeypatch.setattr(fa, "_flash_bwd_cuda", no_kernel)
    monkeypatch.setattr(fa, "_flash_bwd_dq_cuda", no_kernel)
    monkeypatch.setattr(fa, "_flash_bwd_dkv_cuda", no_kernel)
    before = (fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches)
    q, k, v, _ = (torch.from_numpy(t).requires_grad_(True)
                  for t in _inputs(1, 1, 2, 2, 16, 16, 64))
    fa.flash_attention(q, k, v).sum().backward()
    assert (fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches) == before


def test_cuda_backward_wrappers_refuse_what_the_kernels_cannot_take():
    q, k, v, do = (torch.from_numpy(t).bfloat16() for t in _inputs(1, 1, 2, 2, 16, 16, 64))
    lse = torch.zeros(1, 2, 16)
    delta = torch.zeros(1, 2, 16)
    for wrapper in (fa._flash_bwd_dq_cuda, fa._flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="CUDA device"):
            wrapper(q, k, v, lse, do, delta, causal=True, sm_scale=0.125)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.flash_attention_bwd(*(t.to("meta") for t in (q, k, v, q)), lse.to("meta"),
                               do.to("meta"))


def test_delta_is_the_fp32_rowsum():
    o, do = (torch.from_numpy(t).bfloat16() for t in _inputs(2, 1, 2, 2, 8, 8, 64)[:2])
    want = (o.float() * do.float()).sum(-1)
    got = fa.flash_bwd_delta(o, do)
    assert got.dtype == torch.float32 and got.shape == (1, 2, 8)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def _bf16(*shape, offset=0):
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(*shape)


def _fake_launch(monkeypatch):
    """Device and dtype checks bypassed and the C call recorded, so the CPU
    can stand in for the card."""
    launched = []
    monkeypatch.setattr(fa, "flash_bwd_dq_launches", 0)
    monkeypatch.setattr(fa, "flash_bwd_dkv_launches", 0)
    monkeypatch.setattr(fa, "_check_kernel_inputs", lambda *a, **kw: None)
    monkeypatch.setattr(fa, "_launch", lambda *a: launched.append(a))
    return launched


@pytest.mark.parametrize("wrapper,which", [("_flash_bwd_dq_cuda", 1), ("_flash_bwd_dkv_cuda", 2)])
@pytest.mark.parametrize("name", ["q", "k", "v", "do"])
def test_cuda_backward_wrappers_raise_on_a_misaligned_input(monkeypatch, wrapper, which, name):
    """Each backward wrapper launches only its own kernel, and raises on a
    tensor TMA cannot take: no launch and no fallback."""
    launched = _fake_launch(monkeypatch)
    ts = {n: _bf16(1, 2, 16, 64) for n in ("q", "k", "v", "do")}
    lse, delta = torch.zeros(1, 2, 16), torch.zeros(1, 2, 16)

    def call():
        return getattr(fa, wrapper)(ts["q"], ts["k"], ts["v"], lse, ts["do"], delta,
                                    causal=True, sm_scale=0.125)

    call()
    assert len(launched) == 1 and launched[0][-1] == which
    ts[name] = _bf16(1, 2, 16, 64, offset=1)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        call()
    assert len(launched) == 1
    assert (fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches) == (which & 1, which >> 1)


def test_cuda_backward_launches_both_kernels_from_one_call(monkeypatch):
    """``flash_attention_bwd``'s CUDA path: one C call (the tensor maps of
    q, k, v and dO encoded once) launches both kernels, and each count
    rises by one."""
    launched = _fake_launch(monkeypatch)
    q, do = _bf16(1, 4, 16, 64), _bf16(1, 4, 16, 64)
    k, v = _bf16(1, 2, 32, 64), _bf16(1, 2, 32, 64)
    lse, delta = torch.zeros(1, 4, 16), torch.zeros(1, 4, 16)
    dq, dk, dv = fa._flash_bwd_cuda(q, k, v, lse, do, delta, causal=True, sm_scale=0.125)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert len(launched) == 1 and launched[0][-1] == 3
    # bn, s, bkv, sk, d as the kernels take them
    assert launched[0][-8:-3] == (4, 16, 2, 32, 64)
    assert (fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches) == (1, 1)


def test_backward_kernels_are_built_on_the_hopper_header():
    """``csrc/flash_bwd.cu`` computes its products with wgmma and loads its
    tiles by TMA (``csrc/hopper.cuh``); no mma.sync is left."""
    from dlbb_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_bwd.cu").read_text()
    assert '#include "hopper.cuh"' in src
    assert "mma.sync" not in src
    for piece in ("wgmma_m64n64k16_ss", "tma_load_3d", "tma_store_3d", "mbar_wait",
                  "setmaxnreg_inc"):
        assert f"hopper::{piece}" in src, piece
