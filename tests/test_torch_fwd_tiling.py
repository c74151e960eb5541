"""What the Hopper forward kernel's host side decides, checked without a card.

- ``fwd_tile_plan``: the kernel's tile rule (which K tiles a Q tile visits,
  which of them take the per-element mask) written once in Python, against
  brute-force visibility from the reference's rule ``c <= r + (sk - s)``.
  The shapes are those ``chip_smoke.py`` runs the kernel at, plus edge cases
  and a hypothesis search.
- ``tma_compatible``: the TMA precondition (contiguous, 16-byte-aligned
  base) that the CUDA wrapper checks before it launches, raising and never
  falling back.
- ``_build.build_dir``: the build key covers ``csrc/hopper.cuh``, so a change
  to the shared header rebuilds the kernels.
"""

import shutil

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from dlbb_tpu_torch.ops import _build
from dlbb_tpu_torch.ops import flash_attention as fa


def _check_plan(s, sk, causal, block_m=fa.FWD_BLOCK_M, block_n=fa.FWD_BLOCK_N):
    plan = fa.fwd_tile_plan(s, sk, block_m, block_n, causal)
    assert len(plan) == -(-s // block_m)
    offset = sk - s
    n_tiles = -(-sk // block_n)
    cols = np.arange(n_tiles * block_n)
    for qi, (visited, masked) in enumerate(plan):
        rows = np.arange(qi * block_m, min((qi + 1) * block_m, s))
        vis = (cols[None, :] < sk) & (
            (cols[None, :] <= rows[:, None] + offset) if causal else True)
        tile_of_col = cols // block_n
        # every visible pair lies in a visited tile
        assert set(np.unique(tile_of_col[vis.any(0)])) <= set(visited)
        # visited tiles run from the last down, and each holds a visible pair
        assert visited == sorted(visited, reverse=True)
        assert set(masked) <= set(visited)
        for n in visited:
            block = vis[:, n * block_n:(n + 1) * block_n]
            assert block.any(), (qi, n)
            # a tile that skips the mask is fully visible to every row
            if n not in masked:
                assert block.all(), (qi, n)
    return plan


SHAPES = sorted({(c["s"], c["sk"], c["causal"])
                 for c in {**chip_smoke.CASES, **chip_smoke.EDGE_CASES}.values()}
                | {(chip_smoke.LONG_SHAPE["s"], chip_smoke.LONG_SHAPE["sk"], True),
                   (128, 128, True), (129, 129, True), (127, 300, True), (300, 127, True),
                   (256, 1, True), (1, 1, False), (640, 200, False), (255, 257, True)})


@pytest.mark.parametrize("s,sk,causal", SHAPES, ids=[f"s{s}-sk{sk}-{'causal' if c else 'full'}"
                                                    for s, sk, c in SHAPES])
def test_tile_plan_covers_visibility(s, sk, causal):
    _check_plan(s, sk, causal)


@settings(max_examples=60, deadline=None)
@given(s=st.integers(1, 700), sk=st.integers(1, 700), causal=st.booleans(),
       block_m=st.sampled_from([64, 128]), block_n=st.sampled_from([64, 128]))
def test_tile_plan_covers_visibility_search(s, sk, causal, block_m, block_n):
    _check_plan(s, sk, causal, block_m, block_n)


def test_tile_plan_main_shape_masks_only_the_diagonal():
    """S = Sk = 512, causal: Q tile i visits K tiles i .. 0 and masks only
    tile i, the one on the diagonal."""
    plan = fa.fwd_tile_plan(512, 512, causal=True)
    assert plan == [(list(range(i, -1, -1)), [i]) for i in range(4)]


def test_tile_plan_fully_masked_rows_visit_nothing():
    """Sk < S, causal: Q tiles whose rows all see no key visit no tile (the
    kernel then writes o = 0 and lse = NEG_INF)."""
    plan = fa.fwd_tile_plan(512, 72, causal=True)
    assert [v for v, _ in plan][:3] == [[], [], []]
    assert plan[3] == ([0], [0])


def test_tile_plan_non_causal_masks_only_the_ragged_tail():
    plan = fa.fwd_tile_plan(256, 768 + 5, causal=False)
    assert all(v == list(range(6, -1, -1)) and m == [6] for v, m in plan)
    assert all(m == [] for _, m in fa.fwd_tile_plan(256, 768, causal=False))


def _bf16(*shape, offset=0):
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(*shape)


@pytest.mark.parametrize("offset,ok", [(0, True), (8, True), (1, False), (4, False)])
def test_tma_compatible_alignment(offset, ok):
    t = _bf16(1, 2, 16, 64, offset=offset)
    assert t.is_contiguous()
    assert fa.tma_compatible(t) is ok


def test_tma_compatible_refuses_non_contiguous():
    t = _bf16(1, 16, 2, 64).transpose(1, 2)
    assert t.data_ptr() % 16 == 0 and not fa.tma_compatible(t)


@pytest.mark.parametrize("name", ["q", "k", "v"])
def test_cuda_wrapper_raises_on_a_misaligned_input(monkeypatch, name):
    """The forward wrapper raises on a tensor TMA cannot take: no launch and
    no fallback.  (Device and dtype checks are bypassed so the CPU can stand
    in for the card.)"""
    launched = []
    monkeypatch.setattr(fa, "flash_fwd_launches", 0)
    monkeypatch.setattr(fa, "_check_kernel_inputs", lambda *a, **kw: None)
    monkeypatch.setattr(fa, "_launch", lambda *a: launched.append(a))
    ts = {"q": _bf16(1, 2, 16, 64), "k": _bf16(1, 2, 16, 64), "v": _bf16(1, 2, 16, 64)}
    fa._flash_fwd_cuda(ts["q"], ts["k"], ts["v"], causal=True, sm_scale=0.125)
    assert len(launched) == 1
    ts[name] = _bf16(1, 2, 16, 64, offset=1)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fa._flash_fwd_cuda(ts["q"], ts["k"], ts["v"], causal=True, sm_scale=0.125)
    assert len(launched) == 1 and fa.flash_fwd_launches == 1


def test_build_key_covers_the_shared_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert (csrc / "hopper.cuh").exists()
    for src in ("flash_fwd.cu", "flash_bwd.cu"):
        assert '#include "hopper.cuh"' in (csrc / src).read_text()
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.build_dir()
    assert _build.build_dir() == first
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("\n// changed\n")
    second = _build.build_dir()
    assert second != first
    assert [p.name for p in _build.sources()] == ["flash_bwd.cu", "flash_fwd.cu"]
