"""Synthetic embedding batches (counterpart of ``dlbb_tpu/data/synthetic.py``).

One fixed, seeded ``[batch, seq_len, hidden]`` batch returned on every
``get_batch()``.  The draw is the JAX package's own
(``np.random.default_rng(seed).standard_normal(..., float32)``), rounded to
the model dtype the same way, so both packages see bit-identical inputs.
Under data and sequence parallelism the global batch is drawn the same
way and cut by ``batch_slice``: rank ``dp_rank`` of ``dp`` keeps rows
``[dp_rank B/dp, (dp_rank + 1) B/dp)`` and rank ``sp_rank`` of ``sp`` the
sequence positions ``[sp_rank S/sp, (sp_rank + 1) S/sp)``, the slice JAX's
``device_put`` gives it under ``batch_spec`` (``models/sharding.py::
batch_spec`` gives a mesh's ranks and sizes).  A training step that cuts
the global batch into micro-batches (gradient accumulation, a pipeline's
microbatches) takes ``chunks`` of them: each global micro-batch, rows
``[i B/chunks, (i + 1) B/chunks)`` as JAX's ``reshape`` takes them, is laid
over dp by itself, so a rank holds its share of every micro-batch, in
order, as GSPMD reshards JAX's.  Every rank draws the global batch from
the global seed, so no collective moves a row.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def dp_rows(rows: int, dp_rank: int, dp: int) -> tuple[int, int]:
    """``(start, count)`` of rank ``dp_rank``'s part of ``rows`` rows laid
    over ``dp`` ranks: near-equal contiguous parts, the first ``rows % dp``
    ranks taking one more row (a rank may take none)."""
    base, extra = divmod(rows, dp)
    return dp_rank * base + min(dp_rank, extra), base + (dp_rank < extra)


def batch_slice(a, dp_rank: int = 0, dp: int = 1, sp_rank: int = 0, sp: int = 1,
                chunks: int = 1):
    """Rank ``(dp_rank, sp_rank)``'s rows and sequence positions of a global
    ``[B, S, ...]`` array or tensor: with one chunk its ``B/dp`` rows (a
    view), else its ``dp_rows`` part of each of the ``chunks`` micro-batches,
    concatenated in micro-batch order (module docstring)."""
    b, s = a.shape[:2]
    if chunks < 1 or b % chunks != 0:
        raise ValueError(f"input.batch_size={b} not divisible into {chunks} micro-batches")
    if chunks == 1 and b % dp != 0:
        raise ValueError(f"input.batch_size={b} not divisible by data_parallel={dp}")
    if s % sp != 0:
        raise ValueError(f"sequence length {s} not divisible by sp={sp}")
    cols = slice(sp_rank * (s // sp), (sp_rank + 1) * (s // sp))
    rows = b // chunks
    start, count = dp_rows(rows, dp_rank, dp)
    if chunks == 1:
        return a[start:start + count, cols]
    parts = [a[i * rows + start:i * rows + start + count, cols] for i in range(chunks)]
    return (torch.cat(parts) if isinstance(a, torch.Tensor)
            else np.concatenate(parts))


class SyntheticEmbeddingDataset:
    def __init__(self, batch_size: int, seq_length: int, hidden_size: int,
                 seed: int = 42, dtype: torch.dtype = torch.bfloat16,
                 device="cpu", dp_rank: int = 0, dp: int = 1, sp_rank: int = 0,
                 sp: int = 1, chunks: int = 1) -> None:
        self.batch_size = batch_size
        self.seq_length = seq_length
        self.hidden_size = hidden_size
        self.seed = seed
        host = np.random.default_rng(seed).standard_normal(
            (batch_size, seq_length, hidden_size), dtype=np.float32)
        host = np.ascontiguousarray(batch_slice(host, dp_rank, dp, sp_rank, sp, chunks))
        self._batch = torch.from_numpy(host).to(device=device, dtype=dtype)

    def get_batch(self) -> torch.Tensor:
        return self._batch


def _request_host_embeddings(seed: int, prompt_len: int,
                             hidden_size: int,
                             period: Optional[int] = None,
                             prefix_len: Optional[int] = None,
                             prefix_seed: Optional[int] = None) -> np.ndarray:
    """The host-side float32 prompt array both :func:`request_embeddings`
    and :func:`prompt_token_ids` derive from — ONE rng consumption
    pattern, so the device prompt and its host-side token-id view can
    never drift.  ``period`` tiles a seeded motif of that many positions
    (the repeating-structure traffic variant, ``serve/traffic.py``);
    None keeps the original draw byte-identical.

    ``prefix_len``/``prefix_seed`` compose the shared-prefix traffic
    variant: the first ``prefix_len`` positions are drawn from
    ``prefix_seed`` (the GROUP seed — every request in a prefix group
    gets the bit-identical prefix, which is what makes its token-block
    chain content-addressable in the prefix trie), the remainder from
    the per-request ``seed``.  The per-seed draws are prefix-closed
    (``default_rng`` fills row-major), so requests whose clamped prefix
    lengths differ still share their common head."""
    if prefix_len is not None and prefix_seed is not None and prefix_len > 0:
        if prefix_len >= prompt_len:
            raise ValueError(
                f"prefix_len={prefix_len} must leave at least one "
                f"per-request position (prompt_len={prompt_len})"
            )
        head = _request_host_embeddings(prefix_seed, prefix_len,
                                        hidden_size, period=period)
        tail = _request_host_embeddings(seed, prompt_len - prefix_len,
                                        hidden_size, period=period)
        return np.concatenate([head, tail], axis=1)
    rng = np.random.default_rng(seed)
    if period is not None:
        if period < 1:
            raise ValueError(f"period must be >= 1, got {period}")
        motif = rng.standard_normal((1, period, hidden_size),
                                    dtype=np.float32)
        reps = -(-prompt_len // period)
        return np.tile(motif, (1, reps, 1))[:, :prompt_len]
    return rng.standard_normal((1, prompt_len, hidden_size),
                               dtype=np.float32)


def request_embeddings(
    seed: int,
    prompt_len: int,
    hidden_size: int,
    dtype: torch.dtype = torch.bfloat16,
    pad_to: Optional[int] = None,
    period: Optional[int] = None,
    prefix_len: Optional[int] = None,
    prefix_seed: Optional[int] = None,
    device="cpu",
) -> torch.Tensor:
    """Seeded synthetic prompt embeddings for ONE serving request:
    ``[1, prompt_len, hidden]`` (``[1, pad_to, hidden]`` when padded for a
    prefill bucket — pad positions are zeros; causal attention plus the
    engine's length masking keep them out of every real token's output).

    The serving analogue of :class:`SyntheticEmbeddingDataset`: the
    benchmark measures scheduling and communication, not input variety,
    but each request still gets its own deterministic inputs (seed from
    the trace, ``serve/traffic.py``) so a replayed trace replays the
    exact computation.  ``period`` tiles a seeded motif instead of a
    fully random draw (the repeating-structure trace variant the
    speculative-decoding bench uses, so n-gram drafting has structure
    to look up); None is byte-identical to the original draw.  The host
    array is the JAX package's draw, rounded to ``dtype`` on ``device``."""
    if pad_to is not None and pad_to < prompt_len:
        raise ValueError(
            f"pad_to={pad_to} is shorter than prompt_len={prompt_len}"
        )
    host = _request_host_embeddings(seed, prompt_len, hidden_size,
                                    period=period, prefix_len=prefix_len,
                                    prefix_seed=prefix_seed)
    if pad_to is not None and pad_to > prompt_len:
        host = np.concatenate(
            [host, np.zeros((1, pad_to - prompt_len, hidden_size),
                            dtype=np.float32)], axis=1,
        )
    return torch.from_numpy(host).to(device=device, dtype=dtype)


def prompt_token_ids(seed: int, prompt_len: int, hidden_size: int,
                     period: Optional[int] = None,
                     prefix_len: Optional[int] = None,
                     prefix_seed: Optional[int] = None) -> list[int]:
    """The prompt's greedy token-id view: per-position argmax of the SAME
    host array :func:`request_embeddings` uploads — the n-gram drafter's
    prompt-lookup context (the JAX package's ``serve/engine.py``).  Pure numpy, computed at
    admission: drafting hints never need device transfers, and a wrong
    hint costs only acceptance (the target verify gates every commit)."""
    host = _request_host_embeddings(seed, prompt_len, hidden_size,
                                    period=period, prefix_len=prefix_len,
                                    prefix_seed=prefix_seed)
    return [int(t) for t in np.argmax(host[0], axis=-1)]


# Fixed seed for the greedy token-embedding table: one global vocabulary
# per hidden size, shared by every engine so token-identity comparisons
# across engines/meshes are meaningful.
_TOKEN_TABLE_SEED = 0xD1BB


def token_embedding_table(hidden_size: int, dtype: torch.dtype = torch.bfloat16,
                          device="cpu") -> torch.Tensor:
    """The greedy-decode token embedding table ``[H, H]``.

    The serving engine's legacy decode feeds each output hidden state
    straight back as the next input (the model is its own next-token
    function) — a CONTINUOUS feedback with no discrete token alphabet,
    which speculative decoding cannot draft against.  Greedy token
    feedback (``serving.speculation != "off"``) quantises the loop
    through this table: the committed token is ``argmax`` over the
    output hidden state (vocab = hidden_size, the argmax alphabet the
    equivalence gate already records), and the next input is that
    token's row here.  ``emb(token)`` being a deterministic function of
    the token id is exactly what makes a verified draft bit-identical
    to the sequential step — the foundation of the token-identity
    contract (docs/serving.md, "Speculative decoding")."""
    rng = np.random.default_rng(_TOKEN_TABLE_SEED)
    host = rng.standard_normal((hidden_size, hidden_size),
                               dtype=np.float32)
    return torch.from_numpy(host).to(device=device, dtype=dtype)


def create_dataset_from_config(config: dict[str, Any], dtype=torch.bfloat16,
                               device="cpu", hidden_size: Optional[int] = None,
                               seed_offset: int = 0, dp_rank: int = 0,
                               dp: int = 1, sp_rank: int = 0,
                               sp: int = 1, chunks: int = 1) -> SyntheticEmbeddingDataset:
    """Build from the YAML ``input:`` + ``model:`` sections;
    ``seed_offset`` derives another batch from the same config (the
    training targets are seed + 1); ``dp_rank``/``dp``, ``sp_rank``/``sp``
    and ``chunks`` select a slice (``batch_slice``)."""
    if hidden_size is None:
        hidden_size = config["model"]["hidden_size"]
    return SyntheticEmbeddingDataset(
        batch_size=config["input"]["batch_size"],
        seq_length=config["input"]["sequence_length"],
        hidden_size=hidden_size,
        seed=config["input"].get("seed", 42) + seed_offset,
        dtype=dtype,
        device=device,
        dp_rank=dp_rank,
        dp=dp,
        sp_rank=sp_rank,
        sp=sp,
        chunks=chunks,
    )
