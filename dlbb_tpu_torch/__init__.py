"""dlbb_tpu_torch — the PyTorch/CUDA port of ``dlbb_tpu``, for NVIDIA Hopper.

The JAX package ``dlbb_tpu`` stays the reference; every module here mirrors
its counterpart's name and is held against it by the ``tests/test_torch_*``
parity tests (same seeded inputs and weights in, same outputs out, within a
stated tolerance).  This package imports ``torch`` and numpy only — never
``jax`` and never a module of ``dlbb_tpu``.

Ported so far (the single-device end-to-end forward):

- ``models`` — ``ModelConfig``/``MODEL_CONFIGS`` (1B/7B/13B), the dense
  decoder ``forward`` with the simplified/full/dense/flash attention modes,
  ``dense_attention``, and ``params_from_jax`` to carry JAX weights across;
- ``ops`` — ``flash_attention``: a hand-written CUDA C++ kernel for Hopper
  (``ops/csrc/flash_fwd.cu``, the port of the Pallas ``_fwd_kernel``) with
  its plain PyTorch version beside it;
- ``data`` — the seeded synthetic embedding batch;
- ``utils`` — ``summarize``/``Timer``, per-iteration CUDA-event timing,
  config IO, system info;
- ``bench.e2e`` — ``run_e2e`` at world size 1, and ``cli e2e``.

Not ported yet (see ROADMAP.md): the flash backward kernels and training,
MoE, remat, tp_overlap, meshes and sharding, ring/Ulysses attention,
pipelines, collectives and sweeps, serving, and the observability,
resilience, planning and analysis layers.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA device and no explicit ``"cpu"`` they raise.
"""

__version__ = "0.1.0"
