"""dlbb_tpu_torch — the PyTorch/CUDA port of ``dlbb_tpu``, for NVIDIA Hopper.

The JAX package ``dlbb_tpu`` stays the reference; every module here mirrors
its counterpart's name and is held against it by the ``tests/test_torch_*``
parity tests (same seeded inputs and weights in, same outputs out, within a
stated tolerance).  This package imports ``torch`` and numpy only — never
``jax`` and never a module of ``dlbb_tpu``.

Ported so far (the single-device forward and train step, the collective
sweeps, the tensor-parallel forward):

- ``models`` — ``ModelConfig``/``MODEL_CONFIGS`` (1B/7B/13B), the dense
  decoder ``forward`` with the simplified/full/dense/flash attention modes
  and remat ("full", "dots"), ``dense_attention``, and ``params_from_jax``
  to carry JAX weights across;
- ``ops`` — ``flash_attention``, differentiable through a
  ``torch.autograd.Function``: hand-written CUDA C++ kernels for Hopper
  (``ops/csrc/flash_fwd.cu``, the port of the Pallas ``_fwd_kernel``;
  ``ops/csrc/flash_bwd.cu``, the ports of ``_dq_kernel`` and
  ``_dkv_kernel``) with their plain PyTorch versions beside them;
- ``data`` — the seeded synthetic embedding batch (and its targets);
- ``train`` — ``optim`` (Adam with the constant schedule, ``cast_moments``,
  optax's rounding rules) and ``loop`` (``make_train_step``, ``run_train``
  at ZeRO stage 0, world size 1);
- ``utils`` — ``summarize``/``Timer``, per-iteration CUDA-event timing,
  config IO, system info;
- ``bench.e2e`` — ``run_e2e``, on one device or on every rank of a (dp, tp)
  process-group mesh; ``cli e2e`` (``--world N``) and ``cli train``;
- ``parallel.plan`` — ``ParallelismPlan``: the JAX plan's checks and the
  mesh; ``models.sharding`` — explicit Megatron tensor-parallel shards;
- ``comm`` — process groups (``torch.distributed``: NCCL, or gloo on the
  CPU), the collective ops, payloads and mesh-shape variants;
  ``bench.runner`` and ``bench.launch`` — the 1D and 3D collective sweeps
  on spawned ranks; ``stats`` — their statistics; ``cli bench1d``,
  ``bench3d``, ``stats1d``, ``stats3d``.

Not ported yet (see ROADMAP.md): MoE, tp_overlap, uneven tp shards, TP
training, ZeRO 1-3, gradient accumulation, checkpointing, the other optimizers and
schedules, ring/Ulysses attention, pipelines, the quantised and
collective-matmul ops, serving, and the observability, resilience,
planning and analysis layers.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA device and no explicit ``"cpu"`` they raise.
"""

__version__ = "0.1.0"
