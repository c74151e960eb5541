"""Training (counterpart of ``dlbb_tpu/train``): the DDP/ZeRO and
tensor-parallel train step (``loop``, ``zero``), its optimizers (``optim``)
and checkpoints (``checkpoint``)."""
