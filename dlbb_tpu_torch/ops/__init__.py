"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (counterpart of ``dlbb_tpu/ops``, whose kernels are Pallas).

``ops.flash_attention`` holds the flash attention forward and its launch
counter ``flash_fwd_launches``."""
