"""Training (counterpart of ``dlbb_tpu/train``): the single-device Adam step."""
