"""Benchmark harnesses (counterpart of ``dlbb_tpu/bench``): the end-to-end
forward, the collective sweeps and their launcher."""
