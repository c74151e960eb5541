"""Metrics, timing, config IO and system info (counterpart of
``dlbb_tpu/utils``)."""
