"""Offline statistics of the sweep results (counterpart of
``dlbb_tpu/stats``): the 1D per-file ``*_stats.json`` and consolidated CSV,
the 3D standard and transposed CSVs, in the JAX package's (and the
reference's) columns, and the derived reports over them (``compare``,
``variants_report``, ``northstar``, ``parallelism_report``,
``serving_report``): file processing.  The quantised wire's constants
and the analytic wire model live in ``analysis/expectations.py``."""

from dlbb_tpu_torch.stats.stats1d import (
    calculate_bandwidth,
    calculate_statistics,
    process_1d_results,
)
from dlbb_tpu_torch.stats.stats3d import calculate_statistics_3d, process_3d_results

__all__ = [
    "calculate_bandwidth",
    "calculate_statistics",
    "calculate_statistics_3d",
    "process_1d_results",
    "process_3d_results",
]
