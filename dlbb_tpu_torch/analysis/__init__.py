"""Static and runtime analysis (counterpart of ``dlbb_tpu/analysis``): the
findings model and exit codes that ``obs/devtrace.py`` reports through
(``findings``) and the α–β cost-model table (``costmodel``).  The
comm-lint, schedule, memory and numerics audits are ROADMAP Queue 1, Slice
F, item 15."""
