"""Static and runtime analysis (counterpart of ``dlbb_tpu/analysis``): so
far only the findings model and exit codes that ``obs/devtrace.py``
reports through (``findings``).  The comm-lint, schedule, memory and
numerics audits are ROADMAP Queue 1, Slice F, item 15."""
