"""Plan-space search: cm2-driven parallelism-plan autotuning (counterpart
of ``dlbb_tpu/plan``).

The paper answers "which launcher/knob combination is fastest for this
tensor shape" by brute-force sweep; this package closes the loop with a
predict-prune-measure search grounded in the fitted cm2 cost model and
the static memory-feasibility term (``hbm_headroom_bytes``), so the
sweep only ever *runs* the handful of plans the model cannot separate
(``cli plan --auto``), and prices a fleet capacity curve (``cli plan
--capacity``).
"""

from dlbb_tpu_torch.plan.autotune import (  # noqa: F401
    CAL_FAMILIES,
    PlanPoint,
    calibration_agreement,
    enumerate_serving_space,
    enumerate_train_space,
    heuristic_point,
    predict_point_us,
    prune_point,
    rank_points,
    run_capacity_plan,
    run_plan_search,
)
