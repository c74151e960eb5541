"""cm2-driven parallelism-plan autotuner + fleet capacity planner
(counterpart of ``dlbb_tpu/plan/autotune.py``: JAX's grid, pruning,
prices, ranking and files).

The reference framework answers "which knob combination is fastest" by
brute-force sweep (oneCCL knob grids); we have two things the reference
never had — a *fitted* cost model (cm2, regression-gated by the
calibration baseline) and a static memory-feasibility term
(``hbm_headroom_bytes``) — so the sweep becomes the classic
predict-prune-measure autotuner loop:

1. **Enumerate** the full plan space for a ModelConfig + mesh:
   (dp, tp) factorizations x decode_horizon x inflight_window x
   prefill_chunk x compact_threshold for serving targets;
   (dp, sp, pp, tp) factorizations x tp_overlap x grad_compression x
   zero_stage x attention variant (ring/ulysses when sp > 1) for train
   targets.
2. **Prune** statically: every point that fails the repo's own
   ``validate_*`` contracts or whose analytic peak-bytes envelope has
   ``hbm_headroom_bytes < 0`` is dropped — *journaled with its reason*
   (``validation-reject`` / ``infeasible-hbm`` / ``cm2-fit-missing``),
   never silently.  A missing cm2 fit fails the whole search closed:
   ranking with the unfitted analytic seed would launder cm1 guesses as
   "model-picked".
3. **Rank** survivors by cm2-predicted per-token cost (serving) or step
   time (train), composed from the same fitted primitives the schedule
   auditor prices HLO with (``collective_cost_us`` / ``compute_cost_us``
   / ``dispatch_cost_us``).  Ties break toward the *simpler* plan
   (fewest engaged knobs), then lexically — deterministic by
   construction.
4. **Measure** the top-k (plus the default heuristic plan, always) with
   the real serving/train engines, and emit a model-picked vs
   measured-winner agreement table.

On top sits the fleet capacity planner (``cli plan --capacity``): a
``serve/traffic.py`` trace + SLO (``deadline_s``) is priced per
(plan, replica count) with cm2-predicted goodput/TTFT, validated by at
least one measured serving run per plotted plan, and published as a
"how many replicas of which plan serve N users within SLO" curve in
SERVING.md.

Predicted and measured live on one tier: on the CPU (``cli plan
--simulate N``) the ``cpu-sim`` tier, whose fit comes from gloo ranks and
whose times are host-core times, so relative ordering is the honest
signal; on the card the ``cuda`` tier.  A measured plan runs on
``dp x tp`` (serving) or ``dp x sp x pp x tp`` (train) ranks launched by
``bench/launch.py`` as ``cli serve --world`` launches them (gloo on the
CPU, NCCL with one GPU per rank on the card; in the caller's process at
world 1).  The ``cuda`` tier has no cm2 fit at world 1 (one card: a single
wire size, ``obs/fit.py`` refuses it), so on the card the search fails
closed with every point journaled ``cm2-fit-missing``.

The static half (enumerate / prune / rank / agreement) does no device
work; measurement runs the port's ``run_serving`` and ``run_train``.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Optional

from dlbb_tpu_torch.analysis.costmodel import (
    DEFAULT_FIT_DIR,
    DEFAULT_TIER,
    CostTier,
    FitMissingError,
    collective_cost_us,
    compute_cost_us,
    dispatch_cost_us,
    hbm_headroom_bytes,
    load_fitted_tier,
)
from dlbb_tpu_torch.models.configs import (
    ModelConfig,
    kv_cache_bytes_per_device,
    validate_attention_parallelism,
    validate_expert_parallelism,
    validate_tp_overlap,
)
from dlbb_tpu_torch.obs.export import MetricsRegistry
from dlbb_tpu_torch.resilience.journal import SweepJournal
from dlbb_tpu_torch.utils.config import save_json

# pruning reasons — the journal/manifest vocabulary (satellite contract)
PRUNE_VALIDATION = "validation-reject"
PRUNE_HBM = "infeasible-hbm"
PRUNE_FIT = "cm2-fit-missing"
PRUNE_REASONS = (PRUNE_VALIDATION, PRUNE_HBM, PRUNE_FIT)

AUTOTUNE_SCHEMA = "dlbb_autotune_v1"
BENCH_SCHEMA = "dlbb_bench_autotune_v1"
CAPACITY_SCHEMA = "dlbb_capacity_v1"

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}

# search-space axes (full grid — every point is either ranked or
# journaled with a prune reason; there is no silent cap anywhere)
SERVE_HORIZONS = (1, 2, 4, 8, 16)
SERVE_INFLIGHT = (1, 2)
TRAIN_OVERLAPS = ("off", "ring", "bidir")
TRAIN_COMPRESSIONS = ("none", "int8", "fp8")
TRAIN_ZERO_STAGES = (0, 1)
SP_ATTENTION_VARIANTS = ("ring", "ulysses")

# reference workload (mirrors serve/bench.py DEFAULT_SERVE_MODEL /
# the serving envelope defaults; kept literal here, as in JAX)
DEFAULT_PLAN_MODEL: dict[str, Any] = {
    "hidden_size": 128, "num_layers": 4, "num_heads": 8,
    "num_kv_heads": 4, "ffn_intermediate": 256, "dtype": "float32",
    "attention": "full",
}
DEFAULT_PLAN_SERVING: dict[str, Any] = {
    "max_batch": 8, "max_seq": 256, "block_size": 16,
    "queue_capacity": 64,
}
DEFAULT_PLAN_INPUT: dict[str, Any] = {
    "batch_size": 8, "sequence_length": 64, "seed": 42,
}

# committed-calibration agreement grid: each family is a set of
# calibration targets measuring the same work under different plan
# knobs; per-entry divisor normalizes multi-step targets to per-step
# cost (decode_fused[k4] runs 4 decode steps per dispatch).  This is
# the pinned validation grid for the >=70% top-2 regression.
CAL_FAMILIES: dict[str, list[tuple[str, float]]] = {
    "ag_matmul_schedule": [
        ("comm/ops.py::ag_matmul[ring]", 1),
        ("comm/ops.py::ag_matmul[bidir]", 1),
        ("comm/ops.py::ag_matmul[fused]", 1),
    ],
    "matmul_rs_schedule": [
        ("comm/ops.py::matmul_rs[ring]", 1),
        ("comm/ops.py::matmul_rs[bidir]", 1),
        ("comm/ops.py::matmul_rs[fused]", 1),
    ],
    "allreduce_schedule": [
        ("comm/ops.py::allreduce", 1),
        ("comm/ops.py::allreduce_hierarchical", 1),
    ],
    "collective_compression": [
        ("comm/ops.py::allreduce", 1),
        ("comm/ops.py::allreduce_q[int8]", 1),
        ("comm/ops.py::allreduce_q[fp8]", 1),
    ],
    "tp_overlap_forward": [
        ("models/transformer.py::forward[dp,tp]", 1),
        ("models/transformer.py::forward[dp,tp,overlap=ring]", 1),
        ("models/transformer.py::forward[dp,tp,overlap=bidir]", 1),
    ],
    "context_parallel_forward": [
        ("models/transformer.py::forward[sp,ring]", 1),
        ("models/transformer.py::forward[sp,ulysses]", 1),
    ],
    "prefill_path": [
        ("serve/engine.py::prefill[dp,tp]", 1),
        ("serve/engine.py::prefill_chunk[dp,tp]", 1),
    ],
    "decode_path": [
        ("serve/engine.py::decode_step[dp,tp]", 1),
        ("serve/engine.py::decode_fused[k4,dp,tp]", 4),
    ],
    "zero_stage": [
        ("train/loop.py::train_step[zero0,dp]", 1),
        ("train/loop.py::train_step[zero1,dp]", 1),
    ],
    "grad_compression": [
        ("train/loop.py::train_step[zero0,dp]", 1),
        ("train/loop.py::train_step[ddp,compressed=int8]", 1),
    ],
}

# the port's own calibration baseline (obs/calibration.py, ROADMAP Queue 1,
# Slice F, item 14, part 14b): until it exists the agreement record says
# "calibration baseline not found", as JAX's does for a missing file
DEFAULT_CAL_BASELINE = Path(
    "stats/torch/analysis/calibration/calibration_baseline_cm2.json"
)


# ---------------------------------------------------------------------------
# plan points
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlanPoint:
    """One point of the plan space — the knobs the search owns.

    ``target`` selects which axes are live: serving points use
    (dp, tp) + the decode fast-path knobs; train points use
    (dp, sp, pp, tp) + overlap/compression/zero + the attention
    variant (the per-op variant axis: ring vs ulysses when sp > 1).
    """

    target: str  # "serving" | "train"
    dp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    # train knobs
    tp_overlap: str = "off"
    grad_compression: str = "none"
    zero_stage: int = 0
    attention: Optional[str] = None  # per-op variant; None = model default
    # serving knobs
    decode_horizon: int = 1
    prefill_chunk: Optional[int] = None
    compact_threshold: Optional[float] = None
    inflight_window: int = 1

    def key(self) -> str:
        """Compact stable identifier (journal ``config`` field, report
        rows, tie-break of last resort)."""
        if self.target == "serving":
            parts = [f"dp{self.dp}", f"tp{self.tp}",
                     f"K{self.decode_horizon}", f"W{self.inflight_window}"]
            if self.prefill_chunk is not None:
                parts.append(f"chunk{self.prefill_chunk}")
            if self.compact_threshold is not None:
                parts.append(f"compact{self.compact_threshold:g}")
            return "serve[" + ",".join(parts) + "]"
        parts = [f"dp{self.dp}", f"tp{self.tp}", f"sp{self.sp}",
                 f"pp{self.pp}"]
        if self.tp_overlap != "off":
            parts.append(f"overlap={self.tp_overlap}")
        if self.grad_compression != "none":
            parts.append(f"comp={self.grad_compression}")
        if self.zero_stage:
            parts.append(f"zero{self.zero_stage}")
        if self.attention is not None:
            parts.append(f"attn={self.attention}")
        return "train[" + ",".join(parts) + "]"

    def complexity(self) -> int:
        """Number of engaged non-default knobs — the tie-break: when cm2
        cannot separate two plans, the simpler one wins."""
        n = 0
        if self.target == "serving":
            n += int(self.decode_horizon > 1)
            n += int(self.inflight_window > 1)
            n += int(self.prefill_chunk is not None)
            n += int(self.compact_threshold is not None)
        else:
            n += int(self.tp_overlap != "off")
            n += int(self.grad_compression != "none")
            n += int(self.zero_stage > 0)
            n += int(self.attention is not None)
            n += int(self.sp > 1) + int(self.pp > 1)
        return n

    def to_dict(self) -> dict[str, Any]:
        d = asdict(self)
        d["key"] = self.key()
        return d


def _factor_pairs(n: int) -> list[tuple[int, int]]:
    """All (a, b) with a * b == n."""
    return [(a, n // a) for a in range(1, n + 1) if n % a == 0]


def enumerate_serving_space(
    model_cfg: ModelConfig,
    n_devices: int,
    serving: dict[str, Any],
) -> list[PlanPoint]:
    """Full serving grid: every (dp, tp) factorization of the mesh x
    decode horizon x in-flight window x chunked prefill {off, 2 blocks}
    x slot compaction {off, 0.5}.  Infeasible combinations are NOT
    filtered here — pruning journals them with reasons."""
    block = int(serving.get("block_size", 16))
    pts = []
    for dp, tp in _factor_pairs(n_devices):
        for k in SERVE_HORIZONS:
            for w in SERVE_INFLIGHT:
                for chunk in (None, 2 * block):
                    for compact in (None, 0.5):
                        pts.append(PlanPoint(
                            target="serving", dp=dp, tp=tp,
                            decode_horizon=k, inflight_window=w,
                            prefill_chunk=chunk,
                            compact_threshold=compact,
                        ))
    return pts


def enumerate_train_space(
    model_cfg: ModelConfig,
    n_devices: int,
) -> list[PlanPoint]:
    """Full train grid: every ordered (dp, sp, pp, tp) factorization of
    the mesh x tp-overlap schedule x gradient compression x ZeRO stage,
    with the attention variant axis (ring / ulysses) enumerated whenever
    sp > 1 offers the choice (the per-op variant dimension)."""
    pts = []
    for dp in range(1, n_devices + 1):
        if n_devices % dp:
            continue
        rem = n_devices // dp
        for sp in range(1, rem + 1):
            if rem % sp:
                continue
            rem2 = rem // sp
            for pp, tp in _factor_pairs(rem2):
                attn_variants: tuple[Optional[str], ...] = (
                    SP_ATTENTION_VARIANTS if sp > 1 else (None,)
                )
                for attn in attn_variants:
                    for ov in TRAIN_OVERLAPS:
                        for comp in TRAIN_COMPRESSIONS:
                            for z in TRAIN_ZERO_STAGES:
                                pts.append(PlanPoint(
                                    target="train", dp=dp, sp=sp,
                                    pp=pp, tp=tp, tp_overlap=ov,
                                    grad_compression=comp,
                                    zero_stage=z, attention=attn,
                                ))
    return pts


def _point_model(point: PlanPoint, model_cfg: ModelConfig) -> ModelConfig:
    """The model under this point's per-op variant (attention mode)."""
    from dataclasses import replace

    if point.attention is not None \
            and point.attention != model_cfg.attention:
        return replace(model_cfg, attention=point.attention)
    return model_cfg


# ---------------------------------------------------------------------------
# static pruning
# ---------------------------------------------------------------------------


def _serving_peak_bytes(point: PlanPoint, model_cfg: ModelConfig,
                        serving: dict[str, Any]) -> int:
    """Analytic per-device peak-bytes envelope for a serving plan:
    tp-sharded weights + the engine's own KV accounting + a prefill
    activation envelope (2 live [B/dp, S, H] planes)."""
    from dlbb_tpu_torch.models.transformer import num_parameters

    pbytes = _DTYPE_BYTES.get(model_cfg.dtype, 4)
    mb = int(serving["max_batch"])
    ms = int(serving["max_seq"])
    weights = num_parameters(model_cfg) * pbytes // max(point.tp, 1)
    kv = kv_cache_bytes_per_device(
        model_cfg, mb, ms, dp=point.dp, tp=point.tp,
        block_size=int(serving.get("block_size", 16)),
    )
    acts = 2 * (mb // max(point.dp, 1)) * ms \
        * model_cfg.hidden_size * pbytes
    return weights + kv + acts


def _train_peak_bytes(point: PlanPoint, model_cfg: ModelConfig,
                      input_cfg: dict[str, Any]) -> int:
    """Analytic per-device peak-bytes envelope for a train plan:
    weights + grads (model dtype, sharded over tp*pp), fp32 Adam
    moments (additionally sharded over dp under ZeRO>=1), and a
    2-plane activation envelope sharded over (dp, sp, pp)."""
    from dlbb_tpu_torch.models.transformer import num_parameters

    pbytes = _DTYPE_BYTES.get(model_cfg.dtype, 4)
    params = num_parameters(model_cfg)
    shard = max(point.tp, 1) * max(point.pp, 1)
    w_g = 2 * params * pbytes // shard
    opt_shard = shard * (max(point.dp, 1) if point.zero_stage >= 1 else 1)
    opt = 8 * params // opt_shard
    b = int(input_cfg["batch_size"])
    s = int(input_cfg["sequence_length"])
    acts = (2 * b * s * model_cfg.hidden_size
            * model_cfg.num_layers * pbytes
            // (max(point.dp, 1) * max(point.sp, 1) * max(point.pp, 1)))
    return w_g + opt + acts


def prune_point(
    point: PlanPoint,
    model_cfg: ModelConfig,
    tier: CostTier,
    n_devices: int,
    serving: Optional[dict[str, Any]] = None,
    input_cfg: Optional[dict[str, Any]] = None,
) -> Optional[tuple[str, str]]:
    """Static feasibility check; ``None`` for a survivor, otherwise
    ``(reason, detail)`` with reason in :data:`PRUNE_REASONS`.

    Serving points run the engine's own ``ServingConfig.validate``
    contract (the very checks the real build would raise); train points
    run the shared ``validate_*`` family.  Either way a rejection quotes
    the contract's message — the journal stays actionable."""
    model_pt = _point_model(point, model_cfg)
    needed = point.dp * point.tp * point.sp * point.pp
    if needed > n_devices:
        return (PRUNE_VALIDATION,
                f"plan needs {needed} devices, mesh has {n_devices}")
    try:
        if point.target == "serving":
            serving = serving or DEFAULT_PLAN_SERVING
            from dlbb_tpu_torch.serve.engine import ServingConfig

            cfg = ServingConfig.from_dict({
                **serving,
                "decode_horizon": point.decode_horizon,
                "inflight_window": point.inflight_window,
                "prefill_chunk": point.prefill_chunk,
                "compact_threshold": point.compact_threshold,
            })
            cfg.validate(model_pt, dp=point.dp, tp=point.tp)
        else:
            input_cfg = input_cfg or DEFAULT_PLAN_INPUT
            validate_attention_parallelism(model_pt, point.sp)
            validate_expert_parallelism(model_pt, 1)
            validate_tp_overlap(
                model_pt if point.tp_overlap == "off"
                else _with_overlap(model_pt, point.tp_overlap),
                point.tp, pp=point.pp,
                seq_len=int(input_cfg["sequence_length"]), sp=point.sp,
            )
            if point.pp > 1:
                from dlbb_tpu_torch.parallel.pipeline import validate_pipeline

                validate_pipeline(model_pt, point.pp,
                                  int(input_cfg["batch_size"]), None)
            if int(input_cfg["batch_size"]) % (point.dp * point.sp):
                raise ValueError(
                    f"batch_size={input_cfg['batch_size']} not divisible "
                    f"by dp*sp={point.dp * point.sp}"
                )
            if int(input_cfg["sequence_length"]) % point.sp:
                raise ValueError(
                    f"sequence_length={input_cfg['sequence_length']} not "
                    f"divisible by sp={point.sp}"
                )
    except ValueError as e:
        return (PRUNE_VALIDATION, str(e))

    if point.target == "serving":
        peak = _serving_peak_bytes(point, model_pt,
                                   serving or DEFAULT_PLAN_SERVING)
    else:
        peak = _train_peak_bytes(point, model_pt,
                                 input_cfg or DEFAULT_PLAN_INPUT)
    headroom = hbm_headroom_bytes(peak, tier)
    if headroom is not None and headroom < 0:
        return (PRUNE_HBM,
                f"peak {peak} B exceeds tier hbm {tier.hbm_bytes} B "
                f"(headroom {headroom} B)")
    return None


def _with_overlap(model_cfg: ModelConfig, overlap: str) -> ModelConfig:
    from dataclasses import replace

    return replace(model_cfg, tp_overlap=overlap)


# ---------------------------------------------------------------------------
# cm2 prediction
# ---------------------------------------------------------------------------


def _compute_shard(point: PlanPoint, tier: CostTier) -> float:
    """Effective compute-sharding divisor for this tier.

    On a real chip mesh, per-device FLOPs divide by the mesh extent.  On
    the CPU-simulated tiers (``*sim*``) the "devices" are serialized on
    the host — sharding moves work between fake devices without removing
    any of it from the wall clock, so the honest divisor is 1 (the same
    host-core caveat every measured corpus in this repo carries; the cm2
    peak was fitted against exactly such host-serial programs)."""
    if "sim" in tier.name:
        return 1.0
    return float(point.dp * point.tp * point.sp * point.pp)


def predict_serving_per_token_us(
    point: PlanPoint,
    model_cfg: ModelConfig,
    serving: dict[str, Any],
    tier: CostTier,
) -> dict[str, float]:
    """cm2-predicted steady-state decode cost per generated token.

    Composed from the fitted primitives, mirroring how the schedule
    auditor prices compiled programs: one decode step moves the full
    batch one token — per-device compute (QKV/out/FFN at S=1 plus the
    KV-context attention reads at the half-full envelope), 2 tp
    collectives per layer when tp > 1, and the fitted dispatch overhead
    amortized over the fused horizon K and the in-flight window W (the
    two knobs whose entire purpose is to shrink the gamma term)."""
    from dlbb_tpu_torch.models.transformer import forward_flops

    pbytes = _DTYPE_BYTES.get(model_cfg.dtype, 4)
    b = int(serving["max_batch"])
    ms = int(serving["max_seq"])
    h, nl = model_cfg.hidden_size, model_cfg.num_layers
    flops = forward_flops(model_cfg, b, 1) + 4 * b * (ms // 2) * h * nl
    compute = compute_cost_us(flops / _compute_shard(point, tier), tier)
    comm = 0.0
    if point.tp > 1:
        msg = (b // max(point.dp, 1)) * h * pbytes
        wire = 2 * (point.tp - 1) / point.tp * msg
        comm = 2 * nl * collective_cost_us(wire, tier)
    disp = dispatch_cost_us(1, tier) / (
        point.decode_horizon * point.inflight_window
    )
    step = compute + comm + disp
    return {
        "cost_us": step / b,
        "step_us": step,
        "compute_us": compute,
        "comm_us": comm,
        "dispatch_us": disp,
    }


def predict_ttft_us(
    point: PlanPoint,
    model_cfg: ModelConfig,
    serving: dict[str, Any],
    tier: CostTier,
    prompt_len: int,
) -> float:
    """cm2-predicted prefill latency for one request (queueing excluded:
    this is the unloaded-floor TTFT the capacity planner compares to the
    SLO).  A single request shards over tp only; chunked prefill pays
    one dispatch per chunk."""
    from dlbb_tpu_torch.models.transformer import forward_flops

    pbytes = _DTYPE_BYTES.get(model_cfg.dtype, 4)
    h, nl = model_cfg.hidden_size, model_cfg.num_layers
    flops = forward_flops(model_cfg, 1, prompt_len)
    # one request shards over tp only (dp is a batch axis) — and over
    # nothing at all on the host-serial sim tiers (see _compute_shard)
    tp_div = 1.0 if "sim" in tier.name else float(max(point.tp, 1))
    compute = compute_cost_us(flops / tp_div, tier)
    comm = 0.0
    if point.tp > 1:
        wire = 2 * (point.tp - 1) / point.tp * prompt_len * h * pbytes
        comm = 2 * nl * collective_cost_us(wire, tier)
    chunks = 1
    if point.prefill_chunk:
        chunks = max(1, math.ceil(prompt_len / point.prefill_chunk))
    return compute + comm + dispatch_cost_us(chunks, tier)


def predict_train_step_us(
    point: PlanPoint,
    model_cfg: ModelConfig,
    input_cfg: dict[str, Any],
    tier: CostTier,
) -> dict[str, float]:
    """cm2-predicted training step time: 3x-forward compute sharded over
    the full mesh, tp collectives (4 per layer fwd+bwd), sp attention
    exchange (ring: sp-1 staged sends; ulysses: 2 all-to-alls), the dp
    gradient allreduce (compression shrinks wire bytes to 1 B/elem but
    pays quant/dequant compute + 2 dispatches), the ZeRO-1
    reduce-scatter/allgather split, the pipeline bubble, and the
    decomposed-overlap dispatch penalty (on the host-serial simulated
    mesh the ring/bidir schedules ADD chunk dispatches without hiding
    comm — exactly what the calibration baseline measured)."""
    from dlbb_tpu_torch.models.transformer import forward_flops, num_parameters

    pbytes = _DTYPE_BYTES.get(model_cfg.dtype, 4)
    b = int(input_cfg["batch_size"])
    s = int(input_cfg["sequence_length"])
    h, nl = model_cfg.hidden_size, model_cfg.num_layers
    params = num_parameters(model_cfg)
    shard = _compute_shard(point, tier)
    compute = compute_cost_us(3 * forward_flops(model_cfg, b, s) / shard,
                              tier)
    if point.pp > 1:
        m = point.pp  # validate_pipeline default: one microbatch/stage
        compute *= (m + point.pp - 1) / m
    comm = 0.0
    disp = dispatch_cost_us(1, tier)
    if point.tp > 1:
        msg = b * s * h * pbytes / (point.dp * point.sp)
        wire = 2 * (point.tp - 1) / point.tp * msg
        comm += 4 * nl * collective_cost_us(wire, tier)
        if point.tp_overlap == "ring":
            disp += 2 * nl * dispatch_cost_us(point.tp - 1, tier)
        elif point.tp_overlap == "bidir":
            disp += 2 * nl * dispatch_cost_us(max(point.tp // 2, 1), tier)
    if point.sp > 1:
        msg = b * s * h * pbytes / (point.dp * point.sp)
        if point.attention == "ulysses":
            comm += 2 * nl * collective_cost_us(msg, tier)
        else:  # ring
            comm += nl * (point.sp - 1) * collective_cost_us(
                msg / point.sp, tier)
    if point.dp > 1:
        grad_bytes = params * pbytes / (point.tp * point.pp)
        if point.grad_compression != "none":
            grad_bytes /= pbytes  # 1 byte/elem on the wire
            compute += compute_cost_us(
                4 * params / (point.tp * point.pp), tier)
            disp += dispatch_cost_us(2, tier)
        wire = 2 * (point.dp - 1) / point.dp * grad_bytes
        comm += collective_cost_us(wire, tier)
        if point.zero_stage >= 1:
            disp += dispatch_cost_us(1, tier)
    if point.pp > 1:
        disp += dispatch_cost_us(2 * point.pp * point.pp, tier)
    step = compute + comm + disp
    return {
        "cost_us": step,
        "compute_us": compute,
        "comm_us": comm,
        "dispatch_us": disp,
    }


def predict_point_us(
    point: PlanPoint,
    model_cfg: ModelConfig,
    tier: CostTier,
    serving: Optional[dict[str, Any]] = None,
    input_cfg: Optional[dict[str, Any]] = None,
) -> dict[str, float]:
    """Dispatch to the target's predictor; ``cost_us`` is the ranking
    scalar (per-token for serving, per-step for train)."""
    model_pt = _point_model(point, model_cfg)
    if point.target == "serving":
        return predict_serving_per_token_us(
            point, model_pt, serving or DEFAULT_PLAN_SERVING, tier)
    return predict_train_step_us(
        point, model_pt, input_cfg or DEFAULT_PLAN_INPUT, tier)


def rank_points(
    scored: list[tuple[PlanPoint, dict[str, float]]],
) -> list[tuple[PlanPoint, dict[str, float]]]:
    """Deterministic ranking: predicted cost (rounded to ns so fp noise
    cannot reorder), then plan complexity (simpler wins a tie), then the
    lexical key (total order of last resort)."""
    return sorted(
        scored,
        key=lambda pc: (round(pc[1]["cost_us"], 3),
                        pc[0].complexity(), pc[0].key()),
    )


def heuristic_point(
    target: str,
    n_devices: int,
    model_cfg: ModelConfig,
    serving: Optional[dict[str, Any]] = None,
) -> PlanPoint:
    """The default-heuristic plan the search must beat: what the serving
    CLI picks with no flags (``default_parallelism`` + every fast-path
    knob off), or plain DDP for train."""
    if target == "serving":
        serving = serving or DEFAULT_PLAN_SERVING
        from dlbb_tpu_torch.serve.bench import default_parallelism

        dp, tp = default_parallelism(n_devices, model_cfg.kv_heads,
                                     int(serving["max_batch"]))
        return PlanPoint(target="serving", dp=dp, tp=tp)
    return PlanPoint(target="train", dp=n_devices)


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


def _measure_serving(
    point: PlanPoint,
    model_dict: dict[str, Any],
    serving: dict[str, Any],
    trace: Any,
    out_dir: Path,
    device: Optional[Any] = None,
) -> dict[str, Any]:
    """One real serving run for this plan on the shared seeded trace, on
    its ``dp x tp`` ranks (module docstring)."""
    from dlbb_tpu_torch.serve.bench import _launched, serve_worker

    config = {
        "model": dict(model_dict),
        "serving": {
            **serving,
            "decode_horizon": point.decode_horizon,
            "inflight_window": point.inflight_window,
            "prefill_chunk": point.prefill_chunk,
            "compact_threshold": point.compact_threshold,
        },
        "parallelism": {"world_size": point.tp,
                        "data_parallel": point.dp},
    }
    report = _launched(serve_worker, point.dp * point.tp, device,
                       (config, trace, str(out_dir), False, None, device))
    return {
        "goodput_tokens_per_s": report["goodput_tokens_per_s"],
        "throughput_tokens_per_s": report["throughput_tokens_per_s"],
        "ttft_p50_s": report["ttft"]["median"],
        "completed": report["requests"]["completed"],
        "total": report["requests"]["arrived"],
    }


def train_worker(config: dict[str, Any], output_dir: str, device) -> dict[str, Any]:
    """One rank of :func:`_measure_train` (launched by name)."""
    from dlbb_tpu_torch.train.loop import run_train

    return run_train(config, device=device, output_dir=output_dir, verbose=False)


def _measure_train(
    point: PlanPoint,
    model_dict: dict[str, Any],
    input_cfg: dict[str, Any],
    out_dir: Path,
    device: Optional[Any] = None,
    iterations: int = 4,
) -> dict[str, Any]:
    """One real training run for this plan (short measured window), on its
    ``dp x sp x pp x tp`` ranks (module docstring)."""
    from dlbb_tpu_torch.serve.bench import _launched

    model = dict(model_dict)
    if point.tp_overlap != "off":
        model["tp_overlap"] = point.tp_overlap
    if point.attention is not None:
        model["attention"] = point.attention
    config = {
        "experiment": {"name": f"autotune_{point.key()}"},
        "model": model,
        "parallelism": {
            "world_size": point.tp, "data_parallel": point.dp,
            "sequence_parallel": point.sp,
            "pipeline_parallel": point.pp,
        },
        "input": dict(input_cfg),
        "training": {"grad_compression": point.grad_compression,
                     "zero_stage": point.zero_stage},
        "execution": {"warmup_iterations": 1,
                      "benchmark_iterations": iterations},
    }
    report = _launched(train_worker, point.dp * point.sp * point.pp * point.tp, device,
                       (config, str(out_dir), device))
    return {
        "step_time_mean_s": report["step_time"]["mean"],
        "tokens_per_second": report["tokens_per_second"],
    }


# ---------------------------------------------------------------------------
# agreement
# ---------------------------------------------------------------------------


def calibration_agreement(
    baseline_path: "str | Path" = DEFAULT_CAL_BASELINE,
    families: Optional[dict[str, list[tuple[str, float]]]] = None,
) -> dict[str, Any]:
    """Model-picked vs measured-winner agreement over the committed
    calibration grid: for each family, does the cm2 top-2 (by predicted
    cost) contain the measured winner?  Families with members missing
    from the baseline are reported with status ``missing-target`` and
    excluded from the ratio denominator — visibly, never silently."""
    import json

    families = families or CAL_FAMILIES
    path = Path(baseline_path)
    if not path.exists():
        return {"ratio": None, "families": [],
                "error": f"calibration baseline not found: {path}"}
    data = json.loads(path.read_text())
    by_target = {t["target"]: t for t in data.get("targets", [])}
    rows: list[dict[str, Any]] = []
    agree = total = 0
    for fam, members in families.items():
        entries = []
        missing = [name for name, _ in members if name not in by_target]
        if missing:
            rows.append({"family": fam, "status": "missing-target",
                         "missing": missing})
            continue
        for name, div in members:
            t = by_target[name]
            entries.append({
                "member": name,
                "predicted_us": t["predicted_us"] / div,
                "measured_us": t["measured_us"] / div,
            })
        pred_order = sorted(entries, key=lambda e: e["predicted_us"])
        meas_winner = min(entries, key=lambda e: e["measured_us"])
        top2 = [e["member"] for e in pred_order[:2]]
        ok = meas_winner["member"] in top2
        agree += int(ok)
        total += 1
        rows.append({
            "family": fam, "status": "ok",
            "predicted_order": [e["member"] for e in pred_order],
            "measured_winner": meas_winner["member"],
            "top2_contains_winner": ok,
            "members": entries,
        })
    return {
        "ratio": (agree / total) if total else None,
        "agree": agree, "total": total,
        "families": rows,
        "baseline": str(path),
    }


def _live_agreement(
    measured: list[dict[str, Any]],
    metric: str,
    higher_is_better: bool,
) -> dict[str, Any]:
    """Agreement over the points actually measured this run: ranks by
    cm2 prediction vs ranks by measurement, and whether the measured
    winner sits in the predicted top-2."""
    if not measured:
        return {"rows": [], "top1_match": None, "top2_contains": None}
    by_pred = sorted(measured, key=lambda r: r["predicted_us"])
    by_meas = sorted(measured, key=lambda r: r[metric],
                     reverse=higher_is_better)
    pred_rank = {r["plan"]: i + 1 for i, r in enumerate(by_pred)}
    meas_rank = {r["plan"]: i + 1 for i, r in enumerate(by_meas)}
    rows = []
    for r in measured:
        rows.append({**r, "predicted_rank": pred_rank[r["plan"]],
                     "measured_rank": meas_rank[r["plan"]]})
    winner = by_meas[0]["plan"]
    top2 = [r["plan"] for r in by_pred[:2]]
    return {
        "rows": sorted(rows, key=lambda r: r["measured_rank"]),
        "measured_winner": winner,
        "predicted_winner": by_pred[0]["plan"],
        "top1_match": winner == by_pred[0]["plan"],
        "top2_contains": winner in top2,
    }


# ---------------------------------------------------------------------------
# the search driver
# ---------------------------------------------------------------------------


def run_plan_search(
    target: str = "serving",
    n_devices: int = 8,
    model: Optional[dict[str, Any]] = None,
    serving: Optional[dict[str, Any]] = None,
    input_cfg: Optional[dict[str, Any]] = None,
    top_k: int = 2,
    output_dir: "str | Path" = "results/torch/autotune",
    trace: str = "poisson",
    num_requests: int = 24,
    seed: int = 42,
    rate: Optional[float] = None,
    trace_params: Optional[dict[str, Any]] = None,
    tier_name: str = DEFAULT_TIER,
    fit_dir: "Optional[str | Path]" = None,
    fit_version: Optional[int] = None,
    measure: bool = True,
    mesh_champions: bool = True,
    device: Optional[Any] = None,
    verbose: bool = True,
    bench_out: "Optional[str | Path]" = None,
    cal_baseline: "str | Path" = DEFAULT_CAL_BASELINE,
) -> dict[str, Any]:
    """The predict-prune-measure loop.  Returns the full report dict and
    writes ``autotune_report.json`` + journal + ``sweep_manifest.json``
    + ``metrics.prom`` under ``output_dir`` (and ``BENCH_autotune.json``
    when ``bench_out`` is set).  ``device`` is where the measured plans run
    (``cuda`` unless the caller names ``cpu``)."""
    if target not in ("serving", "train"):
        raise ValueError(f"unknown plan target {target!r} "
                         "(expected 'serving' or 'train')")
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    model_dict = {**DEFAULT_PLAN_MODEL, **(model or {})}
    serving_env = {**DEFAULT_PLAN_SERVING, **(serving or {})}
    input_env = {**DEFAULT_PLAN_INPUT, **(input_cfg or {})}
    model_cfg = ModelConfig.from_dict(model_dict)

    journal = SweepJournal(out, meta={"mode": "plan-auto",
                                      "target": target,
                                      "devices": n_devices})
    registry = MetricsRegistry()
    counts = registry.labeled_counter(
        "plan_search_points", "outcome",
        initial=("searched", "measured")
        + tuple(f"pruned-{r}" for r in PRUNE_REASONS),
        help="autotuner plan-space accounting by outcome",
    )

    if target == "serving":
        points = enumerate_serving_space(model_cfg, n_devices, serving_env)
    else:
        points = enumerate_train_space(model_cfg, n_devices)
    counts["searched"] += len(points)

    def _finish(payload: dict[str, Any]) -> dict[str, Any]:
        cal = payload.get("calibration_agreement") or {}
        if cal.get("ratio") is not None:
            registry.set_gauge(
                "plan_agreement_ratio", cal["ratio"],
                help="cm2 top-2 contains measured winner (fraction)",
                scope="calibration-grid",
            )
        live = payload.get("agreement") or {}
        if live.get("top2_contains") is not None:
            registry.set_gauge(
                "plan_agreement_ratio",
                1.0 if live["top2_contains"] else 0.0,
                help="cm2 top-2 contains measured winner (fraction)",
                scope="measured-topk",
            )
        registry.write_textfile(out / "metrics.prom")
        from dlbb_tpu_torch.bench.schedule import write_sweep_manifest

        write_sweep_manifest(out, {
            "mode": "plan-auto",
            "target": target,
            "devices": n_devices,
            "searched": counts["searched"],
            "pruned": {r: counts[f"pruned-{r}"] for r in PRUNE_REASONS},
            "measured": counts["measured"],
            "winner": payload.get("winner"),
            "speedup_vs_default": payload.get("speedup_vs_default"),
            "agreement": {
                "calibration_ratio": cal.get("ratio"),
                "measured_top2_contains": live.get("top2_contains"),
            },
        })
        journal.event("sweep-complete",
                      searched=counts["searched"],
                      measured=counts["measured"])
        journal.close()
        save_json(payload, out / "autotune_report.json")
        return payload

    # cm2 is the ranking model or there is no ranking: a missing fit
    # journals EVERY point and fails the search closed (ranking with the
    # cm1 analytic seed would launder guesses as "model-picked")
    try:
        tier = load_fitted_tier(tier_name, fit_dir or DEFAULT_FIT_DIR,
                                fit_version)
    except FitMissingError as e:
        for p in points:
            counts[f"pruned-{PRUNE_FIT}"] += 1
            journal.event("plan-pruned", config=p.key(),
                          reason=PRUNE_FIT, detail=str(e))
        if verbose:
            print(f"plan --auto: {len(points)} points pruned "
                  f"({PRUNE_FIT}): {e}")
        return _finish({
            "schema": AUTOTUNE_SCHEMA, "target": target,
            "error": f"{PRUNE_FIT}: {e}",
            "searched": len(points), "ranked": [], "measured": [],
            "calibration_agreement": None,
        })

    survivors: list[tuple[PlanPoint, dict[str, float]]] = []
    pruned_rows: list[dict[str, Any]] = []
    for p in points:
        res = prune_point(p, model_cfg, tier, n_devices,
                          serving=serving_env, input_cfg=input_env)
        if res is not None:
            reason, detail = res
            counts[f"pruned-{reason}"] += 1
            journal.event("plan-pruned", config=p.key(),
                          reason=reason, detail=detail)
            pruned_rows.append({"plan": p.key(), "reason": reason,
                                "detail": detail})
            continue
        survivors.append((p, predict_point_us(
            p, model_cfg, tier, serving=serving_env,
            input_cfg=input_env)))

    ranked = rank_points(survivors)
    for i, (p, pred) in enumerate(ranked):
        journal.event("plan-ranked", config=p.key(), rank=i + 1,
                      predicted_us=round(pred["cost_us"], 3))
    if verbose:
        kept = len(ranked)
        print(f"plan --auto [{target}]: {len(points)} searched, "
              f"{len(points) - kept} pruned, {kept} ranked by cm2 "
              f"(tier {tier.name}, fit v{tier.fit.get('fit_version')})")
        for i, (p, pred) in enumerate(ranked[:5]):
            print(f"  #{i + 1} {p.key()}  predicted "
                  f"{pred['cost_us']:.1f} us")

    default_pt = heuristic_point(target, n_devices, model_cfg,
                                 serving_env)
    to_measure: list[tuple[PlanPoint, dict[str, float], str]] = [
        (p, pred, "top-k") for p, pred in ranked[:top_k]
    ]
    # stratified validation: also measure the predicted-best plan of
    # every surviving mesh factorization — cm2 cannot price the sim
    # host's per-shard scheduling effects, and a mesh the model
    # mis-ranks would otherwise never reach the agreement table (the
    # predicted-vs-measured disagreement is the product, not a failure)
    seen = {p.key() for p, _, _ in to_measure}
    if mesh_champions:
        champs: dict[tuple[int, int, int, int],
                     tuple[PlanPoint, dict]] = {}
        for p, pred in ranked:
            champs.setdefault((p.dp, p.tp, p.sp, p.pp), (p, pred))
        for p, pred in champs.values():
            if p.key() not in seen:
                seen.add(p.key())
                to_measure.append((p, pred, "mesh-champion"))
    if default_pt.key() not in seen:
        default_pred = predict_point_us(
            default_pt, model_cfg, tier, serving=serving_env,
            input_cfg=input_env)
        to_measure.append((default_pt, default_pred, "default-heuristic"))

    measured_rows: list[dict[str, Any]] = []
    if measure and to_measure:
        shared_trace = None
        if target == "serving":
            from dlbb_tpu_torch.serve.bench import resolve_trace

            shared_trace = resolve_trace(
                trace, num_requests=num_requests, seed=seed, rate=rate,
                **(trace_params or {}),
            )
        for p, pred, role in to_measure:
            slug = p.key().replace("[", "_").replace("]", "") \
                .replace(",", "_").replace("=", "")
            mdir = out / "measure" / slug
            if target == "serving":
                m = _measure_serving(p, model_dict, serving_env,
                                     shared_trace, mdir, device=device)
            else:
                m = _measure_train(p, model_dict, input_env, mdir,
                                   device=device)
            counts["measured"] += 1
            row = {"plan": p.key(), "role": role,
                   "predicted_us": round(pred["cost_us"], 3), **m}
            journal.event("plan-measured", config=p.key(), **m)
            measured_rows.append(row)
            if verbose:
                metric = ("goodput_tokens_per_s" if target == "serving"
                          else "tokens_per_second")
                print(f"  measured {p.key()} ({role}): "
                      f"{row[metric]:.0f} tok/s")

    metric = ("goodput_tokens_per_s" if target == "serving"
              else "tokens_per_second")
    agreement = _live_agreement(measured_rows, metric,
                                higher_is_better=True)
    winner = agreement.get("measured_winner")
    speedup = None
    default_row = next((r for r in measured_rows
                        if r["plan"] == default_pt.key()), None)
    winner_row = next((r for r in measured_rows if r["plan"] == winner),
                      None)
    if default_row and winner_row and default_row[metric] > 0:
        speedup = winner_row[metric] / default_row[metric]

    cal = calibration_agreement(cal_baseline)
    payload = {
        "schema": AUTOTUNE_SCHEMA,
        "target": target,
        "devices": n_devices,
        "model": model_dict,
        "serving": serving_env if target == "serving" else None,
        "input": input_env if target == "train" else None,
        "tier": {"name": tier.name, "version": tier.version,
                 "fit": tier.fit},
        "searched": len(points),
        "pruned": {r: counts[f"pruned-{r}"] for r in PRUNE_REASONS},
        "pruned_points": pruned_rows,
        "ranked": [
            {"rank": i + 1, "plan": p.key(),
             "predicted_us": round(pred["cost_us"], 3),
             "complexity": p.complexity(), **p.to_dict()}
            for i, (p, pred) in enumerate(ranked)
        ],
        "measured": measured_rows,
        "winner": winner,
        "default_plan": default_pt.key(),
        "speedup_vs_default": speedup,
        "agreement": agreement,
        "calibration_agreement": cal,
        "trace": {"kind": trace, "num_requests": num_requests,
                  "seed": seed, "rate": rate,
                  "params": trace_params or {}}
        if target == "serving" else None,
    }
    if verbose and speedup is not None:
        print(f"plan --auto: measured winner {winner} = "
              f"{speedup:.2f}x the default heuristic "
              f"({default_pt.key()})")
    result = _finish(payload)
    if bench_out is not None:
        _write_bench(result, Path(bench_out), device)
        if verbose:
            print(f"bench artifact -> {bench_out}")
    return result


def _write_bench(report: dict[str, Any], path: Path, device: Optional[Any] = None) -> Path:
    """The bench artifact (``cli reports`` reads it from ``RESULTS/``)."""
    backend = "cuda" if device is None else str(device).split(":")[0]
    payload = {
        "harness": "dlbb_tpu_torch/plan/autotune.py",
        "schema": BENCH_SCHEMA,
        "backend": backend,
        "methodology": (
            "full plan-space enumeration, static validate_*/HBM pruning "
            "(every pruned point journaled with reason), cm2-predicted "
            "ranking, top-k + default-heuristic measured through the "
            "real engines on one shared seeded trace"
        ),
        **{k: report[k] for k in (
            "target", "devices", "model", "serving", "input", "tier",
            "searched", "pruned", "ranked", "measured", "winner",
            "default_plan", "speedup_vs_default", "agreement",
            "calibration_agreement", "trace",
        ) if k in report},
        "chip": {
            "status": "no-cuda-fit",
            "note": ("the `cuda` tier has no cm2 fit at world 1: one card gives "
                     "NCCL a single wire size, which `obs fit` refuses, so "
                     "`python -m dlbb_tpu_torch.cli plan --auto` on the card "
                     "journals every point cm2-fit-missing; ranked plans on "
                     "the card wait for NCCL at world >= 2"),
        },
    }
    return save_json(payload, path)


# ---------------------------------------------------------------------------
# fleet capacity planner
# ---------------------------------------------------------------------------


def run_capacity_plan(
    n_devices: int = 8,
    plans: Optional[list[PlanPoint]] = None,
    slo: float = 30.0,
    users: tuple[int, ...] = (4, 8, 16, 32, 64),
    user_rate: float = 0.2,
    trace: str = "poisson",
    num_requests: int = 24,
    seed: int = 42,
    rate: Optional[float] = None,
    trace_params: Optional[dict[str, Any]] = None,
    model: Optional[dict[str, Any]] = None,
    serving: Optional[dict[str, Any]] = None,
    output_dir: "str | Path" = "results/torch/capacity",
    tier_name: str = DEFAULT_TIER,
    fit_dir: "Optional[str | Path]" = None,
    device: Optional[Any] = None,
    verbose: bool = True,
    stats_dir: "str | Path" = "stats/torch/serving",
) -> dict[str, Any]:
    """Fleet capacity planning over a traffic trace + SLO.

    Per (plan, replica count): cm2-predicted goodput (1e6 /
    per-token-us per replica) and unloaded-floor TTFT, validated by one
    *measured* serving run per plotted plan (the trace carries
    ``deadline_s`` = SLO so shed/late requests are the engine's own
    accounting).  A "user" is a request stream issuing ``user_rate``
    req/s; serving N users within SLO needs
    ``ceil(N * user_rate * mean_output_tokens / per-replica goodput)``
    replicas, provided the plan's measured TTFT p50 fits the SLO.
    Replica scaling is linear extrapolation (replicas are independent
    engines behind a round-robin splitter) — stated, not hidden.  That
    assumption is now the literal runtime architecture: ``cli serve
    --replicas N`` runs the counted replicas as independent failure
    domains under ``serve/fleet.py``'s supervisor (least-loaded
    admission, failover re-prefill — docs/fleet.md), and
    ``BENCH_fleet.json`` prices what a replica death costs the curve.

    The curve is published under ``stats_dir`` (the port's serving report
    tree).  With ``plans`` None the static search runs first, into
    ``output_dir/static_search``: without a fit it journals every point
    ``cm2-fit-missing`` there before the planner raises
    :class:`FitMissingError` (JAX raises before any search)."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    model_dict = {**DEFAULT_PLAN_MODEL, **(model or {})}
    serving_env = {**DEFAULT_PLAN_SERVING, **(serving or {})}
    model_cfg = ModelConfig.from_dict(model_dict)
    static = None
    if plans is None:
        # default fleet candidates: the no-flags heuristic plan + the
        # cm2-ranked winner of a fresh static search (measure=False —
        # the capacity run itself is the measurement)
        static = run_plan_search(
            target="serving", n_devices=n_devices, model=model,
            serving=serving, measure=False, verbose=False,
            output_dir=out / "static_search", tier_name=tier_name,
            fit_dir=fit_dir,
        )
    tier = load_fitted_tier(tier_name, fit_dir or DEFAULT_FIT_DIR)

    journal = SweepJournal(out, meta={"mode": "plan-capacity",
                                      "devices": n_devices,
                                      "slo_s": slo})

    if static is not None:
        plans = [heuristic_point("serving", n_devices, model_cfg,
                                 serving_env)]
        ranked = static.get("ranked", [])
        if ranked:
            best = ranked[0]
            pt = PlanPoint(**{
                k: best[k] for k in (
                    "target", "dp", "tp", "sp", "pp", "tp_overlap",
                    "grad_compression", "zero_stage", "attention",
                    "decode_horizon", "prefill_chunk",
                    "compact_threshold", "inflight_window")
            })
            if pt.key() not in {p.key() for p in plans}:
                plans.append(pt)

    from dlbb_tpu_torch.serve.bench import resolve_trace

    shared_trace = resolve_trace(
        trace, num_requests=num_requests, seed=seed, rate=rate,
        deadline_s=slo, **(trace_params or {}),
    )
    prompt_mean = int(round(
        sum(r.prompt_len for r in shared_trace.requests)
        / max(len(shared_trace.requests), 1)))
    output_mean = (sum(r.output_len for r in shared_trace.requests)
                   / max(len(shared_trace.requests), 1))

    plan_rows: list[dict[str, Any]] = []
    for p in plans:
        pred = predict_serving_per_token_us(
            p, _point_model(p, model_cfg), serving_env, tier)
        goodput_pred = 1e6 / pred["cost_us"]
        ttft_pred_s = predict_ttft_us(
            p, _point_model(p, model_cfg), serving_env, tier,
            prompt_mean) / 1e6
        slug = p.key().replace("[", "_").replace("]", "") \
            .replace(",", "_")
        m = _measure_serving(p, model_dict, serving_env, shared_trace,
                             out / "measure" / slug, device=device)
        journal.event("capacity-measured", config=p.key(), **m)
        row = {
            "plan": p.key(),
            "point": p.to_dict(),
            "predicted_goodput_tokens_per_s": round(goodput_pred, 1),
            "predicted_ttft_s": round(ttft_pred_s, 6),
            "measured_goodput_tokens_per_s":
                round(m["goodput_tokens_per_s"], 1),
            "measured_ttft_p50_s": round(m["ttft_p50_s"], 6),
            "completed": m["completed"], "total": m["total"],
            "slo_attainable": m["ttft_p50_s"] <= slo,
            "curve": [],
        }
        for n in users:
            demand = n * user_rate * output_mean  # tokens/s
            def _replicas(goodput: float, ttft: float) -> Optional[int]:
                if goodput <= 0 or ttft > slo:
                    return None  # no replica count rescues a blown TTFT
                return max(1, math.ceil(demand / goodput))
            row["curve"].append({
                "users": n,
                "demand_tokens_per_s": round(demand, 1),
                "replicas_predicted": _replicas(goodput_pred,
                                                ttft_pred_s),
                "replicas_measured": _replicas(
                    m["goodput_tokens_per_s"], m["ttft_p50_s"]),
            })
        plan_rows.append(row)
        if verbose:
            print(f"capacity {p.key()}: predicted "
                  f"{goodput_pred:.0f} tok/s, measured "
                  f"{m['goodput_tokens_per_s']:.0f} tok/s, "
                  f"ttft p50 {m['ttft_p50_s'] * 1e3:.1f} ms "
                  f"(SLO {slo:g} s)")

    report = {
        "schema": CAPACITY_SCHEMA,
        "devices": n_devices,
        "model": model_dict,
        "serving": serving_env,
        "slo_s": slo,
        "user_rate_req_per_s": user_rate,
        "mean_prompt_tokens": prompt_mean,
        "mean_output_tokens": round(output_mean, 1),
        "trace": {"kind": trace, "num_requests": num_requests,
                  "seed": seed, "rate": rate, "deadline_s": slo,
                  "params": trace_params or {}},
        "tier": {"name": tier.name, "version": tier.version,
                 "fit": tier.fit},
        "plans": plan_rows,
        "replica_model": ("linear extrapolation: replicas are "
                          "independent engines behind round-robin "
                          "admission; one measured run per plan "
                          "anchors the per-replica numbers"),
    }
    save_json(report, out / "capacity_report.json")
    journal.event("sweep-complete", plans=len(plan_rows))
    journal.close()

    # publish the curve into the serving report tree (SERVING.md)
    from dlbb_tpu_torch.stats.serving_report import publish_capacity_curve

    md = publish_capacity_curve(report, stats_dir)
    if verbose:
        print(f"capacity report -> {out / 'capacity_report.json'}; "
              f"curve -> {md}")
    return report
