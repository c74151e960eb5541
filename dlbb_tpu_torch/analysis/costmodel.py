"""Versioned α–β / peak-FLOPs cost-model table (a copy of
``dlbb_tpu/analysis/costmodel.py``; the port imports nothing of the JAX
package).

A collective moving ``w`` analytic wire bytes on tier ``t`` costs
``α(t) + w / β(t)`` microseconds and a dense-compute step of ``f`` FLOPs
``f / peak(t)``.  The numbers are seeds, and ``obs/fit.py`` replaces them
with coefficients fitted from sweep artifacts (cm2).  Any change to a
number of an existing tier bumps ``COST_MODEL_VERSION``: a report records
the version it was priced with.

Tier provenance:

- ``cpu-sim``, ``tpu-v5lite``, ``tpu-v5lite-dcn``: JAX's three cm1 tiers,
  field for field (the host-process mesh, a TPU v5e slice's ICI, and the
  cross-slice network).  ``cpu-sim`` is also the tier of the port's gloo
  artifacts on the CPU (``obs/corpus.py::tier_of_result``).
- ``cuda``: the tier of the port's artifacts on an NVIDIA H100 80GB HBM3
  (``system_info.backend`` ``cuda``).  Its seeds: the datasheet's 989
  TFLOP/s bf16 peak at 700 W, NVLink 4's 450 GB/s per direction for β,
  the card's 80 GB for the capacity, and α from NCCL's median at 1 KB on
  a one-rank communicator on that card (PERF.md §3).  Adding a tier
  changes no number of an existing one, so the version stays "cm1".

The fitted DB of the port lives under ``stats/torch/analysis/
costmodel_fit``, never beside JAX's: a cm2 fitted on XLA's host mesh
prices no gloo or NCCL run.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

COST_MODEL_VERSION = "cm1"

# the fitted model: coefficients regressed from the measured sweep corpus
# (obs/corpus.py, obs/fit.py) into a versioned DB; resolve_tier(...,
# model=CM2_VERSION) loads the latest fit and prices with it
CM2_VERSION = "cm2"
KNOWN_MODELS = (COST_MODEL_VERSION, CM2_VERSION)

FIT_SCHEMA = "dlbb_costmodel_fit_v1"
DEFAULT_FIT_DIR = Path("stats/torch/analysis/costmodel_fit")


@dataclass(frozen=True)
class CostTier:
    """One link and compute tier of the α–β table.

    alpha_us:           per-collective fixed latency in µs.
    beta_bytes_per_us:  sustained link bandwidth (1 GB/s == 1000 bytes/µs).
    peak_flops_per_us:  dense-compute peak (1 TFLOP/s == 1e6 FLOPs/µs).
    gamma_dispatch_us:  per-dispatch host overhead; 0 in cm1, fitted in cm2.
    hbm_bytes:          per-device memory capacity (0 = unknown).  A
                        capacity record, never a priced coefficient, so
                        changing it does not bump COST_MODEL_VERSION.
    version:            the cost model the numbers came from ("cm1"
                        seeds, "cm2" fitted).
    fit:                fit metadata (coefficient CIs, residuals, sample
                        counts, fit_version) when version == "cm2".
    """

    name: str
    alpha_us: float
    beta_bytes_per_us: float
    peak_flops_per_us: float
    description: str = ""
    gamma_dispatch_us: float = 0.0
    hbm_bytes: float = 0.0
    version: str = COST_MODEL_VERSION
    fit: Optional[dict] = field(default=None, compare=False)


# version -> tier name -> CostTier.  Append-only: old versions stay so a
# report priced with them remains interpretable.
COST_MODELS: dict[str, dict[str, CostTier]] = {
    "cm1": {
        "cpu-sim": CostTier(
            name="cpu-sim",
            alpha_us=1.0,
            beta_bytes_per_us=10_000.0,      # ~10 GB/s shared-memory copy
            peak_flops_per_us=50_000.0,      # ~50 GFLOP/s single core
            hbm_bytes=2.0 * 2**30,           # ~2 GiB host-RAM share/device
            description="--simulate N host-process mesh (CI baseline tier)",
        ),
        "tpu-v5lite": CostTier(
            name="tpu-v5lite",
            alpha_us=1.0,
            beta_bytes_per_us=45_000.0,      # ~45 GB/s/dir ICI link
            peak_flops_per_us=197_000_000.0,  # 197 TFLOP/s bf16 peak
            hbm_bytes=16.0 * 2**30,          # 16 GiB HBM per v5e chip
            description="TPU v5e single slice, ICI ring",
        ),
        "tpu-v5lite-dcn": CostTier(
            name="tpu-v5lite-dcn",
            alpha_us=10.0,
            beta_bytes_per_us=12_500.0,      # ~100 Gb/s DCN
            peak_flops_per_us=197_000_000.0,
            hbm_bytes=16.0 * 2**30,
            description="TPU v5e cross-slice data-center network",
        ),
        "cuda": CostTier(
            name="cuda",
            # the median of NCCL's 1 KB medians over the nine sweep ops on a
            # one-rank communicator, NVIDIA H100 80GB HBM3 at 700 W
            # (chip_smoke.py phase comm, PERF.md §3)
            alpha_us=54.93,
            beta_bytes_per_us=450_000.0,     # NVLink 4, 450 GB/s/direction
            peak_flops_per_us=989_000_000.0,  # 989 TFLOP/s bf16 peak, 700 W
            hbm_bytes=80.0 * 2**30,          # 80 GB HBM3
            description="NVIDIA H100 80GB HBM3 over NCCL (NVLink 4)",
        ),
    },
}

DEFAULT_TIER = "cpu-sim"


def get_tier(name: Optional[str] = None,
             version: str = COST_MODEL_VERSION) -> CostTier:
    """Look up a tier in one model version; raises KeyError with the known
    names on a typo so the CLI error is actionable."""
    table = COST_MODELS.get(version)
    if table is None:
        raise KeyError(
            f"unknown cost-model version {version!r}; "
            f"known: {sorted(COST_MODELS)}"
        )
    tier = table.get(name or DEFAULT_TIER)
    if tier is None:
        raise KeyError(
            f"unknown cost-model tier {name!r}; known: {sorted(table)}"
        )
    return tier


def collective_cost_us(wire_bytes: int, tier: CostTier) -> float:
    """α + bytes/β: the Hockney cost of moving ``wire_bytes`` per-device
    analytic wire bytes over one tier."""
    return tier.alpha_us + wire_bytes / tier.beta_bytes_per_us


def compute_cost_us(flops: int, tier: CostTier) -> float:
    """FLOPs / peak: dense-compute time at the tier's peak throughput."""
    return flops / tier.peak_flops_per_us


def dispatch_cost_us(dispatch_count: int, tier: CostTier) -> float:
    """γ x dispatches: the host-side cost of launching ``dispatch_count``
    programs, the term cm1 omits (γ = 0) and cm2 fits."""
    return dispatch_count * tier.gamma_dispatch_us


def hbm_headroom_bytes(peak_bytes: int, tier: CostTier) -> Optional[int]:
    """Per-device memory headroom of a program whose peak live bytes are
    ``peak_bytes`` on ``tier``; None when the tier records no capacity."""
    if not tier.hbm_bytes:
        return None
    return int(tier.hbm_bytes) - int(peak_bytes)


def memory_feasible(peak_bytes: int, tier: CostTier) -> Optional[bool]:
    """Whether a program with the given peak fits the tier's per-device
    memory (None = the tier records no capacity)."""
    headroom = hbm_headroom_bytes(peak_bytes, tier)
    return None if headroom is None else headroom >= 0


# ---------------------------------------------------------------------------
# cm2: the fitted model
# ---------------------------------------------------------------------------


class FitMissingError(FileNotFoundError):
    """cm2 was requested but no fitted DB exists for the tier."""


def fit_db_path(tier: str,
                directory: "Optional[str | Path]" = None) -> Path:
    return Path(directory or DEFAULT_FIT_DIR) / f"{CM2_VERSION}_{tier}.json"


def load_fitted_tier(
    name: str,
    directory: "Optional[str | Path]" = None,
    fit_version: Optional[int] = None,
) -> CostTier:
    """The cm2 pricing tier: cm1's seed overlaid with the latest (or a
    pinned ``fit_version``) coefficients of the fitted DB.  Raises
    :class:`FitMissingError` when no DB exists."""
    cm1 = get_tier(name)  # validates the tier name first
    path = fit_db_path(name, directory)
    if not path.exists():
        raise FitMissingError(
            f"no fitted cm2 DB for tier {name!r} at {path} — run "
            "`python -m dlbb_tpu_torch.cli obs fit --results results/torch` and "
            "commit the DB"
        )
    db = json.loads(path.read_text())
    versions = db.get("versions") or []
    if not versions:
        raise FitMissingError(f"fitted DB {path} holds no versions")
    if fit_version is not None:
        matches = [v for v in versions
                   if v.get("fit_version") == fit_version]
        if not matches:
            raise FitMissingError(
                f"fitted DB {path} has no fit_version {fit_version} "
                f"(latest: {versions[-1].get('fit_version')})"
            )
        entry = matches[0]
    else:
        entry = versions[-1]
    coeff = entry["coefficients"]

    def _v(key: str, fallback: float) -> float:
        c = coeff.get(key)
        if isinstance(c, dict) and isinstance(c.get("value"), (int, float)):
            return float(c["value"])
        return fallback

    meta: dict[str, Any] = {
        "fit_version": entry.get("fit_version"),
        "fitted_at": entry.get("fitted_at"),
        "db_path": str(path),
        "samples_used": entry.get("samples_used"),
        "residuals": entry.get("residuals"),
        "coefficients": coeff,
        "alpha_pinned": entry.get("alpha_pinned"),
        "peak_pinned": entry.get("peak_pinned"),
    }
    return CostTier(
        name=name,
        alpha_us=_v("alpha_us", cm1.alpha_us),
        beta_bytes_per_us=_v("beta_bytes_per_us", cm1.beta_bytes_per_us),
        peak_flops_per_us=_v("peak_flops_per_us", cm1.peak_flops_per_us),
        gamma_dispatch_us=_v("gamma_dispatch_us", 0.0),
        hbm_bytes=cm1.hbm_bytes,  # capacity record, never fitted
        description=(f"fitted from the sweep corpus "
                     f"(fit v{entry.get('fit_version')}); "
                     f"seed: {cm1.description}"),
        version=CM2_VERSION,
        fit=meta,
    )


def resolve_tier(
    name: Optional[str] = None,
    model: str = COST_MODEL_VERSION,
    fit_dir: "Optional[str | Path]" = None,
    warn: bool = True,
) -> CostTier:
    """The one model-selection entry point.  cm2 with no fit falls back to
    the cm1 constants with a loud warning; the returned tier's ``version``
    stays "cm1", so a report records which model actually priced it."""
    if model not in KNOWN_MODELS:
        raise KeyError(
            f"unknown cost model {model!r}; known: {list(KNOWN_MODELS)}"
        )
    if model == COST_MODEL_VERSION:
        return get_tier(name)
    try:
        return load_fitted_tier(name or DEFAULT_TIER, fit_dir)
    except FitMissingError as e:
        if warn:
            print(f"[costmodel] WARNING: fit-missing — {e}; "
                  "falling back to cm1 analytic constants")
        return get_tier(name)
