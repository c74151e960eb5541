"""cm2: robust α–β–γ regression over the sweep-artifact corpus (a copy of
``dlbb_tpu/obs/fit.py``; the port imports nothing of the JAX package).

The cm1 table (``analysis/costmodel.py``) prices a collective at ``α +
wire/β`` and compute at ``FLOPs/peak`` from seeded constants, with the
per-dispatch host overhead unmodelled.  This module fits that term and
re-fits the constants from measured data (``obs/corpus.py``):

    measured_us ≈ γ·dispatches + α·collectives + wire/β + FLOPs/peak

solved per tier by weighted least squares (weights ``1/measured``, the
relative-error objective), with:

- **non-negativity** by an active-set loop: a negative coefficient is
  clamped to zero and its column removed;
- **identifiability fallback**: where every sample posts one collective
  per dispatch, α and γ are collinear, so α is pinned to the cm1 seed
  (``alpha_pinned``); peak likewise where no sample carries dense compute
  (``peak_pinned``); a ``host_filter``-ed population with one dispatch
  count pins γ from a pre-fit over the whole tier (``gamma_pinned:
  "tier-corpus"``);
- **device-timed op samples** (the devtrace rows, ``dispatches: 0``),
  exempt from ``host_filter``: they identify β without a dispatch term;
- **outlier rejection**: MAD trimming of the relative residuals (6 MADs,
  two rounds);
- **fail-closed degeneracy checks**: too few samples, a single distinct
  message size (β unidentifiable), or an all-rejected corpus raise
  :class:`FitError` with the reason, and no DB is written.

The result is appended to the versioned DB
(``stats/torch/analysis/costmodel_fit/cm2_<tier>.json``), append-only, with
per-coefficient 95 % CI bounds, sample counts and residual stats;
``analysis/costmodel.py`` loads the latest version as the cm2 tier.

Host-side numpy only.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Any, Optional, Sequence

from dlbb_tpu_torch.analysis.costmodel import (
    FIT_SCHEMA,
    fit_db_path,
    get_tier,
)

MIN_SAMPLES = 16
MIN_DISTINCT_WIRE = 2
OUTLIER_MAD = 6.0
OUTLIER_ROUNDS = 2

_COEFFS = ("gamma_dispatch_us", "alpha_us", "beta_inv", "peak_inv")


class FitError(RuntimeError):
    """A corpus that cannot produce a trustworthy fit (degenerate or
    contradictory) — the caller must NOT get a DB out of it."""


def _finite(x: Any) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x) and x > 0


def fit_tier(
    samples: Sequence[dict[str, Any]],
    tier: str,
    min_samples: int = MIN_SAMPLES,
    host_filter: Optional[str] = None,
    outlier_mad: float = OUTLIER_MAD,
) -> dict[str, Any]:
    """Fit one tier's coefficients from corpus samples.  Returns the fit
    record (the DB version entry, minus the version number); raises
    :class:`FitError` on any degeneracy."""
    import numpy as np

    cm1 = get_tier(tier)  # validates the tier name against cm1's table
    usable = [
        s for s in samples
        if s.get("tier") == tier
        and _finite(s.get("measured_median_us"))
        and s.get("wire_bytes") is not None
    ]
    # device-timed samples (the devtrace op rows, dispatches = 0) are
    # EXEMPT from the host filter: the filter isolates the host-runtime
    # dispatch overhead, which a device-op duration never carries —
    # while the wire behaviour they measure is a property of the
    # backend tier the fit predicts (they are what identifies β)
    device_rows = [s for s in usable if s.get("source") == "devtrace"]
    host_rows = [s for s in usable if s.get("source") != "devtrace"]
    gamma_pin: Optional[float] = None
    if host_filter:
        all_rows = usable
        host_rows = [s for s in host_rows
                     if host_filter in str(s.get("host", ""))]
        if len({float(s.get("dispatches", 1.0))
                for s in host_rows}) == 1:
            # the filtered HOST population cannot identify γ (no
            # dispatch-count variation; the device rows' zeros are no
            # evidence of the per-dispatch cost, only of its absence);
            # pin it from the full tier corpus — the host-runtime
            # constant is population-independent
            try:
                pre = fit_tier(all_rows, tier, min_samples=min_samples,
                               outlier_mad=outlier_mad)
                gamma_pin = pre["coefficients"]["gamma_dispatch_us"][
                    "value"]
            except FitError:
                gamma_pin = None  # full corpus degenerate too: fit free
    rows = host_rows + device_rows
    if not rows:
        raise FitError(
            f"no usable corpus samples for tier {tier!r}"
            + (f" with host filter {host_filter!r}" if host_filter else "")
            + " — every row is missing, non-finite, or filtered out"
        )
    if len(rows) < min_samples:
        raise FitError(
            f"only {len(rows)} corpus sample(s) for tier {tier!r} "
            f"(need >= {min_samples}) — a fit this thin would be noise; "
            "run a wider sweep or lower --min-samples deliberately"
        )
    wires = {s["wire_bytes"] for s in rows}
    if len(wires) < MIN_DISTINCT_WIRE:
        raise FitError(
            f"corpus for tier {tier!r} holds a single message size "
            f"(wire_bytes={next(iter(wires))}) — β is unidentifiable "
            "from one point; sweep at least two payload sizes"
        )

    d = np.array([s.get("dispatches", 1.0) for s in rows], dtype=float)
    a = np.array([s.get("collectives", 1.0) for s in rows], dtype=float)
    w = np.array([s["wire_bytes"] for s in rows], dtype=float)
    f = np.array([s.get("flops", 0) for s in rows], dtype=float)
    y = np.array([s["measured_median_us"] for s in rows], dtype=float)

    # identifiability: α needs samples whose collectives-per-dispatch
    # ratio varies (ring vs fused rows); peak needs dense-compute rows
    ratio = a / np.maximum(d, 1e-12)
    alpha_pinned = bool(np.allclose(ratio, ratio[0], rtol=1e-6))
    peak_pinned = bool(not np.any(f > 0))

    # a corpus with no dispatch-bearing samples at all (device-timed
    # rows only) carries zero evidence about γ — an all-zero column
    # would poison the covariance (singular X'X, every CI lost), so γ
    # pins to the cm1 seed (0) like any other unidentifiable term
    gamma_zero_pin = gamma_pin is None and not bool(np.any(d > 0))

    y_fit = y.copy()
    cols: list[tuple[str, "np.ndarray"]] = []
    if gamma_pin is not None:
        y_fit = y_fit - gamma_pin * d
    elif not gamma_zero_pin:
        cols.append(("gamma_dispatch_us", d))
    if alpha_pinned:
        y_fit = y_fit - cm1.alpha_us * a
    else:
        cols.append(("alpha_us", a))
    cols.append(("beta_inv", w))
    if not peak_pinned:
        cols.append(("peak_inv", f))

    keep = np.ones(len(rows), dtype=bool)
    # Stage 1 — outlier rejection on the PLAIN 1/measured-weighted fit
    # (irls_rounds=1).  The IRLS refinement must only ever see the
    # cleaned set: its reweighting trusts the current prediction, and a
    # wild row drags the prediction toward itself — reweighting on a
    # contaminated fit up-weights exactly the rows that need rejecting.
    for _ in range(OUTLIER_ROUNDS):
        _coef, _se, pred = _nnls_relative(
            [(n, c[keep]) for n, c in cols], y_fit[keep], irls_rounds=1
        )
        # relative residuals over the KEPT set; trim past the MAD gate.
        # The MAD floor keeps a near-exact corpus (residuals at numeric
        # noise) from trimming half of itself every round.
        rel = (pred - y_fit[keep]) / np.maximum(y_fit[keep], 1e-9)
        med = float(np.median(rel))
        mad = max(float(np.median(np.abs(rel - med))), 1e-7)
        ok = np.abs(rel - med) <= outlier_mad * mad
        if ok.all():
            break
        idx = np.flatnonzero(keep)
        keep[idx[~ok]] = False
        if keep.sum() < max(min_samples // 2, len(_COEFFS)):
            raise FitError(
                f"outlier rejection left {int(keep.sum())} of {len(rows)} "
                f"sample(s) for tier {tier!r} — the corpus is internally "
                "contradictory (mixed hosts? torn artifacts?); fit refused"
            )
    # Stage 2 — the full IRLS fit (the geomean-error objective) on the
    # cleaned set
    coef, stderr, _pred = _nnls_relative(
        [(n, c[keep]) for n, c in cols], y_fit[keep]
    )

    if gamma_pin is not None:
        gamma = gamma_pin
    elif gamma_zero_pin:
        gamma = cm1.gamma_dispatch_us
    else:
        gamma = coef.get("gamma_dispatch_us", 0.0)
    alpha = cm1.alpha_us if alpha_pinned else coef.get("alpha_us", 0.0)
    beta_inv = coef.get("beta_inv", 0.0)
    peak_inv = coef.get("peak_inv", 0.0)
    beta = 1.0 / beta_inv if beta_inv > 0 else cm1.beta_bytes_per_us
    peak = (1.0 / peak_inv if peak_inv > 0
            else cm1.peak_flops_per_us)
    for name, v in (("gamma_dispatch_us", gamma), ("alpha_us", alpha),
                    ("beta_bytes_per_us", beta),
                    ("peak_flops_per_us", peak)):
        if not math.isfinite(v) or v < 0:
            raise FitError(
                f"fit for tier {tier!r} produced {name}={v!r} — refusing "
                "to write a non-finite/negative coefficient DB"
            )

    # residual stats of the FULL model on the kept samples
    pred_full = (gamma * d + alpha * a + w / beta
                 + (f / peak if peak > 0 else 0.0))
    kept_pred, kept_meas = pred_full[keep], y[keep]
    factors = np.maximum(kept_pred, 1e-9) / np.maximum(kept_meas, 1e-9)
    factors = np.maximum(factors, 1.0 / factors)
    residuals = {
        "geomean_error_factor": float(np.exp(np.log(factors).mean())),
        "max_error_factor": float(factors.max()),
        "rms_log_error": float(
            np.sqrt((np.log(kept_pred / np.maximum(kept_meas, 1e-9)) ** 2)
                    .mean())
        ),
        "median_signed_rel_error": float(
            np.median((kept_pred - kept_meas)
                      / np.maximum(kept_meas, 1e-9))
        ),
    }

    def _ci(name: str, value: float, invert: bool) -> dict[str, Any]:
        se = stderr.get(name)
        out: dict[str, Any] = {"value": value}
        if se is None or not math.isfinite(se):
            return out
        c = coef.get(name, 0.0)
        lo, hi = c - 1.96 * se, c + 1.96 * se
        if invert:
            # β / peak are fitted as inverses: invert the interval ends;
            # a lower inverse bound at/below zero means the upper end is
            # unbounded — recorded as null (bare Infinity is not JSON)
            hi_v = 1.0 / lo if lo > 0 else None
            lo_v = 1.0 / hi if hi > 0 else 0.0
            out.update(ci95=[lo_v, hi_v], stderr_inv=se)
        else:
            out.update(ci95=[max(lo, 0.0), hi], stderr=se)
        return out

    coefficients = {
        "gamma_dispatch_us": (
            {"value": gamma, "pinned": "tier-corpus"}
            if gamma_pin is not None
            else {"value": gamma, "pinned": "cm1"} if gamma_zero_pin
            else _ci("gamma_dispatch_us", gamma, False)
        ),
        "alpha_us": (
            {"value": alpha, "pinned": "cm1"} if alpha_pinned
            else _ci("alpha_us", alpha, False)
        ),
        # a clamped-out inverse coefficient (wire / compute term not
        # positively identified) seeds from cm1 — recorded as a pin,
        # indistinguishable-from-fitted would break the every-pin-is-
        # recorded contract (docs/observability.md)
        "beta_bytes_per_us": (
            {"value": beta, "pinned": "cm1"} if beta_inv <= 0
            else _ci("beta_inv", beta, True)
        ),
        "peak_flops_per_us": (
            {"value": peak, "pinned": "cm1"}
            if peak_pinned or peak_inv <= 0
            else _ci("peak_inv", peak, True)
        ),
    }
    hosts = sorted({str(s.get("host")) for s in rows})
    return {
        "tier": tier,
        "coefficients": coefficients,
        "residuals": residuals,
        "samples_used": int(keep.sum()),
        "samples_total": len(rows),
        # the op-granularity device-timed rows (devtrace source) — the
        # population that identifies β without a host dispatch term
        "device_samples": len(device_rows),
        "outliers_rejected": int(len(rows) - keep.sum()),
        "alpha_pinned": alpha_pinned,
        "peak_pinned": peak_pinned,
        "gamma_pinned": gamma_pin is not None or gamma_zero_pin,
        "host_filter": host_filter,
        "hosts": hosts,
        "distinct_wire_sizes": len(wires),
        "ops": sorted({s["op"] for s in rows}),
    }


def _nnls_relative(cols, y, irls_rounds: int = 6):
    """Non-negative least squares in (approximate) LOG space, by
    iteratively-reweighted linear least squares: round 0 weights rows by
    ``1/measured`` (relative error), each later round by
    ``1/sqrt(prediction · measured)`` — the symmetrised Gauss-Newton
    linearization of ``Σ log(pred/measured)²``, i.e. the geomean-error-
    factor objective the calibration gate scores.  A plain
    ``1/measured`` weighting is asymmetric (under-prediction error is
    bounded at −1, over-prediction unbounded) and systematically
    under-fits mixed-scale corpora; a plain ``1/prediction`` reweight is
    unstable the other way (a row the current fit under-predicts by k
    gets its weight multiplied by k, so the next round chases it — the
    geometric mean bounds that amplification at √k).
    Negative coefficients are clamped out active-set style (a fit may
    conclude "no measurable per-collective latency", never a negative
    one).  Returns ``(coef, stderr, prediction)`` over the free columns
    (dropped ones report 0 with no stderr)."""
    import numpy as np

    names = [n for n, _ in cols]
    wgt = 1.0 / np.maximum(y, 1e-9)
    sol = np.zeros(0)
    pred = y.copy()
    active: list[int] = list(range(len(cols)))
    for round_ in range(irls_rounds):
        # a column clamped out under one weighting may be positive under
        # the next: every round restarts from the full column set
        active = list(range(len(cols)))
        for _ in range(len(cols) + 1):
            X = np.stack([cols[i][1] for i in active], axis=1)
            Xw = X * wgt[:, None]
            yw = y * wgt
            sol, *_ = np.linalg.lstsq(Xw, yw, rcond=None)
            neg = [i for i, v in enumerate(sol) if v < 0]
            if not neg:
                break
            active = [a for i, a in enumerate(active) if i not in neg]
            if not active:
                return {n: 0.0 for n in names}, {}, np.zeros_like(y)
        X = np.stack([cols[i][1] for i in active], axis=1)
        pred = X @ sol
        new_wgt = 1.0 / np.sqrt(np.maximum(pred, 1e-9)
                                * np.maximum(y, 1e-9))
        if np.allclose(new_wgt, wgt, rtol=1e-4):
            break
        wgt = new_wgt
    Xw = X * wgt[:, None]
    dof = max(len(y) - len(active), 1)
    rss = float(((pred - y) * wgt).dot((pred - y) * wgt))
    try:
        cov = rss / dof * np.linalg.inv(Xw.T @ Xw)
        ses = np.sqrt(np.maximum(np.diag(cov), 0.0))
    except np.linalg.LinAlgError:
        ses = np.full(len(active), float("nan"))
    coef = {n: 0.0 for n in names}
    stderr: dict[str, float] = {}
    for i, col_idx in enumerate(active):
        coef[names[col_idx]] = float(sol[i])
        stderr[names[col_idx]] = float(ses[i])
    return coef, stderr, pred


# ---------------------------------------------------------------------------
# versioned DB (append-only, like cm1's COST_MODELS table)
# ---------------------------------------------------------------------------


def save_fit(fit: dict[str, Any], directory: "Optional[str | Path]" = None,
             corpus_meta: Optional[dict[str, Any]] = None
             ) -> tuple[Path, int]:
    """Append one fit as a new version of the tier's cm2 DB; returns
    ``(path, fit_version)``.  Existing versions are never rewritten — a
    calibration baseline recording ``fit_version: 2`` stays
    interpretable after version 3 lands."""
    from dlbb_tpu_torch.utils.config import atomic_write_text

    path = fit_db_path(fit["tier"], directory)
    db: dict[str, Any] = {
        "schema": FIT_SCHEMA, "model": "cm2", "tier": fit["tier"],
        "versions": [],
    }
    if path.exists():
        db = json.loads(path.read_text())
        if db.get("tier") != fit["tier"]:
            raise FitError(
                f"{path} holds tier {db.get('tier')!r}, refusing to "
                f"append a {fit['tier']!r} fit"
            )
    version = len(db["versions"]) + 1
    entry = dict(fit)
    entry["fit_version"] = version
    entry["fitted_at"] = time.time()
    if corpus_meta:
        entry["corpus"] = corpus_meta
    db["versions"].append(entry)
    path.parent.mkdir(parents=True, exist_ok=True)
    atomic_write_text(json.dumps(db, indent=1, sort_keys=True) + "\n", path)
    return path, version


def run_fit(
    results: "Sequence[str | Path]",
    tiers: Optional[Sequence[str]] = None,
    fit_dir: "Optional[str | Path]" = None,
    min_samples: int = MIN_SAMPLES,
    host_filter: Optional[str] = None,
    verbose: bool = True,
    baselines_dir: "Optional[str | Path]" = None,
) -> dict[str, Any]:
    """CLI driver (``cli obs fit``): corpus → per-tier fit → versioned
    DB.  Fits every tier present in the corpus unless ``tiers`` names a
    subset; a tier that fails its degeneracy checks raises (fail closed)
    when explicitly requested, and is reported-but-skipped when it was
    merely present in a mixed corpus."""
    from dlbb_tpu_torch.obs.corpus import build_corpus

    corpus = build_corpus(results, verbose=verbose,
                          baselines_dir=baselines_dir)
    present = sorted({s["tier"] for s in corpus["samples"]})
    requested = list(tiers) if tiers else present
    if not corpus["samples"]:
        raise FitError(
            f"corpus under {[str(r) for r in results]} produced zero "
            f"samples ({len(corpus['skipped'])} file(s) skipped) — "
            "nothing to fit"
        )
    out: dict[str, Any] = {"fits": {}, "skipped_tiers": {}}
    for tier in requested:
        try:
            fit = fit_tier(corpus["samples"], tier,
                           min_samples=min_samples,
                           host_filter=host_filter)
        except FitError as e:
            if tiers:  # explicitly requested → fail closed
                raise
            out["skipped_tiers"][tier] = str(e)
            if verbose:
                print(f"[fit] {tier}: SKIPPED ({e})")
            continue
        corpus_meta = {
            "roots": corpus["roots"],
            "samples": len(corpus["samples"]),
            "files": len({str(s["file"]).split("::")[0]
                          for s in corpus["samples"]}),
            "manifests": len(corpus["manifests"]),
        }
        path, version = save_fit(fit, fit_dir, corpus_meta=corpus_meta)
        out["fits"][tier] = {"path": str(path), "fit_version": version,
                             **fit}
        if verbose:
            c = fit["coefficients"]
            print(
                f"[fit] {tier}: v{version} over {fit['samples_used']}/"
                f"{fit['samples_total']} sample(s) -> {path}\n"
                f"      gamma {c['gamma_dispatch_us']['value']:.1f}us"
                f"/dispatch, alpha {c['alpha_us']['value']:.2f}us, "
                f"beta {c['beta_bytes_per_us']['value']:.0f}B/us, "
                f"peak {c['peak_flops_per_us']['value']:.0f}FLOP/us "
                f"(fit geomean error "
                f"{fit['residuals']['geomean_error_factor']:.2f}x)"
            )
    if not out["fits"]:
        raise FitError(
            "no tier produced a fit — reasons: "
            + "; ".join(f"{t}: {r}" for t, r in
                        out["skipped_tiers"].items())
        )
    return out
