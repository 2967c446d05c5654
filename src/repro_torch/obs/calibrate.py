"""Cost-model calibration: fitted ns-per-virtual-cycle + outlier report.

The port's copy of ``repro/obs/calibrate.py``. The barrel-controller cost
model prices every serial layer in virtual cycles (``a_bits * w_bits *
tiles * positions``); scheduling, HPM counters, and SLO booking all run on
that currency. This module turns measured profiles
(:mod:`repro_torch.obs.profiler`) into an exchange rate: for each
(device type × op-kind) it fits ns-per-cycle with a robust
median-of-ratios regression (the Theil–Sen slope of the through-origin
model ``wall_ns = k * cycles``), reports layers where the model
mispredicts beyond a tolerance, and persists the fit through
:class:`~repro_torch.compiler.artifact.ArtifactStore` — so a warm boot
restores the wall-time oracle along with the Programs.

The fit's ``backend`` is the device type the profile ran on (``"cuda"``
or ``"cpu"``) and is part of the store key, so a CPU fit is never served
on the card. ``SlotScheduler.set_calibration`` consumes the fit to turn
cycle-domain admissions into wall-time finish estimates;
:func:`fit_samples` also covers the LM decode path from
``ContinuousLMEngine.wall_samples()``::

    cal = calibrate.fit_samples(
        [("decode_step", "lm_decode", c, w) for c, w in engine.wall_samples()],
        backend="cuda")
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["OVERALL", "DEFAULT_TOLERANCE", "Calibration", "fit_samples",
           "fit", "calibration_key", "save", "load", "format_calibration"]

OVERALL = "*"                 # kind key for the pooled fit
DEFAULT_TOLERANCE = 1.0       # |relative residual| flagged as outlier


@dataclasses.dataclass(frozen=True)
class Calibration:
    """A fitted wall-time model for one device type (``backend``).

    ``ns_per_cycle`` maps op-kind -> fitted ns per virtual cycle, with
    the pooled fit under ``"*"``. ``residuals`` maps sample name ->
    relative misprediction ``(measured - predicted) / predicted`` under
    that sample's kind fit; names beyond ``tolerance`` are ``outliers``.
    """
    backend: str
    ns_per_cycle: Dict[str, float]
    residuals: Dict[str, float]
    outliers: Tuple[str, ...]
    tolerance: float
    n_samples: int
    max_abs_residual: float
    meta: Dict = dataclasses.field(default_factory=dict)

    def ns_for(self, kind: str = OVERALL) -> float:
        """Fitted ns/cycle for ``kind``, pooled fit as fallback."""
        v = self.ns_per_cycle.get(kind)
        if v is None:
            v = self.ns_per_cycle.get(OVERALL, 0.0)
        return float(v)

    def predict_wall_seconds(self, cycles: float,
                             kind: str = OVERALL) -> float:
        """Wall-time estimate for a virtual-cycle count."""
        return float(cycles) * self.ns_for(kind) * 1e-9

    def to_payload(self) -> Dict:
        return {
            "backend": self.backend,
            "ns_per_cycle": dict(self.ns_per_cycle),
            "residuals": dict(self.residuals),
            "outliers": list(self.outliers),
            "tolerance": self.tolerance,
            "n_samples": self.n_samples,
            "max_abs_residual": self.max_abs_residual,
            "meta": dict(self.meta),
        }

    @classmethod
    def from_payload(cls, payload: Dict) -> "Calibration":
        return cls(
            backend=payload["backend"],
            ns_per_cycle=dict(payload["ns_per_cycle"]),
            residuals=dict(payload.get("residuals", {})),
            outliers=tuple(payload.get("outliers", ())),
            tolerance=float(payload.get("tolerance", DEFAULT_TOLERANCE)),
            n_samples=int(payload.get("n_samples", 0)),
            max_abs_residual=float(payload.get("max_abs_residual", 0.0)),
            meta=dict(payload.get("meta", {})),
        )


# samples are (name, kind, pred_cycles, wall_ns) tuples
Sample = Tuple[str, str, int, float]


def fit_samples(samples: Sequence[Sample], *, backend: str,
                tolerance: float = DEFAULT_TOLERANCE,
                meta: Optional[Dict] = None) -> Calibration:
    """Fit ns/cycle per kind from (name, kind, cycles, wall_ns) samples
    measured on ``backend`` (the device type).

    Median-of-ratios is exactly the Theil–Sen estimator for the
    one-parameter through-origin model, so a single pathological layer
    cannot drag the fit — it surfaces in the residual report instead.
    """
    usable = [(n, k, c, w) for (n, k, c, w) in samples if c > 0 and w > 0]
    by_kind: Dict[str, List[float]] = {}
    for _, k, c, w in usable:
        by_kind.setdefault(k, []).append(w / c)
    ns_per_cycle = {k: float(statistics.median(v))
                    for k, v in by_kind.items()}
    all_ratios = [w / c for _, _, c, w in usable]
    ns_per_cycle[OVERALL] = (float(statistics.median(all_ratios))
                             if all_ratios else 0.0)

    residuals: Dict[str, float] = {}
    for n, k, c, w in usable:
        pred_ns = ns_per_cycle.get(k, ns_per_cycle[OVERALL]) * c
        if pred_ns > 0:
            residuals[n] = (w - pred_ns) / pred_ns
    outliers = tuple(sorted(n for n, r in residuals.items()
                            if abs(r) > tolerance))
    max_abs = max((abs(r) for r in residuals.values()), default=0.0)
    return Calibration(
        backend=backend, ns_per_cycle=ns_per_cycle, residuals=residuals,
        outliers=outliers, tolerance=tolerance,
        n_samples=len(usable), max_abs_residual=max_abs,
        meta=dict(meta or {}))


def fit(profile, *, tolerance: float = DEFAULT_TOLERANCE,
        meta: Optional[Dict] = None) -> Calibration:
    """Fit a Calibration from one :class:`ProgramProfile` — only steps
    the cost model actually prices (pred_cycles > 0) participate."""
    samples = [(s.name, s.kind, s.pred_cycles, s.wall_ns)
               for s in profile.steps if s.pred_cycles > 0]
    m = {"graph": profile.graph_name, "batch": profile.batch,
         "mode": profile.mode}
    m.update(meta or {})
    return fit_samples(samples, backend=profile.backend,
                       tolerance=tolerance, meta=m)


# --------------------------------------------------------------------------
# ArtifactStore persistence
# --------------------------------------------------------------------------

def calibration_key(backend: str, name: str) -> str:
    """Stable store key for one device type and one variant name."""
    return repr(("calibration", backend, name))


def save(store, cal: Calibration, name: str) -> str:
    """Persist through ``ArtifactStore.tuning_put``; returns the key."""
    key = calibration_key(cal.backend, name)
    store.tuning_put(key, "calibration", cal.to_payload())
    return key


def load(store, backend: str, name: str) -> Optional[Calibration]:
    """Load a persisted Calibration; None when absent/corrupt."""
    rec = store.tuning_get(calibration_key(backend, name))
    if rec is None or rec.get("kind") != "calibration":
        return None
    try:
        return Calibration.from_payload(rec["config"])
    except (KeyError, TypeError, ValueError):
        return None


def format_calibration(cal: Calibration) -> str:
    """Human summary: fitted rates, worst residual, outlier list."""
    kinds = ", ".join(f"{k}={v:.2f}" for k, v in
                      sorted(cal.ns_per_cycle.items()) if k != OVERALL)
    lines = [
        f"calibration[{cal.backend}]: "
        f"ns/cycle {cal.ns_for():.2f} overall"
        + (f" ({kinds})" if kinds else ""),
        f"  samples={cal.n_samples} "
        f"max|residual|={cal.max_abs_residual:.2f} "
        f"tolerance={cal.tolerance:.2f}",
    ]
    if cal.outliers:
        lines.append("  mispredicted layers (|resid| > tol):")
        for n in cal.outliers:
            lines.append(f"    {n}: {cal.residuals[n]:+.2f}")
    else:
        lines.append("  mispredicted layers: none")
    return "\n".join(lines)
