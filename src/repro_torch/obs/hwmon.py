"""Photonic hardware health monitoring: planned vs observed drift.
Counterpart of ``repro/obs/hwmon.py``.

The emulated MRR bank carries its physical state (OU resonance drift +
the controller's calibration estimate) through training, and the train
step already returns the summary scalars (``hw_drift_rms``,
``hw_residual_rms``, ``hw_dead_rings`` — computed on the device, drained
in the fit loop's one transfer per logging interval).  The monitor
compares the *observed* residual against the OU prediction for the run's
recalibration cadence (``expected_drift_sigma``) every logged step and
raises a warn-level alert the moment a ``drift_budget`` is crossed.  The
reference's schedule autotuner, which plans such a budget, is not ported:
the budget defaults to half the stationary drift σ, as there.

Alerts are edge-triggered: one alert per budget crossing, re-armed when
the residual recovers below the budget (a recalibration sweep landing),
so a long excursion is one event, not one per logged step.

Derived gauges per sample:

* ``hw_drift_rms`` / ``hw_residual_rms`` — raw vs uncompensated detuning
* ``hw_expected_sigma`` — the OU prediction for the configured cadence
* ``hw_residual_vs_expected`` — observed/predicted (≈1 means the device
  behaves like the model the autotuner planned against)
* ``hw_effective_bits`` — ``photonics.sigma_to_resolution`` of the
  residual: the resolution the analog path currently delivers
* ``hw_dead_rings`` — rings whose residual exceeds the dead-ring
  threshold (default 3× the stationary drift σ)
* ``hw_failed_buses`` — dead buses the schedule reroutes around
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.photonics import sigma_to_resolution

# residual threshold (in stationary drift σ) past which a ring counts as
# dead — shared by the trainer's in-step ``hw_dead_rings`` metric and the
# monitor's gauge so the two always agree
DEAD_RING_FACTOR = 3.0


def expected_drift_sigma(device, recalibrate_every: int) -> float:
    """Expected per-ring detuning residual (OU model) at the end of a
    recalibration window of ``recalibrate_every`` steps — the port's copy
    of the reference's ``sim.autotune.expected_drift_sigma``::

        σ_resid² = drift_sigma² · (1 − exp(−2·every/τ)) + cal_noise²

    ``recalibrate_every <= 0`` means never: the stationary drift_sigma."""
    if device is None or device.drift_sigma <= 0:
        return 0.0
    if recalibrate_every <= 0:
        return float(device.drift_sigma)
    grow = 1.0 - math.exp(-2.0 * recalibrate_every / device.drift_tau)
    return math.sqrt(device.drift_sigma ** 2 * grow + device.cal_noise ** 2)


@dataclasses.dataclass(frozen=True)
class HwAlert:
    """One warn-level hardware event."""

    step: int
    kind: str  # "drift_budget"
    value: float  # the observed residual rms
    budget: float
    message: str


class HardwareMonitor:
    """Samples carried hardware state scalars each logged step.

    Parameters
    ----------
    device : hardware.mrr.MRRConfig | None
        The bank's device description (drift σ/τ, cal noise).
    recalibrate_every : int
        The in-situ recalibration cadence the run uses — sets the OU
        residual prediction the observed drift is compared against.
    drift_budget : float | None
        The residual the schedule was planned for; defaults to half the
        stationary drift σ — the regime where the drift-recovery
        benchmarks keep DFA training.
    dead_ring_factor : float
        Residual threshold (in stationary σ) past which a ring counts as
        dead in ``hw_dead_rings``.
    """

    def __init__(self, device, recalibrate_every: int = 0,
                 drift_budget: float | None = None,
                 dead_ring_factor: float = DEAD_RING_FACTOR,
                 n_failed_buses: int = 0):
        self.device = device
        self.recalibrate_every = int(recalibrate_every)
        sigma = float(getattr(device, "drift_sigma", 0.0) or 0.0)
        if drift_budget is None and sigma > 0:
            drift_budget = 0.5 * sigma
        self.drift_budget = drift_budget
        self.expected_sigma = expected_drift_sigma(device, recalibrate_every)
        self.dead_ring_threshold = dead_ring_factor * sigma
        self.n_failed_buses = int(n_failed_buses)
        self.alerts: list[HwAlert] = []
        self._over_budget = False  # edge-trigger arm

    def sample(self, step: int, scalars: dict) -> dict:
        """Derive the health gauges from one logged step's host scalars
        (must contain ``hw_residual_rms``; the rest are optional) and
        fire the budget alert on a below→above crossing.  Returns the
        gauge dict (empty when the row carries no hardware scalars)."""
        if "hw_residual_rms" not in scalars:
            return {}
        resid = float(scalars["hw_residual_rms"])
        out = {"hw_residual_rms": resid}
        if "hw_drift_rms" in scalars:
            out["hw_drift_rms"] = float(scalars["hw_drift_rms"])
        if "hw_dead_rings" in scalars:
            out["hw_dead_rings"] = float(scalars["hw_dead_rings"])
        out["hw_expected_sigma"] = self.expected_sigma
        if self.expected_sigma > 0:
            out["hw_residual_vs_expected"] = resid / self.expected_sigma
        if resid > 0:
            # the resolution the analog path currently delivers (an ideal
            # zero-residual bank would be unbounded — omit the gauge)
            out["hw_effective_bits"] = sigma_to_resolution(resid)
        out["hw_failed_buses"] = float(self.n_failed_buses)
        if self.drift_budget is not None:
            over = resid > self.drift_budget
            if over and not self._over_budget:
                self.alerts.append(HwAlert(
                    step=int(step), kind="drift_budget", value=resid,
                    budget=self.drift_budget,
                    message=(f"residual drift rms {resid:.4f} exceeds the "
                             f"planned budget {self.drift_budget:.4f} at "
                             f"step {step} (recal cadence "
                             f"{self.recalibrate_every})")))
            self._over_budget = over
        return out
