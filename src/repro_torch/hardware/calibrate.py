"""In-situ calibration: per-ring lookup-table inversion, crosstalk
pre-compensation, and the periodic recalibration sweep.

Counterpart of ``repro/hardware/calibrate.py``: ``command_deltas`` is the
controller's write path (Lorentzian inversion, Jacobi pre-inversion of the
thermal coupling, heater-DAC quantisation), ``measure`` a calibration
sweep, and ``advance`` one train step of hardware evolution (OU drift of
every ring, and on the recalibration cadence a fresh measurement).  Keys
are integer seeds: ``advance`` folds 1 into its key for the OU step and 2
for the sweep, as the reference folds its JAX key.
"""

from __future__ import annotations

import torch

from repro_torch.hardware import drift as drift_lib
from repro_torch.hardware import mrr
from repro_torch.utils import prng


def quantize_command(delta_cmd, cfg: mrr.MRRConfig):
    """Heater-DAC quantisation of the commanded detuning over [0, delta_max]
    (``heater_bits=1`` clamps to {0, delta_max}).  ``torch.round`` rounds
    half to even, as ``jnp.round`` does."""
    if cfg.heater_bits is None:
        return delta_cmd
    levels = max(2**cfg.heater_bits - 1, 1)
    d = torch.clamp(delta_cmd / cfg.delta_max, 0.0, 1.0) * levels
    return torch.round(d) / levels * cfg.delta_max


def compensate_crosstalk(delta_target, cfg: mrr.MRRConfig, row_axis: int | None = None,
                         col_axis: int | None = None, bus_axis: int | None = None):
    """Solve (I + c·N)·δ_cmd = δ_target by ``ct_iters`` Jacobi sweeps, in the
    reference's form δ_cmd = δ_target − leak(δ_cmd)."""
    delta_cmd = delta_target
    for _ in range(cfg.ct_iters):
        delta_cmd = delta_target - mrr.crosstalk_leak(
            delta_cmd, cfg, row_axis, col_axis, bus_axis)
    return delta_cmd


def command_deltas(w_target, cfg: mrr.MRRConfig, row_axis: int | None = None,
                   col_axis: int | None = None, bus_axis: int | None = None):
    """Target weights -> commanded heater detunings: LUT inversion,
    crosstalk pre-inversion, clip, heater DAC."""
    delta = mrr.inscribe(w_target, cfg)
    if cfg.compensate_crosstalk and (cfg.crosstalk != 0.0 or cfg.bus_crosstalk != 0.0):
        delta = compensate_crosstalk(delta, cfg, row_axis, col_axis, bus_axis)
    delta = torch.clamp(delta, 0.0, cfg.delta_max)
    return quantize_command(delta, cfg)


def measure(drift, key: int, cfg: mrr.MRRConfig):
    """One calibration sweep: the true per-ring drift plus ``cal_noise``
    measurement noise (exact with ``cal_noise=0``)."""
    if cfg.cal_noise == 0.0:
        return drift
    z = torch.randn(drift.shape, generator=prng.generator(key, drift.device),
                    device=drift.device, dtype=drift.dtype)
    return drift + cfg.cal_noise * z


def advance(state: dict, photonics_cfg, step: int, key: int,
            recalibrate_every: int = 0) -> dict:
    """Advance the carried hardware state by one train step: OU-drift every
    ring, and recalibrate when ``step % recalibrate_every == 0 and step > 0``
    (a fresh chip is already calibrated).  0 disables recalibration, so the
    stored estimate stays frozen.  Returns a new state dict."""
    cfg = photonics_cfg.mrr or mrr.MRRConfig()
    d = state["drift"]
    if cfg.drift_sigma > 0.0:
        d = drift_lib.ou_step(d, prng.fold(key, 1), cfg.drift_sigma, cfg.drift_tau)
    cal = state["cal"]
    if recalibrate_every and recalibrate_every > 0:
        step = int(step)
        if step % recalibrate_every == 0 and step > 0:
            cal = measure(d, prng.fold(key, 2), cfg)
    return {"drift": d, "cal": cal}
