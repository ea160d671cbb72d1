"""Microring-resonator device description.

Counterpart of ``repro/hardware/mrr.py``.  Slice 1 ports only the
``MRRConfig`` dataclass: it is the type of ``PhotonicConfig.mrr`` and of
the ``emu_*`` presets.  The device physics (Lorentzian transfer,
inscription, crosstalk, dead rings) belongs to the ``emu`` backend, which a
later slice ports.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MRRConfig:
    """Device-level nonidealities of one physical MRR weight bank (see the
    reference for each field's physics).  ``MRRConfig.ideal()`` zeroes every
    nonideality."""

    gamma: float = 1.0
    delta_max: float = 100.0
    heater_bits: int | None = 12
    adc_bits: int | None = None
    crosstalk: float = 0.005
    bus_crosstalk: float = 0.0
    compensate_crosstalk: bool = True
    ct_iters: int = 2
    shot_noise: float = 0.0
    drift_sigma: float = 0.05
    drift_tau: float = 1000.0
    cal_noise: float = 0.005
    dead_ring_rate: float = 0.0
    yield_seed: int = 0
    thermal_settle_s: float = 2e-6

    @classmethod
    def ideal(cls) -> "MRRConfig":
        return cls(delta_max=1e6, heater_bits=None, adc_bits=None,
                   crosstalk=0.0, shot_noise=0.0, drift_sigma=0.0,
                   cal_noise=0.0)

    @property
    def stateful(self) -> bool:
        """True when the device drifts — training must carry hardware state."""
        return self.drift_sigma > 0.0
