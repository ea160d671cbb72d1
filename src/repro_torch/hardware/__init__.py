"""``repro_torch.hardware`` — device-level MRR weight-bank emulation.
Counterpart of ``repro/hardware``:

* ``mrr``       — Lorentzian ring transfer, inscription, crosstalk geometry,
  dead rings, and the ``MRRConfig`` device description
* ``channel``   — the signal chain (DAC → rings → BPD → ADC) tiled over bank
  panels and the WDM buses; the "emu" backend calls
  ``channel.emulated_matmul``
* ``drift``     — per-ring OU resonance drift and the context that carries
  the trainer's hardware state into the chain
* ``calibrate`` — LUT inversion, crosstalk pre-compensation, recalibration

``core.photonics`` imports ``mrr`` and ``channel`` imports ``core.photonics``
back, so only ``mrr`` loads eagerly; the rest resolve on first access.
"""

from __future__ import annotations

import importlib

from repro_torch.hardware.mrr import MRRConfig

_SUBMODULES = ("mrr", "channel", "drift", "calibrate")


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.hardware.{name}")
    raise AttributeError(f"module 'repro_torch.hardware' has no attribute {name!r}")


def __dir__():
    return sorted([*globals(), *_SUBMODULES])


__all__ = ["MRRConfig", *_SUBMODULES]
