"""Per-stage timing and power models of the photonic pipeline.
Counterpart of ``repro/sim/components.py``; pure Python, and every time and
power here is the modelled photonic chip's.

The paper's throughput claim (Eq. 2, Fig. 3) is a *pipeline* claim: a new
input vector enters the chip every operational cycle (the DAC-limited
initiation interval 1/f_s) while earlier vectors are still in flight
through the downstream stages.  The stages, in signal order:

    dac   input DAC settling        — one sample period (the design is
                                      DAC-throughput-limited, paper §5)
    mod   MZM electro-optic encode  — tens of ps (carrier-depletion EO
                                      response, effectively instantaneous)
    ring  MRR cavity response       — the photon lifetime of the loaded
                                      resonator, ~ps at the paper's Q
    bpd   BPD + TIA rise            — 0.35 / receiver bandwidth, with the
                                      receiver matched to the symbol rate
    adc   ADC conversion            — a pipelined converter: one sample
                                      per cycle throughput, a few cycles
                                      of conversion latency

A sixth, *off-pipeline* activity is the heater update: re-inscribing a
ring's weight waits on the thermal settling time (µs — 4+ orders slower
than a cycle).  It never sits on the per-sample path — feedback matrices
are fixed and forward weights update once per training step — but the
simulator prices it wherever weights actually change (the per-step update
epilogue, recalibration sweeps).

``StageTimes`` carries the resolved latencies; ``stage_times`` derives
them from a ``PhotonicConfig`` (+ its optional ``MRRConfig``) so the
simulator, the emulator, and the energy model read the same hardware
description.  Powers stay single-sourced in ``core.energy`` (Eq. 3/4).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import energy, photonics
from repro_torch.hardware.mrr import MRRConfig

# stage names in signal order — the pipeline the event timeline models
STAGES = ("dac", "mod", "ring", "bpd", "adc")

# electro-optic modulation response: effectively instantaneous next to a
# 100 ps cycle, kept nonzero so the fill latency is honest
MOD_LATENCY_S = 20e-12
# photon lifetime of the loaded resonator (Q ~ 1e4 at 193 THz)
RING_LATENCY_S = 10e-12
# pipelined-ADC conversion latency, in operational cycles
ADC_LATENCY_CYCLES = 4.0


@dataclasses.dataclass(frozen=True)
class StageTimes:
    """Resolved per-stage latencies [s] of one bus's signal chain."""

    ii: float  # initiation interval: one sample period, 1/f_s
    dac: float
    mod: float
    ring: float
    bpd: float
    adc: float
    heater: float  # weight re-inscription (thermal settling), off-pipeline

    @property
    def fill(self) -> float:
        """Pipeline depth: latency from a sample entering the DAC to its
        contribution leaving the ADC."""
        return self.dac + self.mod + self.ring + self.bpd + self.adc

    def latency(self, stage: str) -> float:
        return getattr(self, stage)


def stage_times(pcfg: photonics.PhotonicConfig,
                f_s: float | None = None) -> StageTimes:
    """Derive the stage latencies from the hardware description.

    ``f_s`` overrides the config's operational rate (the autotuner sweeps
    it); the receiver chain is assumed rate-matched, so the BPD/TIA rise
    and the ADC latency scale with the symbol period.
    """
    f = float(f_s if f_s is not None else pcfg.f_s)
    if f <= 0.0:
        raise ValueError(f"operational rate must be positive, got {f}")
    ii = 1.0 / f
    device = pcfg.mrr or MRRConfig()
    return StageTimes(
        ii=ii,
        dac=ii,  # settles within one sample period (DAC-limited design)
        mod=MOD_LATENCY_S,
        ring=RING_LATENCY_S,
        bpd=0.35 / f,  # 10–90% rise of a rate-matched receiver
        adc=ADC_LATENCY_CYCLES * ii,
        heater=float(device.thermal_settle_s),
    )


def bank_power_w(pcfg: photonics.PhotonicConfig, ecfg=None,
                 f_s: float | None = None, n_buses: int | None = None) -> float:
    """Wall-plug power of the modelled chip (Eq. 4 via ``core.energy``),
    with the simulator's knobs (f_s, bus count) applied on top of the
    energy config — the autotuner's feasibility measure."""
    base = ecfg or energy.EnergyConfig()
    cfg = dataclasses.replace(
        base,
        f_s=float(f_s if f_s is not None else pcfg.f_s),
        n_buses=int(n_buses if n_buses is not None
                    else photonics.active_buses(pcfg)),
    )
    return energy.total_power(pcfg.bank_rows, pcfg.bank_cols, cfg)
