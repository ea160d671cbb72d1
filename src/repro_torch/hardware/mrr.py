"""Microring-resonator device physics: the Lorentzian transfer function,
the weight → heater-detuning inscription, the thermal-crosstalk geometry
and the fabrication-yield dead-ring mask.

Counterpart of ``repro/hardware/mrr.py``; see its docstring for the
physics.  In short, a ring read out by a balanced photodetector has the
effective weight

    w(δ) = (δ² − γ²) / (δ² + γ²)

at heater detuning δ, and ``inscribe`` is its exact inverse
δ(w) = γ·sqrt((1 + w) / (1 − w)) on [−1, w_ceiling].

The crosstalk sums keep the reference's order of f32 operations
(``_edge_pair_sum`` adds x[i−1] + x[i+1] with zero edges; rows before
cols; intra-bus before inter-bus), since the heater DAC rounds their
result and an ulp can move a command by a whole DAC step.
"""

from __future__ import annotations

import dataclasses

import torch

# f32 cannot resolve weights closer to 1 than its epsilon — clip there even
# when the heater range allows more.
_W_EPS = 1e-7


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


def dead_ring_mask(cfg: MRRConfig, shape: tuple, device="cpu"):
    """1/0 survival mask over the physical ring grid (usually (n_buses,
    rows, cols)).  The dead set is chip-fixed: drawn from a generator
    seeded with ``yield_seed ^ 0xDEAD``, independent of the training step.
    The port's draw is not the reference's ``jax.random.bernoulli`` stream;
    only the rate agrees (``ROADMAP.md`` queue 3)."""
    if cfg.dead_ring_rate <= 0.0:
        return torch.ones(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device="cpu").manual_seed(cfg.yield_seed ^ 0xDEAD)
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (u < 1.0 - cfg.dead_ring_rate).to(torch.float32).to(device)


def ring_weight(delta, gamma: float = 1.0):
    """Lorentzian BPD transfer: detuning -> effective weight in [-1, 1)."""
    d2 = torch.square(delta)
    g2 = gamma * gamma
    return (d2 - g2) / (d2 + g2)


def w_ceiling(cfg: MRRConfig) -> float:
    """Largest inscribable weight: the transfer at full heater range."""
    d2 = cfg.delta_max * cfg.delta_max
    g2 = cfg.gamma * cfg.gamma
    return min((d2 - g2) / (d2 + g2), 1.0 - _W_EPS)


def inscribe(w, cfg: MRRConfig):
    """Weight -> heater detuning δ(w) = γ·sqrt((1+w)/(1-w)), the exact
    inverse of ``ring_weight`` after clipping to the reachable range.

    Always in f32 (the reference inscribes in the weights' dtype): in bf16
    the ceiling 1 − 2e-4 rounds to 1, so a normalised bank's largest
    weight, exactly 1, would get an infinite detuning and the crosstalk
    sums would turn it into NaN (``ROADMAP.md`` queue 3)."""
    w_c = torch.clamp(w.float(), -1.0, w_ceiling(cfg))
    return cfg.gamma * torch.sqrt((1.0 + w_c) / (1.0 - w_c))


def grid_axes(x) -> tuple[int, int]:
    """(row_axis, col_axis) of the physical ring grid: (-2, -1) for a bare
    (rows, cols) grid, (-3, -1) for the tiled (..., rows, nk, cols) and
    bus-stacked (..., n_buses, rows, nk, cols) layouts."""
    return (-3, -1) if x.ndim >= 3 else (-2, -1)


def bus_axis_of(x) -> int | None:
    """The bus axis of a panel stack: -4 for the full (nm, n_buses, rows,
    nk, cols) tiling (ndim >= 5), else None."""
    return -4 if x.ndim >= 5 else None


def _edge_pair_sum(x, axis: int):
    """x[i-1] + x[i+1] along ``axis`` with zero edges, added in that order."""
    n = x.shape[axis]
    xp = torch.nn.functional.pad(x.movedim(axis, -1), (1, 1)).movedim(-1, axis)
    return xp.narrow(axis, 0, n) + xp.narrow(axis, 2, n)


def neighbor_sum(delta, row_axis: int | None = None, col_axis: int | None = None):
    """Sum of the 4 nearest neighbours on the physical ring grid: rows, then
    cols."""
    if row_axis is None or col_axis is None:
        row_axis, col_axis = grid_axes(delta)
    return _edge_pair_sum(delta, row_axis) + _edge_pair_sum(delta, col_axis)


def crosstalk_leak(delta_cmd, cfg: MRRConfig, row_axis: int | None = None,
                   col_axis: int | None = None, bus_axis: int | None = None):
    """Thermal power leaked into each ring by its neighbours: the intra-bus
    grid coupling plus, when the layout carries a bus axis, the coupling to
    the same ring position on the adjacent buses' banks."""
    leak = None
    if cfg.crosstalk != 0.0:
        leak = cfg.crosstalk * neighbor_sum(delta_cmd, row_axis, col_axis)
    if cfg.bus_crosstalk != 0.0:
        if bus_axis is None:
            bus_axis = bus_axis_of(delta_cmd)
        if bus_axis is not None and delta_cmd.shape[bus_axis] > 1:
            bus = cfg.bus_crosstalk * _edge_pair_sum(delta_cmd, bus_axis)
            leak = bus if leak is None else leak + bus
    if leak is None:
        return torch.zeros_like(delta_cmd)
    return leak
