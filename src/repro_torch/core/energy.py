"""Energy & speed model of the photonic DFA architecture (paper §5).
Counterpart of ``repro/core/energy.py``; pure Python.

Implements Eqs. (2)–(4) with the paper's component constants and reproduces
the headline numbers:  a 50×20 weight bank at f_s = 10 GHz delivers
20 TOPS at ~1.0 pJ/op (thermal MRR locking) or ~0.28 pJ/op (post-fab
trimming), with a compute density of ~5.78 TOPS/mm².

These constants describe the *modelled photonic chip*: every time, power
and energy this module returns is that chip's, never a time of the card the
port runs on.
"""

from __future__ import annotations

import dataclasses

# --- physical constants ---
H_BAR_OMEGA_1550NM = 1.281e-19  # photon energy at 1550 nm [J]
ELEMENTARY_CHARGE = 1.602e-19  # [C]


@dataclasses.dataclass(frozen=True)
class EnergyConfig:
    f_s: float = 10e9  # operational rate [Hz] (DAC-throughput limited)
    # parallel WDM buses, each a full M×N bank with its own lasers, DACs,
    # TIAs and ADCs (Eq. 4 per-bus terms); throughput (Eq. 2) scales with
    # the bus count while E_op stays flat up to schedule-quantization loss
    n_buses: int = 1
    # one frequency-comb source feeds every bus (paper §5 cites Kerr combs
    # powering hundreds of channels): the Eq. 3 laser floor is then paid
    # once and split across the banks instead of once per bus — the
    # remaining Eq. 4 terms (rings, DACs, TIA/ADC chains) stay per-bus
    shared_comb: bool = False
    n_bits: int = 6  # fixed-point precision N_b
    eta: float = 0.2  # laser+detector+waveguide efficiency
    c_pd: float = 2.4e-15  # photodetector capacitance [F]
    v_d: float = 1.0  # photodetector driving voltage [V]
    p_mrr_heater: float = 14.12e-3  # thermal resonance locking [W]
    p_mrr_trimmed: float = 120e-6  # carrier-depletion tuning only [W]
    p_dac: float = 180e-3  # 12-bit 10 GS/s DAC [W]
    p_adc: float = 13e-3  # 6-bit 12 GS/s ADC [W]
    tia_pj_per_bit: float = 2.4e-12  # TIA energy per sample [J]
    mac_cell_area_m2: float = 47.4e-6 * 73.0e-6  # paper Fig. 3(a) cell
    trimming: bool = False  # post-fabrication trimming vs embedded heaters

    @property
    def p_mrr(self) -> float:
        return self.p_mrr_trimmed if self.trimming else self.p_mrr_heater

    @property
    def p_tia(self) -> float:
        # 2.4 pJ/bit at the operational sample rate
        return self.tia_pj_per_bit * self.f_s


def ops_per_second(m: int, n: int, cfg: EnergyConfig) -> float:
    """Eq. (2):  OPS = 2 f_s M N B — the B parallel buses each complete an
    M×N panel per operational cycle."""
    return 2.0 * cfg.f_s * m * n * cfg.n_buses


def laser_power(m: int, cfg: EnergyConfig) -> float:
    """Eq. (3): optical power floor per laser for M-row fan-out — the
    required photons per symbol (shot-noise or PD-capacitance limited,
    whichever is worse) delivered at the operational rate.  The ×f_s
    converts the per-symbol energy floor to watts; without it the
    "power" was dimensionally J/symbol (sub-pW — a bug that made the
    laser share of Eq. 4 vanish and the shared-comb variant a no-op)."""
    shot_limit = 2.0 ** (2 * cfg.n_bits + 1)
    cap_limit = cfg.c_pd * cfg.v_d / ELEMENTARY_CHARGE
    per_symbol = m * (H_BAR_OMEGA_1550NM / cfg.eta) * max(shot_limit, cap_limit)
    return per_symbol * cfg.f_s


def total_power(m: int, n: int, cfg: EnergyConfig) -> float:
    """Eq. (4): wall-plug power of an M×N weight bank circuit, times the
    ``n_buses`` parallel copies — every term is per-bus (each bus carries
    its own N lasers and input DACs, N·(M+1) tuned rings, and M TIA/ADC
    readout chains).  With ``shared_comb`` one comb source carries the N
    laser lines for ALL buses, so the Eq. 3 floor is paid once."""
    lasers = n * laser_power(m, cfg)
    if not cfg.shared_comb:
        lasers *= cfg.n_buses
    per_bus = (
        n * (m + 1) * cfg.p_mrr
        + n * cfg.p_dac
        + m * (cfg.p_tia + cfg.p_adc)
    )
    return lasers + cfg.n_buses * per_bus


def energy_per_op(m: int, n: int, cfg: EnergyConfig) -> float:
    """E_op = P_total / OPS  [J]."""
    return total_power(m, n, cfg) / ops_per_second(m, n, cfg)


def compute_density_tops_mm2(m: int, n: int, cfg: EnergyConfig) -> float:
    area_mm2 = m * n * cfg.mac_cell_area_m2 * 1e6
    return ops_per_second(m, n, cfg) / 1e12 / area_mm2


def optimal_bank_dims(n_cells: int, cfg: EnergyConfig, min_dim: int = 5):
    """Fig. 6: over factorizations M×N == n_cells (M, N ≥ 5), the dims that
    minimise E_op.  Returns (m, n, e_op)."""
    best = None
    for m in range(min_dim, n_cells // min_dim + 1):
        if n_cells % m:
            continue
        n = n_cells // m
        if n < min_dim:
            continue
        e = energy_per_op(m, n, cfg)
        if best is None or e < best[2]:
            best = (m, n, e)
    if best is None:
        raise ValueError(f"no factorization of {n_cells} with dims >= {min_dim}")
    return best


def fig6_curve(cfg: EnergyConfig, cells=None):
    """(n_cells, optimal E_op) samples reproducing Fig. 6."""
    if cells is None:
        cells = [100, 200, 400, 600, 1000, 1500, 2000, 3000, 4000, 6000, 10000]
    out = []
    for c in cells:
        try:
            m, n, e = optimal_bank_dims(c, cfg)
            out.append({"cells": c, "m": m, "n": n, "e_op_pj": e * 1e12})
        except ValueError:
            continue
    return out


def dfa_backward_cost(layer_dims, d_tap: int, cfg: EnergyConfig,
                      bank_m: int = 50, bank_n: int = 20):
    """Cycles/energy/time for one DFA backward pass (all B(k)·e products)
    executed on ``cfg.n_buses`` M×N banks via the GeMM compiler — the
    paper's unit of work.  layer_dims: injection dims per hidden layer.
    The schedule length comes from ``photonics.gemm_cycles`` (the single
    source of the tiling math — this used to re-implement it inline and
    would have silently disagreed once buses landed)."""
    from repro_torch.core import photonics  # lazy: photonics imports torch

    pcfg = photonics.PhotonicConfig(bank_rows=bank_m, bank_cols=bank_n,
                                    n_buses=cfg.n_buses)
    total_cycles = 0
    total_macs = 0
    for d in layer_dims:
        total_cycles += photonics.gemm_cycles(d, d_tap, pcfg)
        total_macs += d * d_tap
    seconds = total_cycles / cfg.f_s
    energy = total_power(bank_m, bank_n, cfg) * seconds
    return {
        "cycles": total_cycles,
        "seconds": seconds,
        "macs": total_macs,
        "energy_j": energy,
        "pj_per_mac": energy / total_macs * 1e12,
        "tops": 2 * total_macs / seconds / 1e12,
    }
