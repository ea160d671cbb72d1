"""The port's energy model (``repro_torch.core.energy``, paper §5, Eqs. 2–4,
Fig. 6) against ``repro.core.energy`` on a grid of configs: every function,
shared comb on and off, trimming on and off, 1 to 8 buses and the bank
dims ``optimal_bank_dims`` picks.  The module is a pure-Python copy, so the
numbers must be equal; the paper's headline numbers are held as the
reference's tests hold them.  Every number here is the modelled photonic
chip's, never a time of the card."""

from __future__ import annotations

import dataclasses
import itertools

import pytest

torch = pytest.importorskip("torch")

from repro.core import energy as jenergy  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402

BUSES = (1, 2, 3, 4, 8)
CONFIGS = [dict(shared_comb=comb, trimming=trim, n_buses=b)
           for comb, trim, b in itertools.product((False, True), (False, True), BUSES)]
CELLS = (100, 400, 1000, 6000)


def _pair(**kw):
    return jenergy.EnergyConfig(**kw), tenergy.EnergyConfig(**kw)


def _dims(jcfg):
    """(50, 20), the paper's bank, and the reference's optimal dims at each
    of CELLS for this config."""
    return [(50, 20)] + [jenergy.optimal_bank_dims(c, jcfg)[:2] for c in CELLS]


def test_config_fields_match_the_reference():
    jc, tc = _pair()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    for name in ("H_BAR_OMEGA_1550NM", "ELEMENTARY_CHARGE"):
        assert getattr(jenergy, name) == getattr(tenergy, name)


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_every_function_equals_the_reference(kw):
    """Eqs. 2–4, E_op, the compute density and the config's derived powers
    at each bank dims, and the optimal dims themselves: equal."""
    jc, tc = _pair(**kw)
    assert (jc.p_mrr, jc.p_tia) == (tc.p_mrr, tc.p_tia)
    for m, n in _dims(jc):
        for fn in ("ops_per_second", "total_power", "energy_per_op",
                   "compute_density_tops_mm2"):
            assert getattr(tenergy, fn)(m, n, tc) == getattr(jenergy, fn)(m, n, jc), (fn, m, n)
        assert tenergy.laser_power(m, tc) == jenergy.laser_power(m, jc)
    for cells in CELLS:
        assert tenergy.optimal_bank_dims(cells, tc) == jenergy.optimal_bank_dims(cells, jc)


@pytest.mark.parametrize("trimming", [False, True])
@pytest.mark.parametrize("shared_comb", [False, True])
def test_fig6_curve_equals_the_reference(trimming, shared_comb):
    jc, tc = _pair(trimming=trimming, shared_comb=shared_comb, n_buses=4)
    assert tenergy.fig6_curve(tc) == jenergy.fig6_curve(jc)
    cells = [7, 100, 101, 1000]  # 7 and 101 have no factorisation with dims >= 5
    assert tenergy.fig6_curve(tc, cells) == jenergy.fig6_curve(jc, cells)
    with pytest.raises(ValueError, match="no factorization"):
        tenergy.optimal_bank_dims(101, tc)


@pytest.mark.parametrize("n_buses", BUSES)
def test_dfa_backward_cost_equals_the_reference(n_buses):
    """Through the port's ``photonics.gemm_cycles``: the paper's MLP, the
    smoke LM's and qwen1.5-0.5b's injection dims, at the paper's bank and
    at an optimal one."""
    jc, tc = _pair(n_buses=n_buses)
    for dims, d_tap in (([800, 800], 10), ([32] * 2, 32), ([1024] * 24, 1024)):
        for bank in ((50, 20), jenergy.optimal_bank_dims(1000, jc)[:2]):
            assert (tenergy.dfa_backward_cost(dims, d_tap, tc, *bank)
                    == jenergy.dfa_backward_cost(dims, d_tap, jc, *bank))


def test_headline_numbers():
    """The reference's assertions of the paper's numbers: 20 TOPS on a 50×20
    bank at 10 GHz, ≈ 1.0 pJ/op with heaters, ≈ 0.28 trimmed, ≈ 5.78
    TOPS/mm², a capacitance-limited laser floor, and the MLP's backward at
    32 cycles and 10 TOPS (half the bank idle)."""
    cfg = tenergy.EnergyConfig()
    assert tenergy.ops_per_second(50, 20, cfg) == pytest.approx(20e12)
    assert tenergy.energy_per_op(50, 20, cfg) * 1e12 == pytest.approx(1.0, abs=0.05)
    trimmed = tenergy.EnergyConfig(trimming=True)
    assert tenergy.energy_per_op(50, 20, trimmed) * 1e12 == pytest.approx(0.28, abs=0.02)
    assert tenergy.compute_density_tops_mm2(50, 20, cfg) == pytest.approx(5.78, abs=0.05)
    assert cfg.c_pd * cfg.v_d / tenergy.ELEMENTARY_CHARGE > 2.0 ** (2 * cfg.n_bits + 1)
    assert tenergy.laser_power(50, tenergy.EnergyConfig(n_bits=8)) > tenergy.laser_power(50, cfg)
    es = [r["e_op_pj"] for r in tenergy.fig6_curve(trimmed, cells=[100, 400, 1000, 4000])]
    assert all(a >= b for a, b in zip(es, es[1:]))
    r = tenergy.dfa_backward_cost([800, 800], 10, cfg)
    assert r["cycles"] == 32 and r["seconds"] == pytest.approx(3.2e-9)
    assert r["tops"] == pytest.approx(10.0)
    # one comb for every bus pays the laser floor once
    eight = tenergy.EnergyConfig(n_buses=8)
    assert (tenergy.total_power(50, 20, dataclasses.replace(eight, shared_comb=True))
            < tenergy.total_power(50, 20, eight))


def test_core_package_exports_energy():
    from repro_torch import core

    assert core.energy is tenergy
