"""Photonic noise-budget attribution: decompose the emu backend's output
error into per-source physical contributions.  Counterpart of
``repro/obs/attribution.py``.

``noise_budget(e, b, cfg, key, residual=)`` re-runs ONE sampled feedback
panel product (e·Bᵀ, the paper's Eq. 1 projection) through
``hardware.channel.bank_product`` (the unfused chain, as the reference's
"ref" spine) several times:

* a **clean** pass under ``channel.ideal_twin(cfg)`` — same geometry and
  panel schedule, every nonideality off;
* the **full** configured chain (the error power actually observed);
* one **sole-source** pass per ``channel.NOISE_SOURCES`` entry
  (quantization, thermal, shot, ADC, drift residual, crosstalk, dead
  rings) under ``channel.isolate_source``.

Every noisy pass gets the caller's integer key, so a sole-source run
draws from the same generators as the full chain (common random numbers)
and the error powers are directly comparable.  Emitted gauges (all
mean-square error vs the clean pass, natural output units; 0-d tensors):

* ``nb_<source>_var`` per source, ``nb_total_var`` for the full chain;
* ``nb_sum_var`` and ``nb_closure`` = Σ sources / total — for
  independent zero-mean sources this is ≈ 1;
* ``nb_thermal_vs_analytic`` — measured thermal-only error std over
  ``photonics.noise_sigma_total``'s closed-form accounting.
"""

from __future__ import annotations

import torch

from repro_torch.core import photonics
from repro_torch.hardware import channel

SOURCES = channel.NOISE_SOURCES

_TINY = 1e-30


def _product(a, b, cfg, key, residual):
    """The emu backend's "ref" spine with the residual under explicit
    control: encode, bank product, rescale.  No ambient drift-state
    lookup — sole-source runs must not pick up the trainer's
    ``drift.use_state`` context."""
    a_n, b_n, s_a, s_b = photonics.normalise_operands(a, b, cfg)
    out = channel.bank_product(a_n, b_n, cfg, key, residual=residual)
    return out * (s_a * s_b)


def _power(x):
    return torch.mean(torch.square(x.float()))


def noise_budget(e, b, cfg, key, *, residual=None) -> dict:
    """Per-source error-power attribution for one panel product.

    e: (T, K) sampled error rows; b: (M, K) feedback bank; cfg: the emu
    session's ``PhotonicConfig``; key: a probe-owned integer seed (never a
    training key); residual: the carried drift-cal residual, if any.
    -> flat dict of 0-d tensors (``nb_*``)."""
    clean = _product(e, b, channel.ideal_twin(cfg), None, None)
    full = _product(e, b, cfg, key, residual)
    total = _power(full - clean)
    out = {"nb_total_var": total}
    acc = torch.zeros((), dtype=torch.float32, device=e.device)
    for src in SOURCES:
        res = residual if src == "drift" else None
        # common random numbers by design: every sole-source run draws from
        # the full run's generators, so differences are the source alone
        only = _product(e, b, channel.isolate_source(cfg, src), key, res)
        power = _power(only - clean)
        out[f"nb_{src}_var"] = power
        acc = acc + power
    out["nb_sum_var"] = acc
    out["nb_closure"] = acc / torch.clamp(total, min=_TINY)
    if cfg.noise_std > 0.0:
        _, _, s_a, s_b = photonics.normalise_operands(e, b, cfg)
        analytic = photonics.noise_sigma_total(e.shape[-1], s_a, s_b, cfg)
        out["nb_thermal_vs_analytic"] = (
            torch.sqrt(out["nb_thermal_var"]) / torch.clamp(analytic, min=_TINY))
    return out
