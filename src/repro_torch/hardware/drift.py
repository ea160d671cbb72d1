"""Stateful resonance drift: an Ornstein–Uhlenbeck process per physical
ring, carried through training as hardware state.

Counterpart of ``repro/hardware/drift.py``.  The per-ring detuning error
follows d[t+1] = a·d[t] + σ·sqrt(1 − a²)·ε with a = exp(−1/τ), whose
stationary law is N(0, σ²).  The state is

    {"drift": (n_buses, bank_rows, bank_cols),  # detuning error per ring
     "cal":   (n_buses, bank_rows, bank_cols)}  # estimate at the last sweep

made by ``init_state`` (a freshly calibrated chip: both zero) and advanced
once per step by ``calibrate.advance``.  Only the residual ``drift − cal``
reaches the signal chain.  The trainer and the serving engine push the
state onto a context stack (``use_state``) around the step, and
``channel.emulated_matmul`` reads it there; the port runs eagerly, so the
stack carries the tensors themselves.  Outside any context the bank is
drift-free.
"""

from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.utils import prng


def init_state(cfg, key=None, device="cpu") -> dict:
    """A just-calibrated chip for a ``PhotonicConfig``-shaped bank: zero
    drift and zero estimate over (n_buses, bank_rows, bank_cols).  ``key``
    is unused, as in the reference (kept for call compatibility)."""
    shape = (max(getattr(cfg, "n_buses", 1), 1), cfg.bank_rows, cfg.bank_cols)
    return {"drift": torch.zeros(shape, dtype=torch.float32, device=device),
            "cal": torch.zeros(shape, dtype=torch.float32, device=device)}


def ou_step(x, key: int, sigma: float, tau: float):
    """One discrete OU step with stationary std ``sigma`` and relaxation
    time ``tau`` (steps), drawing from a generator seeded with ``key``."""
    a = math.exp(-1.0 / max(tau, 1e-9))
    s = sigma * math.sqrt(max(1.0 - a * a, 0.0))
    z = torch.randn(x.shape, generator=prng.generator(key, x.device), device=x.device,
                    dtype=x.dtype)
    return a * x + s * z


def residual(state: dict):
    """The detuning error the controller has NOT compensated."""
    return state["drift"] - state["cal"]


_ACTIVE: list = []


@contextlib.contextmanager
def use_state(state: dict):
    """Make ``state`` visible to ``channel.emulated_matmul`` for the dynamic
    extent of the block."""
    _ACTIVE.append(state)
    try:
        yield state
    finally:
        _ACTIVE.pop()


def active_state() -> dict | None:
    return _ACTIVE[-1] if _ACTIVE else None
