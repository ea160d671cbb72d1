"""Fused DFA gradient δ = (A @ Bᵀ + η) ⊙ mask: the CUDA kernel's wrapper and
its plain version.

Counterpart of ``repro/kernels/dfa_gradient.py::dfa_gradient_pallas``: the
paper's electro-optic circuit in one pass (Fig. 4b) — the weight-bank
product, the analog read noise, and the TIA gain stage that applies the
Hadamard with g'(a) as an epilogue.  The kernel is the bank kernel of
``csrc/photonic_matmul.cu`` with its mask template flag set (entry
``dfa_gradient_launch``), built into the same library as
``photonic_matmul``; importing this module builds nothing.

The mask is a contiguous (T, M) **f32** tensor (``ops`` casts g'(a) to f32
before the call).  Noise modes and their counters are kernel A's, so the
plain version is ``photonic_matmul_plain(...) * mask`` and prng mode has an
elementwise oracle on the card.  ``dfa_gradient_cuda`` launches the kernel
for CUDA tensors, and runs the plain version only because its tensors lie
on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.photonic_matmul import (check_operands, launch_kernel,
                                                 photonic_matmul_plain)
from repro_torch.utils import flop_cost

launches = 0  # kernel launches since the last reset; read by chip_smoke.py


def dfa_gradient_plain(a, b, mask, *, noise=None, seed=None, sigma_step: float = 0.0):
    """The kernel's function in plain torch -> f32 (T, M)."""
    out = photonic_matmul_plain(a, b, noise=noise, seed=seed, sigma_step=sigma_step)
    return out * mask


def _check_mask(a, b, mask):
    shape = (*a.shape[:-1], b.shape[-2])
    if tuple(mask.shape) != shape:
        raise ValueError(f"mask must be the output's {shape}, got {tuple(mask.shape)}")
    if mask.dtype != torch.float32:
        raise TypeError(f"the mask is f32, got {mask.dtype}")
    if mask.device != a.device:
        raise ValueError(f"mask on {mask.device}, operands on {a.device}")


def dfa_gradient_cuda(a, b, mask, *, noise=None, seed=None, sigma_step: float = 0.0):
    """δ = (A @ Bᵀ + η) ⊙ mask.  A:(T,K) B:(M,K) mask:(T,M) f32 -> (T,M) f32
    (or batched, mask (E, T, M), as ``photonic_matmul_cuda``).

    ``noise`` (T, M) f32 selects "input" mode, ``seed`` (an int) "prng"
    mode with ``sigma_step`` per K tile, as ``photonic_matmul_cuda``."""
    global launches
    check_operands(a, b, noise, seed)
    _check_mask(a, b, mask)
    if a.device.type == "cpu":
        return dfa_gradient_plain(a, b, mask, noise=noise, seed=seed, sigma_step=sigma_step)
    out = launch_kernel(a, b, mask=mask, noise=noise, seed=seed, sigma_step=sigma_step)
    launches += 1
    flop_cost.count_launch(2 * a.numel() * b.shape[-2])
    return out
