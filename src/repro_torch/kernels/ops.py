"""Public wrappers around the bank kernels: the ``cuda`` backend's product.

Counterpart of ``repro/kernels/ops.py``.  Handles operand normalisation to
the photonic [-1, 1] range, fake-quant, noise-mode selection and
rescaling, so callers see the semantics of
``core.photonics.photonic_matmul`` executed by the kernels: the bank
product (``photonic_matmul``), or with ``mask=`` the fused DFA gradient
(``dfa_gradient``).  The kernels mask their own ragged edge, so nothing is
padded.

Like the reference, the kernels implement the abstract noise model only;
device-level effects (``PhotonicConfig.mrr``) belong to the ``emu``
backend.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import photonics
from repro_torch.kernels.dfa_gradient import dfa_gradient_cuda
from repro_torch.kernels.photonic_matmul import BLOCK_K, photonic_matmul_cuda
from repro_torch.kernels.ref import total_noise
from repro_torch.lint.runtime import check_finite


def photonic_matmul(a, b, cfg, key=None, *, mask=None, noise_mode="auto"):
    """Weight-bank product with the paper's noise model, kernel-executed.

    a: (T, K) inputs; b: (M, K) weights; mask: optional (T, M) epilogue,
    applied after the noise and before the rescale by s_a·s_b, in the
    ``dfa_gradient`` kernel; ``key`` an integer seed.
    noise_mode: auto|none|input|prng — "auto" picks ``input`` when a key is
    given and the hardware is noisy, else ``none``.
    """
    if mask is None:
        kernel = photonic_matmul_cuda
    else:
        mask = mask.to(torch.float32).contiguous()

        def kernel(a_, b_, **kw):
            return dfa_gradient_cuda(a_, b_, mask, **kw)

    if not cfg.enabled:
        return kernel(a, b).to(a.dtype)

    k_dim = a.shape[1]
    a_n, b_n, s_a, s_b = photonics.normalise_operands(a, b, cfg)
    if noise_mode == "auto":
        noise_mode = "input" if (cfg.noise_std > 0 and key is not None) else "none"

    if noise_mode == "none":
        out = kernel(a_n, b_n)
    elif noise_mode == "input":
        noise = total_noise(key, (a.shape[0], b.shape[0]), k_dim, cfg, a.device)
        out = kernel(a_n, b_n, noise=noise)
    elif noise_mode == "prng":
        nk = math.ceil(k_dim / BLOCK_K)
        sigma_step = photonics.noise_sigma_total(k_dim, 1.0, 1.0, cfg) / math.sqrt(nk)
        out = kernel(a_n, b_n, seed=key if key is not None else 0, sigma_step=sigma_step)
    else:
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    return check_finite((out * (s_a * s_b)).to(a.dtype), "the bank kernel's output")


def dfa_gradient(a, b, mask, cfg, key=None, **kw):
    """Fused δ = (A@Bᵀ + η) ⊙ mask — alias with a mandatory mask."""
    return photonic_matmul(a, b, cfg, key, mask=mask, **kw)
