"""Public wrapper around the bank kernel: the ``cuda`` backend's product.

Counterpart of ``repro/kernels/ops.py``.  Handles operand normalisation to
the photonic [-1, 1] range, fake-quant, noise-mode selection and
rescaling, so callers see the semantics of
``core.photonics.photonic_matmul`` executed by the kernel.  The kernel
masks its own ragged edge, so nothing is padded.

Like the reference, the kernel implements the abstract noise model only;
device-level effects (``PhotonicConfig.mrr``) belong to the ``emu``
backend.
"""

from __future__ import annotations

import math

from repro_torch.core import photonics
from repro_torch.kernels.photonic_matmul import BLOCK_K, photonic_matmul_cuda
from repro_torch.kernels.ref import total_noise


def photonic_matmul(a, b, cfg, key=None, *, mask=None, noise_mode="auto"):
    """Weight-bank product with the paper's noise model, kernel-executed.

    a: (T, K) inputs; b: (M, K) weights; ``key`` an integer seed.
    noise_mode: auto|none|input|prng — "auto" picks ``input`` when a key is
    given and the hardware is noisy, else ``none``.
    """
    if mask is not None:
        raise NotImplementedError(
            "mask= needs the fused dfa_gradient kernel, ported with the "
            "training slice; use the 'ref' backend")
    if not cfg.enabled:
        return photonic_matmul_cuda(a, b).to(a.dtype)

    k_dim = a.shape[1]
    a_n, b_n, s_a, s_b = photonics.normalise_operands(a, b, cfg)
    if noise_mode == "auto":
        noise_mode = "input" if (cfg.noise_std > 0 and key is not None) else "none"

    if noise_mode == "none":
        out = photonic_matmul_cuda(a_n, b_n)
    elif noise_mode == "input":
        noise = total_noise(key, (a.shape[0], b.shape[0]), k_dim, cfg, a.device)
        out = photonic_matmul_cuda(a_n, b_n, noise=noise)
    elif noise_mode == "prng":
        nk = math.ceil(k_dim / BLOCK_K)
        sigma_step = photonics.noise_sigma_total(k_dim, 1.0, 1.0, cfg) / math.sqrt(nk)
        out = photonic_matmul_cuda(a_n, b_n, seed=key if key is not None else 0,
                                   sigma_step=sigma_step)
    else:
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    return (out * (s_a * s_b)).to(a.dtype)
