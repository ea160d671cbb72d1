"""Plain-torch oracles for the bank kernels (the ground truth in tests).

Counterpart of ``repro/kernels/ref.py``."""

from __future__ import annotations

import torch

from repro_torch.utils import prng


def photonic_matmul_ref(a, b, *, noise=None):
    """C = A @ Bᵀ (+ noise).  a:(T,K) b:(M,K) noise:(T,M)|None, or a batch
    a:(E,T,K) b:(E,M,K) with the (T, M) noise at every index."""
    out = torch.einsum("...tk,...mk->...tm", a.float(), b.float())
    if noise is not None:
        out = out + noise.float()
    return out.to(a.dtype)


def dfa_gradient_ref(a, b, mask, *, noise=None):
    """δ = (A @ Bᵀ + η) ⊙ mask."""
    out = torch.einsum("tk,mk->tm", a.float(), b.float())
    if noise is not None:
        out = out + noise.float()
    out = out * mask.float()
    return out.to(a.dtype)


def total_noise(key, shape, k_dim: int, cfg, device, dtype=torch.float32):
    """Draw the accumulated bank noise for a (T,M) output with contraction
    length k_dim, in normalised units — used by ``ops`` ("input" mode).
    Inside a data-parallel row window the rows are this rank's rows of the
    draw over the global rows, inside a model-parallel column window the
    columns its columns of the draw over the global columns
    (``photonics.randn_rows``)."""
    from repro_torch.core import photonics

    sigma = photonics.noise_sigma_total(k_dim, 1.0, 1.0, cfg)
    return sigma * photonics.randn_rows(shape, prng.generator(key, device), device, dtype)
