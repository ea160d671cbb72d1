"""Normalisation layers (computed in f32, cast back).
Counterpart of ``repro/nn/norms.py``."""

from __future__ import annotations

import torch

from repro_torch.nn.module import Module, empty_param


class RMSNorm(Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.scale = empty_param((dim,), dtype, device)

    def init(self, seed: int):
        del seed
        with torch.no_grad():
            self.scale.fill_(1.0)
        return self

    def forward(self, x):
        x32 = x.float()
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        y = x32 * (var + self.eps) ** -0.5
        return (y * self.scale.float()).to(x.dtype)


class LayerNorm(Module):
    """Mean and variance in f32, ``scale`` and an optional ``bias``, cast
    back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, use_bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.scale = empty_param((dim,), dtype, device)
        self.bias = empty_param((dim,), dtype, device) if use_bias else None

    def init(self, seed: int):
        del seed
        with torch.no_grad():
            self.scale.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()
        return self

    def forward(self, x):
        x32 = x.float()
        mean = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
        y = (x32 - mean) * (var + self.eps) ** -0.5
        y = y * self.scale.float()
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


def rms_normalize(x, eps: float = 1e-6):
    """Parameter-free RMS normalisation (the qk-norm and MLA building
    block): f32 inside, cast back to the input dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * (var + eps) ** -0.5).to(x.dtype)
