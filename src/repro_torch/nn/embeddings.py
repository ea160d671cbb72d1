"""Token embeddings and rotary position embeddings.
Counterpart of ``repro/nn/embeddings.py``."""

from __future__ import annotations

import torch

from repro_torch.nn import initializers
from repro_torch.nn.module import Module, empty_param
from repro_torch.utils import prng


class Embedding(Module):
    def __init__(self, vocab_size: int, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.table = empty_param((vocab_size, dim), dtype, device)

    def init(self, seed: int):
        with torch.no_grad():
            g = prng.generator(seed, self.table.device)
            self.table.copy_(initializers.normal(0.02)(
                g, self.table.shape, self.table.dtype, self.table.device))
        return self

    def forward(self, token_ids):
        return self.table[token_ids]


def rotary_angles(positions, head_dim: int, theta: float = 10000.0):
    """Return (cos, sin) of shape positions.shape + (head_dim//2,)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x, cos, sin):
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim//2).
    Rotates the halves (x[..., :half], x[..., half:]) — the half-split
    (GPT-NeoX / llama) convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    rot1 = x1 * c - x2 * s
    rot2 = x2 * c + x1 * s
    return torch.cat([rot1, rot2], dim=-1).to(x.dtype)
