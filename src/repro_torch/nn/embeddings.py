"""Token embeddings and rotary position embeddings.
Counterpart of ``repro/nn/embeddings.py``.

Under tensor parallelism the table's vocabulary is split over ``model``
(the reference's ``embed`` rule): ``lookup`` is then vocabulary-parallel."""

from __future__ import annotations

import torch

from repro_torch.dist import sharding
from repro_torch.nn import initializers
from repro_torch.nn.module import Module, empty_param
from repro_torch.utils import prng


class Embedding(Module):
    def __init__(self, vocab_size: int, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.vocab_size = vocab_size
        self.table = empty_param((vocab_size, dim), dtype, device)

    def init(self, seed: int):
        with torch.no_grad():
            g = prng.generator(seed, self.table.device)
            self.table.copy_(initializers.normal(0.02)(
                g, self.table.shape, self.table.dtype, self.table.device))
        return self

    def forward(self, token_ids):
        return lookup(self.table, token_ids, self.vocab_size)


def lookup(table, token_ids, vocab_size: int):
    """``table[token_ids]``.  Where ``table`` holds this rank's rows of a
    ``vocab_size``-row table split over the model axis, the ids in its
    range are looked up, the others give zeros, and the pieces are summed
    over the axis (``reduce_from_model``): exact, since one rank holds each
    row, and each rank's rows get their own gradient."""
    rows = table.shape[0]
    if rows == vocab_size:
        return table[token_ids]
    start = sharding.model_index(sharding.current_mesh())[0] * rows
    local = token_ids - start
    hit = (local >= 0) & (local < rows)
    out = torch.where(hit[..., None], table[local.clamp(0, rows - 1)], 0.0)
    return sharding.reduce_from_model(out)


def positions_from_offset(batch: int, seq: int, offset):
    """(batch, seq) absolute positions starting at ``offset``, one per row
    (a decode step); a scalar offset gives one (1, seq) row, as the
    reference's broadcast does."""
    del batch
    offset = torch.as_tensor(offset)
    return torch.arange(seq, device=offset.device)[None, :] + offset.reshape(-1, 1)


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
