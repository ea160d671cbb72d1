"""Modality frontends: stubs, as in the reference.  Counterpart of
``repro/nn/frontends.py``.

The audio (whisper) and vision (internvl2) configs specify the transformer
backbone only: batches carry precomputed frame or patch embeddings.  The
stubs add the reference's minimal learned glue — a positional embedding and
a LayerNorm for audio frames, a LayerNorm and a projection for vision
patches — and no conv or ViT tower.  The vision projection is a raw
``x @ Wᵀ + b``, digital as the reference's ``@``: it never reaches the
bank.  Its parameter keeps the reference's ``proj`` names (``proj.weight``
in torch layout (d_model, d_vision), ``proj.bias``).
"""

from __future__ import annotations

import torch

from repro_torch.nn import initializers
from repro_torch.nn.linear import Linear
from repro_torch.nn.module import Module, empty_param
from repro_torch.nn.norms import LayerNorm
from repro_torch.utils import prng


class AudioFrontendStub(Module):
    """Precomputed frames (B, T, d) + learned ``pos[:T]``, then LayerNorm."""

    def __init__(self, d_model: int, max_frames: int = 1500, dtype=torch.float32, device=None):
        super().__init__()
        self.pos = empty_param((max_frames, d_model), dtype, device)
        self.ln = LayerNorm(d_model, dtype=dtype, device=device)

    def init(self, seed: int):
        with torch.no_grad():
            self.pos.copy_(initializers.normal(0.01)(
                prng.generator(prng.fold(seed, "pos"), self.pos.device), self.pos.shape,
                self.pos.dtype, self.pos.device))
        self.ln.init(prng.fold(seed, "ln"))
        return self

    def forward(self, frames):
        return self.ln(frames + self.pos[:frames.shape[1]])


class VisionFrontendStub(Module):
    """Precomputed patch embeddings (B, P, d_vision) → LayerNorm → the
    digital projection to the LM width (InternVL's mlp1 connector)."""

    def __init__(self, d_vision: int, d_model: int, dtype=torch.float32, device=None):
        super().__init__()
        self.proj = Linear(d_vision, d_model, use_bias=True, dtype=dtype, device=device)
        self.ln = LayerNorm(d_vision, dtype=dtype, device=device)

    def forward(self, patches):
        x = self.ln(patches)
        dt = torch.result_type(x, self.proj.weight)  # the reference's promotion
        return x.to(dt) @ self.proj.weight.T.to(dt) + self.proj.bias.to(dt)
