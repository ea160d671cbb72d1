"""granite-8b [dense] — 36L d=4096 32H (GQA kv=8) d_ff=14336 vocab=49152,
llama-arch code model.  [arXiv:2405.04324]"""

from __future__ import annotations

import torch

from repro_torch.configs.base import Arch
from repro_torch.models.transformer import TransformerConfig, TransformerLM


def full(dtype=torch.bfloat16, device=None) -> TransformerLM:
    return TransformerLM(TransformerConfig(
        name="granite-8b", n_layers=36, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab_size=49152, head_dim=128,
        rope_theta=1e4, dtype=dtype,
    ), device=device)


def smoke(device=None) -> TransformerLM:
    return TransformerLM(TransformerConfig(
        name="granite-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=192, vocab_size=128, head_dim=16,
        dtype=torch.float32,
    ), device=device)


ARCH = Arch(
    name="granite-8b", family="dense", make_model=full, make_smoke=smoke,
    source="arXiv:2405.04324",
)
