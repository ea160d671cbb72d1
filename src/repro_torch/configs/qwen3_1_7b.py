"""qwen3-1.7b [dense] — 28L d=2048 16H (GQA kv=8) d_ff=6144 vocab=151936,
qk_norm.  [hf:Qwen/Qwen3-family]"""

from __future__ import annotations

import torch

from repro_torch.configs.base import Arch
from repro_torch.models.transformer import TransformerConfig, TransformerLM


def full(dtype=torch.bfloat16, device=None) -> TransformerLM:
    return TransformerLM(TransformerConfig(
        name="qwen3-1.7b", n_layers=28, d_model=2048, n_heads=16,
        n_kv_heads=8, d_ff=6144, vocab_size=151936, head_dim=128,
        qk_norm=True, rope_theta=1e6, dtype=dtype,
    ), device=device)


def smoke(device=None) -> TransformerLM:
    return TransformerLM(TransformerConfig(
        name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16,
        qk_norm=True, rope_theta=1e6, dtype=torch.float32,
    ), device=device)


ARCH = Arch(
    name="qwen3-1.7b", family="dense", make_model=full, make_smoke=smoke,
    source="hf:Qwen/Qwen3-8B (family)", notes="qk_norm, GQA",
)
