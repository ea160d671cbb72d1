"""qwen1.5-0.5b [dense] — 24L d=1024 16H (GQA kv=16) d_ff=2816 vocab=151936,
QKV bias.  [hf:Qwen/Qwen1.5-0.5B]"""

from __future__ import annotations

import torch

from repro_torch.configs.base import Arch
from repro_torch.models.transformer import TransformerConfig, TransformerLM


def full(dtype=torch.bfloat16, device=None) -> TransformerLM:
    return TransformerLM(TransformerConfig(
        name="qwen1.5-0.5b", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=16, d_ff=2816, vocab_size=151936, head_dim=64,
        qkv_bias=True, rope_theta=1e6, dtype=dtype,
    ), device=device)


def smoke(device=None) -> TransformerLM:
    return TransformerLM(TransformerConfig(
        name="qwen1.5-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=128, head_dim=16,
        qkv_bias=True, rope_theta=1e6, dtype=torch.float32,
    ), device=device)


ARCH = Arch(
    name="qwen1.5-0.5b", family="dense", make_model=full, make_smoke=smoke,
    source="hf:Qwen/Qwen1.5-0.5B",
)
