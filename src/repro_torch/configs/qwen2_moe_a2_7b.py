"""qwen2-moe-a2.7b [moe] — 24L d=2048 16H (GQA kv=16) expert d_ff=1408
vocab=151936, 60 routed experts top-4 + 4 shared.
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""

from __future__ import annotations

import torch

from repro_torch.configs.base import Arch
from repro_torch.models.transformer import MoESettings, TransformerConfig, TransformerLM


def full(dtype=torch.bfloat16, device=None) -> TransformerLM:
    return TransformerLM(TransformerConfig(
        name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1408, vocab_size=151936, head_dim=128,
        moe=MoESettings(n_experts=60, top_k=4, d_ff_expert=1408,
                        n_shared_experts=4, d_ff_shared=1408),
        rope_theta=1e6, dtype=dtype,
    ), device=device)


def smoke(device=None) -> TransformerLM:
    return TransformerLM(TransformerConfig(
        name="qwen2-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=96, vocab_size=128, head_dim=16,
        moe=MoESettings(n_experts=8, top_k=2, d_ff_expert=96,
                        n_shared_experts=2, d_ff_shared=96,
                        capacity_factor=2.0),
        dtype=torch.float32,
    ), device=device)


def opt(dtype=torch.bfloat16, device=None) -> TransformerLM:
    """full() with the einsum dispatch named explicitly, as the reference's."""
    return TransformerLM(TransformerConfig(
        name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1408, vocab_size=151936, head_dim=128,
        moe=MoESettings(n_experts=60, top_k=4, d_ff_expert=1408,
                        n_shared_experts=4, d_ff_shared=1408, dispatch="einsum"),
        rope_theta=1e6, dtype=dtype,
    ), device=device)


ARCH = Arch(
    name="qwen2-moe-a2.7b", family="moe", make_model=full, make_smoke=smoke,
    make_opt=opt,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B", notes="4 shared + 60 routed top-4",
)
