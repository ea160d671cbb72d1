"""kimi-k2-1t-a32b [moe] — 61L d=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, 384 routed experts top-8 + 1 shared: 1.04 T parameters.
[arXiv:2501.kimi2; unverified]

head_dim is 128, as the reference sets it (7168 / 64 = 112 otherwise).
Serving or training it at full size needs the model sharded over cards,
which the port does not have yet; one card holds its layouts on the meta
device and its expert products at full width."""

from __future__ import annotations

import torch

from repro_torch.configs.base import Arch
from repro_torch.models.transformer import MoESettings, TransformerConfig, TransformerLM


def full(dtype=torch.bfloat16, device=None) -> TransformerLM:
    return TransformerLM(TransformerConfig(
        name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
        n_kv_heads=8, d_ff=2048, vocab_size=163840, head_dim=128,
        moe=MoESettings(n_experts=384, top_k=8, d_ff_expert=2048,
                        n_shared_experts=1, d_ff_shared=2048,
                        capacity_factor=1.25),
        rope_theta=5e4, dtype=dtype,
    ), device=device)


def smoke(device=None) -> TransformerLM:
    return TransformerLM(TransformerConfig(
        name="kimi-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=64, vocab_size=128, head_dim=16,
        moe=MoESettings(n_experts=16, top_k=4, d_ff_expert=64,
                        n_shared_experts=1, d_ff_shared=64,
                        capacity_factor=2.0),
        dtype=torch.float32,
    ), device=device)


def opt(dtype=torch.bfloat16, device=None) -> TransformerLM:
    """full() with the einsum dispatch named explicitly: the reference
    keeps einsum because its gather dispatch lowered to all-to-alls under
    its expert sharding; the gather path stays available."""
    return TransformerLM(TransformerConfig(
        name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
        n_kv_heads=8, d_ff=2048, vocab_size=163840, head_dim=128,
        moe=MoESettings(n_experts=384, top_k=8, d_ff_expert=2048,
                        n_shared_experts=1, d_ff_shared=2048,
                        capacity_factor=1.25, dispatch="einsum"),
        rope_theta=5e4, dtype=dtype,
    ), device=device)


ARCH = Arch(
    name="kimi-k2-1t-a32b", family="moe", make_model=full, make_smoke=smoke,
    make_opt=opt,
    source="arXiv:2501.kimi2 (unverified)",
    notes="1T total / 32B active; full size needs the model sharded over cards",
)
