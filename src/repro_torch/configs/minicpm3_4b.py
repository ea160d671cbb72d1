"""minicpm3-4b [dense] — 62L d=2560 40H d_ff=6400 vocab=73448, MLA.
[hf:openbmb/MiniCPM3-4B]  MLA dims follow the HF config family:
q_lora 768, kv_lora 256, qk_nope 64, qk_rope 32, v_head 64."""

from __future__ import annotations

import torch

from repro_torch.configs.base import Arch
from repro_torch.models.transformer import MLASettings, TransformerConfig, TransformerLM


def full(dtype=torch.bfloat16, device=None) -> TransformerLM:
    return TransformerLM(TransformerConfig(
        name="minicpm3-4b", n_layers=62, d_model=2560, n_heads=40,
        n_kv_heads=40, d_ff=6400, vocab_size=73448,
        mla=MLASettings(q_lora_rank=768, kv_lora_rank=256,
                        qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64),
        dtype=dtype,
    ), device=device)


def smoke(device=None) -> TransformerLM:
    return TransformerLM(TransformerConfig(
        name="minicpm3-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=128,
        mla=MLASettings(q_lora_rank=32, kv_lora_rank=16,
                        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
        dtype=torch.float32,
    ), device=device)


def opt(dtype=torch.bfloat16, device=None) -> TransformerLM:
    """The vocabulary padded to 73728, the reference's sharding-friendly
    layout; padded ids are masked out of the logits."""
    return TransformerLM(TransformerConfig(
        name="minicpm3-4b", n_layers=62, d_model=2560, n_heads=40,
        n_kv_heads=40, d_ff=6400, vocab_size=73448, pad_vocab_to=73728,
        mla=MLASettings(q_lora_rank=768, kv_lora_rank=256,
                        qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64),
        dtype=dtype,
    ), device=device)


ARCH = Arch(
    name="minicpm3-4b", family="dense", make_model=full, make_smoke=smoke,
    make_opt=opt,
    source="hf:openbmb/MiniCPM3-4B", notes="MLA latent cache; absorbed decode",
)
