"""internvl2-2b [vlm] — 24L d=2048 16H (GQA kv=8) d_ff=8192 vocab=92553,
InternViT frontend stubbed (precomputed patch embeds, d_vision=1024).
[arXiv:2404.16821]"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import Arch
from repro_torch.models.transformer import TransformerConfig, TransformerLM, VisionSettings

N_PATCHES = 256
D_VISION = 1024


def full(dtype=torch.bfloat16, device=None) -> TransformerLM:
    return TransformerLM(TransformerConfig(
        name="internvl2-2b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=8, d_ff=8192, vocab_size=92553, head_dim=128,
        vision=VisionSettings(d_vision=D_VISION, n_patches=N_PATCHES),
        rope_theta=1e6, dtype=dtype,
    ), device=device)


def smoke(device=None) -> TransformerLM:
    return TransformerLM(TransformerConfig(
        name="internvl2-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16,
        vision=VisionSettings(d_vision=32, n_patches=8),
        dtype=torch.float32,
    ), device=device)


def opt(dtype=torch.bfloat16, device=None) -> TransformerLM:
    """The vocabulary padded to 92672, the reference's sharding-friendly
    layout."""
    return TransformerLM(TransformerConfig(
        name="internvl2-2b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=8, d_ff=8192, vocab_size=92553, pad_vocab_to=92672,
        head_dim=128,
        vision=VisionSettings(d_vision=D_VISION, n_patches=N_PATCHES),
        rope_theta=1e6, dtype=dtype,
    ), device=device)


@dataclasses.dataclass(frozen=True)
class _InternVLArch(Arch):
    def input_extras(self, batch: int, kind: str, dtype=torch.bfloat16) -> dict:
        # precomputed patch embeddings (the ViT stub); serving is text-only
        if kind == "train":
            return {"patch_embeds": torch.empty((batch, N_PATCHES, D_VISION), dtype=dtype,
                                                device="meta")}
        return {}


ARCH = _InternVLArch(
    name="internvl2-2b", family="vlm", make_model=full, make_smoke=smoke,
    make_opt=opt,
    source="arXiv:2404.16821",
    notes="ViT tower stubbed; serve paths are text-decode",
)
