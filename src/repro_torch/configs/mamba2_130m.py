"""mamba2-130m [ssm] — 24L d=768 (attention-free) vocab=50280,
ssm_state=128, SSD.  [arXiv:2405.21060; unverified]"""

from __future__ import annotations

import torch

from repro_torch.configs.base import Arch
from repro_torch.models.mamba import MambaConfig, MambaLM


def full(dtype=torch.bfloat16, device=None) -> MambaLM:
    return MambaLM(MambaConfig(
        name="mamba2-130m", n_layers=24, d_model=768, vocab_size=50280,
        d_state=128, head_dim=64, expand=2, chunk=256, dtype=dtype,
    ), device=device)


def smoke(device=None) -> MambaLM:
    return MambaLM(MambaConfig(
        name="mamba2-smoke", n_layers=2, d_model=32, vocab_size=128,
        d_state=16, head_dim=16, expand=2, chunk=8, dtype=torch.float32,
    ), device=device)


def opt(dtype=torch.bfloat16, device=None) -> MambaLM:
    """Split input projections (three in place of the fused one) and the
    vocabulary padded to 50432, the reference's sharding-friendly layout."""
    return MambaLM(MambaConfig(
        name="mamba2-130m", n_layers=24, d_model=768, vocab_size=50280,
        d_state=128, head_dim=64, expand=2, chunk=256,
        split_proj=True, pad_vocab_to=50432, dtype=dtype,
    ), device=device)


ARCH = Arch(
    name="mamba2-130m", family="ssm", make_model=full, make_smoke=smoke,
    make_opt=opt, sub_quadratic=True,
    source="arXiv:2405.21060 (unverified)",
    notes="SSD; O(1) decode state",
)
