"""whisper-small [audio] — 12+12L d=768 12H d_ff=3072 vocab=51865, enc-dec,
conv frontend stubbed (precomputed frame embeds).  [arXiv:2212.04356;
unverified]"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import Arch
from repro_torch.models.whisper import WhisperConfig, WhisperModel

N_FRAMES = 1500
D_MODEL = 768


def full(dtype=torch.bfloat16, device=None) -> WhisperModel:
    return WhisperModel(WhisperConfig(
        name="whisper-small", n_enc_layers=12, n_dec_layers=12,
        d_model=D_MODEL, n_heads=12, d_ff=3072, vocab_size=51865,
        n_frames=N_FRAMES, dtype=dtype,
    ), device=device)


def smoke(device=None) -> WhisperModel:
    return WhisperModel(WhisperConfig(
        name="whisper-smoke", n_enc_layers=2, n_dec_layers=2,
        d_model=48, n_heads=4, d_ff=96, vocab_size=128,
        n_frames=32, max_target=64, dtype=torch.float32,
    ), device=device)


def opt(dtype=torch.bfloat16, device=None) -> WhisperModel:
    """The vocabulary padded to 51968 (a multiple of 16), the reference's
    sharding-friendly layout."""
    return WhisperModel(WhisperConfig(
        name="whisper-small", n_enc_layers=12, n_dec_layers=12,
        d_model=D_MODEL, n_heads=12, d_ff=3072, vocab_size=51865,
        pad_vocab_to=51968, n_frames=N_FRAMES, dtype=dtype,
    ), device=device)


@dataclasses.dataclass(frozen=True)
class _WhisperArch(Arch):
    def input_extras(self, batch: int, kind: str, dtype=torch.bfloat16) -> dict:
        # precomputed frame embeddings at backbone width (the frontend stub)
        del kind
        return {"frames": torch.empty((batch, N_FRAMES, D_MODEL), dtype=dtype, device="meta")}


ARCH = _WhisperArch(
    name="whisper-small", family="audio", make_model=full, make_smoke=smoke,
    make_opt=opt,
    source="arXiv:2212.04356 (unverified)",
    notes="enc-dec DFA: encoder gets pooled-error feedback",
)
