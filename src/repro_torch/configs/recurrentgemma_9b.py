"""recurrentgemma-9b [hybrid] — 38L d=4096 16H (GQA kv=1) d_ff=12288
vocab=256000, RG-LRU + local attention 1:2 pattern, window 2048.
[arXiv:2402.19427; unverified]"""

from __future__ import annotations

import torch

from repro_torch.configs.base import Arch
from repro_torch.models.recurrentgemma import RecurrentGemmaConfig, RecurrentGemmaLM


def full(dtype=torch.bfloat16, device=None) -> RecurrentGemmaLM:
    return RecurrentGemmaLM(RecurrentGemmaConfig(
        name="recurrentgemma-9b", n_layers=38, d_model=4096, n_heads=16,
        n_kv_heads=1, d_ff=12288, vocab_size=256000, d_rnn=4096,
        window=2048, dtype=dtype,
    ), device=device)


def smoke(device=None) -> RecurrentGemmaLM:
    return RecurrentGemmaLM(RecurrentGemmaConfig(
        name="recurrentgemma-smoke", n_layers=5, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=128, vocab_size=128, d_rnn=64,
        window=16, dtype=torch.float32,
    ), device=device)


ARCH = Arch(
    name="recurrentgemma-9b", family="hybrid", make_model=full, make_smoke=smoke,
    sub_quadratic=True,
    source="arXiv:2402.19427 (unverified)",
    notes="ring-buffer window cache + O(1) RG-LRU state",
)
