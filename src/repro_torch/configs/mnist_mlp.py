"""The paper's own architecture: 784×800×800×10 ReLU MLP (Fig. 5),
error_tap = logits, DFA per Eq. 1.  Counterpart of
``repro/configs/mnist_mlp.py``."""

from __future__ import annotations

import torch

from repro_torch.configs.base import Arch
from repro_torch.models.mlp import MLPClassifier


def full(dtype=torch.float32, device=None) -> MLPClassifier:
    return MLPClassifier(in_dim=784, hidden=(800, 800), n_classes=10, dtype=dtype,
                         device=device)


def smoke(device=None) -> MLPClassifier:
    return MLPClassifier(in_dim=64, hidden=(32, 32), n_classes=10, dtype=torch.float32,
                         device=device)


ARCH = Arch(
    name="mnist_mlp", family="paper", make_model=full, make_smoke=smoke,
    has_decoder=False,
    source="paper §4",
)
