"""Activation functions.  Counterpart of ``repro/nn/activations.py``;
slice 1 ports the one serving needs."""

from __future__ import annotations

import torch


def silu(x):
    return x * torch.sigmoid(x)
