"""Parameter initializers: ``init(generator, shape, dtype, device)``.

Counterpart of ``repro/nn/initializers.py``.  Values are drawn in f32 from
an explicit generator on the target device and cast to ``dtype``, as the
reference draws f32 and casts.  Weights are in torch layout (out, in), so
the fan-in is the last axis.
"""

from __future__ import annotations

import numpy as np
import torch


def normal(stddev: float = 0.02):
    def init(generator, shape, dtype, device):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * stddev).to(dtype)

    return init


def lecun_normal(in_axis: int = -1):
    """Variance-scaling (fan_in) — the default for projection weights."""

    def init(generator, shape, dtype, device):
        fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
        std = 1.0 / np.sqrt(max(1, fan_in))
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * std).to(dtype)

    return init
