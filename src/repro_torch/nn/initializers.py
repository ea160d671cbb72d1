"""Parameter initializers: ``init(generator, shape, dtype, device)``.

Counterpart of ``repro/nn/initializers.py``.  Values are drawn in f32 from
an explicit generator on the target device and cast to ``dtype``, as the
reference draws f32 and casts.  Weights are in torch layout (out, in), so
the fan-in is the last axis.
"""

from __future__ import annotations

import numpy as np
import torch


def zeros(generator, shape, dtype, device):
    del generator
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(generator, shape, dtype, device):
    del generator
    return torch.ones(shape, dtype=dtype, device=device)


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


def glorot_normal():
    """Normal with std sqrt(2 / (fan_in + fan_out)) over the last two dims
    (symmetric in them, so the same in either layout)."""

    def init(generator, shape, dtype, device):
        std = np.sqrt(2.0 / (shape[-2] + shape[-1]))
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * std).to(dtype)

    return init


def uniform_sym(scale: float):
    """Uniform on [-scale, scale)."""

    def init(generator, shape, dtype, device):
        x = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * (2 * scale) - scale).to(dtype)

    return init
