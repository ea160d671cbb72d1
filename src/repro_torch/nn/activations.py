"""Activation functions and their derivatives.  Counterpart of
``repro/nn/activations.py``.

The DFA gradient (paper Eq. 1) needs g'(a) explicitly: on the photonic chip
it is the per-row TIA gain, here the Hadamard mask handed to the fused
``dfa_gradient`` kernel.  For ReLU the mask is binary.

``relu`` is ``torch.maximum(x, 0)``, not ``torch.relu``: autograd then
gives the gradient 0.5 at x = 0, as ``jnp.maximum`` does in the reference
(``torch.relu`` gives 0 there), so the two packages' gradients agree where a
pre-activation is exactly 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def relu(x):
    return torch.maximum(x, torch.zeros_like(x))


def relu_deriv(a):
    return (a > 0).to(a.dtype)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def gelu_deriv(a):
    # d/da of tanh-approximate gelu
    c = math.sqrt(2.0 / math.pi)
    u = c * (a + 0.044715 * a**3)
    t = torch.tanh(u)
    du = c * (1 + 3 * 0.044715 * a**2)
    return 0.5 * (1 + t) + 0.5 * a * (1 - t**2) * du


def silu(x):
    return x * torch.sigmoid(x)


def silu_deriv(a):
    s = torch.sigmoid(a)
    return s * (1 + a * (1 - s))


def tanh(x):
    return torch.tanh(x)


def tanh_deriv(a):
    return 1 - torch.tanh(a) ** 2


def identity(x):
    return x


def identity_deriv(a):
    return torch.ones_like(a)


ACTIVATIONS = {
    "relu": (relu, relu_deriv),
    "gelu": (gelu, gelu_deriv),
    "silu": (silu, silu_deriv),
    "tanh": (tanh, tanh_deriv),
    "identity": (identity, identity_deriv),
}


def get(name: str):
    """Return (g, g') for a named activation."""
    return ACTIVATIONS[name]
