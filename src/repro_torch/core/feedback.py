"""Fixed random feedback matrices B(k) for DFA (paper Eq. 1).
Counterpart of ``repro/core/feedback.py``.

B(k) maps the error tap (dim ``d_tap``) to layer k's injection point (dim
``d_out``), stored (d_out, d_tap): the bank's (M, K) operand.  They are
fixed — never updated — so they live outside the optimizer state.  Options
as the reference's: gaussian, uniform or orthogonal init; one B shared by a
segment's layers; ternary B ∈ {-1, 0, +1}·scale.  B is stored in natural
units; ``core.photonics`` normalises it onto the bank's [-1, 1] range.

Numbers are drawn from ``torch.Generator``s seeded through
``utils.prng.fold``: the same distribution as the reference, another stream
(the tests carry the reference's matrices across through ``convert``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils import prng


@dataclasses.dataclass(frozen=True)
class FeedbackConfig:
    init: str = "gaussian"  # gaussian | uniform | orthogonal
    scale: float | None = None  # None -> 1/sqrt(d_out)
    shared: bool = False  # one B shared across a segment's layers
    ternary: bool = False
    dtype: torch.dtype = torch.float32


def _sample(seed: int, shape, cfg: FeedbackConfig, device):
    gen = prng.generator(seed, device)
    d_out, d_tap = shape[-2], shape[-1]
    # default scale 1/sqrt(d_out): keeps ||B·e|| ≈ ||e||
    scale = cfg.scale if cfg.scale is not None else 1.0 / math.sqrt(d_out)
    if cfg.init == "gaussian":
        b = torch.randn(shape, generator=gen, device=device) * scale
    elif cfg.init == "uniform":
        u = torch.rand(shape, generator=gen, device=device) * 2 - 1
        b = u * scale * math.sqrt(3.0)
    elif cfg.init == "orthogonal":
        # Haar-distributed orthogonal matrices: QR of a gaussian with the
        # signs of R's diagonal folded into Q
        n = max(d_out, d_tap)
        z = torch.randn(tuple(shape[:-2]) + (n, n), generator=gen, device=device)
        q, r = torch.linalg.qr(z)
        q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[..., None, :]
        b = q[..., :d_out, :d_tap] * (scale * math.sqrt(d_tap))
    else:
        raise ValueError(f"unknown feedback init {cfg.init!r}")
    if cfg.ternary:
        thresh = 0.6745 * scale  # median(|N(0, s)|): about half the entries survive
        mag = b.abs().mean()
        b = torch.sign(b) * (b.abs() > thresh) * mag * 2.0
    return b.to(cfg.dtype)


def make_feedback(seed: int, n_layers: int, d_out: int, d_tap: int, cfg: FeedbackConfig,
                  device):
    """Stacked feedback (n_layers, d_out, d_tap) — or (1, ...) if shared."""
    if cfg.shared:
        return _sample(prng.fold(seed, "shared"), (1, d_out, d_tap), cfg, device)
    layers = prng.fold(seed, "layers")
    return torch.stack([_sample(prng.fold(layers, i), (d_out, d_tap), cfg, device)
                        for i in range(n_layers)])


def feedback_for(stacked, layer_idx: int):
    """Select a layer's B from stacked feedback (handles shared)."""
    return stacked[min(int(layer_idx), stacked.shape[0] - 1)]
