"""RG-LRU recurrent block (Griffin / RecurrentGemma — arXiv:2402.19427).
Counterpart of ``repro/nn/rglru.py``.

The Real-Gated Linear Recurrent Unit is a diagonal linear recurrence

    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)
    a_t = exp(c · r_t · log σ(Λ)),  r_t = σ(W_a x_t),  i_t = σ(W_x x_t)

Being diagonal and linear in h it is an associative scan with the combine
(a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2).  The reference lowers it with
``lax.associative_scan``; the port runs the same combine as a doubling
(Hillis–Steele) scan in plain torch, ⌈log₂ S⌉ passes over the sequence,
and autograd gives the block's local vjp.  No Pallas kernel computes it in
the reference, so there is no kernel to port.  Decode is the O(1)
per-step update.  The block is Griffin's recurrent block: (in_x → causal
conv → RG-LRU) ⊙ gelu(in_gate) → out, each projection through
``forward_matmul`` in the reference's order (in_x, w_a, w_i, in_gate,
out).

Parameter names follow the reference's tree (``in_x.weight``,
``in_gate.weight``, ``conv_w`` (K, D), ``conv_b``, ``w_a.weight``,
``w_i.weight``, ``lambda``, ``out.weight``); ``lambda`` is a Python
keyword, so the parameter is registered under that name and read with
``getattr``.
"""

from __future__ import annotations

import torch

from repro_torch.core.photonics import forward_matmul
from repro_torch.nn.activations import gelu
from repro_torch.nn.linear import Linear
from repro_torch.nn.module import Module, empty_param, init_children
from repro_torch.nn.ssm import causal_conv1d, softplus
from repro_torch.utils import prng

_C = 8.0  # Griffin's recurrence-gate temperature


def _log_a(lam, r):
    """log a_t = c · r_t · log σ(Λ), with log σ(Λ) = -softplus(-Λ)."""
    return _C * r * -softplus(-lam.float())


def _gains(lam, r):
    """(a, sqrt(1 - a²)) from the recurrence gate r, the root computed as
    1 - exp(2 log a) floored at 1e-12."""
    log_a = _log_a(lam, r)
    beta = torch.sqrt(torch.maximum(1.0 - torch.exp(2.0 * log_a),
                                    torch.full((), 1e-12, device=r.device)))
    return torch.exp(log_a), beta


def rglru_scan(x, r, i, lam):
    """The RG-LRU over a sequence.  x, r, i: (B, S, D) f32; lam (D,).
    Returns h (B, S, D), from a zero state."""
    a, beta = _gains(lam, r)
    b = beta * (i * x)
    s, off = x.shape[1], 1
    while off < s:
        # position t folds in the prefix that ends at t - off
        b = torch.cat([b[:, :off], b[:, off:] + a[:, off:] * b[:, :-off]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


class RGLRUBlock(Module):
    def __init__(self, d_model: int, d_rnn: int, conv_width: int = 4, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.d_model, self.d_rnn, self.conv_width, self.dtype = d_model, d_rnn, conv_width, dtype
        lin = dict(dtype=dtype, device=device)
        self.in_x = Linear(d_model, d_rnn, **lin)
        self.in_gate = Linear(d_model, d_rnn, **lin)
        self.conv_w = empty_param((conv_width, d_rnn), dtype, device)
        self.conv_b = empty_param((d_rnn,), dtype, device)
        self.w_a = Linear(d_rnn, d_rnn, **lin)
        self.w_i = Linear(d_rnn, d_rnn, **lin)
        self.register_parameter("lambda", empty_param((d_rnn,), dtype, device))
        self.out = Linear(d_rnn, d_model, **lin)

    @property
    def lam(self):
        return getattr(self, "lambda")

    def init(self, seed: int):
        """The Linears from folded seeds; Λ so that a^c spans (0.9, 0.999),
        as in Griffin; the conv weights N(0, 0.1²), its bias zero."""
        init_children(self, seed)
        dev = self.conv_w.device
        with torch.no_grad():
            g = prng.generator(prng.fold(seed, "lambda"), dev)
            u = 0.9 + 0.099 * torch.rand((self.d_rnn,), generator=g, device=dev)
            root = u ** (1 / _C)
            self.lam.copy_(torch.log(root / (1 - root)))
            g = prng.generator(prng.fold(seed, "conv_w"), dev)
            self.conv_w.copy_(0.1 * torch.randn(self.conv_w.shape, generator=g, device=dev))
            self.conv_b.zero_()
        return self

    def _gates(self, x):
        """(r, i) f32 from the conv output x."""
        return (torch.sigmoid(forward_matmul(x, self.w_a.weight).float()),
                torch.sigmoid(forward_matmul(x, self.w_i.weight).float()))

    def _branch(self, u):
        x = causal_conv1d(forward_matmul(u, self.in_x.weight), self.conv_w, self.conv_b)
        r, i = self._gates(x)
        return x.float(), r, i

    def _out(self, h, u):
        gate = gelu(forward_matmul(u, self.in_gate.weight).float())
        return forward_matmul((h * gate).to(u.dtype), self.out.weight)

    def forward(self, u):
        """u: (B, S, d_model) -> (B, S, d_model)."""
        x, r, i = self._branch(u)
        return self._out(rglru_scan(x, r, i, self.lam), u)

    # ---- decode -----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int = 0, dtype=None):
        """The recurrent state in f32 and the conv window's last K-1 inputs
        in the model dtype; ``max_len`` is not used (the state is O(1))."""
        del max_len
        dev = self.conv_w.device
        return {
            "h": torch.zeros((batch, self.d_rnn), dtype=torch.float32, device=dev),
            "conv": torch.zeros((batch, self.conv_width - 1, self.d_rnn),
                                dtype=dtype or self.dtype, device=dev),
        }

    def decode(self, u, cache, cache_len):
        """u: (B, 1, d_model).  One O(1) state update."""
        del cache_len
        win = torch.cat([cache["conv"], forward_matmul(u, self.in_x.weight)], dim=1)
        # einsum returns a transposed view here; the bank kernel takes
        # contiguous operands
        x = (torch.einsum("bkc,kc->bc", win, self.conv_w).contiguous()
             + self.conv_b)[:, None, :]
        r, i = self._gates(x)
        a, beta = _gains(self.lam, r)
        h = a[:, 0] * cache["h"] + beta[:, 0] * (i[:, 0] * x.float()[:, 0])
        y = self._out(h[:, None, :], u)
        return y, {"h": h, "conv": win[:, 1:, :].to(cache["conv"].dtype)}
