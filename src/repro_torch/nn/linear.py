"""Linear / MLP layers.  Counterpart of ``repro/nn/linear.py``: ``Linear``,
the paper's ``DenseBlock``, the gated ``GatedMLP`` and whisper's plain
two-layer ``MLP``.

Weights are in torch layout (out, in): ``forward_matmul`` hands ``weight``
to the bank as its (M, K) operand with no copy.  ``stack=E`` holds E such
weights in one (E, out, in) parameter, the reference's ``stack_init`` of a
module run under ``jax.vmap`` (a mixture of experts' expert FFNs): each
product then runs over the stack as one batched bank product.

Tensor parallelism (``dist.sharding``): under a mesh whose ``model`` axis
split a weight's output dim (every 2-D weight, as the reference's
placements dictate), a layer holds this rank's rows of it, gathers them
and runs the one process's product on the whole weight, so its output is
whole on every rank and its arithmetic the one process's (a narrower
product is not: ``dist.sharding`` says why).  A layer reads the split from
its own weight (local rows against ``out_dim``), so a weight the
divisibility fallback left whole is computed whole."""

from __future__ import annotations

import torch

from repro_torch.core.photonics import forward_matmul
from repro_torch.dist.sharding import gather_from_model
from repro_torch.nn import activations, initializers
from repro_torch.nn.module import Module, empty_param
from repro_torch.utils import prng


class Linear(Module):
    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = False,
                 dtype=torch.float32, device=None, stack: int | None = None):
        super().__init__()
        lead = (stack,) if stack else ()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.weight = empty_param((*lead, out_dim, in_dim), dtype, device)
        self.bias = empty_param((out_dim,), dtype, device) if use_bias else None

    def init(self, seed: int):
        w = self.weight
        with torch.no_grad():
            w.copy_(initializers.lecun_normal()(
                prng.generator(prng.fold(seed, "w"), w.device), w.shape, w.dtype, w.device))
            if self.bias is not None:
                self.bias.zero_()
        return self

    def forward(self, x):
        """The layer on ``x``, a model-split weight and bias gathered whole
        first."""
        w, b = self.weight, self.bias
        if w.shape[-2] != self.out_dim:
            w = gather_from_model(w, 0)
        if b is not None and b.shape[0] != self.out_dim:
            b = gather_from_model(b, 0)
        y = forward_matmul(x, w)
        return y if b is None else y + b


class DenseBlock(Linear):
    """linear -> activation, the paper's hidden-layer unit.

    Block-granular DFA applied to this block reproduces the paper's DFA
    update: injecting delta = B e at the block *output* and differentiating
    the block locally yields grad_W = (B e ⊙ g'(a)) h_inᵀ (Eq. 1), because
    the local gradient through g contributes the ⊙ g'(a) Hadamard."""

    def __init__(self, in_dim: int, out_dim: int, activation: str = "relu",
                 use_bias: bool = True, dtype=torch.float32, device=None):
        super().__init__(in_dim, out_dim, use_bias, dtype, device)
        self.activation = activation

    def preact(self, x):
        return super().forward(x)

    def forward(self, x):
        g, _ = activations.get(self.activation)
        return g(self.preact(x))


class GatedMLP(Module):
    """Gated FFN: down( act(gate(x)) * up(x) ), SwiGLU by default
    (``activation="silu"``; recurrentgemma's is ``"gelu"``, the tanh
    form).  With ``stack=E`` it is E FFNs on stacked weights, x (E, ...,
    d_model) -> (E, ..., d_model)."""

    def __init__(self, d_model: int, d_ff: int, activation: str = "silu",
                 dtype=torch.float32, device=None, stack: int | None = None):
        super().__init__()
        self.activation = activation
        self.gate = Linear(d_model, d_ff, dtype=dtype, device=device, stack=stack)
        self.up = Linear(d_model, d_ff, dtype=dtype, device=device, stack=stack)
        self.down = Linear(d_ff, d_model, dtype=dtype, device=device, stack=stack)

    def forward(self, x):
        g, _ = activations.get(self.activation)
        return self.down(g(self.gate(x)) * self.up(x))


class MLP(Module):
    """Plain two-layer MLP (whisper's FFN): fc2(act(fc1(x))), both products
    on the bank, biases on by default, GELU (the tanh form) by default."""

    def __init__(self, d_model: int, d_ff: int, activation: str = "gelu",
                 use_bias: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        self.activation = activation
        self.fc1 = Linear(d_model, d_ff, use_bias, dtype, device)
        self.fc2 = Linear(d_ff, d_model, use_bias, dtype, device)

    def forward(self, x):
        g, _ = activations.get(self.activation)
        return self.fc2(g(self.fc1(x)))
