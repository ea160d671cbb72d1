"""Linear / MLP layers.  Counterpart of ``repro/nn/linear.py``: ``Linear``,
the paper's ``DenseBlock``, the gated ``GatedMLP`` and whisper's plain
two-layer ``MLP``.

Weights are in torch layout (out, in): ``forward_matmul`` hands ``weight``
to the bank as its (M, K) operand with no copy.  ``stack=E`` holds E such
weights in one (E, out, in) parameter, the reference's ``stack_init`` of a
module run under ``jax.vmap`` (a mixture of experts' expert FFNs): each
product then runs over the stack as one batched bank product.

Tensor parallelism (``dist.sharding``): a layer runs on whole weights,
which the FSDP gather hands it, so its output is whole on every rank and
its arithmetic the one process's (a narrower product is not:
``dist.sharding`` says why).  The experts' stacked weight is the
exception: split along E, the layer runs its E/m products on the matching
slice of its input (``nn/moe.py`` hands it over)."""

from __future__ import annotations

import torch

from repro_torch.core.photonics import forward_matmul
from repro_torch.nn import activations, initializers
from repro_torch.nn.module import Module, empty_param
from repro_torch.utils import prng


class Linear(Module):
    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = False,
                 dtype=torch.float32, device=None, stack: int | None = None):
        super().__init__()
        lead = (stack,) if stack else ()
        self.in_dim, self.out_dim, self.stack = in_dim, out_dim, stack
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
        """The layer on ``x``; a stack split along E on the matching E/m
        slice of ``x``."""
        w, b = self.weight, self.bias
        if self.stack and w.shape[0] != x.shape[0]:
            raise ValueError(f"a stack of {w.shape[0]} of {self.stack} weights on an input of "
                             f"{x.shape[0]}: an expert-parallel rank takes its slice of E")
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
