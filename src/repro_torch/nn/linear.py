"""Linear / MLP layers.  Counterpart of ``repro/nn/linear.py``: ``Linear``,
the paper's ``DenseBlock``, the gated ``GatedMLP`` and whisper's plain
two-layer ``MLP``.

Weights are in torch layout (out, in): ``forward_matmul`` hands ``weight``
to the bank as its (M, K) operand with no copy.  ``stack=E`` holds E such
weights in one (E, out, in) parameter, the reference's ``stack_init`` of a
module run under ``jax.vmap`` (a mixture of experts' expert FFNs): each
product then runs over the stack as one batched bank product.

Tensor parallelism (``dist.sharding``): a layer whose weight holds this
rank's rows of a weight split over the ``model`` axis (``split``; the FSDP
gather leaves it split for the parts a module names, ``COLUMN_SPLIT``) is
column-parallel: it computes this rank's columns of the product from the
whole input (``columns``), inside a ``photonics.ColumnWindow`` on the bank
(s_b the whole weight's MAX over the model group, the noise its columns of
the global draw), so that its columns are the one process's product's, up
to the rounding of a narrower product.  Called as a module it gathers the
columns (``forward``); ``Attention``, ``GatedMLP`` and the LM head call
``columns`` to keep them local.  A layer on a whole weight runs the one
process's product.  The experts' stacked weight splits along E instead:
the layer runs its E/m products on the matching slice of its input
(``nn/moe.py`` hands it over).  A layer with a ``region`` name counts its
products' FLOPs under it (``utils.flop_cost.region``)."""

from __future__ import annotations

import torch

from repro_torch.core import photonics
from repro_torch.core.photonics import forward_matmul
from repro_torch.dist import sharding
from repro_torch.nn import activations, initializers
from repro_torch.nn.module import Module, empty_param
from repro_torch.utils import flop_cost, prng


class Linear(Module):
    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = False,
                 dtype=torch.float32, device=None, stack: int | None = None,
                 region: str | None = None):
        super().__init__()
        lead = (stack,) if stack else ()
        self.in_dim, self.out_dim, self.stack = in_dim, out_dim, stack
        self.region = region
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

    def splits(self, w) -> bool:
        """Whether ``w`` holds this rank's rows of the layer's weight split
        over the model axis (the FSDP gather left it split: the layer is
        column-parallel)."""
        return not self.stack and w.shape[-2] != self.out_dim

    @property
    def split(self) -> bool:
        """Whether the layer's own weight is split (``splits``)."""
        return self.splits(self.weight)

    def product(self, x, w):
        """``forward_matmul(x, w)``, counted under the layer's region."""
        if self.region is None:
            return forward_matmul(x, w)
        return flop_cost.region(self.region, lambda a: forward_matmul(a, w), x)

    def columns(self, x, weight=None):
        """This rank's columns of the layer (by ``weight``, default its own
        rows) on a whole ``x`` that entered the split through
        ``sharding.copy_to_model``: the product in a column window, plus
        this rank's slice of the bias."""
        w = self.weight if weight is None else weight
        group, index, _ = sharding.tp_group()
        n = w.shape[-2]
        with photonics.column_window(photonics.ColumnWindow(index * n, n, self.out_dim, group)):
            y = self.product(x, w)
        return y if self.bias is None else y + self.bias

    def forward(self, x):
        """The layer on ``x``; a stack split along E on the matching E/m
        slice of ``x``; a column-parallel layer's columns gathered."""
        w, b = self.weight, self.bias
        if self.stack and w.shape[0] != x.shape[0]:
            raise ValueError(f"a stack of {w.shape[0]} of {self.stack} weights on an input of "
                             f"{x.shape[0]}: an expert-parallel rank takes its slice of E")
        if self.split:
            return sharding.gather_from_model(self.columns(sharding.copy_to_model(x)), -1)
        y = self.product(x, w)
        return y if b is None else y + b


class DenseBlock(Linear):
    """linear -> activation, the paper's hidden-layer unit.

    Block-granular DFA applied to this block reproduces the paper's DFA
    update: injecting delta = B e at the block *output* and differentiating
    the block locally yields grad_W = (B e ⊙ g'(a)) h_inᵀ (Eq. 1), because
    the local gradient through g contributes the ⊙ g'(a) Hadamard."""

    def __init__(self, in_dim: int, out_dim: int, activation: str = "relu",
                 use_bias: bool = True, dtype=torch.float32, device=None,
                 region: str | None = None):
        super().__init__(in_dim, out_dim, use_bias, dtype, device, region=region)
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
    d_model) -> (E, ..., d_model).  Column-parallel gate and up give this
    rank's columns of gate·up, gathered before ``down``.  ``region`` names
    its products' regions (``{region}.gate``, ...), ``parts`` its
    ``COLUMN_SPLIT`` parts (gate and up's, down's): a decoder block's FFN
    ``ffn.*`` and ("ffn", "down"), a mixture of experts' shared experts
    ``shared.*`` and ("shared", "shared_down")."""

    def __init__(self, d_model: int, d_ff: int, activation: str = "silu",
                 dtype=torch.float32, device=None, stack: int | None = None,
                 region: str = "ffn", parts: tuple = ("ffn", "down")):
        super().__init__()
        self.activation = activation
        self.parts = parts
        mk = lambda i, o, n: Linear(i, o, dtype=dtype, device=device, stack=stack,
                                    region=None if stack else f"{region}.{n}")
        self.gate = mk(d_model, d_ff, "gate")
        self.up = mk(d_model, d_ff, "up")
        self.down = mk(d_ff, d_model, "down")

    def column_parts(self, size: int, serving: bool) -> tuple[list, dict]:
        """(the ``COLUMN_SPLIT`` parts this FFN computes column-parallel on
        a model axis of ``size``, the parts it keeps whole -> why): gate and
        up, and down; a leaf the divisibility fallback leaves whole runs
        whole (``Linear.split``)."""
        del size, serving
        return list(self.parts), {}

    def forward(self, x):
        g, _ = activations.get(self.activation)
        if not self.gate.split:
            return self.down(g(self.gate(x)) * self.up(x))
        x = sharding.copy_to_model(x)
        h = g(self.gate.columns(x)) * self.up.columns(x)
        return self.down(sharding.gather_from_model(h, -1))


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
