"""The paper's feed-forward network: 784×800×800×10 ReLU MLP (Fig. 5).
Counterpart of ``repro/models/mlp.py``.

error_tap = "logits": e = ∂L/∂logits = softmax(ŷ) − y, dim 10 — the error
the photonic circuit amplitude-encodes onto the N WDM channels.  The hidden
``DenseBlock``s ``h0``, ``h1``, ... are segments of one block each and get
DFA feedback δ(k) = B(k)e ⊙ g'(a(k)) through the engine's block-local
gradient; the output layer ("head") is updated with e exactly.

Under tensor parallelism each ``DenseBlock`` and the head run on their
gathered weights (``nn/linear.py``): every block's output and the logits
are whole on every rank.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from repro_torch.models.base import (DFAModel, SavedSegment, SegmentSpec,
                                     cross_entropy_loss, gathered)
from repro_torch.nn.linear import DenseBlock, Linear
from repro_torch.utils.device import resolve_device


class MLPClassifier(DFAModel):
    def __init__(self, in_dim: int = 784, hidden: tuple = (800, 800), n_classes: int = 10,
                 activation: str = "relu", dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.in_dim = in_dim
        self.hidden = tuple(hidden)
        self.n_classes = n_classes
        self.activation = activation
        self.dtype = dtype
        dims = (in_dim,) + self.hidden
        for i in range(len(self.hidden)):
            self.add_module(f"h{i}", DenseBlock(dims[i], dims[i + 1], activation,
                                                dtype=dtype, device=device))
        self.head = Linear(self.hidden[-1], n_classes, use_bias=True, dtype=dtype,
                           device=device)

    @property
    def error_tap(self) -> str:
        return "logits"

    @property
    def d_tap(self) -> int:
        return self.n_classes

    def _blocks(self):
        return [getattr(self, f"h{i}") for i in range(len(self.hidden))]

    def forward_gemm_specs(self):
        dims = (self.in_dim,) + self.hidden
        specs = [(f"h{i}", dims[i + 1], dims[i]) for i in range(len(self.hidden))]
        specs.append(("head", self.n_classes, self.hidden[-1]))
        return specs

    def segment_specs(self):
        specs = []
        for i, blk in enumerate(self._blocks()):
            def apply(p, x, extras, blk=blk):
                del extras
                return functional_call(blk, p, (x,)), torch.zeros((), device=x.device)

            specs.append(SegmentSpec(name=f"h{i}", n_layers=1,
                                     d_inject=blk.weight.shape[0], apply=apply))
        return tuple(specs)

    def embed(self, params, batch):
        return batch["x"].to(self.dtype)

    def run_segments(self, params, x0):
        x = x0
        saved = {}
        for spec in self.segment_specs():
            saved[spec.name] = SavedSegment(inputs=x[None])
            x, _ = spec.apply(spec.gathered_params(params, 0), x, None)
        return x, saved, {}

    def head_logits(self, params, x_final, batch):
        """The logits whole on every rank (a head split over the model axis
        runs on its gathered weight): the tapped error is their gradient."""
        del batch
        return functional_call(self.head, gathered(params, "head."), (x_final,))

    def loss_from_logits(self, logits, batch):
        return cross_entropy_loss(logits, batch["y"])
