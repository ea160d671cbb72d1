"""Mamba-2 language model (mamba2-130m): attention-free SSD blocks.
Counterpart of ``repro/models/mamba.py``.

DFA applies per block: each (norm → SSD → residual) block is a DFA unit
and its recurrence gets the exact local vjp.  The model is a ``DFAModel``
with the hidden error tap (d_tap = d_model), the blocks in one segment
``blocks`` and DFA feedback into the embedding table.  It serves with an
O(1) decode state: caches ``{"ssm", "conv"}`` stacked (L, B, ...), the SSM
state in f32 and the conv window in the model dtype.  It has no parallel
prefill: the engine fills its state by the masked decode-scan
(``serve.decode.make_prefill_step``).

As in the reference, the training head (``head_logits``) is the digital
``h @ Wᵀ`` and the decode head runs through ``forward_matmul`` (the
photonic bank when serving on one).  The reference scans stacked layer
parameters; the port loops over a ``ModuleList`` (``photonics.
scanned_layers`` keeps the reference's per-layer noise-key numbering).

Tensor parallelism (``dist.sharding``): the FSDP gather hands each block
its leaves whole, the ones it reads outside ``Linear.forward`` (the
SSD's projections, ``conv_w``, ``conv_b``, ``A_log``, ``D`` and
``dt_bias``) included, and the head's; the table is looked up
vocabulary-parallel (``nn/embeddings.lookup``).  Every product is then
the one process's, and only the feedback projections split.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import functional_call

from repro_torch.core import photonics
from repro_torch.core.photonics import forward_matmul
from repro_torch.models.base import (DFAModel, SavedSegment, SegmentSpec, ServingModel,
                                     cross_entropy_loss, gathered, new_tape, serving_params,
                                     subtree)
from repro_torch.nn.embeddings import Embedding, lookup
from repro_torch.nn.linear import Linear
from repro_torch.nn.module import Module
from repro_torch.nn.norms import RMSNorm
from repro_torch.nn.ssm import Mamba2Block
from repro_torch.utils.device import resolve_device

CACHE_NAMES = ("ssm", "conv")


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    name: str
    n_layers: int
    d_model: int
    vocab_size: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128
    norm_eps: float = 1e-5
    split_proj: bool = False
    pad_vocab_to: int | None = None
    dtype: torch.dtype = torch.float32

    @property
    def v_padded(self) -> int:
        return self.pad_vocab_to or self.vocab_size


class MambaLayer(Module):
    def __init__(self, cfg: MambaConfig, device=None):
        super().__init__()
        c = cfg
        self.norm = RMSNorm(c.d_model, c.norm_eps, c.dtype, device)
        self.mixer = Mamba2Block(c.d_model, d_state=c.d_state, head_dim=c.head_dim,
                                 expand=c.expand, conv_width=c.conv_width, chunk=c.chunk,
                                 split_proj=c.split_proj, dtype=c.dtype, device=device)

    def forward(self, x):
        return x + self.mixer(self.norm(x))

    def decode(self, x, cache, cache_len):
        y, cache = self.mixer.decode(self.norm(x), cache, cache_len)
        return x + y, cache


class MambaLM(DFAModel, ServingModel):
    """Parameter names follow the reference's tree (``embed.tok.table``,
    ``blocks.{i}.mixer.in_proj.weight``, ``head.out.weight``, ...);
    ``convert.py`` maps one onto the other."""

    def __init__(self, cfg: MambaConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        c = cfg
        self.cfg = cfg
        self.embed = torch.nn.ModuleDict(
            {"tok": Embedding(c.v_padded, c.d_model, c.dtype, device)})
        self.blocks = torch.nn.ModuleList(MambaLayer(c, device) for _ in range(c.n_layers))
        self.head = torch.nn.ModuleDict({
            "norm": RMSNorm(c.d_model, c.norm_eps, c.dtype, device),
            "out": Linear(c.d_model, c.v_padded, dtype=c.dtype, device=device),
        })

    @property
    def device(self) -> torch.device:
        return self._home or self.head["out"].weight.device

    def _tokens(self, token_ids):
        """The token embedding with the module's own table (the method
        ``embed`` is the DFA hook)."""
        return self._modules["embed"]["tok"](token_ids)

    def _mask_pad(self, logits):
        c = self.cfg
        if not c.pad_vocab_to:
            return logits
        pad_mask = torch.arange(c.v_padded, device=logits.device) >= c.vocab_size
        return torch.where(pad_mask, torch.tensor(-1e30, dtype=logits.dtype,
                                                  device=logits.device), logits)

    # ---- training (DFAModel) ----------------------------------------------
    @property
    def d_tap(self) -> int:
        return self.cfg.d_model

    def segment_specs(self):
        layer = self.blocks[0]  # the layers share one structure

        def apply(p, x, extras):
            del extras
            return functional_call(layer, p, (x,)), torch.zeros((), device=x.device)

        return (SegmentSpec("blocks", self.cfg.n_layers, self.cfg.d_model, apply,
                            stacked=True),)

    def embed(self, params, batch):
        return lookup(gathered(params, "embed.")["tok.table"], batch["tokens"],
                      self.cfg.v_padded)

    def run_segments(self, params, x0):
        """Every block's input (L, B, S, d) on the tape."""
        (spec,) = self.segment_specs()
        inputs = new_tape(spec.n_layers, x0)
        x = x0
        for i in photonics.scanned_layers(range(spec.n_layers)):
            inputs[i] = x
            x, _ = spec.apply(spec.gathered_params(params, i), x, None)
        saved = {"blocks": SavedSegment(inputs=inputs)}
        return x, saved, {"blocks": torch.zeros((), device=x0.device)}

    def head_logits(self, params, x_final, batch):
        """The digital unembedding ``h @ Wᵀ``, as the reference's."""
        del batch
        p = gathered(params, "head.")
        h = functional_call(self.head["norm"], subtree(p, "norm."), (x_final,))
        return self._mask_pad(h @ p["out.weight"].T)

    def loss_from_logits(self, logits, batch):
        return cross_entropy_loss(logits, batch["labels"], mask=batch.get("mask"))

    # ---- serving ----------------------------------------------------------
    def init_caches(self, batch: int, max_len: int = 0, dtype=None):
        """Stacked per-layer states (L leading axis)."""
        one = self.blocks[0].mixer.init_cache(batch, max_len, dtype)
        return {n: t[None].repeat(self.cfg.n_layers, *(1,) * t.ndim) for n, t in one.items()}

    def decode_step(self, token, caches, cache_len, params=None):
        """token: (B, 1) int -> (logits (B, 1, V), new caches).  The head
        runs through ``forward_matmul``, as the reference's decode head.
        ``params``: a flat dict (``DTensor``s under a sharded serving step)
        each block gathers a layer at a time (``serving_params``)."""
        with serving_params(self._modules["embed"]["tok"], params, "embed.tok."):
            x = self._tokens(token)
        new = {n: [] for n in CACHE_NAMES}
        for i, layer in enumerate(photonics.scanned_layers(self.blocks)):
            with serving_params(layer, params, f"blocks.{i}."):
                x, cache = layer.decode(x, {n: caches[n][i] for n in CACHE_NAMES}, cache_len)
            for n in CACHE_NAMES:
                new[n].append(cache[n])
        with serving_params(self.head, params, "head."):
            h = self.head["norm"](x)
            logits = self._mask_pad(forward_matmul(h, self.head["out"].weight))
        return logits, {n: torch.stack(t) for n, t in new.items()}

    def forward_gemm_specs(self):
        """(name, m, k) of the per-token forward projections: the fused
        input projection, the output projection, and the unembedding.  The
        convolutions and the diagonal SSD recurrence are not bank
        products."""
        c = self.cfg
        d_inner = c.expand * c.d_model
        n_heads = d_inner // c.head_dim
        conv_dim = d_inner + 2 * c.d_state  # n_groups == 1
        per_layer = [
            ("mixer.in_proj", d_inner + conv_dim + n_heads, c.d_model),
            ("mixer.out_proj", c.d_model, d_inner),
        ]
        specs = []
        for i in range(c.n_layers):
            specs += [(f"blocks[{i}].{n}", m, k) for (n, m, k) in per_layer]
        specs.append(("head.unembed", c.v_padded, c.d_model))
        return specs
