"""RecurrentGemma (Griffin): hybrid RG-LRU + local attention, 1:2 pattern.
Counterpart of ``repro/models/recurrentgemma.py``.

38 layers = 12 × (Rec, Rec, LocalAttn) + (Rec, Rec) tail.  Each layer is a
Griffin residual layer: (norm → temporal mix → residual) then (norm →
gated GELU MLP → residual).  DFA segments: the three group sub-positions
``grp_rec1``, ``grp_rec2`` and ``grp_attn`` (each a stack of n_groups
layers) and the tail ``tail_rec``; every layer gets its own feedback
matrix and local vjp, and the RG-LRU recurrence stays inside the block.

The reference scans one body over (rec, rec, attn), so every group draws
the same noise keys through its three layers in order, and scans the tail
with a body of its own.  The port iterates the groups, then the tail,
through ``photonics.scanned_layers`` to keep that numbering.  As in the
reference, the training head (``head_logits``) is the digital ``h @ Wᵀ``
and the decode head runs through ``forward_matmul``.

Serving caches are a flat dict of stacked (n, B, ...) tensors, named
``{segment}.{leaf}``: ``grp_rec1.h`` (f32 state), ``grp_rec1.conv``,
``grp_attn.k``, ``grp_attn.v`` (ring buffers of ``window`` slots), ...;
``convert.caches_to_reference`` nests them as the reference's tree.  The
model has no parallel prefill: the engine fills its state by the masked
decode-scan (``serve.decode.make_prefill_step``), as the reference's
windowed caches require.

Tensor parallelism (``dist.sharding``): the FSDP gather hands each block
its leaves whole, the ones it reads outside ``Linear.forward`` (the
RG-LRU's projections, conv and gate leaves) included, and the head's; the
table is looked up vocabulary-parallel (``nn/embeddings.lookup``).
Every product is then the one process's, and only the feedback
projections split.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import functional_call

from repro_torch.core import photonics
from repro_torch.core.photonics import forward_matmul
from repro_torch.dist import sharding
from repro_torch.models.base import (DFAModel, SavedSegment, SegmentSpec, ServingModel,
                                     cross_entropy_loss, gathered, new_tape, serving_params,
                                     subtree)
from repro_torch.nn.attention import Attention
from repro_torch.nn.embeddings import Embedding, lookup
from repro_torch.nn.linear import GatedMLP, Linear
from repro_torch.nn.module import Module
from repro_torch.nn.norms import RMSNorm
from repro_torch.nn.rglru import RGLRUBlock
from repro_torch.utils.device import resolve_device

GROUP = ("grp_rec1", "grp_rec2", "grp_attn")  # one scanned body, in order
TAIL = "tail_rec"
CACHE_NAMES = {"rec": ("h", "conv"), "attn": ("k", "v")}


@dataclasses.dataclass(frozen=True)
class RecurrentGemmaConfig:
    name: str
    n_layers: int  # total (pattern RRA, remainder = trailing R's)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_rnn: int | None = None  # defaults to d_model
    window: int = 2048
    conv_width: int = 4
    norm_eps: float = 1e-6
    rope_theta: float = 1e4
    dtype: torch.dtype = torch.float32
    q_chunk: int = 2048
    k_chunk: int = 1024

    @property
    def n_groups(self) -> int:
        return self.n_layers // 3

    @property
    def n_tail(self) -> int:
        return self.n_layers - 3 * self.n_groups

    @property
    def v_padded(self) -> int:
        """The head's width (no padded vocabulary)."""
        return self.vocab_size


class _Layer(Module):
    def __init__(self, cfg: RecurrentGemmaConfig, kind: str, device=None):
        super().__init__()
        c = cfg
        self.cfg, self.kind = cfg, kind
        self.norm1 = RMSNorm(c.d_model, c.norm_eps, c.dtype, device)
        if kind == "rec":
            self.mixer = RGLRUBlock(c.d_model, c.d_rnn or c.d_model, c.conv_width, c.dtype,
                                    device)
        else:
            self.mixer = Attention(c.d_model, c.n_heads, c.n_kv_heads, window=c.window,
                                   rope_theta=c.rope_theta, dtype=c.dtype, device=device)
        self.norm2 = RMSNorm(c.d_model, c.norm_eps, c.dtype, device)
        self.mlp = GatedMLP(c.d_model, c.d_ff, "gelu", dtype=c.dtype, device=device)

    def forward(self, x, positions):
        """-> (y, None): the layer has no aux loss."""
        c = self.cfg
        h = self.norm1(x)
        if self.kind == "rec":
            h = self.mixer(h)
        else:
            h = self.mixer(h, positions=positions, q_chunk=c.q_chunk, k_chunk=c.k_chunk)
        x = x + h
        return x + self.mlp(self.norm2(x)), None

    def init_cache(self, batch: int, max_len: int, dtype=None):
        return self.mixer.init_cache(batch, 0 if self.kind == "rec" else max_len, dtype)

    def decode(self, x, cache, cache_len):
        h, cache = self.mixer.decode(self.norm1(x), cache, cache_len)
        x = x + h
        return x + self.mlp(self.norm2(x)), cache


class RecurrentGemmaLM(DFAModel, ServingModel):
    """Parameter names follow the reference's tree (``embed.tok.table``,
    ``grp_rec1.{i}.mixer.in_x.weight``, ``grp_attn.{i}.mixer.q.weight``,
    ``tail_rec.{i}.mlp.down.weight``, ``head.out.weight``, ...);
    ``convert.py`` maps one onto the other."""

    def __init__(self, cfg: RecurrentGemmaConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        c = cfg
        self.cfg = cfg
        self.embed = torch.nn.ModuleDict(
            {"tok": Embedding(c.vocab_size, c.d_model, c.dtype, device)})
        for name in GROUP:
            kind = "attn" if name == "grp_attn" else "rec"
            setattr(self, name, torch.nn.ModuleList(
                _Layer(c, kind, device) for _ in range(c.n_groups)))
        if c.n_tail:
            self.tail_rec = torch.nn.ModuleList(_Layer(c, "rec", device) for _ in range(c.n_tail))
        self.head = torch.nn.ModuleDict({
            "norm": RMSNorm(c.d_model, c.norm_eps, c.dtype, device),
            "out": Linear(c.d_model, c.vocab_size, dtype=c.dtype, device=device),
        })

    @property
    def device(self) -> torch.device:
        return self._home or self.head["out"].weight.device

    @property
    def segments(self) -> tuple[str, ...]:
        """The stacked segments, in the order a token passes them."""
        return GROUP + ((TAIL,) if self.cfg.n_tail else ())

    def _tokens(self, token_ids):
        """The token embedding with the module's own table (the method
        ``embed`` is the DFA hook)."""
        return self._modules["embed"]["tok"](token_ids)

    # ---- training (DFAModel) ----------------------------------------------
    @property
    def d_tap(self) -> int:
        return self.cfg.d_model

    def segment_specs(self):
        c = self.cfg

        def spec(name):
            layer = self._modules[name][0]  # the stack shares one structure

            def apply(p, x, extras):
                return functional_call(layer, p, (x, extras))

            return SegmentSpec(name, c.n_tail if name == TAIL else c.n_groups, c.d_model, apply,
                               stacked=True)

        return tuple(spec(n) for n in self.segments)

    def embed(self, params, batch):
        return lookup(gathered(params, "embed.")["tok.table"], batch["tokens"],
                      self.cfg.vocab_size)

    def run_segments(self, params, x0):
        """Every layer's input (n, B, S, d) on its segment's tape, with the
        positions as the shared extras; no aux losses."""
        b, s, _ = x0.shape
        positions = torch.arange(s, device=x0.device)[None, :].expand(b, s)
        specs = {sp.name: sp for sp in self.segment_specs()}
        inputs = {n: new_tape(sp.n_layers, x0) for n, sp in specs.items()}
        x = x0

        def run(names, count):
            nonlocal x
            for i in photonics.scanned_layers(range(count)):
                for n in names:
                    inputs[n][i] = x
                    x, _ = specs[n].apply(specs[n].gathered_params(params, i), x, positions)

        run(GROUP, self.cfg.n_groups)
        if self.cfg.n_tail:
            run((TAIL,), self.cfg.n_tail)
        saved = {n: SavedSegment(inputs=inputs[n], extras=positions) for n in specs}
        return x, saved, {}

    def head_logits(self, params, x_final, batch):
        """The digital unembedding ``h @ Wᵀ``, as the reference's."""
        del batch
        p = gathered(params, "head.")
        h = functional_call(self.head["norm"], subtree(p, "norm."), (x_final,))
        return h @ p["out.weight"].T

    def loss_from_logits(self, logits, batch):
        return cross_entropy_loss(logits, batch["labels"], mask=batch.get("mask"))

    # ---- serving ----------------------------------------------------------
    def init_caches(self, batch: int, max_len: int, dtype=None):
        """``{segment}.{leaf}`` -> the segment's layers' caches stacked on a
        leading axis."""
        caches = {}
        for name in self.segments:
            stack = self._modules[name]
            one = stack[0].init_cache(batch, max_len, dtype)
            for leaf, t in one.items():
                caches[f"{name}.{leaf}"] = t[None].repeat(len(stack), *(1,) * t.ndim)
        return caches

    def decode_step(self, token, caches, cache_len, params=None):
        """token: (B, 1) int -> (logits (B, 1, V), new caches).  The head
        runs through ``forward_matmul``, as the reference's decode head.
        ``params``: a flat dict (``DTensor``s under a sharded serving step)
        each layer gathers as it runs (``serving_params``)."""
        with serving_params(self._modules["embed"]["tok"], params, "embed.tok."):
            x = self._tokens(token)
        new = {n: [] for n in caches}

        def run(names, count):
            nonlocal x
            for i in photonics.scanned_layers(range(count)):
                for n in names:
                    layer = self._modules[n][i]
                    leaves = CACHE_NAMES[layer.kind]
                    with serving_params(layer, params, f"{n}.{i}."), \
                            sharding.split_caches(self._split_of(n)):
                        x, cache = layer.decode(
                            x, {leaf: caches[f"{n}.{leaf}"][i] for leaf in leaves}, cache_len)
                    for leaf in leaves:
                        new[f"{n}.{leaf}"].append(cache[leaf])

        run(GROUP, self.cfg.n_groups)
        if self.cfg.n_tail:
            run((TAIL,), self.cfg.n_tail)
        with serving_params(self.head, params, "head."):
            logits = forward_matmul(self.head["norm"](x), self.head["out"].weight)
        return logits, {n: torch.stack(t) for n, t in new.items()}

    def _split_of(self, segment: str) -> dict:
        """The active cache split of ``segment``'s leaves, named as its
        layers read them (the model's keys are ``{segment}.{leaf}``)."""
        split = sharding.active_cache_split()
        return {leaf.split(".", 1)[1]: d for leaf, d in split.items()
                if leaf.startswith(segment + ".")}

    def forward_gemm_specs(self):
        """(name, m, k) per-token forward projections: a recurrent layer's
        five RG-LRU projections, an attention layer's q / k / v / o, each
        layer's gated MLP, and the unembedding.  The convolutions and the
        diagonal recurrence are not bank products."""
        c = self.cfg
        d, dr = c.d_model, c.d_rnn or c.d_model
        hd = d // c.n_heads
        mlp = [("mlp.gate", c.d_ff, d), ("mlp.up", c.d_ff, d), ("mlp.down", d, c.d_ff)]
        rec = [("mixer.in_x", dr, d), ("mixer.in_gate", dr, d),
               ("mixer.w_a", dr, dr), ("mixer.w_i", dr, dr),
               ("mixer.out", d, dr)] + mlp
        attn = [("attn.q", c.n_heads * hd, d), ("attn.k", c.n_kv_heads * hd, d),
                ("attn.v", c.n_kv_heads * hd, d), ("attn.o", d, c.n_heads * hd)] + mlp
        kinds = [rec, rec, attn] * c.n_groups + [rec] * c.n_tail
        specs = [(f"layers[{i}].{n}", m, k) for i, kind in enumerate(kinds)
                 for (n, m, k) in kind]
        specs.append(("head.unembed", c.vocab_size, d))
        return specs
