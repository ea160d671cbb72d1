"""Decoder-only transformer LM.  Counterpart of
``repro/models/transformer.py``.

The port has RMSNorm, rotary GQA attention (qkv bias, qk-norm) or
multi-head latent attention (``cfg.mla``), a gated SiLU FFN or a mixture
of experts (``cfg.moe``, ``nn/moe.py``), and the unembedding (qwen1.5,
qwen3, granite, minicpm3, qwen2-moe, kimi-k2, internvl2).  The model serves
(``init_caches``, ``decode_step``, ``prefill_step``) and trains: it is a
``DFAModel`` with the hidden error tap (d_tap = d_model), the blocks in
one segment ``blocks`` and DFA feedback into the embedding table.  The
reference scans stacked layer parameters; the port loops over a
``ModuleList`` (``photonics.scanned_layers`` keeps the reference's
per-layer noise-key numbering).  Caches keep the reference's stacked
layout, one (L, B, ...) tensor per key of the attention's ``init_cache``:
``{"k", "v"}`` (L, B, S, KVH, D), or MLA's ``{"c_kv", "k_rope"}``.  A
block returns its output and, under MoE, its weighted aux loss
lb_weight·lb_loss + z_weight·z_loss (None for a dense FFN), which
``run_segments`` sums over the layers and the DFA engine differentiates
with cotangent 1; serving does not compute it.  With ``cfg.vision``
(internvl2) the embedding holds the vision stub ``embed.vision``
(``nn/frontends.py``): a training batch that carries ``patch_embeds``
(B, P, d_vision) gets their projections as a prefix before its tokens,
positions run over prefix and text, and the loss reads only the text
region; serving is text-only, as the reference's.

Under tensor parallelism (``dist.sharding``, a ``model`` axis above 1 in
``launch/dryrun.build_train``'s step and in a sharded serving call) the
dense decoder block computes its products on its pieces: the FSDP gather
leaves the parts the block names (``DecoderBlock.column_parts``) split, and
the attention runs column-parallel on this rank's heads, the gated FFN on
its columns of gate·up, ``o`` and ``down`` on their rows with their
columns gathered (``nn/linear.py``), so the residual stream stays whole on
every rank (``act_btd``).  A block whose kv heads do not divide over the
axis keeps its attention on gathered weights (``column_fallbacks`` says
which parts ran whole, and why); a block with multi-head latent attention
keeps every product gathered, and a mixture of experts is expert parallel:
each rank runs its E/m experts on its slice of the dispatch buffer and the
outputs are gathered (``nn/moe.py``).  In serving the head is
vocabulary-split (``SERVING_HEAD``): each rank computes its V/m columns of
the logits and the logits are gathered; a training step runs it on its
gathered weight (``head_logits``).  Either way the logits are whole, so
the loss and the tapped error are the one process's.  The embedding is a
vocabulary-parallel lookup and the vision stub runs on its gathered
weights.  The DFA tape stays whole: each rank
holds every block's (B, S, d) input of its rows, not the ``tape_lbsd``
rule's feature slice, so the recompute needs no gather.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import functional_call

from repro_torch.core import photonics
from repro_torch.dist import sharding
from repro_torch.dist.sharding import COLUMN_SPLIT, gather_rows
from repro_torch.models.base import (DFAModel, SavedSegment, SegmentSpec, ServingModel,
                                     cross_entropy_loss, gathered, new_tape, serving_params,
                                     subtree)
from repro_torch.nn.attention import Attention, MLAttention
from repro_torch.nn.embeddings import Embedding, lookup
from repro_torch.nn.frontends import VisionFrontendStub
from repro_torch.nn.linear import GatedMLP, Linear
from repro_torch.nn.module import Module
from repro_torch.nn.moe import MoE
from repro_torch.nn.norms import RMSNorm
from repro_torch.utils.device import resolve_device


# a sharded serving call's vocabulary-split unembedding (a training step
# keeps it whole: ``TransformerLM.head_logits``)
SERVING_HEAD = {"head": COLUMN_SPLIT["head"]}


@dataclasses.dataclass(frozen=True)
class MoESettings:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int | None = None
    capacity_factor: float = 1.25
    lb_weight: float = 0.01
    z_weight: float = 1e-3
    dispatch: str = "einsum"  # einsum | gather (see nn/moe.py)


@dataclasses.dataclass(frozen=True)
class MLASettings:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class VisionSettings:
    d_vision: int = 1024
    n_patches: int = 256


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    window: int | None = None
    moe: MoESettings | None = None
    mla: MLASettings | None = None
    vision: VisionSettings | None = None
    dtype: torch.dtype = torch.float32
    # attention chunking: sequences above 2·k_chunk take flash_attention
    q_chunk: int = 2048
    k_chunk: int = 1024
    pad_vocab_to: int | None = None

    @property
    def v_padded(self) -> int:
        return self.pad_vocab_to or self.vocab_size


class DecoderBlock(Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.norm1 = RMSNorm(c.d_model, c.norm_eps, c.dtype, device)
        if c.mla is not None:
            m = c.mla
            self.attn = MLAttention(c.d_model, c.n_heads, q_lora_rank=m.q_lora_rank,
                                    kv_lora_rank=m.kv_lora_rank, qk_nope_dim=m.qk_nope_dim,
                                    qk_rope_dim=m.qk_rope_dim, v_head_dim=m.v_head_dim,
                                    rope_theta=c.rope_theta, dtype=c.dtype, device=device)
        else:
            self.attn = Attention(c.d_model, c.n_heads, c.n_kv_heads, head_dim=c.head_dim,
                                  qkv_bias=c.qkv_bias, qk_norm=c.qk_norm,
                                  rope_theta=c.rope_theta, window=c.window,
                                  dtype=c.dtype, device=device)
        self.norm2 = RMSNorm(c.d_model, c.norm_eps, c.dtype, device)
        if c.moe is not None:
            m = c.moe
            self.ffn = MoE(c.d_model, m.d_ff_expert, m.n_experts, m.top_k,
                           n_shared_experts=m.n_shared_experts, d_ff_shared=m.d_ff_shared,
                           capacity_factor=m.capacity_factor, dispatch=m.dispatch,
                           dtype=c.dtype, device=device)
        else:
            self.ffn = GatedMLP(c.d_model, c.d_ff, dtype=c.dtype, device=device)

    def column_parts(self) -> tuple[dict, dict]:
        """(the column-parallel parts of this block on the active mesh,
        name -> ``COLUMN_SPLIT`` patterns; the parts it keeps on gathered
        weights, name -> why): the attention where its kv heads divide over
        the model axis, and ``o``, and a dense FFN's; none under multi-head
        latent attention."""
        c = self.cfg
        if c.mla is not None:
            return {}, {}
        size = sharding.model_index(sharding.current_mesh())[1]
        names, kept = ["o"], {}
        if c.n_kv_heads % size == 0:
            names.append("attn")
        else:
            kept["attn"] = (f"{c.n_kv_heads} kv heads over {size} model ranks: a split in the "
                            "middle of a head")
        if c.moe is None:
            names += ["ffn", "down"]
        return {n: COLUMN_SPLIT[n] for n in names}, kept

    def forward(self, x, positions):
        """-> (y, the weighted aux loss, or None for a dense FFN)."""
        c = self.cfg
        x = x + self.attn(self.norm1(x), positions=positions, q_chunk=c.q_chunk,
                          k_chunk=c.k_chunk)
        if c.moe is None:
            return x + self.ffn(self.norm2(x)), None
        h, aux = self.ffn(self.norm2(x))
        return x + h, c.moe.lb_weight * aux["lb_loss"] + c.moe.z_weight * aux["z_loss"]

    def _serve_ffn(self, h):
        """The FFN's output alone: serving computes no aux terms.  A mixture
        of experts on a batch split over the data axes (a serving row
        window) routes the whole batch, as the reference's global routing
        does: the rows are all-gathered, the layer runs on them outside the
        window, and this rank keeps its rows."""
        if self.cfg.moe is None:
            return self.ffn(h)
        window = photonics.active_window()
        if window is None:
            return self.ffn(h, with_aux=False)[0]
        whole = gather_rows(h, window.group, window.total // window.count)
        with photonics.whole_rows():
            y = self.ffn(whole, with_aux=False)[0]
        return y[window.start: window.start + window.count]

    def decode(self, x, cache, cache_len):
        h, cache = self.attn.decode(self.norm1(x), cache, cache_len)
        x = x + h
        return x + self._serve_ffn(self.norm2(x)), cache

    def prefill(self, x, cache, cache_len, n_valid):
        """Chunked cache fill: x (B, C, d).  Padded chunk positions still
        run the FFN; under MoE they compete for expert capacity, as in the
        reference."""
        h, cache = self.attn.prefill(self.norm1(x), cache, cache_len, n_valid)
        x = x + h
        return x + self._serve_ffn(self.norm2(x)), cache


class TransformerLM(DFAModel, ServingModel):
    """Parameter names follow the reference's tree (``embed.tok.table``,
    ``blocks.{i}.attn.q.weight``, ``head.out.weight``, ...); ``convert.py``
    maps one onto the other.  The training methods take that flat dict
    (``DFAModel``); the serving ones run the module's own parameters."""

    @property
    def supports_parallel_prefill(self) -> bool:
        """Global attention's caches are absolute-indexed and prefill in one
        batched forward; windowed ring buffers take the decode-scan."""
        return self.cfg.window is None

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        c = cfg
        self.cfg = cfg
        embed = {"tok": Embedding(c.v_padded, c.d_model, c.dtype, device)}
        if c.vision is not None:
            embed["vision"] = VisionFrontendStub(c.vision.d_vision, c.d_model, c.dtype, device)
        self.embed = torch.nn.ModuleDict(embed)
        self.blocks = torch.nn.ModuleList(
            DecoderBlock(c, device) for _ in range(c.n_layers))
        self.head = torch.nn.ModuleDict({
            "norm": RMSNorm(c.d_model, c.norm_eps, c.dtype, device),
            "out": Linear(c.d_model, c.v_padded, dtype=c.dtype, device=device, region="head"),
        })

    @property
    def device(self) -> torch.device:
        return self._home or self.head["out"].weight.device

    def forward(self, tokens):
        """Full causal forward: tokens (B, S) -> logits (B, S, V)."""
        b, s = tokens.shape
        x = self._tokens(tokens)
        positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        for block in photonics.scanned_layers(self.blocks):
            x, _ = block(x, positions)
        return self._head(self.head["norm"](x))

    def _tokens(self, token_ids):
        """The token embedding with the module's own table (the method
        ``embed`` is the DFA hook, so the ``embed`` ModuleDict is reached
        by name)."""
        return self._modules["embed"]["tok"](token_ids)

    # ---- training (DFAModel) ----------------------------------------------
    @property
    def d_tap(self) -> int:
        return self.cfg.d_model  # the hidden tap

    def segment_specs(self):
        block = self.blocks[0]  # the layers share one structure

        def apply(p, x, extras):
            return functional_call(block, p, (x, extras))

        return (SegmentSpec("blocks", self.cfg.n_layers, self.cfg.d_model, apply,
                            stacked=True, split=lambda: block.column_parts()[0]),)

    def embed(self, params, batch):
        prefix = self.cfg.vision is not None and "patch_embeds" in batch
        p = gathered(params, "embed.")
        tok = lookup(p["tok.table"], batch["tokens"], self.cfg.v_padded)
        if not prefix:
            return tok
        # the vision prefix is optional: text-only batches are valid
        pre = functional_call(self._modules["embed"]["vision"], subtree(p, "vision."),
                              (batch["patch_embeds"],))
        return torch.cat([pre.to(tok.dtype), tok], dim=1)

    def run_segments(self, params, x0):
        """Every block's input (L, B, S, d) on the tape, with the positions
        as the shared extras; the blocks' aux losses summed (zero with
        none)."""
        b, s, _ = x0.shape
        positions = torch.arange(s, device=x0.device)[None, :].expand(b, s)
        (spec,) = self.segment_specs()
        inputs = new_tape(spec.n_layers, x0)
        x, aux_total = x0, torch.zeros((), device=x0.device)
        for i in range(spec.n_layers):
            inputs[i] = x
            x, aux = spec.apply(spec.gathered_params(params, i), x, positions)
            if aux is not None:
                aux_total = aux_total + aux
        saved = {"blocks": SavedSegment(inputs=inputs, extras=positions)}
        return x, saved, {"blocks": aux_total}

    def column_fallbacks(self, params) -> dict:
        """The column-parallel parts that run on gathered weights on the
        active mesh, name -> why: those the blocks keep
        (``DecoderBlock.column_parts``) and those whose leaves in the placed
        ``params`` the divisibility fallback left whole
        (``sharding.left_whole``; the head's as a serving call reads it)."""
        parts, kept = self.blocks[0].column_parts()
        return {**kept, **sharding.left_whole(subtree(params, "blocks.0."), parts),
                **sharding.left_whole(subtree(params, "head."), SERVING_HEAD)}

    def head_logits(self, params, x_final, batch):
        """The head on the forward's output: vocabulary-split in a sharded
        serving call (``sharding.in_serving_call``: ``serve.decode.
        make_prefill``), on its gathered weight in training (split, it moved
        a noisy full-width DFA step past the 1e-5 gate against one process
        on the card: ``tools/tp_split_ablation.py``)."""
        del batch
        p = gathered(params, "head.", SERVING_HEAD if sharding.in_serving_call() else None)
        h = functional_call(self.head["norm"], subtree(p, "norm."), (x_final,))
        return self._head(h, p["out.weight"])

    def loss_from_logits(self, logits, batch):
        if self.cfg.vision is not None:
            # the loss reads only the text region, after the patch prefix
            logits = logits[:, -batch["labels"].shape[1]:]
        return cross_entropy_loss(logits, batch["labels"], mask=batch.get("mask"))

    # ---- serving ----------------------------------------------------------
    def init_caches(self, batch: int, max_len: int, dtype=None):
        """Stacked per-layer caches (L leading axis)."""
        one = self.blocks[0].attn.init_cache(batch, max_len, dtype)
        return {n: t[None].repeat(self.cfg.n_layers, *(1,) * t.ndim)
                for n, t in one.items()}

    def _serve_tokens(self, token_ids, params):
        with serving_params(self._modules["embed"]["tok"], params, "embed.tok."):
            return self._tokens(token_ids)

    def _run_layers(self, x, caches, step, params=None):
        """Each block on its cache, its parameters gathered from ``params``
        a layer at a time where given (``serving_params``), then the
        head."""
        new = {n: [] for n in caches}
        parts = self.blocks[0].column_parts()[0] if params is not None else None
        for i, block in enumerate(photonics.scanned_layers(self.blocks)):
            with serving_params(block, params, f"blocks.{i}.", parts=parts):
                x, cache = step(block, x, {n: t[i] for n, t in caches.items()})
            for n in new:
                new[n].append(cache[n])
        with serving_params(self.head, params, "head.", parts=SERVING_HEAD):
            logits = self._head(self.head["norm"](x))
        return logits, {n: torch.stack(t) for n, t in new.items()}

    def decode_step(self, token, caches, cache_len, params=None):
        """token: (B, 1) int.  Returns (logits (B, 1, V), new caches)."""
        x = self._serve_tokens(token, params)
        return self._run_layers(
            x, caches, lambda blk, x, cache: blk.decode(x, cache, cache_len), params)

    def prefill_step(self, tokens, caches, cache_len, n_valid, params=None):
        """tokens (B, C) -> (logits (B, C, V), new caches).  ``cache_len``
        is not advanced here: the engine owns slot bookkeeping."""
        x = self._serve_tokens(tokens, params)
        return self._run_layers(
            x, caches, lambda blk, x, cache: blk.prefill(x, cache, cache_len, n_valid), params)

    def _head(self, h, weight=None):
        """Unembedding (by ``weight``, default the module's own), masking
        padded vocab ids so greedy serving never emits one.  A weight that
        holds this rank's rows of the vocabulary gives its columns of the
        logits, gathered whole: vocabulary-major, so that the gather joins
        the pieces along its first dim without a copy, and the logits come
        back as a (..., V) view of the (V, ...) whole."""
        c = self.cfg
        out = self.head["out"]
        w = out.weight if weight is None else weight
        if out.splits(w):
            part = out.columns(sharding.copy_to_model(h), w).movedim(-1, 0).contiguous()
            logits = sharding.gather_from_model(part, 0).movedim(0, -1)
        else:
            logits = out.product(h, w)
        if c.pad_vocab_to:
            pad_mask = torch.arange(c.v_padded, device=logits.device) >= c.vocab_size
            logits = torch.where(pad_mask, torch.tensor(-1e30, dtype=logits.dtype,
                                                        device=logits.device), logits)
        return logits

    def forward_gemm_specs(self):
        """(name, m, k) of every weight-stationary forward projection of one
        token, as the reference lists them.  Under MoE that is the router
        (which runs digitally) and one FFN of the top-k experts' and the
        shared experts' widths merged: not the bank launches, which are
        one batched launch over every expert per product."""
        c = self.cfg
        hd = c.head_dim or c.d_model // c.n_heads
        if c.mla is not None:
            m = c.mla
            per_layer = [
                ("attn.q_down", m.q_lora_rank, c.d_model),
                ("attn.q_up", c.n_heads * (m.qk_nope_dim + m.qk_rope_dim), m.q_lora_rank),
                ("attn.kv_down", m.kv_lora_rank + m.qk_rope_dim, c.d_model),
                ("attn.o", c.d_model, c.n_heads * m.v_head_dim),
            ]
        else:
            per_layer = [
                ("attn.q", c.n_heads * hd, c.d_model),
                ("attn.k", c.n_kv_heads * hd, c.d_model),
                ("attn.v", c.n_kv_heads * hd, c.d_model),
                ("attn.o", c.d_model, c.n_heads * hd),
            ]
        if c.moe is not None:
            mo = c.moe
            ff = mo.top_k * mo.d_ff_expert
            if mo.n_shared_experts:
                ff += mo.n_shared_experts * (mo.d_ff_shared or mo.d_ff_expert)
            per_layer.append(("ffn.router", mo.n_experts, c.d_model))
        else:
            ff = c.d_ff
        per_layer += [
            ("ffn.gate", ff, c.d_model),
            ("ffn.up", ff, c.d_model),
            ("ffn.down", c.d_model, ff),
        ]
        specs = []
        for i in range(c.n_layers):
            specs += [(f"blocks[{i}].{n}", m, k) for (n, m, k) in per_layer]
        specs.append(("head.unembed", c.v_padded, c.d_model))
        return specs
