"""Whisper-small backbone (encoder-decoder audio): 12 + 12 layers,
LayerNorm, GELU MLPs, learned positions, no rope.  Counterpart of
``repro/models/whisper.py``.  The conv / mel frontend is a stub: batches
carry precomputed frame embeddings (B, n_frames, d_model).

DFA for the encoder-decoder, as the reference extends it: decoder blocks
take feedback from the decoder's error tap directly; encoder blocks take a
fixed random projection of the *pooled* decoder error (the mean over target
positions, broadcast over frames) through their segment's ``adapt_error`` /
``expand_delta``.  Cross-attention parameters train through the decoder
blocks' local vjp.  ``embed`` returns ``{"enc", "dec"}`` and
``embed_feedback`` a cotangent of the same keys.

Two things are kept as the reference has them: the decoder's training
forward attends to the encoder's raw output (``ln_enc`` is applied only in
``encode``, for serving), so ``head.ln_enc`` gets an exactly zero gradient
in training; and ``decode_step`` recomputes every layer's cross-attention
keys and values from the encoder output at each step (no cross cache).
Bank products: the self-attention's q / k / v / o and the MLP's fc1 / fc2,
6 a layer; the cross-attention and the head (``h @ Wᵀ``) are digital, as
the reference's raw ``@``.  The engine does not serve the model: serving
is ``encode`` then ``serve.decode.make_serve_step(model, whisper_enc=True)``.
The reference scans each segment's layers; the port iterates them through
``photonics.scanned_layers`` to keep its noise-key numbering.

Tensor parallelism (``dist.sharding``): the FSDP gather hands each block,
the frontend stub, the learned positions and the head their leaves whole,
the cross-attention's read outside ``Linear.forward`` included; the token
table is looked up vocabulary-parallel (``nn/embeddings.lookup``).  Every
product, the encoder's pooled error included, is then the one process's,
and only the feedback projections split.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import functional_call

from repro_torch.core import photonics
from repro_torch.models.base import (DFAModel, SavedSegment, SegmentSpec, cross_entropy_loss,
                                     gathered, new_tape, serving_params, subtree)
from repro_torch.nn import initializers
from repro_torch.nn.attention import Attention, CrossAttention
from repro_torch.nn.embeddings import Embedding, lookup
from repro_torch.nn.frontends import AudioFrontendStub
from repro_torch.nn.linear import MLP, Linear
from repro_torch.nn.module import Module, empty_param, init_children
from repro_torch.nn.norms import LayerNorm
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

SEGMENTS = ("enc", "dec")


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    n_frames: int = 1500
    max_target: int = 448
    norm_eps: float = 1e-5
    pad_vocab_to: int | None = None
    dtype: torch.dtype = torch.float32

    @property
    def v_padded(self) -> int:
        return self.pad_vocab_to or self.vocab_size


def _ln(c: WhisperConfig, device):
    return LayerNorm(c.d_model, c.norm_eps, dtype=c.dtype, device=device)


class _EncLayer(Module):
    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        c = cfg
        self.ln1 = _ln(c, device)
        self.attn = Attention(c.d_model, c.n_heads, c.n_heads, qkv_bias=True, out_bias=True,
                              rope=False, causal=False, dtype=c.dtype, device=device)
        self.ln2 = _ln(c, device)
        self.mlp = MLP(c.d_model, c.d_ff, "gelu", dtype=c.dtype, device=device)

    def forward(self, x):
        """-> (y, None): the layer has no aux loss."""
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x)), None


class _DecLayer(Module):
    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        c = cfg
        self.ln1 = _ln(c, device)
        # the reference's name: parameters ``dec.{i}.self.q.weight``, ...
        self.self = Attention(c.d_model, c.n_heads, c.n_heads, qkv_bias=True, out_bias=True,
                              rope=False, causal=True, dtype=c.dtype, device=device)
        self.ln2 = _ln(c, device)
        self.cross = CrossAttention(c.d_model, c.n_heads, dtype=c.dtype, device=device)
        self.ln3 = _ln(c, device)
        self.mlp = MLP(c.d_model, c.d_ff, "gelu", dtype=c.dtype, device=device)

    def forward(self, x, enc):
        """-> (y, None)."""
        x = x + self.self(self.ln1(x))
        x = x + self.cross(self.ln2(x), enc)
        return x + self.mlp(self.ln3(x)), None

    def decode(self, x, enc, cache, cache_len):
        """One token: x (B, 1, d) against the encoder output ``enc``."""
        h, cache = self.self.decode(self.ln1(x), cache, cache_len)
        x = x + h
        x = x + self.cross(self.ln2(x), enc)
        return x + self.mlp(self.ln3(x)), cache


class _Embed(Module):
    """``audio`` (the frame stub), ``tok`` and the decoder's learned
    positions ``pos`` (max_target, d)."""

    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        c = cfg
        self.audio = AudioFrontendStub(c.d_model, c.n_frames, c.dtype, device)
        self.tok = Embedding(c.v_padded, c.d_model, c.dtype, device)
        self.pos = empty_param((c.max_target, c.d_model), c.dtype, device)

    def init(self, seed: int):
        init_children(self, seed)
        with torch.no_grad():
            self.pos.copy_(initializers.normal(0.01)(
                prng.generator(prng.fold(seed, "pos"), self.pos.device), self.pos.shape,
                self.pos.dtype, self.pos.device))
        return self


class WhisperModel(DFAModel):
    """Parameter names follow the reference's tree (``embed.audio.pos``,
    ``embed.pos``, ``enc.{i}.attn.q.weight``, ``dec.{i}.cross.k.weight``,
    ``head.ln_enc.scale``, ``head.out.weight``, ...); ``convert.py`` maps
    one onto the other.  The training methods take that flat dict
    (``DFAModel``); ``encode`` and ``decode_step`` run the module's own
    parameters."""

    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        c = cfg
        self.cfg = cfg
        self.embed = _Embed(c, device)
        self.enc = torch.nn.ModuleList(_EncLayer(c, device) for _ in range(c.n_enc_layers))
        self.dec = torch.nn.ModuleList(_DecLayer(c, device) for _ in range(c.n_dec_layers))
        self.head = torch.nn.ModuleDict({
            "ln_enc": _ln(c, device),
            "ln": _ln(c, device),
            "out": Linear(c.d_model, c.v_padded, dtype=c.dtype, device=device),
        })

    @property
    def device(self) -> torch.device:
        return self._home or self.head["out"].weight.device

    def _embed(self) -> _Embed:
        """The embedding module (the method ``embed`` is the DFA hook)."""
        return self._modules["embed"]

    # ---- training (DFAModel) ----------------------------------------------
    @property
    def d_tap(self) -> int:
        return self.cfg.d_model

    def segment_specs(self):
        c = self.cfg
        enc, dec = self.enc[0], self.dec[0]  # each stack shares one structure

        def enc_apply(p, x, extras):
            del extras
            return functional_call(enc, p, (x,))

        def dec_apply(p, x, extras):
            return functional_call(dec, p, (x, extras))

        return (
            SegmentSpec("enc", c.n_enc_layers, c.d_model, enc_apply, stacked=True,
                        adapt_error=lambda e: e.mean(dim=1, keepdim=True),
                        expand_delta=lambda d, shape: d.expand(shape)),
            SegmentSpec("dec", c.n_dec_layers, c.d_model, dec_apply, stacked=True),
        )

    def embed(self, params, batch):
        c = self.cfg
        p = gathered(params, "embed.")
        enc0 = functional_call(self._embed().audio, subtree(p, "audio."),
                               (batch["frames"].to(c.dtype),))
        tok = lookup(p["tok.table"], batch["tokens"], c.v_padded)
        s, pos = tok.shape[1], p["pos"]
        if s > c.max_target:  # shapes past whisper's real context: tile, as the reference
            pos = pos.repeat(-(-s // c.max_target), 1)
        return {"enc": enc0, "dec": tok + pos[:s]}

    def embed_feedback(self, e_tap, fb_embed, x0, project_fn):
        """The decoder's embedding takes the projected error; the encoder's
        its mean over target positions, broadcast over frames."""
        e_dec = project_fn(e_tap, fb_embed)
        e_pool = e_dec.mean(dim=1, keepdim=True)
        return {"enc": e_pool.expand(x0["enc"].shape).to(x0["enc"].dtype),
                "dec": e_dec.to(x0["dec"].dtype).reshape(x0["dec"].shape)}

    def run_segments(self, params, x0):
        """The encoder's layer inputs, then the decoder's, on their tapes;
        the decoder's extras are the encoder's raw output (no ``ln_enc``),
        as the reference's."""
        enc, dec = self.segment_specs()

        def run(spec, x, extras):
            inputs = new_tape(spec.n_layers, x)
            for i in photonics.scanned_layers(range(spec.n_layers)):
                inputs[i] = x
                x, _ = spec.apply(spec.gathered_params(params, i), x, extras)
            return x, inputs

        enc_final, enc_inputs = run(enc, x0["enc"], None)
        dec_final, dec_inputs = run(dec, x0["dec"], enc_final)
        saved = {"enc": SavedSegment(inputs=enc_inputs),
                 "dec": SavedSegment(inputs=dec_inputs, extras=enc_final)}
        return dec_final, saved, {}

    def _logits(self, h, weight):
        """The digital unembedding ``h @ Wᵀ``, masking padded vocab ids."""
        c = self.cfg
        logits = h @ weight.T
        if c.pad_vocab_to:
            pad_mask = torch.arange(c.v_padded, device=logits.device) >= c.vocab_size
            logits = torch.where(pad_mask, torch.tensor(-1e30, dtype=logits.dtype,
                                                        device=logits.device), logits)
        return logits

    def head_logits(self, params, x_final, batch):
        del batch
        p = gathered(params, "head.")
        h = functional_call(self.head["ln"], subtree(p, "ln."), (x_final,))
        return self._logits(h, p["out.weight"])

    def loss_from_logits(self, logits, batch):
        return cross_entropy_loss(logits, batch["labels"], mask=batch.get("mask"))

    # ---- serving ----------------------------------------------------------
    def encode(self, frames):
        """frames (B, T, d) -> the encoder output through ``ln_enc``."""
        x = self._embed().audio(frames.to(self.cfg.dtype))
        for layer in photonics.scanned_layers(self.enc):
            x, _ = layer(x)
        return self.head["ln_enc"](x)

    def init_caches(self, batch: int, max_len: int, dtype=None):
        """The decoder's self-attention caches ``{"k", "v"}``, stacked
        (L, B, S, H, D)."""
        one = self.dec[0].self.init_cache(batch, max_len, dtype)
        return {n: t[None].repeat(self.cfg.n_dec_layers, *(1,) * t.ndim)
                for n, t in one.items()}

    def decode_step(self, token, enc_out, caches, cache_len, params=None):
        """token (B, 1) int against ``enc_out`` (``encode``'s) -> (logits
        (B, 1, V), new caches).  The position is clamped to max_target - 1;
        the head is digital and, as the reference's decode head, unmasked.
        ``params``: a flat dict (``DTensor``s under a sharded serving step)
        each decoder layer gathers as it runs (``serving_params``)."""
        c = self.cfg
        emb = self._embed()
        with serving_params(emb, params, "embed.", skip="audio."):
            pos = emb.pos[torch.clamp(cache_len, max=c.max_target - 1)]
            x = emb.tok(token) + pos[:, None, :]
        new = {n: [] for n in caches}
        for i, layer in enumerate(photonics.scanned_layers(self.dec)):
            with serving_params(layer, params, f"dec.{i}."):
                x, cache = layer.decode(x, enc_out, {n: t[i] for n, t in caches.items()},
                                        cache_len)
            for n in new:
                new[n].append(cache[n])
        with serving_params(self.head, params, "head.", skip="ln_enc."):
            logits = self.head["ln"](x) @ self.head["out"].weight.T
        return logits, {n: torch.stack(t) for n, t in new.items()}
