"""Attention: MHA / GQA self-attention (rotary, qkv bias, qk-norm) and
multi-head latent attention.

Counterpart of ``repro/nn/attention.py``: ``reference_attention`` (the
O(S²) forward and chunked prefill), ``flash_attention`` (the chunked
online softmax the forward takes above 2·k_chunk), ``decode_attention``
against a KV cache, ``Attention`` (qwen1.5, qwen3, granite) and
``MLAttention`` (minicpm3: a latent cache, absorbed decode and prefill),
each with its cache paths.  ``window`` (a sliding window: position q sees
keys q - window < k <= q) and ``logit_softcap`` (scores through
cap·tanh(s / cap)) are parameters of the three attention functions and
fields of ``Attention`` (recurrentgemma's local layers); a windowed layer
whose cache holds ``window`` slots decodes into it as a ring buffer.
``Attention``'s ``out_bias``, ``rope`` and ``causal`` fields give whisper's
rope-less layers with an output bias, non-causal in its encoder, and
``CrossAttention`` its decoder's attention to the encoder output, whose
products are digital (raw ``@``), as the reference's.

Under tensor parallelism (``dist.sharding``: q, k, v and o split on their
output dims over ``model``) the dense decoder block's ``Attention`` is
column-parallel where its kv heads divide over the axis (the ``attn`` and
``o`` parts): q, k and v are this rank's heads (their rows of the
weights), attention runs on them, the heads are gathered before ``o``, and
``o``'s columns are gathered (``nn/linear.py``); ``MLAttention`` splits
its latent projections and ``o``, and in training its heads.  Elsewhere an
attention runs on the whole weights the FSDP gather hands it and attends
every head on every rank.  A serving step whose cache is split over ``model``
(``serve.decode.cache_shardings``) attends on this rank's piece of it
(below); a column-parallel attention's heads are its kv-heads piece.

Cache updates are out of place, as in the reference: ``decode`` and
``prefill`` return new cache tensors and never write the ones they were
given.  Positions past the end of the cache are dropped, as the
reference's ``mode="drop"`` scatter drops them, without a host sync.
"""

from __future__ import annotations

import math

import torch

from repro_torch.dist import sharding
from repro_torch.nn.embeddings import apply_rotary, rotary_angles
from repro_torch.nn.linear import Linear
from repro_torch.nn.module import Module, empty_param, init_children
from repro_torch.nn.norms import rms_normalize

NEG_INF = -1e30


def _gqa_expand(kv, n_heads: int):
    """(B, S, KVH, D) -> (B, S, H, D) by repeating each kv head."""
    kvh = kv.shape[2]
    if kvh == n_heads:
        return kv
    return kv.repeat_interleave(n_heads // kvh, dim=2)


def _softcap(scores, cap):
    return cap * torch.tanh(scores / cap) if cap else scores


def _mask(b, q_pos, kv_pos, causal, window):
    """(B, Sq, Skv): which keys each query sees."""
    mask = torch.ones((b, q_pos.shape[1], kv_pos.shape[1]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= kv_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        mask &= q_pos[:, :, None] - kv_pos[:, None, :] < window
    return mask


def reference_attention(q, k, v, *, q_pos, kv_pos, causal=True, window=None, scale=None,
                        logit_softcap=None):
    """O(S²) attention in f32.  q:(B,Sq,H,D) k,v:(B,Skv,KVH,D);
    q_pos (B,Sq) and kv_pos (B,Skv) absolute positions."""
    b, sq, h, d = q.shape
    k = _gqa_expand(k, h)
    v = _gqa_expand(v, h)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = _softcap(scores, logit_softcap)
    mask = _mask(b, q_pos, kv_pos, causal, window)
    scores = torch.where(mask[:, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(q.dtype)


def _attend_chunk(q, k, v, q_pos, k_pos, scale, causal, window, logit_softcap, acc, m_prev,
                  l_prev):
    """Online-softmax update for one (q-chunk, k-chunk) tile.  All f32."""
    scores = _softcap(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, logit_softcap)
    mask = _mask(q.shape[0], q_pos, k_pos, causal, window)
    scores = torch.where(mask[:, None, :, :], scores, NEG_INF)
    m_new = torch.maximum(m_prev, scores.amax(dim=-1))  # (B, H, Sq)
    # guard fully-masked rows (m_new == NEG_INF) against NaN
    safe_m = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    p = torch.exp(scores - safe_m[..., None])
    p = torch.where(mask[:, None, :, :], p, 0.0)
    alpha = torch.where(m_prev <= NEG_INF / 2, 0.0, torch.exp(m_prev - safe_m))
    l_new = alpha * l_prev + p.sum(dim=-1)
    acc = acc * alpha.transpose(1, 2)[..., None]
    acc = acc + torch.einsum("bhqk,bkhd->bqhd", p, v)
    return acc, m_new, l_new


def flash_attention(q, k, v, *, q_pos, kv_pos, causal=True, window=None, scale=None,
                    logit_softcap=None, q_chunk: int = 2048, k_chunk: int = 1024):
    """Chunked online-softmax attention; shapes as ``reference_attention``.

    Q runs in static chunks; Q chunk j scans the K chunks [lo, hi) it can
    reach (a window raises lo past the chunks that lie wholly before it),
    so causal work is the exact triangle (the band, windowed) and a score
    tile is
    (q_chunk, k_chunk), never (S, S).  K chunks are folded in one at a time
    in the reference's order.  Ragged sizes take one tile."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    k = _gqa_expand(k, h)
    v = _gqa_expand(v, h)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q_chunk = min(q_chunk, sq)
    k_chunk = min(k_chunk, skv)
    qf, kf, vf = q.float(), k.float(), v.float()

    def attend(qj, qpj, k_steps):
        acc = qf.new_zeros((b, qj.shape[1], h, d))
        m = qf.new_full((b, h, qj.shape[1]), NEG_INF)
        l = qf.new_zeros((b, h, qj.shape[1]))
        for k0, k1 in k_steps:
            acc, m, l = _attend_chunk(qj, kf[:, k0:k1], vf[:, k0:k1], qpj, kv_pos[:, k0:k1],
                                      scale, causal, window, logit_softcap, acc, m, l)
        return acc / torch.clamp(l.transpose(1, 2)[..., None], min=1e-30)

    if sq % q_chunk or skv % k_chunk:
        # a single-tile pass (ragged sizes only appear in tests)
        return attend(qf, q_pos, [(0, skv)]).to(q.dtype)
    n_k = skv // k_chunk
    out = []
    # q_pos / kv_pos are monotone per row; with the layouts used here
    # (training and prefill: both arange) these K ranges are exact
    for j in range(sq // q_chunk):
        if causal and sq == skv and q_chunk % k_chunk == 0:
            hi = (j + 1) * (q_chunk // k_chunk)
        else:
            hi = n_k
        if window is not None and causal and sq == skv:
            lo = max(0, (j * q_chunk - window) // k_chunk)
        else:
            lo = 0
        rows = slice(j * q_chunk, (j + 1) * q_chunk)
        out.append(attend(qf[:, rows], q_pos[:, rows],
                          [(i * k_chunk, (i + 1) * k_chunk) for i in range(lo, hi)]))
    return torch.cat(out, dim=1).to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, cache_len, window=None, q_pos=None, scale=None,
                     logit_softcap=None):
    """Single-step attention against a cache.  q: (B, 1, H, D); caches
    (B, Smax, KVH, D); cache_len (B,) valid lengths (the new token's K/V
    already written at cache_len-1).  With ``window``, cache slot k is seen
    only where q_pos - k < window (q_pos defaults to cache_len - 1).
    Returns (B, 1, H, D)."""
    h, d = q.shape[2], q.shape[3]
    smax = k_cache.shape[1]
    k = _gqa_expand(k_cache, h)
    v = _gqa_expand(v_cache, h)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = _softcap(scores, logit_softcap)
    kv_pos = torch.arange(smax, device=q.device)[None, :]
    valid = kv_pos < cache_len[:, None]
    if window is not None:
        qp = cache_len - 1 if q_pos is None else q_pos
        valid &= qp[:, None] - kv_pos < window
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(q.dtype)


def write_positions(cache, new, start, n_valid):
    """A copy of ``cache`` (B, Smax, ...) with ``new[:, j]`` (B, C, ...)
    written at position ``start + j`` for every j < ``n_valid``.  Positions
    at or past Smax are dropped; nothing else changes."""
    b, smax = cache.shape[:2]
    c = new.shape[1]
    j = torch.arange(smax, device=cache.device)[None, :] - start[:, None]  # (B, Smax)
    hit = (j >= 0) & (j < n_valid[:, None])
    tail = (1,) * (cache.ndim - 2)
    idx = j.clamp(0, c - 1).reshape(b, smax, *tail).expand(b, smax, *cache.shape[2:])
    src = torch.gather(new.to(cache.dtype), 1, idx)
    return torch.where(hit.reshape(b, smax, *tail), src, cache)


# ---------------------------------------------------------------------------
# caches split over the model axis (``serve.decode.cache_shardings``)
# ---------------------------------------------------------------------------
# A serving step on a ``model`` axis above 1 holds this rank's piece of each
# layer's cache (``dist.sharding.cache_split``): its kv heads, its slice of
# head_dim, or its slots of the sequence.  The new token's q, k and v are
# this rank's heads where the projections are column-parallel (the kv-heads
# piece), whole on every rank otherwise; each rank writes its piece of k
# and v into its piece of the cache and attends there.
# Heads: the rank's kv heads and their q heads, the outputs all-gathered
# along heads (the one process's sums).  head_dim: the partial q·k sums
# SUM all-reduced, the softmax whole, the rank's slice of the value
# product gathered.  Sequence: each rank's max, sum and weighted value over
# its slots, combined by MAX and SUM all-reduces (the log-sum-exp combine
# the reference's GSPMD lowers); a token reaches the rank holding its slot.

HEADS, HEAD_DIM, SEQ = 2, 3, 1  # the per-layer dim of a (B, S, KVH, D) cache


def _lse_combine(scores, mask, value):
    """Attention over slots split across ``model``: scores (B, H, Sq, Sl)
    f32 and mask (B, Sq, Sl) of this rank's slots, value(p) the weighted
    value p·V (B, Sq, H, Dv) -> the whole softmax-weighted value."""
    scores = torch.where(mask[:, None], scores, NEG_INF)
    m = sharding.max_over_model(scores.amax(dim=-1))  # (B, H, Sq)
    p = torch.where(mask[:, None], torch.exp(scores - m[..., None]), 0.0)
    total = sharding.reduce_from_model(p.sum(dim=-1))
    out = sharding.reduce_from_model(value(p))
    return out / total.transpose(1, 2)[..., None]


def _split_attention(q, k_cache, v_cache, mask, split, scale, logit_softcap):
    """q (B, Sq, H, D) whole against this rank's piece of the caches (B,
    Sl, KVH', D') split at ``split`` = (dim, index, size) on head_dim or
    the sequence; mask (B, Sq, Sl) over its slots -> (B, Sq, H, D) f32."""
    dim, index, size = split
    h = q.shape[2]
    k = _gqa_expand(k_cache, h).float()
    v = _gqa_expand(v_cache, h).float()
    if dim == HEAD_DIM:
        n = k.shape[-1]
        q_part = q[..., index * n:(index + 1) * n].float()
        scores = sharding.reduce_from_model(torch.einsum("bqhd,bkhd->bhqk", q_part, k))
        scores = _softcap(scores * scale, logit_softcap)
        w = torch.softmax(torch.where(mask[:, None], scores, NEG_INF), dim=-1)
        return sharding.gather_from_model(torch.einsum("bhqk,bkhd->bqhd", w, v), -1)
    if dim != SEQ:
        raise ValueError(f"no split attention along cache dim {dim}")
    scores = _softcap(torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * scale, logit_softcap)
    return _lse_combine(scores, mask, lambda p: torch.einsum("bhqk,bkhd->bqhd", p, v))


def _split_together(layers, names: str, part: str) -> bool:
    """Whether ``layers`` are column-parallel (this rank's heads): all or
    none of them."""
    split = {layer.split for layer in layers}
    if len(split) > 1:
        raise ValueError(f"{names} split over the model axis apart: they split together "
                         f"(the {part} part) or not at all")
    return split.pop()


def _gathered_heads(out, split):
    """A heads-split attention's output (B, Sq, H', D) all-gathered along
    heads (itself otherwise)."""
    return out if split is None else sharding.gather_from_model(out, 2)


def _piece(x, dim, split):
    """This rank's piece of a whole ``x`` along the cache split's ``dim``
    (``x`` where the split is along another dim)."""
    if split is None or split[0] != dim:
        return x
    _, index, size = split
    n = x.shape[dim] // size
    return x.narrow(dim, index * n, n)


def _self_attention(q, k, v, positions, scale, q_chunk, k_chunk, window=None,
                    logit_softcap=None, causal=True):
    """Self-attention of a whole sequence (causal by default): O(S²) up to
    2·k_chunk, ``flash_attention`` above, as the reference switches."""
    kw = dict(q_pos=positions, kv_pos=positions, causal=causal, window=window, scale=scale,
              logit_softcap=logit_softcap)
    if q.shape[1] <= 2 * k_chunk:
        return reference_attention(q, k, v, **kw)
    return flash_attention(q, k, v, q_chunk=q_chunk, k_chunk=k_chunk, **kw)


class Attention(Module):
    """MHA / GQA self-attention with rotary, optional qkv bias, output
    bias, qk-norm, sliding window and logit soft-capping — the qwen1.5
    (bias), qwen3 (qk-norm), granite, internvl2, recurrentgemma local
    (window) and whisper (``rope=False``, ``out_bias``; ``causal=False`` in
    the encoder) layer.  The reference's qk-norm is ``rms_normalize`` with
    no learned scale."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int | None = None, qkv_bias: bool = False,
                 qk_norm: bool = False, rope_theta: float = 10000.0,
                 window: int | None = None, logit_softcap: float | None = None,
                 out_bias: bool = False, rope: bool = True, causal: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.window, self.logit_softcap = window, logit_softcap
        self.rope, self.causal = rope, causal
        self.qk_norm = qk_norm
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.hd = head_dim or d_model // n_heads
        self.rope_theta = rope_theta
        mk = lambda i, o, b, n: Linear(i, o, use_bias=b, dtype=dtype, device=device,
                                       region=f"attn.{n}")
        self.q = mk(d_model, n_heads * self.hd, qkv_bias, "q")
        self.k = mk(d_model, n_kv_heads * self.hd, qkv_bias, "k")
        self.v = mk(d_model, n_kv_heads * self.hd, qkv_bias, "v")
        self.o = mk(n_heads * self.hd, d_model, out_bias, "o")

    @property
    def split(self) -> bool:
        """Whether q, k and v are column-parallel: this rank's heads."""
        return _split_together((self.q, self.k, self.v), "q, k and v", "attn")

    def column_parts(self, size: int, serving: bool) -> tuple[list, dict]:
        """(the ``COLUMN_SPLIT`` parts this attention computes
        column-parallel on a model axis of ``size``, the parts it keeps
        whole -> why): ``o``, and q, k and v (``attn``) where the kv heads
        divide over the axis."""
        del serving
        if self.n_kv_heads % size == 0:
            return ["o", "attn"], {}
        return ["o"], {"attn": f"{self.n_kv_heads} kv heads over {size} model ranks: a split "
                               "in the middle of a head"}

    def qkv(self, x, positions):
        """q (B, S, H, D), k and v (B, S, KVH, D): this rank's H/m and KVH/m
        heads where the attention is column-parallel."""
        b, s, _ = x.shape
        if self.split:
            x = sharding.copy_to_model(x)
            q, k, v = self.q.columns(x), self.k.columns(x), self.v.columns(x)
        else:
            q, k, v = self.q(x), self.k(x), self.v(x)
        q = q.reshape(b, s, -1, self.hd)
        k = k.reshape(b, s, -1, self.hd)
        v = v.reshape(b, s, -1, self.hd)
        if self.qk_norm:
            q = rms_normalize(q)
            k = rms_normalize(k)
        if not self.rope:
            return q, k, v
        cos, sin = rotary_angles(positions, self.hd, self.rope_theta)
        return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v

    def forward(self, x, *, positions=None, q_chunk: int = 2048, k_chunk: int = 1024):
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        q, k, v = self.qkv(x, positions)
        out = _self_attention(q, k, v, positions, None, q_chunk, k_chunk, self.window,
                              self.logit_softcap, self.causal).reshape(b, s, -1)
        if self.split:
            out = sharding.gather_from_model(out, -1)
        return self.o(out)

    # ---- decode path ------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=None):
        """(B, S, KVH, D) ``{"k", "v"}``; a windowed layer holds
        min(max_len, window) slots."""
        slots = max_len if self.window is None else min(max_len, self.window)
        shape = (batch, slots, self.n_kv_heads, self.hd)
        dt = dtype or self.q.weight.dtype
        dev = self.q.weight.device
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}

    def decode(self, x, cache, cache_len):
        """One token: x (B, 1, d).  Returns (y, new_cache).

        A windowed cache of ``window`` slots is a ring buffer: the token at
        position p goes to slot p mod window, every stored slot lies within
        the window by construction, and the first min(p + 1, window) slots
        are valid."""
        b = x.shape[0]
        q, k, v = self.qkv(x, cache_len[:, None])
        split = sharding.cache_split("k")
        q, k, v = self._heads_piece(q, k, v, split)
        seq = split is not None and split[0] == SEQ
        slots = cache["k"].shape[1]
        smax = slots * split[2] if seq else slots  # the whole cache's slots
        base = split[1] * slots if seq else 0  # this rank's first slot
        ring = self.window is not None and smax == self.window
        slot = cache_len % smax if ring else cache_len
        one = torch.ones_like(cache_len)
        k_cache = write_positions(cache["k"], _piece(k, HEAD_DIM, split), slot - base, one)
        v_cache = write_positions(cache["v"], _piece(v, HEAD_DIM, split), slot - base, one)
        n_seen = torch.clamp(cache_len + 1, max=smax) if ring else cache_len + 1
        window = None if ring else self.window
        if split is None or split[0] == HEADS:
            out = decode_attention(q, k_cache, v_cache, cache_len=n_seen, window=window,
                                   logit_softcap=self.logit_softcap)
            out = _gathered_heads(out, split)
        else:
            kv_pos = base + torch.arange(slots, device=x.device)[None, :]
            valid = kv_pos < n_seen[:, None]
            if window is not None:
                valid &= (n_seen - 1)[:, None] - kv_pos < window
            out = _split_attention(q, k_cache, v_cache, valid[:, None, :], split,
                                   1.0 / math.sqrt(self.hd), self.logit_softcap).to(q.dtype)
        y = self.o(out.reshape(b, 1, self.n_heads * self.hd))
        return y, {"k": k_cache, "v": v_cache}

    def _heads_piece(self, q, k, v, split):
        """Under the heads rule this rank's kv heads of k and v and their q
        heads (column-parallel q, k and v are already); the whole q, k, v
        otherwise."""
        if self.split:
            if split is None or split[0] != HEADS:
                raise ValueError("a column-parallel attention serves from a cache split by "
                                 f"kv heads, not {split}")
            return q, k, v
        if split is None or split[0] != HEADS:
            return q, k, v
        _, index, size = split
        rep = self.n_heads // self.n_kv_heads
        n = self.n_kv_heads // size
        return (q[:, :, index * n * rep:(index + 1) * n * rep], k[:, :, index * n:(index + 1) * n],
                v[:, :, index * n:(index + 1) * n])

    def prefill(self, x, cache, cache_len, n_valid):
        """Chunked cache fill: x (B, C, d) is the next C prompt tokens of
        every slot (``n_valid`` of them real), written at positions
        ``cache_len + j`` and attended causally against the whole cache in
        one batched forward.  Slots with ``n_valid == 0`` keep their cache.
        Only for absolute-indexed caches: a windowed layer's ring buffer
        fills by the engine's masked decode-scan
        (``serve.decode.make_prefill_step``), as in the reference."""
        if self.window is not None:
            raise ValueError("windowed caches prefill via the decode-scan")
        b, c, _ = x.shape
        positions = cache_len[:, None] + torch.arange(c, device=x.device)[None, :]
        q, k, v = self.qkv(x, positions)
        split = sharding.cache_split("k")
        q, k, v = self._heads_piece(q, k, v, split)
        slots = cache["k"].shape[1]
        base = split[1] * slots if split is not None and split[0] == SEQ else 0
        k_cache = write_positions(cache["k"], _piece(k, HEAD_DIM, split), cache_len - base,
                                  n_valid)
        v_cache = write_positions(cache["v"], _piece(v, HEAD_DIM, split), cache_len - base,
                                  n_valid)
        kv_pos = base + torch.arange(slots, device=x.device)[None, :].expand(b, slots)
        if split is None or split[0] == HEADS:
            out = reference_attention(q, k_cache, v_cache, q_pos=positions, kv_pos=kv_pos,
                                      causal=True, logit_softcap=self.logit_softcap)
            out = _gathered_heads(out, split)
        else:
            causal = kv_pos[:, None, :] <= positions[:, :, None]
            out = _split_attention(q, k_cache, v_cache, causal, split, 1.0 / math.sqrt(self.hd),
                                   self.logit_softcap).to(q.dtype)
        y = self.o(out.reshape(b, c, self.n_heads * self.hd))
        return y, {"k": k_cache, "v": v_cache}


class CrossAttention(Module):
    """Encoder-decoder cross attention (whisper): queries from the decoder
    stream, keys and values from every encoder frame, non-causal.  q, v and
    o carry a bias, k none.  Every product is a digital ``@``, as in the
    reference: none reaches the bank."""

    def __init__(self, d_model: int, n_heads: int, use_bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.n_heads = n_heads
        self.hd = d_model // n_heads
        mk = lambda b: Linear(d_model, d_model, use_bias=b, dtype=dtype, device=device)
        self.q, self.k, self.v, self.o = mk(use_bias), mk(False), mk(use_bias), mk(use_bias)

    @staticmethod
    def _digital(x, lin):
        y = x @ lin.weight.T
        return y if lin.bias is None else y + lin.bias

    def forward(self, x, enc, q_chunk: int = 2048):
        """x (B, S, d), enc (B, Se, d) -> (B, S, d).  Queries run in chunks
        of ``q_chunk`` where S is a multiple above it, as the reference's
        ``lax.map``, so a score tensor stays (q_chunk, Se)."""
        b, s, d = x.shape
        se = enc.shape[1]
        h, hd = self.n_heads, self.hd
        q = self._digital(x, self.q).reshape(b, s, h, hd)
        k = self._digital(enc, self.k).reshape(b, se, h, hd)
        v = self._digital(enc, self.v).reshape(b, se, h, hd)
        kp = torch.arange(se, device=x.device)[None, :].expand(b, se)

        def attend(qc):
            qp = torch.arange(qc.shape[1], device=x.device)[None, :].expand(b, qc.shape[1])
            return reference_attention(qc, k, v, q_pos=qp, kv_pos=kp, causal=False)

        if s > q_chunk and s % q_chunk == 0:
            out = torch.cat([attend(q[:, i:i + q_chunk]) for i in range(0, s, q_chunk)], dim=1)
        else:
            out = attend(q)
        return self._digital(out.reshape(b, s, d), self.o)


class MLAttention(Module):
    """Multi-head latent attention (MiniCPM3 / DeepSeek-V2 style).

    q: x → q_down → rms_normalize · ``q_norm_scale`` → q_up, per head
    [nope | rope]; kv: x → kv_down = (c_kv ‖ the shared rotary key), c_kv
    normalised · ``kv_norm_scale``, then k_up / v_up per head.  The cache
    holds only ``{"c_kv", "k_rope"}``.  Decode and prefill take the
    absorbed form: q_nope folded through k_up, the output read back through
    v_up, both digital einsums on the weights (as in the reference), so a
    token's bank products are q_down, q_up, kv_down and o.

    Under tensor parallelism (``column_parts``) q_down and kv_down
    (``latent``) and ``o`` are column-parallel, their columns gathered
    (``nn/linear.py``), so the latents are whole on every rank; in training
    q_up, k_up and v_up (``heads``) give this rank's heads of q, k_nope and
    v from the whole latents, the shared rotary key expands to those heads,
    attention runs on them and the heads are gathered before ``o``."""

    def __init__(self, d_model: int, n_heads: int, q_lora_rank: int = 768,
                 kv_lora_rank: int = 256, qk_nope_dim: int = 64, qk_rope_dim: int = 32,
                 v_head_dim: int = 64, rope_theta: float = 10000.0, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.n_heads = n_heads
        self.kv_lora_rank = kv_lora_rank
        self.qk_nope_dim = qk_nope_dim
        self.qk_rope_dim = qk_rope_dim
        self.v_head_dim = v_head_dim
        self.rope_theta = rope_theta
        mk = lambda i, o, n: Linear(i, o, dtype=dtype, device=device, region=f"attn.{n}")
        h = n_heads
        self.q_down = mk(d_model, q_lora_rank, "q_down")
        self.q_norm_scale = empty_param((q_lora_rank,), dtype, device)
        self.q_up = mk(q_lora_rank, h * self.qk_dim, "q_up")
        self.kv_down = mk(d_model, kv_lora_rank + qk_rope_dim, "kv_down")
        self.kv_norm_scale = empty_param((kv_lora_rank,), dtype, device)
        self.k_up = mk(kv_lora_rank, h * qk_nope_dim, "k_up")
        self.v_up = mk(kv_lora_rank, h * v_head_dim, "v_up")
        self.o = mk(h * v_head_dim, d_model, "o")

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def split(self) -> bool:
        """Whether q_up, k_up and v_up are column-parallel: this rank's
        heads."""
        return _split_together((self.q_up, self.k_up, self.v_up), "q_up, k_up and v_up",
                               "heads")

    def column_parts(self, size: int, serving: bool) -> tuple[list, dict]:
        """(the ``COLUMN_SPLIT`` parts this attention computes
        column-parallel on a model axis of ``size``, the parts it keeps
        whole -> why): ``latent`` and ``o``, and in training ``heads``
        where the heads divide over the axis.  A serving call keeps the
        heads whole: its absorbed form reads k_up and v_up whole."""
        parts = ["latent", "o"]
        if serving:
            return parts, {"heads": "the absorbed decode and prefill read k_up and v_up whole "
                                    "(the latent cache has no head axis)"}
        if self.n_heads % size:
            return parts, {"heads": f"{self.n_heads} heads over {size} model ranks: a split in "
                                    "the middle of a head"}
        return parts + ["heads"], {}

    def init(self, seed: int):
        init_children(self, seed)
        with torch.no_grad():
            self.q_norm_scale.fill_(1.0)
            self.kv_norm_scale.fill_(1.0)
        return self

    def _latents(self, x, positions):
        """-> (q (B, S, H, qk_dim), c_kv (B, S, r), k_rope (B, S, rope)); q
        on this rank's heads where they are column-parallel (q_up on the
        whole normalised latent, which enters the split through
        ``copy_to_model``)."""
        b, s, _ = x.shape
        r = self.kv_lora_rank
        ql = rms_normalize(self.q_down(x)) * self.q_norm_scale
        q = self.q_up.columns(sharding.copy_to_model(ql)) if self.split else self.q_up(ql)
        q = q.reshape(b, s, -1, self.qk_dim)
        kv = self.kv_down(x)
        c_kv = rms_normalize(kv[..., :r]) * self.kv_norm_scale
        cos, sin = rotary_angles(positions, self.qk_rope_dim, self.rope_theta)
        q_nope, q_rope = q[..., :self.qk_nope_dim], q[..., self.qk_nope_dim:]
        k_rope = apply_rotary(kv[..., r:][:, :, None, :], cos, sin)[:, :, 0, :]
        q = torch.cat([q_nope, apply_rotary(q_rope, cos, sin)], dim=-1)
        return q, c_kv, k_rope

    def forward(self, x, *, positions=None, q_chunk: int = 2048, k_chunk: int = 1024):
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        q, c_kv, k_rope = self._latents(x, positions)
        h = q.shape[2]  # this rank's heads
        if self.split:  # the whole latents enter the split together
            both = sharding.copy_to_model(torch.cat([c_kv, k_rope], dim=-1))
            c_kv, k_rope = both.split([self.kv_lora_rank, self.qk_rope_dim], dim=-1)
            k_nope, v = self.k_up.columns(c_kv), self.v_up.columns(c_kv)
        else:
            k_nope, v = self.k_up(c_kv), self.v_up(c_kv)
        k_nope = k_nope.reshape(b, s, h, self.qk_nope_dim)
        v = v.reshape(b, s, h, self.v_head_dim)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, self.qk_rope_dim)], dim=-1)
        # v_head_dim != qk_dim: pad V for the shared attention, slice after
        v = torch.nn.functional.pad(v, (0, self.qk_dim - self.v_head_dim))
        out = _self_attention(q, k, v, positions, 1.0 / math.sqrt(self.qk_dim), q_chunk,
                              k_chunk)
        out = out[..., :self.v_head_dim].reshape(b, s, h * self.v_head_dim)
        if self.split:
            out = sharding.gather_from_model(out, -1)
        return self.o(out)

    # ---- decode path (absorbed form) ---------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=None):
        dt = dtype or self.q_down.weight.dtype
        dev = self.q_down.weight.device
        return {"c_kv": torch.zeros((batch, max_len, self.kv_lora_rank), dtype=dt, device=dev),
                "k_rope": torch.zeros((batch, max_len, self.qk_rope_dim), dtype=dt, device=dev)}

    def _absorbed(self, q, c_cache, r_cache, mask, dtype, split=None):
        """Attention of q (B, C, H, qk_dim) against the latent caches, with
        ``mask`` (B, C, S) -> (B, C, H, v_head_dim) in ``dtype``.  The
        reference reshapes its (r, H·n) weights to (r, H, n); the port's are
        (H·n, r), so they are transposed first.  With the caches' sequence
        split over ``model`` (``split``) each rank attends its slots and
        the latent outputs take the log-sum-exp combine."""
        if self.split:
            raise ValueError("the absorbed form reads k_up and v_up whole: a serving call "
                             "keeps the heads gathered (column_parts)")
        h, r = self.n_heads, self.kv_lora_rank
        q_nope, q_rope = q[..., :self.qk_nope_dim].float(), q[..., self.qk_nope_dim:].float()
        w_uk = self.k_up.weight.T.reshape(r, h, self.qk_nope_dim).float()
        q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)
        c = c_cache.float()
        scores = torch.einsum("bqhr,bkr->bhqk", q_abs, c)
        scores = scores + torch.einsum("bqhp,bkp->bhqk", q_rope, r_cache.float())
        scores = scores * (1.0 / math.sqrt(self.qk_dim))
        if split is not None:
            out_lat = _lse_combine(scores, mask, lambda p: torch.einsum("bhqk,bkr->bqhr", p, c))
        else:
            scores = torch.where(mask[:, None], scores, NEG_INF)
            w = torch.softmax(scores, dim=-1)
            out_lat = torch.einsum("bhqk,bkr->bqhr", w, c)
        w_uv = self.v_up.weight.T.reshape(r, h, self.v_head_dim).float()
        return torch.einsum("bqhr,rhv->bqhv", out_lat, w_uv).to(dtype)

    def _split(self, slots: int):
        """(the latent caches' sequence split over ``model``, this rank's
        first slot) for a cache piece of ``slots`` slots: (None, 0) where
        they are whole."""
        split = sharding.cache_split("c_kv")
        if split is None:
            return None, 0
        if split[0] != SEQ:
            raise ValueError(f"a latent cache split along dim {split[0]}: only the sequence")
        return split, split[1] * slots

    def decode(self, x, cache, cache_len):
        """One token: x (B, 1, d).  Returns (y, new_cache)."""
        b = x.shape[0]
        q, c_new, r_new = self._latents(x, cache_len[:, None])
        split, base = self._split(cache["c_kv"].shape[1])
        one = torch.ones_like(cache_len)
        c_cache = write_positions(cache["c_kv"], c_new, cache_len - base, one)
        r_cache = write_positions(cache["k_rope"], r_new, cache_len - base, one)
        kv_pos = base + torch.arange(c_cache.shape[1], device=x.device)[None, :]
        valid = kv_pos < (cache_len + 1)[:, None]
        out = self._absorbed(q, c_cache, r_cache, valid[:, None, :], x.dtype, split)
        y = self.o(out.reshape(b, 1, self.n_heads * self.v_head_dim))
        return y, {"c_kv": c_cache, "k_rope": r_cache}

    def prefill(self, x, cache, cache_len, n_valid):
        """Chunked absorbed prefill: the decode math with a query axis (see
        ``Attention.prefill`` for the write and validity rules)."""
        b, c, _ = x.shape
        positions = cache_len[:, None] + torch.arange(c, device=x.device)[None, :]
        q, c_new, r_new = self._latents(x, positions)
        split, base = self._split(cache["c_kv"].shape[1])
        c_cache = write_positions(cache["c_kv"], c_new, cache_len - base, n_valid)
        r_cache = write_positions(cache["k_rope"], r_new, cache_len - base, n_valid)
        kv_pos = base + torch.arange(c_cache.shape[1], device=x.device)
        causal = kv_pos[None, None, :] <= positions[:, :, None]
        out = self._absorbed(q, c_cache, r_cache, causal, x.dtype, split)
        y = self.o(out.reshape(b, c, self.n_heads * self.v_head_dim))
        return y, {"c_kv": c_cache, "k_rope": r_cache}
