"""Attention: MHA / GQA self-attention with rotary and qkv bias.

Counterpart of ``repro/nn/attention.py``.  Slice 1 ports what serving
qwen1.5-0.5b runs: ``reference_attention`` (the full forward and chunked
prefill), ``decode_attention`` against a KV cache, and ``Attention`` with
its cache paths.  ``flash_attention`` (sequences above 2·k_chunk), sliding
windows and qk-norm raise ``NotImplementedError``; soft-capping, output
bias, non-causal and rope-less attention, MLA and cross attention are not
ported yet.

Cache updates are out of place, as in the reference: ``decode`` and
``prefill`` return new cache tensors and never write the ones they were
given.  Positions past the end of the cache are dropped, as the
reference's ``mode="drop"`` scatter drops them, without a host sync.
"""

from __future__ import annotations

import math

import torch

from repro_torch.nn.embeddings import apply_rotary, rotary_angles
from repro_torch.nn.linear import Linear
from repro_torch.nn.module import Module

NEG_INF = -1e30


def _gqa_expand(kv, n_heads: int):
    """(B, S, KVH, D) -> (B, S, H, D) by repeating each kv head."""
    kvh = kv.shape[2]
    if kvh == n_heads:
        return kv
    return kv.repeat_interleave(n_heads // kvh, dim=2)


def reference_attention(q, k, v, *, q_pos, kv_pos, causal=True, scale=None):
    """O(S²) attention in f32.  q:(B,Sq,H,D) k,v:(B,Skv,KVH,D);
    q_pos (B,Sq) and kv_pos (B,Skv) absolute positions."""
    b, sq, h, d = q.shape
    k = _gqa_expand(k, h)
    v = _gqa_expand(v, h)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones((b, sq, kv_pos.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos[:, None, :] <= q_pos[:, :, None]
    scores = torch.where(mask[:, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, cache_len, scale=None):
    """Single-step attention against a cache.  q: (B, 1, H, D); caches
    (B, Smax, KVH, D); cache_len (B,) valid lengths (the new token's K/V
    already written at cache_len-1).  Returns (B, 1, H, D)."""
    h, d = q.shape[2], q.shape[3]
    smax = k_cache.shape[1]
    k = _gqa_expand(k_cache, h)
    v = _gqa_expand(v_cache, h)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    valid = torch.arange(smax, device=q.device)[None, :] < cache_len[:, None]
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


class Attention(Module):
    """MHA / GQA causal self-attention with rotary and optional qkv bias —
    the qwen1.5 layer."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int | None = None, qkv_bias: bool = False,
                 qk_norm: bool = False, rope_theta: float = 10000.0,
                 window: int | None = None, dtype=torch.float32, device=None):
        super().__init__()
        if qk_norm or window is not None:
            raise NotImplementedError("Attention qk_norm and sliding windows are not ported yet")
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.hd = head_dim or d_model // n_heads
        self.rope_theta = rope_theta
        mk = lambda i, o, b: Linear(i, o, use_bias=b, dtype=dtype, device=device)
        self.q = mk(d_model, n_heads * self.hd, qkv_bias)
        self.k = mk(d_model, n_kv_heads * self.hd, qkv_bias)
        self.v = mk(d_model, n_kv_heads * self.hd, qkv_bias)
        self.o = mk(n_heads * self.hd, d_model, False)

    def qkv(self, x, positions):
        b, s, _ = x.shape
        q = self.q(x).reshape(b, s, self.n_heads, self.hd)
        k = self.k(x).reshape(b, s, self.n_kv_heads, self.hd)
        v = self.v(x).reshape(b, s, self.n_kv_heads, self.hd)
        cos, sin = rotary_angles(positions, self.hd, self.rope_theta)
        return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v

    def forward(self, x, *, positions=None, k_chunk: int = 1024):
        b, s, _ = x.shape
        if s > 2 * k_chunk:
            raise NotImplementedError("flash_attention (s > 2·k_chunk) is not ported yet")
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        q, k, v = self.qkv(x, positions)
        out = reference_attention(q, k, v, q_pos=positions, kv_pos=positions, causal=True)
        return self.o(out.reshape(b, s, self.n_heads * self.hd))

    # ---- decode path ------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=None):
        shape = (batch, max_len, self.n_kv_heads, self.hd)
        dt = dtype or self.q.weight.dtype
        dev = self.q.weight.device
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}

    def decode(self, x, cache, cache_len):
        """One token: x (B, 1, d).  Returns (y, new_cache)."""
        b = x.shape[0]
        q, k, v = self.qkv(x, cache_len[:, None])
        one = torch.ones_like(cache_len)
        k_cache = write_positions(cache["k"], k, cache_len, one)
        v_cache = write_positions(cache["v"], v, cache_len, one)
        out = decode_attention(q, k_cache, v_cache, cache_len=cache_len + 1)
        y = self.o(out.reshape(b, 1, self.n_heads * self.hd))
        return y, {"k": k_cache, "v": v_cache}

    def prefill(self, x, cache, cache_len, n_valid):
        """Chunked cache fill: x (B, C, d) is the next C prompt tokens of
        every slot (``n_valid`` of them real), written at positions
        ``cache_len + j`` and attended causally against the whole cache in
        one batched forward.  Slots with ``n_valid == 0`` keep their cache."""
        b, c, _ = x.shape
        positions = cache_len[:, None] + torch.arange(c, device=x.device)[None, :]
        q, k, v = self.qkv(x, positions)
        k_cache = write_positions(cache["k"], k, cache_len, n_valid)
        v_cache = write_positions(cache["v"], v, cache_len, n_valid)
        smax = k_cache.shape[1]
        kv_pos = torch.arange(smax, device=x.device)[None, :].expand(b, smax)
        out = reference_attention(q, k_cache, v_cache, q_pos=positions, kv_pos=kv_pos,
                                  causal=True)
        y = self.o(out.reshape(b, c, self.n_heads * self.hd))
        return y, {"k": k_cache, "v": v_cache}
