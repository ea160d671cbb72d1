"""Serve-step builders.  Counterpart of ``repro/serve/decode.py``.

The reference's builders take ``params`` and are jitted; the port's
models hold their parameters and run eagerly.  Cache sharding and the
recurrent (masked decode-scan) prefill fallback are not ported yet.
"""

from __future__ import annotations

import torch


def make_serve_step(model, *, sample: str = "greedy"):
    """Returns step(token, caches, cache_len) -> (next_token, logits, new_caches)."""
    if sample != "greedy":
        raise ValueError(sample)

    def step(token, caches, cache_len):
        logits, new_caches = model.decode_step(token, caches, cache_len)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        return nxt, logits, new_caches

    return step


def select_slots(active, new, old):
    """Per-slot cache select over stacked (L, B, ...) caches: slot i takes
    ``new`` where ``active[i]``, else keeps ``old`` — the mask that stops
    finished or empty slots from changing state in a batched step."""

    def sel(n, o):
        m = active.reshape((1, -1) + (1,) * (n.ndim - 2))
        return torch.where(m, n, o)

    return {name: sel(new[name], old[name]) for name in new}


def make_prefill_step(model):
    """Chunked-prefill builder: step(tokens (B, C), n_valid (B,), caches,
    cache_len) -> (last_logits (B, V), new_caches, new_cache_len).

    Fills each slot's KV cache with its next <= C prompt tokens in one
    batched forward.  ``last_logits[i]`` are the logits after slot i's last
    valid token.  Slots with ``n_valid == 0`` are untouched."""
    if not getattr(model, "supports_parallel_prefill", False):
        raise NotImplementedError(
            "the masked decode-scan prefill (recurrent / ring-buffer models) "
            "is not ported yet")

    def step(tokens, n_valid, caches, cache_len):
        c = tokens.shape[1]
        logits, new_caches = model.prefill_step(tokens, caches, cache_len, n_valid)
        idx = torch.clamp(n_valid - 1, 0, c - 1)
        last = torch.take_along_dim(logits, idx[:, None, None], dim=1)[:, 0]
        new_caches = select_slots(n_valid > 0, new_caches, caches)
        return last, new_caches, cache_len + n_valid

    return step
