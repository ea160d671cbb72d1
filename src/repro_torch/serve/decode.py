"""Serve-step builders.  Counterpart of ``repro/serve/decode.py``.

The reference's builders take ``params`` and are jitted; the port's
models hold their parameters and run eagerly.  Cache sharding is not
ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.core import photonics


def make_serve_step(model, *, sample: str = "greedy", whisper_enc: bool = False):
    """Returns step(token, caches, cache_len[, enc]) -> (next_token, logits,
    new_caches).  ``whisper_enc``: the model decodes against an encoder
    output ``enc`` (whisper's ``decode_step(token, enc, caches,
    cache_len)``), passed as the step's last argument."""
    if sample != "greedy":
        raise ValueError(sample)

    def step(token, caches, cache_len, *extra):
        if whisper_enc:
            logits, new_caches = model.decode_step(token, extra[0], caches, cache_len)
        else:
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


def make_prefill(model):
    """Forward over the prompt: prefill(params, batch) -> logits (B, S, V)
    through the training forward (``embed`` → ``run_segments`` →
    ``head_logits``).  The engine fills caches with ``make_prefill_step``."""

    def prefill(params, batch):
        x0 = model.embed(params, batch)
        x_final, _, _ = model.run_segments(params, x0)
        return model.head_logits(params, x_final, batch)

    return prefill


def make_prefill_step(model):
    """Chunked-prefill builder: step(tokens (B, C), n_valid (B,), caches,
    cache_len) -> (last_logits (B, V), new_caches, new_cache_len).

    Fills each slot's cache with its next <= C prompt tokens.
    ``last_logits[i]`` are the logits after slot i's last valid token
    (f32 zeros for a slot with ``n_valid == 0``, whose cache is untouched).

    A model with ``supports_parallel_prefill`` (global attention) runs one
    batched forward over the chunk.  A recurrent model runs the masked
    decode-scan: ``decode_step`` on every slot at each token position t,
    slot i keeping the new state where t < n_valid[i].  The reference scans
    that loop under ``jit``, which traces ``decode_step`` once, so every
    position draws the same bank-noise keys; the port iterates the positions
    through ``photonics.scanned_layers`` to keep that numbering."""
    parallel = getattr(model, "supports_parallel_prefill", False)
    vocab = model.cfg.v_padded

    def parallel_step(tokens, n_valid, caches, cache_len):
        c = tokens.shape[1]
        logits, new_caches = model.prefill_step(tokens, caches, cache_len, n_valid)
        idx = torch.clamp(n_valid - 1, 0, c - 1)
        last = torch.take_along_dim(logits, idx[:, None, None], dim=1)[:, 0]
        new_caches = select_slots(n_valid > 0, new_caches, caches)
        return last, new_caches, cache_len + n_valid

    def scan_step(tokens, n_valid, caches, cache_len):
        b, c = tokens.shape
        clen = cache_len
        last = torch.zeros((b, vocab), dtype=torch.float32, device=tokens.device)
        for t in photonics.scanned_layers(range(c)):
            valid = t < n_valid
            logits, upd = model.decode_step(tokens[:, t:t + 1], caches, clen)
            caches = select_slots(valid, upd, caches)
            clen = clen + valid.to(clen.dtype)
            last = torch.where(valid[:, None], logits[:, -1, :].float(), last)
        return last, caches, cache_len + n_valid

    return parallel_step if parallel else scan_step
