"""Synthetic LM token streams (no text corpus is shipped).
Counterpart of ``repro/data/tokens.py``, a numpy copy that gives the same
tokens for the same arguments.

A mixture of a deterministic successor chain (t' = (a·t + b) mod V with
probability p) and uniform noise: an LM that learns it brings its loss well
below log V, so training curves mean something.  Deterministic per (seed,
step), so a restart replays the stream.
"""

from __future__ import annotations

import numpy as np


class MarkovTokens:
    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 0, p_follow: float = 0.8, a: int = 31, b: int = 7):
        self.v = vocab_size
        self.s = seq_len
        self.b = batch_size
        self.seed = seed
        self.p = p_follow
        self.mult, self.add = a, b

    def batch(self, step: int) -> dict:
        """{"tokens", "labels"}: int32 (batch, seq), labels the next token."""
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((self.b, self.s + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.v, size=self.b)
        follow = rng.random((self.b, self.s)) < self.p
        noise = rng.integers(0, self.v, size=(self.b, self.s))
        for t in range(self.s):
            nxt = (toks[:, t] * self.mult + self.add) % self.v
            toks[:, t + 1] = np.where(follow[:, t], nxt, noise[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
