"""Model interface.  Counterpart of ``repro/models/base.py``.

The reference's ``DFAModel`` protocol serves both training and serving.
Slice 1 ports the serving half: what ``serve.Engine`` calls.  The training
half (segments, saved block inputs, the head split for the DFA error tap)
comes with the training slice.
"""

from __future__ import annotations

from repro_torch.nn.module import Module


class ServingModel(Module):
    """What the serving engine needs of a model."""

    supports_parallel_prefill = False

    def init_caches(self, batch: int, max_len: int, dtype=None):
        raise NotImplementedError

    def decode_step(self, token, caches, cache_len):
        """token (B, 1) -> (logits (B, 1, V), new caches)."""
        raise NotImplementedError

    def prefill_step(self, tokens, caches, cache_len, n_valid):
        """tokens (B, C) -> (logits (B, C, V), new caches)."""
        raise NotImplementedError

    def forward_gemm_specs(self) -> list:
        """(name, m, k) of every weight-stationary forward projection of one
        streamed token."""
        raise NotImplementedError(
            f"{type(self).__name__} declares no forward GEMM workload")
