"""Deterministic, restart-safe data pipelines.  Counterpart of
``repro/data/pipeline.py``.

All batching is a pure function of (seed, step): a restart at step k
replays the identical stream, with no iterator state to save.  Batches are
numpy on the host; ``to_device`` turns one into tensors on the trainer's
device, and ``DevicePrefetcher`` keeps the next few already there.  Under a
data-parallel mesh the trainer's ``put_fn`` is ``dist.sharding.put_batch``:
every rank reads the same global batch and keeps its rows.
"""

from __future__ import annotations

import numpy as np
import torch


class ArrayClassification:
    """Epoch-shuffled minibatcher over an in-memory (x, y) dataset."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0):
        self.x = x
        self.y = y
        self.bs = batch_size
        self.seed = seed
        self.steps_per_epoch = len(x) // batch_size

    def batch(self, step: int) -> dict:
        epoch = step // self.steps_per_epoch
        i = step % self.steps_per_epoch
        rng = np.random.default_rng((self.seed, epoch))
        perm = rng.permutation(len(self.x))
        idx = perm[i * self.bs: (i + 1) * self.bs]
        return {"x": self.x[idx], "y": self.y[idx]}

    def eval_batches(self, x, y, batch_size: int | None = None):
        bs = batch_size or self.bs
        for i in range(0, len(x) - bs + 1, bs):
            yield {"x": x[i: i + bs], "y": y[i: i + bs]}


def to_device(batch: dict, device) -> dict:
    """A batch of arrays -> tensors on ``device``; integer arrays (labels,
    tokens) become int64, the index type torch gathers with."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


class DevicePrefetcher:
    """Keeps up to ``depth`` future batches (beyond the current one) already
    on the device through ``put_fn``, so the copy for step k+1 is queued
    before step k's work.  ``data_fn`` stays a pure function of step: a
    restart at step k just refills the buffer."""

    def __init__(self, data_fn, put_fn, depth: int = 2, limit: int | None = None):
        self.data_fn = data_fn
        self.put = put_fn
        self.depth = max(1, int(depth))
        self.limit = limit  # first step NOT to enqueue (fit's total_steps)
        self._buf: dict = {}

    def _enqueue(self, step: int) -> None:
        if step not in self._buf:
            self._buf[step] = self.put(self.data_fn(step))

    def __call__(self, step: int):
        self._enqueue(step)
        for k in range(step + 1, step + self.depth + 1):
            if self.limit is not None and k >= self.limit:
                break
            self._enqueue(k)
        batch = self._buf.pop(step)
        for k in [k for k in self._buf if k <= step]:  # restart / seek
            del self._buf[k]
        return batch
