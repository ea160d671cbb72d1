"""Model interfaces.  Counterpart of ``repro/models/base.py``.

The reference's ``DFAModel`` protocol serves both training and serving; the
port keeps the two halves apart, and a model that does both (the
transformer LM) derives from both.  ``ServingModel`` is what
``serve.Engine`` calls.  ``DFAModel`` is what the DFA engine
(``algos/dfa.py``) calls: a model that decomposes into

    embed  →  segments (stacks of homogeneous blocks)  →  head

A DFA model is an ``nn.Module`` that owns its parameters, but the training
half is functional: every method takes ``params``, a flat dict in the
module's ``state_dict`` naming (``"h0.weight"``, ``"head.bias"``, ...), and
runs the module on it through ``torch.func.functional_call``.  The trainer
carries that dict as its state, so a step is a function of (params,
feedback, optimizer state, batch, step), as in the reference.

Under a sharded step (``launch/dryrun.build_train``) ``params`` holds
``DTensor``s and the model reads them through the FSDP gather
(``dist.sharding.unshard_fsdp``): one block's parameters at a time
(``SegmentSpec.gathered_params``, the reference's per-layer gathers) and
the embedding's and the head's once each where they are read
(``gathered``); outside a mesh both hand back the dict as it is.  Each
names the column-parallel parts its module computes on this rank's rows
(``SegmentSpec.split``, ``gathered(parts=)``, ``serving_params(parts=)``):
those model-split leaves stay split.  The module's own parameters are then
dropped (``release_parameters``).

The forward pass (``run_segments``) saves each block's input — the only
activation state DFA needs.  The head is split into ``head_logits``
(parameterised) and ``loss_from_logits`` (pure), so the engine can tap the
error at the logits (the paper's MLP: e = ∂L/∂logits) or below the
unembedding (``hidden``).  Head parameters always get exact gradients.
"""

from __future__ import annotations

import contextlib
import dataclasses
import typing

import torch

from repro_torch.dist.sharding import unshard_fsdp
from repro_torch.nn.module import Module
from repro_torch.utils.device import faking


class ServingModel(Module):
    """What the serving engine needs of a model."""

    supports_parallel_prefill = False

    def init_caches(self, batch: int, max_len: int, dtype=None):
        raise NotImplementedError

    def decode_step(self, token, caches, cache_len, params=None):
        """token (B, 1) -> (logits (B, 1, V), new caches); on ``params``
        (``serving_params``) where given, else the module's own."""
        raise NotImplementedError

    def prefill_step(self, tokens, caches, cache_len, n_valid, params=None):
        """tokens (B, C) -> (logits (B, C, V), new caches)."""
        raise NotImplementedError

    def forward_gemm_specs(self) -> list:
        """(name, m, k) of every weight-stationary forward projection of one
        streamed token."""
        raise NotImplementedError(
            f"{type(self).__name__} declares no forward GEMM workload")


@contextlib.contextmanager
def serving_params(module, params: dict | None, prefix: str, skip: str | None = None,
                   parts: dict | None = None):
    """Run ``module`` on ``params``' subtree under ``prefix`` (a flat dict,
    ``DTensor``s under a sharded serving step) through the FSDP gather
    (``unshard_fsdp``: one block's all-gather under a mesh, the
    reference's per-layer serving gathers; the column-parallel ``parts``
    left split), leaving out the leaves under ``skip`` (relative to
    ``prefix``), which the call does not read; on its own parameters where
    ``params`` is None."""
    if params is None:
        yield module
        return
    from torch.nn.utils.stateless import _reparametrize_module

    # gathered under their full names, so that ``SPLIT_READS`` finds the
    # leaves a module reads as its piece (the vocabulary table, the experts)
    leaves = {k: v for k, v in params.items() if k.startswith(prefix)
              and (skip is None or not k[len(prefix):].startswith(skip))}
    with _reparametrize_module(module, subtree(unshard_fsdp(leaves, parts), prefix)):
        yield module


_NO_TAPE: list = []


@contextlib.contextmanager
def no_tape():
    """Within the block ``run_segments`` keeps no tape (a serving prefill
    reads only the logits; the reference's compiler drops the unused
    tape)."""
    _NO_TAPE.append(True)
    try:
        yield
    finally:
        _NO_TAPE.pop()


class _Discard:
    """A tape that keeps nothing."""

    def __setitem__(self, index, value):
        del index, value


def new_tape(n_layers: int, x0: torch.Tensor):
    """The (n_layers, *x0.shape) buffer ``run_segments`` saves each block's
    input in; one that keeps nothing under ``no_tape``."""
    return _Discard() if _NO_TAPE else x0.new_empty((n_layers, *x0.shape))


def subtree(params: dict, prefix: str) -> dict:
    """The entries of a flat parameter dict under ``prefix`` (which ends in
    "."), keyed relative to it."""
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def gathered(params: dict, prefix: str, parts: dict | None = None) -> dict:
    """``subtree(params, prefix)`` through the FSDP gather
    (``unshard_fsdp``, the column-parallel ``parts`` left split): its
    ``DTensor`` leaves as plain tensors under a mesh (the embedding and
    the head, read once a step); the subtree itself otherwise."""
    return unshard_fsdp(subtree(params, prefix), parts)


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    """Static description of one stack of homogeneous blocks."""

    name: str
    n_layers: int
    d_inject: int  # feature dim at the injection point (block output)
    # apply(layer_params, x, extras) -> (y, weighted aux loss scalar or None)
    apply: typing.Callable = dataclasses.field(compare=False)
    # True: the layers are a ``ModuleList`` (``blocks.{i}.``); False: the
    # segment is one block, the module itself (the MLP's ``h{i}.``)
    stacked: bool = False
    # optional: transform the tapped error before projection (whisper's
    # encoder pools the decoder error over its positions)
    adapt_error: typing.Callable | None = dataclasses.field(default=None, compare=False)
    # optional: expand the projected delta to the block-output shape
    # (default: reshape), e.g. broadcast a pooled delta over positions
    expand_delta: typing.Callable | None = dataclasses.field(default=None, compare=False)
    # optional: () -> the column-parallel parts of a layer on the active
    # mesh (``dist.sharding.COLUMN_SPLIT`` entries), left split by ``unshard``
    split: typing.Callable | None = dataclasses.field(default=None, compare=False)

    def layer_prefix(self, idx: int) -> str:
        """Where layer ``idx``'s parameters sit in the flat dict."""
        return f"{self.name}.{idx}." if self.stacked else f"{self.name}."

    def layer_params(self, params: dict, idx: int) -> dict:
        return subtree(params, self.layer_prefix(idx))

    def unshard(self, leaves: dict) -> dict:
        """One block's parameters through the FSDP gather (one block's
        all-gather under a mesh, its column-parallel parts left split; the
        dict itself otherwise)."""
        return unshard_fsdp(leaves, self.split() if self.split is not None else None)

    def gathered_params(self, params: dict, idx: int) -> dict:
        """Layer ``idx``'s parameters through ``unshard``."""
        return self.unshard(self.layer_params(params, idx))


@dataclasses.dataclass(frozen=True)
class SavedSegment:
    """Per-segment forward tape: stacked block inputs + shared extras."""

    inputs: typing.Any  # (L, ...) — the input of each block
    extras: typing.Any = None  # shared across layers (positions, ...)


class DFAModel(Module):
    """Interface — concrete models implement the methods below."""

    # --- static info ---
    @property
    def error_tap(self) -> str:  # "hidden" | "logits"
        return "hidden"

    @property
    def d_tap(self) -> int:
        raise NotImplementedError

    # the device the parameters lived on before ``release_parameters``
    _home: torch.device | None = None

    @property
    def device(self) -> torch.device:
        return self._home or next(self.parameters()).device

    def segment_specs(self) -> tuple[SegmentSpec, ...]:
        raise NotImplementedError

    def param_dict(self) -> dict:
        """A detached copy of the module's parameters: the trainer's
        ``params``."""
        return {k: v.detach().clone() for k, v in self.named_parameters()}

    def release_parameters(self) -> None:
        """Drop the module's own parameter storage (moved to the meta
        device) once a sharded state holds the parameters: the training
        methods read ``params`` only.  ``device`` stays where they were."""
        self._home = self.device
        if faking():
            return  # fake parameters hold no storage (and cannot be swapped)
        self.to("meta")

    # --- forward parts ---
    def embed(self, params, batch):
        raise NotImplementedError

    def run_segments(self, params, x0):
        """x0: ``embed``'s output (a tensor, or a dict of tensors) ->
        (x_final, {name: SavedSegment}, {name: aux_loss_scalar})"""
        raise NotImplementedError

    def head_logits(self, params, x_final, batch):
        raise NotImplementedError

    def loss_from_logits(self, logits, batch):
        """-> (loss, metrics dict)"""
        raise NotImplementedError

    # --- composed API ---
    def loss(self, params, batch):
        """Plain forward loss — used by the backprop baseline and eval."""
        x0 = self.embed(params, batch)
        x_final, _, auxes = self.run_segments(params, x0)
        logits = self.head_logits(params, x_final, batch)
        loss, metrics = self.loss_from_logits(logits, batch)
        aux_total = sum(auxes.values()) if auxes else 0.0
        metrics = dict(metrics)
        if auxes:
            metrics["aux_loss"] = aux_total
        return loss + aux_total, metrics

    # --- DFA hooks with defaults ---
    def embed_feedback(self, e_tap, fb_embed, x0, project_fn):
        """Cotangent injected at the embed output, shaped as ``x0`` (a
        tensor, or a dict of them for an encoder-decoder).  Default: one
        photonic projection of the (flattened-leading) error to x0's
        feature dim."""
        delta = project_fn(e_tap, fb_embed)
        return delta.to(x0.dtype).reshape(x0.shape)


def cross_entropy_loss(logits, labels, *, mask=None, label_smoothing: float = 0.0):
    """Mean CE over valid positions.  logits (..., V), labels (...) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if label_smoothing > 0.0:
        mean_ll = logits.mean(dim=-1)
        nll = (1 - label_smoothing) * nll + label_smoothing * (logz - mean_ll)
    hit = (logits.argmax(-1) == labels).float()
    if mask is not None:
        mask = mask.float()
        denom = mask.sum().clamp_min(1.0)
        loss = (nll * mask).sum() / denom
        acc = (hit * mask).sum() / denom
    else:
        loss = nll.mean()
        acc = hit.mean()
    return loss, {"ce_loss": loss, "accuracy": acc}
