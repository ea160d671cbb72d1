"""Exact-backprop baseline under the identical harness and loss.
Counterpart of ``repro/algos/bp.py``; registered as ``bp``."""

from __future__ import annotations

import torch

from repro_torch.algos import base
from repro_torch.algos import dfa as dfa_lib


def bp_value_and_grad(model):
    """fn(params, fb, batch, rng) -> ((loss, metrics), grads), exact."""

    def fn(params, fb, batch, rng):
        del fb, rng
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            loss, metrics = model.loss(leaves, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return (loss.detach(), metrics), grads

    return fn


class BPAlgorithm(base.Algorithm):
    name = "bp"

    def init_extra_state(self, model, seed, cfg):
        """BP needs no feedback, but building the same matrices keeps the
        training-state layout identical across algorithms, as in the
        reference."""
        return dfa_lib.init_feedback(model, seed, cfg)

    def value_and_grad(self, model, cfg):
        del cfg
        return bp_value_and_grad(model)


base.register(BPAlgorithm())
