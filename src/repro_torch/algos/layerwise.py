"""``dfa-layerwise``: the shallow-DFA ablation with a per-layer error tap.
Counterpart of ``repro/algos/layerwise.py``.

Standard DFA taps the error once at the top and broadcasts it to every
block.  The layerwise ablation taps an error at each block's own output:
block k's output is read out through its fixed feedback bank run forward
(t_k = y_k·B(k), the same inscribed weights used twice), the loss is
evaluated at that local tap, and the local error is projected back through
B(k) as usual:

    t_k   = y_k · B(k)                      # fixed random readout, d_tap wide
    e_k   = ∂L(t_k)/∂t_k                    # the block-local error
    δ(k)  = photonic_project(e_k, B(k)) ⊙ g'(a(k))

For ``error_tap == "logits"`` models t_k feeds ``loss_from_logits``
directly; for ``"hidden"`` models (the LMs) t_k is a pseudo-hidden state
pushed through the exactly trained head (final norm and unembedding).  The
readout runs in f32 on the detached block output.  A segment with an error
adapter or expander (whisper's pooled encoder) falls back to the global
error, as in the reference: its local tap would not line up with the loss.
Head and embedding updates are those of ``dfa``.

Under tensor parallelism a rank holds its rows of B(k) (the feedback's
injection dim is split over ``model``): the readout, which contracts the
whole block output with B(k), runs on B(k) gathered whole (exact, and the
one process's product), and the projection back through B(k) on the
rank's rows in a column window, as ``dfa``'s.
"""

from __future__ import annotations

import torch

from repro_torch.algos import base
from repro_torch.algos import dfa as dfa_lib
from repro_torch.dist import sharding


def value_and_grad(model, cfg: dfa_lib.DFAConfig):
    """fn(params, fb, batch, rng) -> ((loss, metrics), grads) with
    block-local error taps for every block of every segment."""

    def local_error(params, batch, tap):
        """∂L/∂tap at the block-local readout (d_tap wide)."""
        tap = tap.detach().requires_grad_()
        with torch.enable_grad():
            out = tap if model.error_tap == "logits" else model.head_logits(params, tap, batch)
            loss, _metrics = model.loss_from_logits(out, batch)
            (e,) = torch.autograd.grad(loss, tap)
        return e

    def fn(params, fb, batch, rng):
        fwd = dfa_lib.forward_with_error(model, params, cfg, batch)
        global_delta = dfa_lib.dfa_delta(cfg)

        def delta_fn(spec, e_seg, bmat, key, y):
            if spec.adapt_error is not None or spec.expand_delta is not None:
                return global_delta(spec, e_seg, bmat, key, y)
            whole = bmat if bmat.shape[0] == spec.d_inject else sharding.gather_from_model(bmat, 0)
            tap = y.detach().float() @ whole.float()
            e_loc = dfa_lib.compress_error(local_error(params, batch, tap), cfg.error_compress)
            delta = dfa_lib._project(e_loc.to(y.dtype).detach(), bmat, cfg, key, spec.d_inject)
            return delta.reshape(y.shape)

        grads = dict(fwd["g_head"])
        grads.update(dfa_lib.segment_grads(model, params, cfg, fwd, fb, rng, delta_fn))
        grads.update(dfa_lib.embed_grads(model, params, cfg, fwd, fb, rng))
        total, metrics = dfa_lib._totals(fwd)
        return (total, metrics), {k: grads[k] for k in params}

    return fn


class LayerwiseDFAAlgorithm(base.Algorithm):
    name = "dfa-layerwise"

    def init_extra_state(self, model, seed, cfg):
        return dfa_lib.init_feedback(model, seed, cfg)

    def value_and_grad(self, model, cfg):
        return value_and_grad(model, cfg)


base.register(LayerwiseDFAAlgorithm())
