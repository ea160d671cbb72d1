"""Direct Feedback Alignment training engine (the paper's algorithm).
Counterpart of ``repro/algos/dfa.py``.

For every block k the gradient is computed from the *output error only*
(paper Eq. 1):   δ(k) = B(k)·e ⊙ local derivative, realised as

    δ(k) = photonic_project(e, B(k))            # the MRR weight-bank product,
                                                # with measured analog noise
    grads(k) = autograd.grad(block_k(x_k), δ(k))  # exact *within* the block

The per-block loop has no loop-carried dependency: the error is computed
once and each block's gradient needs only its saved input.  For an MLP of
``DenseBlock``s the block-local gradient through the activation contributes
the ⊙ g'(a) Hadamard, so grad_W = (B e ⊙ g'(a)) · h_inᵀ.  The projection
itself carries no mask, as in the reference: the ``cuda`` backend runs it in
the bank kernel, and the fused ``dfa_gradient`` kernel is reached only
through ``photonic_project(mask=)`` (``ROADMAP.md`` queue 3 says why).

Error compression (``ternary``, the paper's ref [48], or ``int8``) is
applied to e before projection.

This module registers two algorithms:

* ``dfa``       — value_and_grad per Eq. 1 (+ the generic fused fallback)
* ``dfa-fused`` — same gradients, but ``fused_step`` applies each block's
  SGD-momentum update as soon as its gradient exists, so the gradients of
  all blocks never exist at once.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.algos import base
from repro_torch.core import feedback as fb_lib
from repro_torch.core import photonics
from repro_torch.models.base import subtree
from repro_torch.utils import prng


@dataclasses.dataclass(frozen=True)
class DFAConfig:
    """Config for the whole DFA algorithm family (bp ignores it)."""

    photonics: photonics.PhotonicConfig = dataclasses.field(
        default_factory=lambda: photonics.PRESETS["ideal"])
    feedback: fb_lib.FeedbackConfig = dataclasses.field(
        default_factory=fb_lib.FeedbackConfig)
    error_compress: str = "none"  # none | ternary | int8
    # photonic execution backend: auto | ref | cuda | a PhotonicBackend
    backend: str | photonics.PhotonicBackend = "auto"
    # freeze norm scales in DFA blocks: their gradients are zero (the
    # reference's trade for the all-reduces that feed them)
    freeze_norms: bool = False


_NORM_PAT = ("norm", "ln1", "ln2", "ln3", "ln_enc", "/ln/")


def _is_norm_path(path: str) -> bool:
    return any(p in path for p in _NORM_PAT)


def compress_error(e, mode: str):
    """Compress the error before broadcast/projection (ref [48])."""
    if mode == "none":
        return e
    if mode == "ternary":
        # sparse ternarisation: keep only errors well above the mean
        a = e.abs()
        tau = 2.0 * a.mean()
        keep = a > tau
        scale = (a * keep).sum() / keep.sum().clamp_min(1)
        return torch.sign(e) * keep * scale
    if mode == "int8":
        amax = e.abs().amax().clamp_min(1e-12)
        q = torch.round(torch.clamp(e / amax, -1, 1) * 127.0)
        return (q / 127.0 * amax).to(e.dtype)
    raise ValueError(f"unknown error_compress {mode!r}")


def init_feedback(model, seed: int, cfg: DFAConfig):
    """Fixed random feedback for every segment + the embed path, on the
    model's device: {segment: (n_layers, d_inject, d_tap), "embed": (d, d_tap)}."""
    d_tap = model.d_tap
    device = model.device
    fb = {}
    for spec in model.segment_specs():
        fb[spec.name] = fb_lib.make_feedback(
            prng.fold(seed, spec.name), spec.n_layers, spec.d_inject, d_tap, cfg.feedback,
            device)
    # embed feedback: inject at embed output (d_inject of the first segment)
    first = model.segment_specs()[0]
    fb["embed"] = fb_lib.make_feedback(
        prng.fold(seed, "embed"), 1, first.d_inject, d_tap, cfg.feedback, device)[0]
    return fb


def _project(e, bmat, cfg: DFAConfig, key):
    """δ = e·Bᵀ through the photonic execution model."""
    return photonics.photonic_project(e, bmat, cfg.photonics, key, backend=cfg.backend)


def _leaves(params: dict) -> dict:
    return {k: v.detach().requires_grad_() for k, v in params.items()}


def forward_with_error(model, params, cfg: DFAConfig, batch):
    """Shared forward: embed → segments → head → loss, returning everything
    the DFA-family backwards need.  Head gradients are exact; the error is
    tapped per ``model.error_tap``, compressed and detached (on hardware e
    is fetched from SRAM and re-encoded each cycle — never differentiated).
    The embedding runs with gradient tracking on its ``embed.`` parameters
    (``embed_vjp`` maps a cotangent at x0 to their gradients, as the
    reference's ``jax.vjp``); the segments run without.
    """
    embed = _leaves(subtree(params, "embed."))
    embed_vjp = None
    if embed:
        with torch.enable_grad():
            x0 = model.embed({**params, **{f"embed.{k}": v for k, v in embed.items()}}, batch)

        def embed_vjp(delta):
            g = torch.autograd.grad(x0, list(embed.values()), delta)
            return {f"embed.{k}": gk for k, gk in zip(embed, g)}
    else:
        with torch.no_grad():
            x0 = model.embed(params, batch)
    with torch.no_grad():
        x_final, saved, auxes = model.run_segments(params, x0.detach())
    head = _leaves(subtree(params, "head."))
    xf = x_final.detach().requires_grad_()
    with torch.enable_grad():
        logits = model.head_logits({**params, **{f"head.{k}": v for k, v in head.items()}},
                                   xf, batch)
        loss, metrics = model.loss_from_logits(logits, batch)
        (e_logits,) = torch.autograd.grad(loss, logits, retain_graph=True)
        # the error below the unembedding only where it is tapped: XLA drops
        # the reference's unused product as dead code
        tap_logits = model.error_tap == "logits"
        g = list(torch.autograd.grad(logits, list(head.values()) + ([] if tap_logits else [xf]),
                                     e_logits))
    del logits
    g_head = {f"head.{k}": gk for k, gk in zip(head, g)}
    if tap_logits:
        e_tap = e_logits
    else:
        # broadcast e in the model's compute dtype, as the reference does
        e_tap = g[-1].to(x_final.dtype)
    e_tap = compress_error(e_tap, cfg.error_compress).detach()
    return dict(x0=x0.detach(), embed_vjp=embed_vjp, saved=saved, auxes=auxes,
                g_head=g_head, e_tap=e_tap, loss=loss.detach(),
                metrics={k: v.detach() for k, v in metrics.items()})


def _block_grads(spec, params, idx, tape, delta_of, cfg: DFAConfig) -> dict:
    """Gradients of block ``idx``'s parameters with the cotangent
    ``delta_of(y)`` injected at its output (keyed as in ``params``)."""
    prefix = spec.layer_prefix(idx)
    leaves = {k: v.detach().requires_grad_(not (cfg.freeze_norms
                                                and _is_norm_path(prefix + k)))
              for k, v in spec.layer_params(params, idx).items()}
    with torch.enable_grad():
        y, aux = spec.apply(leaves, tape.inputs[idx], tape.extras)
        outs, cots = [y], [delta_of(y).to(y.dtype)]
        if aux.requires_grad:
            outs.append(aux)
            cots.append(torch.ones_like(aux))
        live = [k for k, v in leaves.items() if v.requires_grad]
        g = torch.autograd.grad(outs, [leaves[k] for k in live], cots, allow_unused=True)
    got = dict(zip(live, g))
    return {prefix + k: (got[k] if got.get(k) is not None else torch.zeros_like(v))
            for k, v in leaves.items()}


def _block_inputs(model, fwd, fb, rng, delta_fn):
    """Yield (spec, idx, tape, delta_of) for every block: the same keys
    (rng folded with the segment name, then the layer index) for ``dfa`` and
    ``dfa-fused``."""
    for spec in model.segment_specs():
        tape = fwd["saved"][spec.name]
        seg_key = prng.fold(rng, spec.name)
        for idx in range(spec.n_layers):
            bmat = fb_lib.feedback_for(fb[spec.name], idx)
            key = prng.fold(seg_key, idx)

            def delta_of(y, spec=spec, bmat=bmat, key=key):
                return delta_fn(spec, fwd["e_tap"], bmat, key, y)

            yield spec, idx, tape, delta_of


def segment_grads(model, params, cfg: DFAConfig, fwd, fb, rng, delta_fn):
    """Block-parallel backward over every segment (no loop-carried deps).

    ``delta_fn(spec, e_seg, bmat, key, y)`` produces the cotangent injected
    at the block output — the only point where DFA variants differ."""
    grads = {}
    for spec, idx, tape, delta_of in _block_inputs(model, fwd, fb, rng, delta_fn):
        grads.update(_block_grads(spec, params, idx, tape, delta_of, cfg))
    return grads


def dfa_delta(cfg: DFAConfig):
    """Eq. 1's cotangent: the global error projected through B(k)."""

    def delta_fn(spec, e_seg, bmat, key, y):
        del spec
        return _project(e_seg, bmat, cfg, key).reshape(y.shape)

    return delta_fn


def embed_grads(model, params, cfg: DFAConfig, fwd, fb, rng) -> dict:
    """DFA gradients of the embedding parameters: the projected error
    injected at the embed output (``model.embed_feedback``, key folded with
    "embed") and carried to the table by the embedding's vjp.  Empty for a
    model without them (the MLP)."""
    del params
    if fwd["embed_vjp"] is None:
        return {}
    key = prng.fold(rng, "embed")
    delta0 = model.embed_feedback(fwd["e_tap"], fb["embed"], fwd["x0"],
                                  lambda e, b: _project(e, b, cfg, key))
    return fwd["embed_vjp"](delta0)


def _totals(fwd):
    aux_total = sum(fwd["auxes"].values()) if fwd["auxes"] else 0.0
    total = fwd["loss"] + aux_total
    metrics = dict(fwd["metrics"])
    metrics["loss"] = total
    if fwd["auxes"]:
        metrics["aux_loss"] = aux_total
    return total, metrics


def value_and_grad(model, cfg: DFAConfig):
    """Returns fn(params, fb, batch, rng) -> ((loss, metrics), grads).

    ``grads`` is keyed as ``params``.  Head gradients are exact;
    segment/embed gradients are DFA (photonic-noisy) per Eq. 1."""

    def fn(params, fb, batch, rng):
        fwd = forward_with_error(model, params, cfg, batch)
        grads = dict(fwd["g_head"])
        grads.update(segment_grads(model, params, cfg, fwd, fb, rng, dfa_delta(cfg)))
        grads.update(embed_grads(model, params, cfg, fwd, fb, rng))
        total, metrics = _totals(fwd)
        return (total, metrics), {k: grads[k] for k in params}

    return fn


def make_fused_train_step(model, cfg: DFAConfig, optimizer):
    """DFA backward with the SGD-momentum update applied per block: each
    block's gradient is consumed by its parameter / momentum update as soon
    as it exists.  This is possible only because the DFA backward has no
    inter-block dependency.  As in the reference, the update is plain SGDM
    (lr, momentum, weight_decay); nesterov and clip_norm are not applied.

    Returns step(params, fb, opt_state, batch, rng) ->
    (new_params, new_opt_state, loss).
    """

    def _apply(params_t: dict, mom: dict, grads_t: dict, lr):
        new_p, new_m = {}, {}
        with torch.no_grad():
            for k, g in grads_t.items():
                p, m = params_t[k], mom[k]
                g32 = g.float()
                if optimizer.weight_decay:
                    g32 = g32 + optimizer.weight_decay * p.float()
                m_new = optimizer.momentum * m.float() + g32
                new_p[k] = (p.float() - lr * m_new).to(p.dtype)
                new_m[k] = m_new.to(m.dtype)
        return new_p, new_m

    def step(params, fb, opt_state, batch, rng):
        opt_step = opt_state["step"] + 1
        lr = optimizer.lr(opt_step) if callable(optimizer.lr) else optimizer.lr
        mom = opt_state["mom"]
        fwd = forward_with_error(model, params, cfg, batch)
        new_params = dict(params)
        new_mom = dict(mom)
        for spec, idx, tape, delta_of in _block_inputs(model, fwd, fb, rng, dfa_delta(cfg)):
            g = _block_grads(spec, params, idx, tape, delta_of, cfg)
            p, m = _apply(params, mom, g, lr)
            new_params.update(p)
            new_mom.update(m)
        # head (exact grads) + embed (DFA) updated out of the block loop
        for grads in (fwd["g_head"], embed_grads(model, params, cfg, fwd, fb, rng)):
            p, m = _apply(params, mom, grads, lr)
            new_params.update(p)
            new_mom.update(m)
        total, _metrics = _totals(fwd)
        return new_params, {"mom": new_mom, "step": opt_step}, total

    return step


def tree_cosine(a: dict, b: dict):
    """cos(a, b) over all entries of two dicts keyed alike, in f32.
    0.0 for empty dicts (a parameter-free segment has no direction)."""
    if not a or not b:
        return torch.zeros(())
    la = [a[k].float().flatten() for k in a]
    lb = [b[k].float().flatten() for k in a]
    num = sum(torch.dot(x, y) for x, y in zip(la, lb))
    na = torch.sqrt(sum(torch.dot(x, x) for x in la))
    nb = torch.sqrt(sum(torch.dot(y, y) for y in lb))
    return num / torch.clamp(na * nb, min=1e-12)


def grad_alignment(dfa_grads: dict, bp_grads: dict) -> dict:
    """Per-subtree cosine(DFA, BP) — the 'alignment' diagnostic.  A subtree
    is the first component of the parameter name (``h0``, ``head``, ...)."""
    names = dict.fromkeys(k.split(".")[0] for k in dfa_grads)
    return {n: tree_cosine(subtree(dfa_grads, n + "."), subtree(bp_grads, n + "."))
            for n in names}


class DFAAlgorithm(base.Algorithm):
    """The paper's algorithm, Eq. 1."""

    name = "dfa"

    def init_extra_state(self, model, seed, cfg: DFAConfig):
        return init_feedback(model, seed, cfg)

    def value_and_grad(self, model, cfg: DFAConfig):
        return value_and_grad(model, cfg)


class FusedDFAAlgorithm(DFAAlgorithm):
    """Identical gradients to ``dfa``; the fused step consumes each block's
    gradient as soon as it exists (SGDM-shaped optimizers only)."""

    name = "dfa-fused"

    def fused_step(self, model, cfg: DFAConfig, optimizer):
        return make_fused_train_step(model, cfg, optimizer)


base.register(DFAAlgorithm())
base.register(FusedDFAAlgorithm())
