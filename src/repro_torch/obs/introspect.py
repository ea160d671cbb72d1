"""In-situ DFA alignment telemetry: the interval-sampled probe behind
``TrainerConfig.probe_every`` / ``build_session(probe_every=)``.
Counterpart of ``repro/obs/introspect.py``.

The paper's training claim is *feedback alignment*: the fixed photonic
feedback banks only train the network if the DFA update progressively
aligns with the true gradient.  Every ``probe_every`` steps the Trainer
calls ``AlignmentProbe`` on the step's own (state, batch) BEFORE the
update runs and logs:

* ``align_<subtree>`` — cosine between the DFA gradient and the exact
  BP gradient of the same batch, per parameter subtree (the first
  component of the flat parameter name: ``h0``, ``blocks``, ``embed``,
  ``head``, ...; the reference's top-level keys);
* ``align_global``   — the cosine over all compared leaves at once;
* ``gnorm_dfa_<s>`` / ``gnorm_bp_<s>`` — per-subtree gradient norms;
* ``upd_ratio_<s>``  — lr·‖g_dfa‖/‖p‖, the update/parameter norm ratio;
* on stateful-hardware (emu) sessions, the ``nb_*`` noise-budget
  attribution of ``obs.attribution`` for one sampled feedback panel
  product.

Contract with training:

* **No PRNG consumption.**  The probe re-derives the step's keys from
  ``(seed, step, name)`` exactly as ``Trainer._train_step`` does, so
  probe-on and probe-off runs produce bit-identical training states.
* **No state mutation.**  The hardware advance is replayed on the
  functional ``calibrate.advance`` (it returns a new state), gradients
  come from ``torch.autograd.grad`` (no ``.grad`` is left on any tensor)
  and no optimizer runs.
* **One drain.**  The probe returns 0-d tensors; the fit loop pushes them
  through ``Observer.log_step`` (one transfer).

The DFA side is the trainer's own ``_grads``, so on the ``cuda`` backend
every projection of the probe runs the bank kernel (25 launches on
qwen1.5-0.5b) and on ``emu`` the emu kernel; the BP side is
``algos.get("bp")`` (autograd) on the same model and batch.

Analytic anchor: with ideal photonics and the last segment's feedback
bank set to the head weights W (B = W, δ = e·Bᵀ = e·Wᵀ — exactly BP's
cotangent at the last hidden output), the last segment's alignment is
identically 1.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch import algos
from repro_torch.algos.dfa import tree_cosine
from repro_torch.hardware import calibrate as hw_calibrate
from repro_torch.hardware import drift as hw_drift
from repro_torch.models.base import subtree
from repro_torch.utils import prng


def _norm(leaves):
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.dot(x, x) for x in leaves))


def _resolve_lr(optimizer, opt_state) -> float:
    """Best-effort learning rate for the update/param ratio: a float
    ``lr`` attribute, a callable schedule evaluated at the optimizer
    step, else 1.0 (the ratio degrades to grad/param norm)."""
    lr = getattr(optimizer, "lr", None)
    if lr is None:
        return 1.0
    if callable(lr):
        step = opt_state.get("step") if isinstance(opt_state, dict) else None
        return float(lr(step + 1)) if step is not None else 1.0
    return float(lr)


class AlignmentProbe:
    """Alignment probe bound to one Trainer.

    ``probe(state, batch)`` returns a flat dict of 0-d tensors; the caller
    drains them (``Observer.log_step``).  The DFA side reuses the
    trainer's own ``_grads`` (microbatch accumulation included) so the
    probed update is exactly the one training applies."""

    def __init__(self, trainer, *, attribution_rows: int = 64):
        self._trainer = trainer
        cfg = trainer.cfg
        self._bp_vg = algos.get("bp").value_and_grad(trainer.model, cfg.dfa)
        self._attribution = bool(getattr(trainer, "_hw_stateful", False)
                                 and cfg.dfa.photonics.mrr is not None)
        self._attribution_rows = int(attribution_rows)

    def probe(self, state, batch) -> dict:
        """-> flat dict of 0-d tensors for one (state, batch) on the
        trainer's device."""
        trainer = self._trainer
        cfg = trainer.cfg
        step = state["step"]
        rng = prng.step_key(cfg.seed, step, "noise")
        hw = state.get("hw")
        hw_ctx = contextlib.nullcontext()
        if hw is not None:
            # replay the train step's hardware advance so the probed DFA
            # gradient sees the residual the real update will
            hw = hw_calibrate.advance(
                hw, cfg.dfa.photonics, step, prng.step_key(cfg.seed, step, "hardware"),
                recalibrate_every=cfg.recalibrate_every)
            hw_ctx = hw_drift.use_state(hw)
        with hw_ctx:
            (_, _), dfa_grads = trainer._grads(state["params"], state["fb"], batch, rng)
        # the exact gradient of the same batch; BP sees the same step key
        (_, _), bp_grads = self._bp_vg(state["params"], state["fb"], batch,
                                       rng)  # lint: disable=RL001 one draw for DFA and BP

        out = {}
        lr = _resolve_lr(cfg.optimizer, state.get("opt"))
        all_dfa, all_bp = [], []
        with torch.no_grad():
            for name in sorted({k.split(".")[0] for k in dfa_grads}):
                d_tree = subtree(dfa_grads, name + ".")
                b_tree = subtree(bp_grads, name + ".")
                if not d_tree or d_tree.keys() != b_tree.keys():
                    continue
                d = [d_tree[k].float().flatten() for k in d_tree]
                b = [b_tree[k].float().flatten() for k in d_tree]
                all_dfa += d
                all_bp += b
                gn_d = _norm(d)
                out[f"align_{name}"] = tree_cosine(d_tree, b_tree)
                out[f"gnorm_dfa_{name}"] = gn_d
                out[f"gnorm_bp_{name}"] = _norm(b)
                params = subtree(state["params"], name + ".")
                pn = _norm([params[k].float().flatten() for k in d_tree])
                out[f"upd_ratio_{name}"] = lr * gn_d / torch.clamp(pn, min=1e-12)
            num = sum(torch.dot(x, y) for x, y in zip(all_dfa, all_bp))
            out["align_global"] = num / torch.clamp(_norm(all_dfa) * _norm(all_bp), min=1e-12)
        del dfa_grads, bp_grads, all_dfa, all_bp
        if self._attribution:
            out.update(self._noise_budget(state, batch, hw))
        return out

    __call__ = probe

    def _noise_budget(self, state, batch, hw):
        """One sampled feedback panel product through the sole-source
        decomposition of ``obs.attribution`` — the probe's own key
        ("probe-nb"), never a training one.  The bank is the last
        segment's first layer, ``fb[last][0]``: the port stacks each
        segment's feedback (n_layers, d_inject, d_tap) as the reference
        does."""
        from repro_torch.algos import dfa as dfa_lib
        from repro_torch.obs import attribution

        trainer = self._trainer
        cfg = trainer.cfg
        fwd = dfa_lib.forward_with_error(trainer.model, state["params"], cfg.dfa, batch)
        e = fwd["e_tap"].reshape(-1, fwd["e_tap"].shape[-1])
        e = e[: self._attribution_rows].float()
        del fwd
        last = trainer.model.segment_specs()[-1].name
        bmat = state["fb"][last][0].float()
        residual = hw_drift.residual(hw) if hw is not None else None
        key = prng.step_key(cfg.seed, state["step"], "probe-nb")
        with torch.no_grad():
            return attribution.noise_budget(e, bmat, cfg.dfa.photonics, key,
                                            residual=residual)
