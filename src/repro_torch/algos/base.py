"""The Algorithm protocol: what a training algorithm provides to the
trainer and the launchers.  Counterpart of ``repro/algos/base.py``.

* ``init_extra_state(model, seed, cfg)`` — algorithm-owned state that is
  neither a parameter nor optimizer state (DFA: the fixed feedback
  matrices), deterministic in ``seed``.
* ``value_and_grad(model, cfg)`` — returns
  ``fn(params, extra, batch, rng) -> ((loss, metrics), grads)`` with
  ``grads`` keyed as ``params`` (a flat dict of tensors) and ``rng`` an
  integer seed.
* ``fused_step(model, cfg, optimizer)`` — optional step
  ``(params, extra, opt_state, batch, rng) -> (params', opt_state', loss)``;
  the base class composes ``value_and_grad`` with ``optimizer.update``.
"""

from __future__ import annotations


class Algorithm:
    """Base class: subclasses override value_and_grad (and optionally the
    rest); instances are registered by name."""

    name = "base"

    def init_extra_state(self, model, seed, cfg):
        """Algorithm-owned non-parameter state (default: none)."""
        del model, seed, cfg
        return {}

    def value_and_grad(self, model, cfg):
        raise NotImplementedError

    def fused_step(self, model, cfg, optimizer, reduce=None):
        """Generic fallback: value_and_grad composed with optimizer.update.
        ``reduce`` (data parallelism): maps a dict of gradients (and the
        loss) to their mean over the data group before the update."""
        vg = self.value_and_grad(model, cfg)

        def step(params, extra, opt_state, batch, rng):
            (loss, _metrics), grads = vg(params, extra, batch, rng)
            if reduce is not None:
                grads = reduce(grads)
                loss = reduce({"loss": loss})["loss"]
            new_params, new_opt, _info = optimizer.update(grads, opt_state, params)
            return new_params, new_opt, loss

        return step


_REGISTRY: dict[str, Algorithm] = {}


def register(algo: Algorithm) -> Algorithm:
    """Register an Algorithm instance under its ``name``."""
    if not isinstance(algo, Algorithm):
        raise TypeError(f"expected an Algorithm instance, got {type(algo)!r}")
    _REGISTRY[algo.name] = algo
    return algo


def get(name: str) -> Algorithm:
    if name not in _REGISTRY:
        raise KeyError(f"unknown algorithm {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_algos() -> list[str]:
    return sorted(_REGISTRY)
