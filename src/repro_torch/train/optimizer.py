"""Optimizers: SGD with momentum (the paper's choice: lr 0.01, momentum
0.9) and AdamW.  Counterpart of ``repro/train/optimizer.py``.

Both are functional, as the reference's: ``update(grads, state, params)``
returns new parameter and state dicts (flat dicts of tensors keyed alike)
and leaves its inputs as they were.  Both take global gradient-norm
clipping and a schedule (a callable ``lr(step)``).  The step count is a
Python int: the port runs eagerly, so it never needs to live on the device.

On sharded state (``DTensor`` parameters, gradients and momentum, as
``launch/dryrun.build_train`` places them) SGDM updates each rank's own
shards, elementwise as on whole tensors, and the new state carries the
placements of the old.  Global-norm clipping needs the norm over every
shard and is not run there (it raises).
"""

from __future__ import annotations

import dataclasses
import typing

import torch

from repro_torch.dist.sharding import is_dtensor, like, local
from repro_torch.utils.tree import global_norm


def _lr_at(lr, step: int):
    return lr(step) if callable(lr) else lr


def clip_by_global_norm(grads: dict, max_norm: float):
    if any(is_dtensor(g) for g in grads.values()):
        raise NotImplementedError("global-norm clipping of sharded gradients: the norm spans "
                                  "every rank's shards")
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / norm.clamp_min(1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


@dataclasses.dataclass(frozen=True)
class SGDM:
    lr: typing.Any = 0.01
    momentum: float = 0.9
    weight_decay: float = 0.0
    nesterov: bool = False
    clip_norm: float | None = None
    momentum_dtype: typing.Any = None  # None -> same as param dtype

    def init(self, params: dict) -> dict:
        return {"mom": {k: torch.zeros_like(p, dtype=self.momentum_dtype or p.dtype)
                        for k, p in params.items()},
                "step": 0}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        step = state["step"] + 1
        lr = _lr_at(self.lr, step)
        norm = None
        if self.clip_norm is not None:
            grads, norm = clip_by_global_norm(grads, self.clip_norm)
        new_params, new_mom = {}, {}
        for k, param in params.items():
            p, m = local(param), local(state["mom"][k])
            g32 = local(grads[k]).float()
            if self.weight_decay:
                g32 = g32 + self.weight_decay * p.float()
            # momentum·m + g and p − lr·d, rounded step by step as written,
            # each built in its result's own storage: no parameter-sized
            # temporary beside the new parameter and momentum
            m_new = m.float().mul(self.momentum).add_(g32)
            d = (g32 + self.momentum * m_new) if self.nesterov else m_new
            new_p = torch.mul(d, lr)
            new_params[k] = like(param, torch.sub(p.float(), new_p, out=new_p).to(p.dtype))
            new_mom[k] = like(state["mom"][k], m_new.to(m.dtype))
        info = {"lr": lr}
        if norm is not None:
            info["grad_norm"] = norm
        return new_params, {"mom": new_mom, "step": step}, info


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: typing.Any = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float | None = 1.0
    state_dtype: typing.Any = torch.float32

    def init(self, params: dict) -> dict:
        def zeros():
            return {k: torch.zeros_like(p, dtype=self.state_dtype) for k, p in params.items()}

        return {"m": zeros(), "v": zeros(), "step": 0}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        step = state["step"] + 1
        lr = _lr_at(self.lr, step)
        norm = None
        if self.clip_norm is not None:
            grads, norm = clip_by_global_norm(grads, self.clip_norm)
        c1 = 1.0 - self.b1 ** step
        c2 = 1.0 - self.b2 ** step
        new_params, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g32 = grads[k].float()
            m_new = self.b1 * state["m"][k] + (1 - self.b1) * g32
            v_new = self.b2 * state["v"][k] + (1 - self.b2) * g32.square()
            d = (m_new / c1) / (torch.sqrt(v_new / c2) + self.eps) \
                + self.weight_decay * p.float()
            new_params[k] = (p.float() - lr * d).to(p.dtype)
            new_m[k] = m_new.to(self.state_dtype)
            new_v[k] = v_new.to(self.state_dtype)
        info = {"lr": lr}
        if norm is not None:
            info["grad_norm"] = norm
        return new_params, {"m": new_m, "v": new_v, "step": step}, info
