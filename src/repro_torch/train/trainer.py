"""Trainer: the train step of any registered algorithm (bp, dfa,
dfa-fused, dfa-layerwise), microbatch accumulation, the fit loop with
checkpoint and auto-resume, CSV metric logging and a straggler deadline,
and evaluation.  Counterpart of ``repro/train/trainer.py``, single device.

The state is a dict ``{"params", "fb", "opt", "step"}``: ``params`` a flat
dict of tensors in the model's ``state_dict`` naming, ``fb`` the feedback
matrices, ``opt`` the optimizer's state, ``step`` an int.  A backend that
emulates stateful hardware (``emu``) adds ``"hw"``, the per-ring drift and
calibration state (``hardware.drift``): each step advances it
(``hardware.calibrate.advance``, recalibrating every
``TrainerConfig.recalibrate_every`` steps) and runs the gradient under
``drift.use_state``, so the projections see the step's residual.  A step
returns a new state and leaves the one it was given as it was, as the
reference's jitted step does.

Fault tolerance: all training randomness (photonic noise, data order) is a
pure function of (seed, step) through ``utils.prng.step_key``, so with
``ckpt_dir`` set ``fit`` resumes from the newest snapshot
(``train/checkpoint.py``; the ``hw`` state included) and replays the
uninterrupted run bit for bit.

The trainer runs on the card unless ``device="cpu"`` is asked for, and
raises where CUDA is absent.  The reference's data parallelism, observer,
alignment probe and ``debug_checks`` are ported in later slices
(``ROADMAP.md``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import typing

import torch

from repro_torch import algos
from repro_torch.algos.dfa import DFAConfig
from repro_torch.core import photonics
from repro_torch.data.pipeline import DevicePrefetcher, to_device
from repro_torch.hardware import calibrate as hw_calibrate
from repro_torch.hardware import drift as hw_drift
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import SGDM
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    algo: str = "dfa"  # any name in algos.list_algos()
    dfa: DFAConfig = dataclasses.field(default_factory=DFAConfig)
    optimizer: typing.Any = dataclasses.field(default_factory=SGDM)
    seed: int = 0
    microbatches: int = 1
    # batches kept on the device ahead of the step (0 disables)
    prefetch: int = 2
    log_every: int = 50
    log_path: str | None = None
    # in-situ recalibration cadence (steps) for stateful emu hardware;
    # 0 = never (the stored estimate stays frozen)
    recalibrate_every: int = 0
    ckpt_dir: str | None = None
    ckpt_every: int = 500
    keep_ckpts: int = 3
    # straggler mitigation: per-step wall deadline (None = off)
    step_deadline_s: float | None = None


# residual threshold (in stationary drift σ) past which a ring counts as
# dead: the port's copy of repro/obs/hwmon.py:40 DEAD_RING_FACTOR
DEAD_RING_FACTOR = 3.0


class Trainer:
    def __init__(self, model, cfg: TrainerConfig, device=None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model lies on {model.device}, the trainer runs on "
                             f"{self.device}")
        self.model = model
        self.cfg = cfg
        self.algorithm = algos.get(cfg.algo)
        self._vg = self.algorithm.value_and_grad(model, cfg.dfa)
        # only backends that consume device state carry a "hw" state
        self._hw_stateful = photonics.get_backend(cfg.dfa.backend).stateful_hardware
        self.ckpt = CheckpointManager(cfg.ckpt_dir, cfg.keep_ckpts) if cfg.ckpt_dir else None
        self._log_file = None
        self._log_keys = None

    # ---------- state ----------
    def init_state(self, seed: int | None = None) -> dict:
        seed = self.cfg.seed if seed is None else seed
        self.model.init(seed)
        params = self.model.param_dict()
        fb = self.algorithm.init_extra_state(self.model, prng.fold(seed, "feedback"),
                                             self.cfg.dfa)
        state = {"params": params, "fb": fb, "opt": self.cfg.optimizer.init(params), "step": 0}
        if self._hw_stateful:
            state["hw"] = hw_drift.init_state(self.cfg.dfa.photonics, prng.fold(seed, "hardware"),
                                              device=self.device)
        return state

    # ---------- core step ----------
    def _grads(self, params, fb, batch, rng):
        mb = self.cfg.microbatches
        if mb <= 1:
            return self._vg(params, fb, batch, rng)
        n = next(iter(batch.values())).shape[0]
        if n % mb:
            raise ValueError(f"batch of {n} does not split into {mb} microbatches")
        parts = [dict(zip(batch, vals))
                 for vals in zip(*(torch.split(v, n // mb) for v in batch.values()))]
        gsum = msum = None
        total = 0.0
        for i, micro in enumerate(parts):
            (loss, metrics), grads = self._vg(params, fb, micro, prng.fold(rng, i))
            if gsum is None:
                gsum, msum = grads, dict(metrics)
            else:
                gsum = {k: gsum[k] + g for k, g in grads.items()}
                msum = {k: msum[k] + m for k, m in metrics.items()}
            total = total + loss
        return ((total / mb, {k: m / mb for k, m in msum.items()}),
                {k: g / mb for k, g in gsum.items()})

    def _train_step(self, state, batch):
        rng = prng.step_key(self.cfg.seed, state["step"], "noise")
        hw = state.get("hw")
        hw_ctx = contextlib.nullcontext()
        if hw is not None:
            # advance the physical device (drift and calibration sweeps) and
            # expose it to the photonic projections of this step
            hw = hw_calibrate.advance(
                hw, self.cfg.dfa.photonics, state["step"],
                prng.step_key(self.cfg.seed, state["step"], "hardware"),
                recalibrate_every=self.cfg.recalibrate_every)
            hw_ctx = hw_drift.use_state(hw)
        with hw_ctx:
            (loss, metrics), grads = self._grads(state["params"], state["fb"], batch, rng)
        new_params, new_opt, info = self.cfg.optimizer.update(
            grads, state["opt"], state["params"])
        metrics = dict(metrics)
        metrics.update(info)
        new_state = {"params": new_params, "fb": state["fb"], "opt": new_opt,
                     "step": state["step"] + 1}
        if hw is not None:
            new_state["hw"] = hw
            device = self.cfg.dfa.photonics.mrr
            # gauges only when the device drifts: a drift-free bank carries a
            # state that stays zero
            if device is not None and device.stateful:
                resid = hw_drift.residual(hw)
                metrics["hw_drift_rms"] = torch.sqrt(torch.mean(torch.square(hw["drift"])))
                metrics["hw_residual_rms"] = torch.sqrt(torch.mean(torch.square(resid)))
                # rings whose uncompensated detuning left the usable range
                thresh = DEAD_RING_FACTOR * device.drift_sigma
                metrics["hw_dead_rings"] = torch.sum(resid.abs() > thresh).to(torch.float32)
        return new_state, metrics

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dispatch(self, state, batch):
        t0 = time.monotonic()
        state, metrics = self._train_step(state, batch)
        if self.cfg.step_deadline_s is not None:
            self._sync()
            dt = time.monotonic() - t0
            if dt > self.cfg.step_deadline_s:
                raise TimeoutError(
                    f"step {state['step']} exceeded deadline "
                    f"({dt:.1f}s > {self.cfg.step_deadline_s}s) — straggler")
        return state, metrics

    def put(self, batch) -> dict:
        """A host batch -> tensors on the trainer's device."""
        return to_device(batch, self.device)

    def step(self, state, batch):
        return self._dispatch(state, self.put(batch))

    # ---------- loop ----------
    def restore_or_init(self, seed: int | None = None):
        """(state, first step): the newest snapshot in ``ckpt_dir``, cast
        onto a fresh state, or the fresh state at step 0."""
        state = self.init_state(seed)
        if self.ckpt is not None:
            restored, step = self.ckpt.restore(state)
            if restored is not None:
                return restored, int(step)
        return state, 0

    def _log(self, step, row):
        if self.cfg.log_path is None:
            return
        if self._log_file is None:
            os.makedirs(os.path.dirname(os.path.abspath(self.cfg.log_path)), exist_ok=True)
            new = not os.path.exists(self.cfg.log_path)
            self._log_file = open(self.cfg.log_path, "a")
            self._log_keys = sorted(row)
            if new:
                self._log_file.write("step," + ",".join(self._log_keys) + "\n")
        self._log_file.write(
            f"{step}," + ",".join(str(row.get(k, "nan")) for k in self._log_keys) + "\n")
        self._log_file.flush()

    @staticmethod
    def to_host(metrics: dict) -> dict:
        """Metrics -> floats with one device-to-host transfer for all the
        tensors, never one blocking ``item()`` per metric."""
        keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
        host = {k: float(v) for k, v in metrics.items() if k not in keys}
        if keys:
            vals = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
            host.update(zip(keys, vals.tolist()))
        return host

    def _make_feed(self, data_fn, total_steps: int):
        if self.cfg.prefetch <= 0:
            return lambda step: self.put(data_fn(step))
        return DevicePrefetcher(data_fn, put_fn=self.put, depth=self.cfg.prefetch,
                                limit=total_steps)

    def fit(self, data_fn, total_steps: int, eval_fn=None, verbose: bool = True):
        """data_fn(step) -> host batch (deterministic — restart-safe).
        Resumes from the newest snapshot in ``ckpt_dir``, saves one every
        ``ckpt_every`` steps and at the end.
        Returns (state, eval_fn(state)) or (state, last metrics)."""
        state, start = self.restore_or_init()
        feed = self._make_feed(data_fn, total_steps)
        metrics = {}
        for step in range(start, total_steps):
            state, metrics = self._dispatch(state, feed(step))
            if (step + 1) % self.cfg.log_every == 0 or step + 1 == total_steps:
                host = self.to_host(metrics)
                self._log(step + 1, host)
                if verbose:
                    txt = " ".join(f"{k}={v:.4f}" for k, v in sorted(host.items()))
                    print(f"[step {step + 1}/{total_steps}] {txt}", flush=True)
            if self.ckpt is not None and (step + 1) % self.cfg.ckpt_every == 0:
                self.ckpt.save(step + 1, state)
        if self.ckpt is not None:
            self.ckpt.save(total_steps, state)
        if eval_fn is not None:
            return state, eval_fn(state)
        return state, metrics

    # ---------- eval ----------
    @torch.no_grad()
    def evaluate(self, state, batches) -> dict:
        total = {}
        n = 0
        for batch in batches:
            _, metrics = self.model.loss(state["params"], self.put(batch))
            for k, v in metrics.items():
                total[k] = total.get(k, 0.0) + v  # accumulated on the device
            n += 1
        return {k: v / max(n, 1) for k, v in self.to_host(total).items()}
