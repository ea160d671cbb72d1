"""``repro_torch.api`` — the one-call facade over the algorithm × hardware ×
backend matrix.  Counterpart of ``repro/api.py``.

* **algo**     — a name in ``repro_torch.algos`` (``bp`` | ``dfa`` |
  ``dfa-fused`` | ``dfa-layerwise``)
* **hardware** — a ``core.photonics`` preset name or a ``PhotonicConfig``
* **backend**  — how projections execute: ``auto`` | ``ref`` | ``cuda`` |
  ``emu`` (device-level emulation, with drift and in-situ recalibration
  under the trainer), or a ``PhotonicBackend`` instance

Typical use::

    from repro_torch import api
    from repro_torch.data import tokens

    session = api.build_session(arch="mnist_mlp", algo="dfa",
                                hardware="offchip_bpd", backend="cuda")
    state, metrics = session.fit(data_fn, total_steps=512)
    session.evaluate(state, eval_batches)

    lm = api.build_session(arch="qwen1.5-0.5b", smoke=False, algo="dfa",
                           hardware="offchip_bpd", backend="cuda", ckpt_dir="runs/qwen")
    state, metrics = lm.fit(tokens.MarkovTokens(151936, 64, 64).batch, total_steps=16)
    engine = lm.engine(state["params"], batch_slots=4, max_len=128)  # serve them

    emulated = api.build_session(arch="mnist_mlp", hardware="emu_onchip",
                                 backend="emu")  # drift on, recalibration every 500

The defaults are the reference's: the paper's MLP trained with DFA on ideal
hardware, SGD momentum 0.9 at lr 0.01 (the paper's §4 optimizer).  Every
session runs on the card unless ``device="cpu"`` is asked for, and raises
where CUDA is absent.  Every model trains (with checkpoint and
auto-resume under ``ckpt_dir``) and the language models serve as well.
``observe=`` / ``Session.observe`` attach an ``obs.Observer`` that
``fit`` and ``engine`` pick up, ``probe_every=`` samples DFA-vs-BP
alignment during ``fit`` and ``debug_checks=`` arms the runtime
sanitizers.  ``n_buses=`` sets the chip's WDM bus count, and
``schedule="auto"`` runs the ``sim`` autotuner on the model's DFA backward
(under ``power_budget_w=``; with ``recalibrate_every="auto"`` it picks the
recalibration cadence too) and trains on the schedule it picks::

    tuned = api.build_session(arch="qwen1.5-0.5b", smoke=False, hardware="emu_onchip",
                              backend="emu", schedule="auto", power_budget_w=78.0,
                              recalibrate_every="auto", schedule_batch=4096)
    tuned.schedule.describe()  # n_buses=2 ... recal@100: the modelled chip's step

The reference's data parallelism is ported in a later slice.
"""

from __future__ import annotations

import dataclasses
import typing

import torch

from repro_torch import algos, configs
from repro_torch import obs as obs_lib
from repro_torch.algos.dfa import DFAConfig
from repro_torch.core import feedback as fb_lib
from repro_torch.core import photonics
from repro_torch.models.base import DFAModel
from repro_torch.train import SGDM, Trainer, TrainerConfig
from repro_torch.utils.device import resolve_device


def resolve_hardware(hardware) -> photonics.PhotonicConfig:
    """Preset name or PhotonicConfig -> PhotonicConfig."""
    if isinstance(hardware, photonics.PhotonicConfig):
        return hardware
    return photonics.preset(hardware)


def build_model(arch, *, smoke: bool = False, dtype=torch.float32, device=None,
                seed: int = 0):
    """Arch name or a model instance -> model.  A named arch is built on
    ``device`` (default: the card) with weights drawn from ``seed``; on the
    ``meta`` device nothing is allocated or drawn."""
    if not isinstance(arch, str):
        return arch  # already a model
    device = resolve_device(device)
    a = configs.get(arch)
    model = a.make_smoke(device=device) if smoke else a.make_model(dtype, device=device)
    if device.type != "meta":
        model.init(seed)
    return model


@dataclasses.dataclass
class Session:
    """A bound (model, algorithm, hardware, backend) cell of the matrix.
    ``trainer`` is None for a model that is not a ``DFAModel`` (serving
    only)."""

    model: typing.Any
    algorithm: algos.Algorithm
    config: TrainerConfig
    trainer: Trainer | None = None
    # the bound obs.Observer when built with observe=... (or attached later
    # with Session.observe()); None means observability is off
    observer: typing.Any = None
    # the sim.TunedSchedule the session runs on (schedule="auto"), else None
    schedule: typing.Any = None

    @property
    def photonics(self) -> photonics.PhotonicConfig:
        return self.config.dfa.photonics

    @property
    def backend(self):
        return self.config.dfa.backend

    def _trainer(self) -> Trainer:
        if self.trainer is None:
            raise TypeError(f"{type(self.model).__name__} is not a DFAModel: it serves only")
        return self.trainer

    # ---- observability ----
    def observe(self, *, metrics_path: str | None = None, trace_path: str | None = None):
        """Attach (and return) an ``obs.Observer`` wired for this session:
        a hardware monitor on drifting emu hardware, an optional JSONL
        metrics sink and a trace path written on ``close()``.  ``fit`` and
        ``engine`` pick it up."""
        self.observer = obs_lib.for_session(self, metrics_path=metrics_path,
                                            trace_path=trace_path)
        return self.observer

    # ---- training ----
    def init_state(self, seed: int | None = None):
        return self._trainer().init_state(seed)

    def step(self, state, batch):
        return self._trainer().step(state, batch)

    def fit(self, data_fn, total_steps: int, eval_fn=None, verbose: bool = True,
            timer=None, observer=None):
        """Run the training loop.  ``timer``: an optional
        ``bench.StepTimer``; ``observer``: an ``obs.Observer`` (default: the
        session's)."""
        return self._trainer().fit(data_fn, total_steps, eval_fn=eval_fn, verbose=verbose,
                                   timer=timer, observer=observer if observer is not None
                                   else self.observer)

    def step_cost(self, state, batch):
        """Matrix-product FLOPs of one train step (``utils.flop_cost``)."""
        return self._trainer().step_cost(state, batch)

    # ---- gradients / eval ----
    def value_and_grad(self):
        """fn(params, extra_state, batch, rng) -> ((loss, metrics), grads)."""
        self._trainer()
        return self.algorithm.value_and_grad(self.model, self.config.dfa)

    def fused_step(self, optimizer=None):
        """Memory-optimised step (algorithm-specific; generic fallback)."""
        self._trainer()
        return self.algorithm.fused_step(self.model, self.config.dfa,
                                         optimizer or self.config.optimizer)

    def evaluate(self, state, batches) -> dict:
        return self._trainer().evaluate(state, batches)

    # ---- serving ----
    def engine(self, params=None, *, batch_slots: int = 8, max_len: int = 512,
               eos_id: int | None = None, prefill_chunk: int = 16,
               hw_state=None, seed: int = 0, observer=None):
        """A ``serve.Engine`` on this session's (hardware, backend) cell.

        ``params``: a state dict loaded into the model; None draws fresh
        weights from ``seed``, as the reference's ``model.init(key)``.
        Backend rules as the reference's: a backend instance serves as
        "ref" (the reference maps any non-string backend to "ref"), "auto"
        with photonics enabled serves "ref", and disabled photonics serve
        the exact digital forward.  ``emu`` serves through the same emulated
        banks training used; ``hw_state`` is their drift state (default: a
        freshly calibrated chip).  ``observer`` (default: the session's)
        traces the requests and ticks; the session's ``debug_checks`` carry
        over."""
        from repro_torch.serve import Engine

        if params is None:
            self.model.init(seed)
        else:
            self.model.load_state_dict(params)
        hw_cfg = self.photonics
        backend = self.backend
        if not isinstance(backend, str):
            backend = "ref"
        if backend == "auto" and hw_cfg.enabled:
            backend = "ref"
        if not hw_cfg.enabled:
            backend = None
        return Engine(self.model, batch_slots=batch_slots, max_len=max_len,
                      # lint: disable=RL001 init folds parameter names, the engine ticks
                      eos_id=eos_id, prefill_chunk=prefill_chunk, backend=backend,
                      photonics=hw_cfg if backend is not None else None,
                      hw_state=hw_state, seed=seed,
                      observer=observer if observer is not None else self.observer,
                      debug_checks=self.config.debug_checks)


def build_session(*, arch="mnist_mlp", algo: str = "dfa", hardware="ideal",
                  backend="auto", emu_kernel: str | None = None, optimizer=None,
                  seed: int = 0, smoke: bool = False,
                  dtype=torch.float32, error_compress: str = "none",
                  freeze_norms: bool = False,
                  feedback: fb_lib.FeedbackConfig | None = None,
                  n_buses: int | None = None, schedule: str | None = None,
                  power_budget_w: float | None = None,
                  schedule_batch: int | None = None,
                  microbatches: int = 1, prefetch: int = 2,
                  digital_step_s: float | None = None,
                  recalibrate_every: int | str | None = None, ckpt_dir: str | None = None,
                  ckpt_every: int = 500, log_every: int = 50,
                  log_path: str | None = None, step_deadline_s: float | None = None,
                  observe=False, probe_every: int | None = None,
                  debug_checks: bool = False, device=None) -> Session:
    """Compose one cell of the algorithm × hardware × backend matrix, on
    ``device`` (default: the card).

    ``emu_kernel`` ("auto" | "ref" | "cuda") picks the emu backend's
    execution path for the whole session and requires ``backend="emu"``.
    ``recalibrate_every`` defaults to 500 steps when the device drifts and
    to 0 (never) otherwise.

    ``n_buses`` overrides the preset's WDM bus count.  ``schedule="auto"``
    searches (n_buses, f_s) with ``sim.autotune`` on this model's DFA
    backward at ``schedule_batch`` vectors a step (default 64) under
    ``power_budget_w``, overlapping ``digital_step_s`` (a measured step
    time), and runs the session on the winner (``Session.schedule``); a
    pinned ``n_buses`` narrows the search to that count.  Only the
    "panel" tiling, the layout the emulator runs, is searched.  With
    ``recalibrate_every="auto"`` the cadence is searched too, under a
    drift budget of half the device's stationary drift σ.  The budget
    arguments without ``schedule="auto"`` raise ValueError: they would
    enforce nothing.  ``ckpt_dir``: ``fit`` resumes from the newest
    snapshot there and saves one every ``ckpt_every`` steps and at the end.
    A model that is not a ``DFAModel`` (an instance passed as ``arch``)
    gets no trainer and serves with ``algo="bp"`` only.

    ``observe``: False (default) runs without observability; True attaches
    a session-wired ``obs.Observer``; an ``Observer`` instance is taken as
    given.  ``probe_every``: every this many steps ``fit`` runs the
    ``obs.introspect.AlignmentProbe`` (None keeps training bit-identical
    to an unprobed run anyway).  ``debug_checks``: every train step (and
    any ``session.engine()``) runs under the ``lint.runtime``
    sanitizers."""
    device = resolve_device(device)
    algorithm = algos.get(algo)  # fail fast on unknown names
    backend_obj = photonics.get_backend(backend)  # (likewise for the backend)
    if emu_kernel is not None:
        if not isinstance(backend_obj, photonics.EmulatedMRRBackend):
            raise ValueError(f"emu_kernel={emu_kernel!r} requires backend='emu', "
                             f"got {backend_obj.name!r}")
        from repro_torch.hardware.channel import resolve_emu_kernel

        resolve_emu_kernel(emu_kernel)  # fail fast on unknown names
        backend = backend_obj = dataclasses.replace(backend_obj, emu_kernel=emu_kernel)
    if schedule not in (None, "auto"):
        raise ValueError(f"unknown schedule {schedule!r} (None | 'auto')")
    if schedule is None and (power_budget_w is not None or schedule_batch is not None
                             or digital_step_s is not None or recalibrate_every == "auto"):
        # these only steer the autotuner: without it they would enforce nothing
        raise ValueError("power_budget_w/schedule_batch/digital_step_s/"
                         "recalibrate_every='auto' require schedule='auto'")
    hw_cfg = resolve_hardware(hardware)
    if n_buses is not None:
        hw_cfg = dataclasses.replace(hw_cfg, n_buses=n_buses)
    if backend_obj.stateful_hardware and hw_cfg.mrr is None:
        # a device-level backend on an abstract preset: attach the default
        # device (drift on) so the emulation has a bank (before the
        # schedule search, so the autotuner sees the device too)
        from repro_torch.hardware.mrr import MRRConfig

        hw_cfg = dataclasses.replace(hw_cfg, mrr=MRRConfig())
    model = build_model(arch, smoke=smoke, dtype=dtype, device=device, seed=seed)
    tuned = None
    if schedule == "auto":
        hw_cfg, tuned = _autotune(model, hw_cfg, n_buses, power_budget_w, schedule_batch,
                                  digital_step_s, recalibrate_every == "auto")
        if recalibrate_every == "auto":
            recalibrate_every = tuned.recalibrate_every
    if recalibrate_every is None:
        drifting = (backend_obj.stateful_hardware and hw_cfg.mrr is not None
                    and hw_cfg.mrr.stateful)
        recalibrate_every = 500 if drifting else 0
    trainable = isinstance(model, DFAModel)
    if not trainable and algo != "bp":
        raise TypeError(f"algo={algo!r} on {type(model).__name__}, which is not a DFAModel: "
                        "it serves only, with algo='bp'")
    cfg = TrainerConfig(
        # lint: disable=RL001 init folds parameter names, the trainer (step, name)
        algo=algo,
        dfa=DFAConfig(photonics=hw_cfg,
                      feedback=feedback or fb_lib.FeedbackConfig(),
                      error_compress=error_compress, backend=backend,
                      freeze_norms=freeze_norms),
        optimizer=optimizer or SGDM(lr=0.01, momentum=0.9),
        seed=seed, microbatches=microbatches, prefetch=prefetch,
        recalibrate_every=recalibrate_every, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
        log_every=log_every, log_path=log_path, step_deadline_s=step_deadline_s,
        probe_every=probe_every, debug_checks=debug_checks)
    trainer = Trainer(model, cfg, device=device) if trainable else None
    session = Session(model=model, algorithm=algorithm, config=cfg, trainer=trainer,
                      schedule=tuned)
    if observe is True:
        session.observe()
    elif observe:
        session.observer = observe
    return session


def _autotune(model, hw_cfg, n_buses, power_budget_w, schedule_batch, digital_step_s,
              tune_recal: bool):
    """``sim.autotune`` on ``model``'s DFA backward at ``schedule_batch``
    vectors a step (relative ranking is batch-insensitive: fills and heater
    epilogues amortise) -> (the tuned config, the ``TunedSchedule``).  Only
    the "panel" tiling is searched: it is the layout the emulator runs, so
    the applied (n_buses, f_s) is optimal for the schedule the session
    really runs.  ``tune_recal`` co-searches the recalibration cadence under
    a drift budget of half the stationary drift (the regime where drift
    recovery keeps DFA training)."""
    from repro_torch import sim

    workload = sim.dfa_backward_workload(model, t=schedule_batch or 64)
    bus_counts = (n_buses,) if n_buses is not None else sim.DEFAULT_BUS_COUNTS
    recal_candidates, drift_budget = (0,), None
    if tune_recal:
        recal_candidates = sim.DEFAULT_RECAL_CANDIDATES
        if hw_cfg.mrr is not None and hw_cfg.mrr.drift_sigma > 0:
            drift_budget = 0.5 * hw_cfg.mrr.drift_sigma
    tuned = sim.autotune(workload, hw_cfg, power_budget_w=power_budget_w,
                         bus_counts=bus_counts, tilings=("panel",),
                         digital_s=digital_step_s or 0.0,
                         recal_candidates=recal_candidates, drift_budget=drift_budget)
    return tuned.apply(hw_cfg), tuned
