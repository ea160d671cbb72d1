"""``repro_torch.api`` — the facade over the (model, hardware, backend)
cell, serving half.  Counterpart of ``repro/api.py``.

Slice 1 ports serving: ``build_session`` accepts ``algo="bp"`` only (the
forward-only cell the serve launcher builds), and ``Session.engine()``
opens a continuous-batching ``serve.Engine`` whose forward projections run
on the session's photonic backend.  Training (``fit``, the DFA algorithms,
the schedule autotuner, observability) comes with later slices.

Typical use::

    from repro_torch import api

    session = api.build_session(arch="qwen1.5-0.5b", smoke=False,
                                hardware="offchip_bpd", backend="cuda")
    engine = session.engine(batch_slots=4, max_len=128)
"""

from __future__ import annotations

import dataclasses
import typing

import torch

from repro_torch import configs
from repro_torch.core import photonics
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
    """A bound (model, hardware, backend) cell."""

    model: typing.Any
    photonics: photonics.PhotonicConfig
    backend: typing.Any

    def engine(self, params=None, *, batch_slots: int = 8, max_len: int = 512,
               eos_id: int | None = None, prefill_chunk: int = 16,
               seed: int = 0):
        """A ``serve.Engine`` on this session's (hardware, backend) cell.

        ``params``: a state dict loaded into the model; None draws fresh
        weights from ``seed``, as the reference's ``model.init(key)``.
        Backend rules as the reference's: a backend instance serves as
        "ref" (the reference maps any non-string backend to "ref"), "auto"
        with photonics enabled serves "ref", and disabled photonics serve
        the exact digital forward."""
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
                      eos_id=eos_id, prefill_chunk=prefill_chunk, backend=backend,
                      photonics=hw_cfg if backend is not None else None, seed=seed)


def build_session(*, arch="qwen1.5-0.5b", algo: str = "bp", hardware="ideal",
                  backend="auto", seed: int = 0, smoke: bool = False,
                  dtype=torch.float32, device=None) -> Session:
    """Compose one serving cell: model (built on ``device``, default the
    card), hardware preset or config, and photonic backend."""
    if algo != "bp":
        raise NotImplementedError(
            f"algo={algo!r}: the training algorithms are ported in slice 2; "
            "the serving slice takes algo='bp'")
    photonics.get_backend(backend)  # fail fast on unknown names
    model = build_model(arch, smoke=smoke, dtype=dtype, device=device, seed=seed)
    return Session(model=model, photonics=resolve_hardware(hardware), backend=backend)
