"""Architecture registry plumbing.  Counterpart of ``repro/configs/base.py``:
every arch registers an ``Arch`` with a full-size model factory and a
reduced smoke-test factory, each taking ``(dtype, device)``, and its
modality extras (``input_extras``: the frontend stubs' inputs as tensors on
the meta device, the reference's ``ShapeDtypeStruct``s)."""

from __future__ import annotations

import dataclasses
import typing

import torch


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str  # dense | moe | ssm | vlm | hybrid | audio
    make_model: typing.Callable  # (dtype, device) -> model, full public config
    make_smoke: typing.Callable  # (device) -> model, reduced same-family config
    source: str = ""
    notes: str = ""

    def input_extras(self, batch: int, kind: str, dtype=torch.bfloat16) -> dict:
        """Arch-specific extra inputs (modality-frontend stubs) as meta
        tensors.  kind: train | prefill | decode."""
        del batch, kind, dtype
        return {}
