"""Architecture registry plumbing.  Counterpart of ``repro/configs/base.py``:
every arch registers an ``Arch`` with a full-size model factory and a
reduced smoke-test factory, each taking ``(dtype, device)``."""

from __future__ import annotations

import dataclasses
import typing


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str  # dense | moe | ssm | vlm | hybrid | audio
    make_model: typing.Callable  # (dtype, device) -> model, full public config
    make_smoke: typing.Callable  # (device) -> model, reduced same-family config
    source: str = ""
    notes: str = ""
