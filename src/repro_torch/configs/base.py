"""Architecture registry plumbing.  Counterpart of ``repro/configs/base.py``:
every arch registers an ``Arch`` with a full-size model factory and a
reduced smoke-test factory, each taking ``(dtype, device)``, and its
modality extras (``input_extras``: the frontend stubs' inputs as tensors on
the meta device, the reference's ``ShapeDtypeStruct``s), and the dry-run's
input shapes (``ShapeCase``, ``SHAPES``, ``token_specs``).  ``make_opt`` is
the dry-run's ``opt`` variant (None: the arch has none),
``sub_quadratic`` whether its ``long_500k`` decode runs, ``has_decoder``
whether it serves at all (the paper's MLP does not)."""

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
    make_opt: typing.Callable | None = None  # (dtype, device) -> the optimised variant
    sub_quadratic: bool = False  # long_500k runnable?
    has_decoder: bool = True
    source: str = ""
    notes: str = ""

    def input_extras(self, batch: int, kind: str, dtype=torch.bfloat16) -> dict:
        """Arch-specific extra inputs (modality-frontend stubs) as meta
        tensors.  kind: train | prefill | decode."""
        del batch, kind, dtype
        return {}


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCase] = {
    "train_4k": ShapeCase("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCase("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCase("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCase("long_500k", "decode", 524288, 1),
}


def token_specs(batch: int, seq: int) -> dict:
    """The token inputs of a (batch, seq) case as meta tensors (int64, the
    port's token dtype; the reference's are int32 shape structs)."""
    return {
        "tokens": torch.empty((batch, seq), dtype=torch.int64, device="meta"),
        "labels": torch.empty((batch, seq), dtype=torch.int64, device="meta"),
    }
