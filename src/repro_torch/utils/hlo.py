"""Collective accounting for the roofline.  Counterpart of
``repro/utils/hlo.py``.

The reference parses its compiled HLO text and sums the operand bytes of
every communication op.  The port runs eagerly, so it reads a record of
the operations a step dispatches instead: ``record()`` is a
``TorchDispatchMode`` that notes every operation by name and every
``torch.distributed`` collective (the c10d ops, and the functional
collectives ``DTensor`` issues) with the bytes of its operand, as the
reference's ``_operand_bytes`` reads them: an all-gather's operand is this
rank's shard, a reduce-scatter's the full-size input, an all-reduce's the
tensor it reduces.  ``analyze_collectives(rec)`` sums them by the
reference's kinds (``_COLLECTIVES``), and ``count_op(rec, name)`` counts an
operation by name (``"mm"``, ``"allreduce_"``).

This is a second count beside ``utils.flop_cost``'s, which the port's own
collective helpers feed (``count_collective``): a collective issued
outside them (a ``DTensor`` redistribute, say) shows here and not there.
The record runs under a ``FakeTensorMode`` too (the dry-run's fake world),
where every operand is a shape without storage.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass, field

import torch

# bytes an element, by the reference's HLO names
_DTYPE_BYTES = {
    "pred": 1,
    "s4": 1,
    "u4": 1,
    "s8": 1,
    "u8": 1,
    "s16": 2,
    "u16": 2,
    "s32": 4,
    "u32": 4,
    "s64": 8,
    "u64": 8,
    "f8e4m3fn": 1,
    "f8e5m2": 1,
    "bf16": 2,
    "f16": 2,
    "f32": 4,
    "f64": 8,
    "c64": 8,
    "c128": 16,
    "token": 0,
}

# the torch dtypes the reference's names stand for
TORCH_NAMES = {
    torch.bool: "pred",
    torch.int8: "s8",
    torch.uint8: "u8",
    torch.int16: "s16",
    torch.uint16: "u16",
    torch.int32: "s32",
    torch.uint32: "u32",
    torch.int64: "s64",
    torch.uint64: "u64",
    torch.float8_e4m3fn: "f8e4m3fn",
    torch.float8_e5m2: "f8e5m2",
    torch.bfloat16: "bf16",
    torch.float16: "f16",
    torch.float32: "f32",
    torch.float64: "f64",
    torch.complex64: "c64",
    torch.complex128: "c128",
}

_COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
    "collective-broadcast",
    "ragged-all-to-all",
)

# dispatched collective -> (kind, index of its operand among the arguments)
_OPS = {
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::allreduce_coalesced_": ("all-reduce", 0),
    "c10d::_allgather_base_": ("all-gather", 1),
    "c10d::allgather_": ("all-gather", 1),
    "c10d::allgather_coalesced_": ("all-gather", 1),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d::reduce_scatter_": ("reduce-scatter", 1),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d::alltoall_": ("all-to-all", 1),
    "c10d::alltoall_base_": ("all-to-all", 1),
    "c10d::broadcast_": ("collective-broadcast", 0),
    "c10d::send": ("collective-permute", 0),
    "_c10d_functional::all_reduce": ("all-reduce", 0),
    "_c10d_functional::all_reduce_": ("all-reduce", 0),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional::reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "_c10d_functional::all_to_all_single": ("all-to-all", 0),
    "_c10d_functional::broadcast": ("collective-broadcast", 0),
}


def shape_bytes(dtype, dims) -> int:
    """Bytes of a ``dims``-shaped array of ``dtype``: a torch dtype or one of
    the reference's names, and a shape or the reference's "a,b,c" text.
    An unknown dtype counts 0, as in the reference."""
    name = TORCH_NAMES.get(dtype) if isinstance(dtype, torch.dtype) else dtype
    nbytes = _DTYPE_BYTES.get(name)
    if nbytes is None:
        return 0
    if isinstance(dims, str):
        dims = [int(d) for d in dims.split(",")] if dims else []
    n = 1
    for d in dims:
        n *= int(d)
    return n * nbytes


def tensor_bytes(x) -> int:
    """Bytes of every tensor in ``x`` (a tensor, or lists of them)."""
    if isinstance(x, torch.Tensor):
        return shape_bytes(x.dtype, tuple(x.shape))
    if isinstance(x, (list, tuple)):
        return sum(tensor_bytes(v) for v in x)
    return 0


@dataclass
class CollectiveStats:
    """Per-kind byte and instance counts of one step's record."""

    bytes_by_kind: dict = field(default_factory=lambda: defaultdict(int))
    count_by_kind: dict = field(default_factory=lambda: defaultdict(int))
    instances: list = field(default_factory=list)  # (kind, bytes, op name)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def summary(self) -> str:
        rows = [
            f"  {kind:24s} n={self.count_by_kind[kind]:4d} bytes={self.bytes_by_kind[kind]:.3e}"
            for kind in sorted(self.bytes_by_kind)
        ]
        rows.append(f"  {'TOTAL':24s} n={self.total_count:4d} bytes={self.total_bytes:.3e}")
        return "\n".join(rows)


@dataclass
class Record:
    """What ``record`` saw: every operation's count by name
    (``"aten::mm"``, ``"c10d::allreduce_"``) and each collective as (kind,
    operand bytes, op name), in order."""

    ops: Counter = field(default_factory=Counter)
    collectives: list = field(default_factory=list)

    def lines(self) -> list:
        """One text line a collective, the file the dry-run's
        ``--hlo-dir`` keeps."""
        return [f"{kind} {nbytes} {op}" for kind, nbytes, op in self.collectives]


def _op_name(func) -> str:
    return func._schema.name if hasattr(func, "_schema") else str(func)


def record():
    """A dispatch mode that notes every operation in a ``Record`` (its
    ``rec``); enter it around a step: ``with hlo.record() as mode: ...``,
    then ``mode.rec``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.rec = Record()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = _op_name(func)
            self.rec.ops[name] += 1
            kind = _OPS.get(name)
            if kind is not None:
                self.rec.collectives.append((kind[0], tensor_bytes(args[kind[1]]), name))
            return func(*args, **(kwargs or {}))

    return _Recorder()


def analyze_collectives(rec: Record) -> CollectiveStats:
    """The record's collectives summed by kind (the reference's
    ``analyze_collectives`` over an HLO module)."""
    stats = CollectiveStats()
    for kind, nbytes, op in rec.collectives:
        stats.bytes_by_kind[kind] += nbytes
        stats.count_by_kind[kind] += 1
        stats.instances.append((kind, nbytes, op))
    return stats


def count_op(rec: Record, op_name: str) -> int:
    """How many times the step dispatched ``op_name`` (with or without its
    namespace: "mm" counts "aten::mm")."""
    if "::" in op_name:
        return rec.ops.get(op_name, 0)
    return sum(n for name, n in rec.ops.items() if name.split("::")[-1] == op_name)
