"""The cost of one training step as it runs: matrix-product FLOPs and the
bytes its device operations move.  Counterpart, for ``Trainer.step_cost``,
of ``repro/utils/hlo_cost.py`` (``HloCost``, ``analyze``).

The reference walks the optimized HLO of its jitted step.  The port runs
eagerly, so it counts the operations as they run, under
``torch.utils.flop_counter.FlopCounterMode``, and adds the hand-written
kernels, which the mode cannot see (they are launched through ``ctypes``):
each wrapper calls ``count_launch`` with its launch's work, 2·T·K·M from
its operands' shapes (2·E·T·K·M for a batched launch of E products), and
its bytes from the kernel's own helper (``launch_bytes`` in
``kernels/photonic_matmul.py``, ``kernels/dfa_gradient.py`` and
``kernels/emu_matmul.py``: each operand read once, the output written
once).  On CPU tensors a wrapper runs its plain version, whose operations
the mode counts, and reports nothing, so nothing is counted twice; a
photonic step's ``mem_bytes`` on the CPU is therefore its plain versions'
traffic, not the card's.

FLOPs.  Two rules bring the count to the reference's:

* a product whose operands are the same live tensors (same storage, view
  and version) as an earlier product of the step is counted once, as XLA's
  common-subexpression elimination merges them (the MLP's DFA recomputes
  each block's forward on the very tensors its forward used);
* products whose results nothing reads are not run at all (the DFA engine
  skips the head's input gradient when the error is tapped at the
  logits), as XLA removes dead code.

Bytes (``mem_bytes``, the reference's HBM-traffic proxy): the operand
bytes plus the output bytes of every operation the step runs on its
device, plus the kernels' bytes.

* An operation whose output aliases an input moves nothing and counts 0:
  views, reshapes that alias, ``detach``, ``t``, ``expand`` and the like,
  and allocations (``empty``), which write nothing.  They stand where the
  reference's ``_BOOKKEEPING`` ops (parameter, bitcast, tuple, ...) stand.
  An in-place operation writes its input and counts it as read and written;
  one that overwrites its destination (``copy_``, ``fill_``, ``zero_``, the
  in-place random fills) counts the destination as written only, as does
  an ``out=`` operand.
* An operand counts the elements it spans in memory: the fewer of its
  extent and its distinct elements, so a stride-0 broadcast counts its
  stored elements once.
* Eager mode writes every intermediate to memory, where XLA keeps a
  fusion's intermediates on-core, so a step's count lies above the
  reference's for the same step.
* Where any operation ran on a card, host-side (CPU) operations of the
  step are left out.

Loops need no trip-count parsing (the reference's ``known_trip_count`` and
loop-condition constants): a Python loop of N products runs, and is
counted, N times.  Collective bytes come with sharding: ``collective_bytes``
is 0 here.
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import torch

_ACTIVE: list = []  # the counters of the measurements under way

# operations that allocate without writing: nothing moves
_ALLOCATE = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                       "new_empty_strided", "resize_"})
# in-place operations that overwrite their first operand without reading it
_OVERWRITE = frozenset({"copy_", "fill_", "zero_", "normal_", "uniform_", "bernoulli_",
                        "exponential_", "random_"})


def count_launch(flops: int, nbytes: int) -> None:
    """Add one hand-written kernel launch of ``flops`` moving ``nbytes`` to
    every measurement under way; free when none is."""
    for counter in _ACTIVE:
        counter.kernel_flops += int(flops)
        counter.kernel_bytes += int(nbytes)
        counter.kernel_launches += 1


@dataclasses.dataclass(frozen=True)
class StepCost:
    """flops: every matrix product of the step; counted_flops: those the
    mode saw; kernel_flops / kernel_launches / kernel_bytes: the
    hand-written kernels'; mem_bytes: every device operation's operand and
    output bytes, the kernels' included."""

    flops: int
    counted_flops: int
    kernel_flops: int
    kernel_launches: int
    mem_bytes: int = 0
    kernel_bytes: int = 0

    def as_dict(self) -> dict:
        """The reference's ``HloCost.as_dict`` keys; no collectives yet."""
        return {"flops": float(self.flops), "mem_bytes": float(self.mem_bytes),
                "collective_bytes": 0.0, "coll_bytes_by_kind": {}}


def _describe(x, roots: list):
    if isinstance(x, torch.Tensor):
        base = x._base if x._base is not None else x
        roots.append(weakref.ref(base))
        return ("tensor", x.device, x.dtype, tuple(x.shape), tuple(x.stride()),
                x.storage_offset(), x.data_ptr(), x._version)
    if isinstance(x, (list, tuple)):
        return tuple(_describe(v, roots) for v in x)
    return repr(x)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def span_bytes(x: torch.Tensor) -> int:
    """Bytes of the elements ``x`` spans in memory: the fewer of its extent
    and its distinct (nonzero-stride) elements."""
    if x.numel() == 0:
        return 0
    extent = 1 + sum((n - 1) * abs(s) for n, s in zip(x.shape, x.stride()))
    distinct = math.prod(n for n, s in zip(x.shape, x.stride()) if s != 0)
    return min(extent, distinct) * x.element_size()


def _storage(x):
    return x.untyped_storage().data_ptr() if x.numel() else None


def op_bytes(name: str, out, args, kwargs) -> int:
    """Operand plus output bytes of one operation (0 for an alias)."""
    if name in _ALLOCATE:
        return 0
    inputs = list(_tensors((args, kwargs)))
    outputs = list(_tensors(out))
    stored = {_storage(x) for x in inputs} - {None}
    for y in outputs:
        if not any(y is x for x in inputs) and _storage(y) in stored:
            return 0  # a view of an input
    written = list(_tensors(kwargs.get("out")))  # an out= operand is written only
    reads = [x for x in (inputs[1:] if name in _OVERWRITE else inputs)
             if not any(x is w for w in written)]
    return sum(span_bytes(x) for x in reads) + sum(span_bytes(y) for y in outputs)


class _Counter:
    def __init__(self):
        self.kernel_flops = 0
        self.kernel_bytes = 0
        self.kernel_launches = 0


class _GlobalOnly:
    """Stands in for ``FlopCounterMode``'s module tracker: the count is one
    total, and the tracker's backward hooks on module outputs break
    ``torch.autograd.grad`` over leaves, which the DFA engine calls."""

    parents = ("Global",)

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return None


def _counting_mode():
    from torch.utils.flop_counter import FlopCounterMode

    class CostMode(FlopCounterMode):
        """``FlopCounterMode`` that counts a product on the same live
        operands once, and every operation's bytes."""

        def __init__(self):
            super().__init__(display=False)
            self.mod_tracker = _GlobalOnly()
            self._seen: dict = {}
            self.device_bytes = 0
            self.host_bytes = 0

        def _count_flops(self, func_packet, out, args, kwargs):
            name = func_packet._qualified_op_name.split("::")[-1]
            nbytes = op_bytes(name, out, args, kwargs)
            if any(x.device.type != "cpu" for x in _tensors((out, args, kwargs))):
                self.device_bytes += nbytes
            else:
                self.host_bytes += nbytes
            if func_packet in self.flop_registry:
                roots: list = []
                key = (func_packet, _describe(args, roots),
                       _describe(tuple(sorted(kwargs.items())), roots))
                prev = self._seen.get(key)
                if prev is not None and all(r() is not None for r in prev):
                    return out  # the same product on the same live tensors
                self._seen[key] = roots
            return super()._count_flops(func_packet, out, args, kwargs)

    return CostMode()


def measure(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once, counting its matrix products and
    its bytes -> (its result, ``StepCost``)."""
    mode = _counting_mode()
    counter = _Counter()
    _ACTIVE.append(counter)
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE.remove(counter)
    counted = int(mode.get_total_flops())
    on_card = mode.device_bytes or counter.kernel_launches
    ops_bytes = mode.device_bytes if on_card else mode.host_bytes
    return out, StepCost(flops=counted + counter.kernel_flops, counted_flops=counted,
                         kernel_flops=counter.kernel_flops,
                         kernel_launches=counter.kernel_launches,
                         mem_bytes=ops_bytes + counter.kernel_bytes,
                         kernel_bytes=counter.kernel_bytes)
