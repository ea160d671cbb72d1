"""Matrix-product FLOPs of one training step: the counterpart, for
``Trainer.step_cost``, of ``flops`` in ``repro/utils/hlo_cost.py``.

The reference walks the optimized HLO of its jitted step and sums the dot
FLOPs (2 · |out| · contracted).  The port runs eagerly, so it counts the
products as they run, with ``torch.utils.flop_counter.FlopCounterMode``,
and adds the hand-written kernels, which the mode cannot see (they are
launched through ``ctypes``): each wrapper calls ``count_launch`` with the
work of its launch, 2·T·K·M from its operands' shapes.  On CPU tensors a
wrapper runs its plain version, which the mode counts, and reports
nothing, so no product is counted twice.

Two rules bring the count to the reference's:

* a product whose operands are the same live tensors (same storage, view
  and version) as an earlier product of the step is counted once, as XLA's
  common-subexpression elimination merges them (the MLP's DFA recomputes
  each block's forward on the very tensors its forward used);
* products whose results nothing reads are not run at all (the DFA engine
  skips the head's input gradient when the error is tapped at the
  logits), as XLA removes dead code.

The reference's HBM-traffic proxy and collective bytes wait for the full
``hlo_cost`` port.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch

_ACTIVE: list = []  # the counters of the measurements under way


def count_launch(flops: int) -> None:
    """Add one hand-written kernel launch of ``flops`` to every measurement
    under way; free when none is."""
    for counter in _ACTIVE:
        counter.kernel_flops += int(flops)
        counter.kernel_launches += 1


@dataclasses.dataclass(frozen=True)
class StepCost:
    """flops: every matrix product of the step; counted_flops: those the
    mode saw; kernel_flops / kernel_launches: the hand-written kernels'."""

    flops: int
    counted_flops: int
    kernel_flops: int
    kernel_launches: int


def _describe(x, roots: list):
    if isinstance(x, torch.Tensor):
        base = x._base if x._base is not None else x
        roots.append(weakref.ref(base))
        return ("tensor", x.device, x.dtype, tuple(x.shape), tuple(x.stride()),
                x.storage_offset(), x.data_ptr(), x._version)
    if isinstance(x, (list, tuple)):
        return tuple(_describe(v, roots) for v in x)
    return repr(x)


class _Counter:
    def __init__(self):
        self.kernel_flops = 0
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


def _dedup_mode():
    from torch.utils.flop_counter import FlopCounterMode

    class DedupFlopCounterMode(FlopCounterMode):
        """``FlopCounterMode`` that counts a product on the same live
        operands once."""

        def __init__(self):
            super().__init__(display=False)
            self.mod_tracker = _GlobalOnly()
            self._seen: dict = {}

        def _count_flops(self, func_packet, out, args, kwargs):
            if func_packet in self.flop_registry:
                roots: list = []
                key = (func_packet, _describe(args, roots),
                       _describe(tuple(sorted(kwargs.items())), roots))
                prev = self._seen.get(key)
                if prev is not None and all(r() is not None for r in prev):
                    return out  # the same product on the same live tensors
                self._seen[key] = roots
            return super()._count_flops(func_packet, out, args, kwargs)

    return DedupFlopCounterMode()


def measure(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once, counting its matrix products ->
    (its result, ``StepCost``)."""
    mode = _dedup_mode()
    counter = _Counter()
    _ACTIVE.append(counter)
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE.remove(counter)
    counted = int(mode.get_total_flops())
    return out, StepCost(flops=counted + counter.kernel_flops, counted_flops=counted,
                         kernel_flops=counter.kernel_flops,
                         kernel_launches=counter.kernel_launches)
