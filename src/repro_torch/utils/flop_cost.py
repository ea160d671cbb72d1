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
counted, N times.

Collectives (the reference's ``utils/hlo.py`` kinds ``all-reduce``,
``all-gather`` and ``reduce-scatter``): the port's own collective helpers
(``dist.sharding``'s mean all-reduce, the FSDP gather and its
reduce-scatter, the model-axis operators of tensor parallelism,
``core.photonics``' row and column windows' MAX) call
``count_collective`` with each collective's operand bytes, as the
reference's ``_operand_bytes`` reads them from the HLO: an all-gather's
operand is this rank's shard, a reduce-scatter's the full-size input, an
all-reduce's the tensor it reduces, each counted once per rank.  A step on
one process issues none and counts 0.  The operations a collective's
backend dispatches to carry it out (``collective``) are not counted as the
step's device traffic.

Regions: ``region(name, fn, x)`` runs ``fn(x)`` and adds the FLOPs of the
products it runs, in the forward and, through two identity autograd nodes
at its input and output, in its backward, to ``StepCost.region_flops``
under ``name`` as well (a mixture of experts' expert products, which
expert parallelism divides over the ranks; the dense layers' products,
which the column-parallel split divides: ``nn/linear.Linear.region``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref

import torch

_ACTIVE: list = []  # the counters of the measurements under way
_COLLECTIVE: list = []  # the collectives under way (``collective``)
_REGIONS: list = []  # the names of the regions whose products run now

# operations that allocate without writing: nothing moves
_ALLOCATE = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                       "new_empty_strided", "resize_"})
# metadata queries a fake tensor dispatches (a real one answers them without
# a dispatch): nothing moves
_METADATA = frozenset({"device", "dim", "size", "stride", "numel", "layout", "sym_size",
                       "sym_stride", "sym_numel", "sym_storage_offset", "is_contiguous",
                       "is_strides_like_format", "is_non_overlapping_and_dense"})
# in-place operations that overwrite their first operand without reading it
_OVERWRITE = frozenset({"copy_", "fill_", "zero_", "normal_", "uniform_", "bernoulli_",
                        "exponential_", "random_"})


@contextlib.contextmanager
def collective(kind: str, nbytes: int):
    """Run one collective of ``kind`` on an operand of ``nbytes`` in the
    block, counted as ``count_collective`` counts it; the operations its
    backend dispatches to carry it out (gloo's copies) are the transport's,
    not the step's device traffic, and are not counted."""
    _COLLECTIVE.append(kind)
    try:
        yield
    finally:
        _COLLECTIVE.pop()
    count_collective(kind, nbytes)


def count_collective(kind: str, nbytes: int) -> None:
    """Add one collective of ``kind`` ("all-reduce", "all-gather",
    "reduce-scatter") on an operand of ``nbytes`` to every measurement under
    way; free when none is."""
    for counter in _ACTIVE:
        counter.coll_bytes[kind] = counter.coll_bytes.get(kind, 0) + int(nbytes)
        counter.coll_count[kind] = counter.coll_count.get(kind, 0) + 1


def count_launch(flops: int, nbytes: int) -> None:
    """Add one hand-written kernel launch of ``flops`` moving ``nbytes`` to
    every measurement under way; free when none is."""
    for counter in _ACTIVE:
        counter.kernel_flops += int(flops)
        counter.kernel_bytes += int(nbytes)
        counter.kernel_launches += 1


class _RegionEdge(torch.autograd.Function):
    """Identity; its backward opens a region (at the region's output) or
    closes it (at its input)."""

    @staticmethod
    def forward(ctx, x, name, opening):
        ctx.name, ctx.opening = name, opening
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.opening:
            _REGIONS.append(ctx.name)
        elif ctx.name in _REGIONS:
            _REGIONS.remove(ctx.name)
        return g, None, None


def region(name: str, fn, x):
    """``fn(x)``, its products' FLOPs, forward and backward, also counted
    under ``name`` by every measurement under way; ``fn(x)`` alone when
    none is.

    The backward count opens the region at the output's edge and closes
    it at the input's, so it assumes the autograd engine runs the region's
    own nodes between the two and no other product: true of ``fn`` a chain
    from ``x`` to its output, which the engine runs in sequence-number
    order (the experts between the dispatch and the combine).  A backward
    that never reaches the input's edge leaves the region open until
    ``measure`` ends."""
    if not _ACTIVE:
        return fn(x)
    track = torch.is_grad_enabled() and x.requires_grad
    if track:
        x = _RegionEdge.apply(x, name, False)
    _REGIONS.append(name)
    try:
        y = fn(x)
    finally:
        _REGIONS.remove(name)
    return _RegionEdge.apply(y, name, True) if track else y


@dataclasses.dataclass(frozen=True)
class StepCost:
    """flops: every matrix product of the step; counted_flops: those the
    mode saw; kernel_flops / kernel_launches / kernel_bytes: the
    hand-written kernels'; mem_bytes: every device operation's operand and
    output bytes, the kernels' included; coll_bytes_by_kind /
    coll_count_by_kind: the operand bytes and the number of the step's
    collectives, by kind; region_flops: the FLOPs of the products run in
    each ``region``, by name."""

    flops: int
    counted_flops: int
    kernel_flops: int
    kernel_launches: int
    mem_bytes: int = 0
    kernel_bytes: int = 0
    coll_bytes_by_kind: dict = dataclasses.field(default_factory=dict)
    coll_count_by_kind: dict = dataclasses.field(default_factory=dict)
    region_flops: dict = dataclasses.field(default_factory=dict)

    @property
    def collective_bytes(self) -> int:
        return sum(self.coll_bytes_by_kind.values())

    def as_dict(self) -> dict:
        """The reference's ``HloCost.as_dict`` keys."""
        return {"flops": float(self.flops), "mem_bytes": float(self.mem_bytes),
                "collective_bytes": float(self.collective_bytes),
                "coll_bytes_by_kind": {k: float(v) for k, v in self.coll_bytes_by_kind.items()}}


def _describe(x, roots: list):
    if isinstance(x, torch.Tensor):
        x = getattr(x, "_local_tensor", x)
        base = x._base if x._base is not None else x
        roots.append(weakref.ref(base))
        return ("tensor", x.device, x.dtype, tuple(x.shape), tuple(x.stride()),
                x.storage_offset(), storage_key(x), x._version)
    if isinstance(x, (list, tuple)):
        return tuple(_describe(v, roots) for v in x)
    return repr(x)


def _tensors(x):
    """The tensors in ``x``; a ``DTensor`` (an FSDP leaf) as this rank's
    shard, the memory the operation touches here."""
    if isinstance(x, torch.Tensor):
        yield getattr(x, "_local_tensor", x)
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


def storage_key(x: torch.Tensor) -> int:
    """The identity of ``x``'s storage, shared by its views: the storage
    object's own address, which a fake tensor (the dry-run's) has too,
    where its data pointer does not exist."""
    return x.untyped_storage()._cdata


def _storage(x):
    return storage_key(x) if x.numel() else None


def op_bytes(name: str, out, args, kwargs) -> int:
    """Operand plus output bytes of one operation (0 for an alias)."""
    if name in _ALLOCATE or name in _METADATA:
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
        self.coll_bytes: dict = {}
        self.coll_count: dict = {}
        self.region_flops: dict = {}


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
            qualified = func_packet._qualified_op_name
            if _COLLECTIVE and not qualified.startswith(("c10d::", "_c10d_functional::")):
                return out  # the transport's own work inside a collective
            name = qualified.split("::")[-1]
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
                if _REGIONS:
                    before = self.get_total_flops()
                    out = super()._count_flops(func_packet, out, args, kwargs)
                    for counter in _ACTIVE:
                        flops = counter.region_flops
                        flops[_REGIONS[-1]] = (flops.get(_REGIONS[-1], 0)
                                               + self.get_total_flops() - before)
                    return out
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
        if not _ACTIVE:
            _REGIONS.clear()
    counted = int(mode.get_total_flops())
    on_card = mode.device_bytes or counter.kernel_launches
    ops_bytes = mode.device_bytes if on_card else mode.host_bytes
    return out, StepCost(flops=counted + counter.kernel_flops, counted_flops=counted,
                         kernel_flops=counter.kernel_flops,
                         kernel_launches=counter.kernel_launches,
                         mem_bytes=ops_bytes + counter.kernel_bytes,
                         kernel_bytes=counter.kernel_bytes,
                         coll_bytes_by_kind=dict(counter.coll_bytes),
                         coll_count_by_kind=dict(counter.coll_count),
                         region_flops=dict(counter.region_flops))
