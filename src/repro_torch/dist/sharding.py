"""Sharding policy: mesh axes, parameter and batch placement rules, and the
activation annotations.  Counterpart of ``repro/dist/sharding.py``.

Mesh axes (``launch/mesh.py``):

* ``data``  — FSDP axis: parameters are sharded along their first dim
  (ZeRO-3) and, for training, the batch's rows;
* ``model`` — tensor-parallel axis: matmul output dims, the embedding's
  vocabulary, the expert dim, and the feedback's injection dim;
* ``pod``   — optional leading axis (multi-pod); joins ``data`` for batch
  sharding only.

A spec (``P``) names a mesh axis (or a tuple of them, or None) for each
dim of a leaf, as ``jax.sharding.PartitionSpec`` does.  The rule tables are
the reference's, written for its layout: (d_in, d_out) weights and "a/b/c"
paths.  The port's own leaves are matched through ``ref_path`` (its dotted
``state_dict`` name read as the reference's path: "blocks.0.attn.q.weight"
→ "blocks/attn/q/w"), and a Linear ``weight``, stored (d_out, d_in) in
torch layout, takes the rule's spec with its last two entries swapped, so
a leaf splits along the same logical dims in both packages.  A spec becomes
``DTensor`` placements (``placements``): ``Shard(d)`` on each mesh dim that
splits tensor dim d, ``Replicate()`` on the others.

Single-process contract: without an active mesh ``annotate`` and
``unshard_fsdp`` return their argument itself (identity, not a copy), as
the reference's do, and so do the model-axis operators on a ``model``
axis of 1.  Data-parallel training replicates the state and splits the
batch (``put_batch``).

FSDP (ZeRO-3): ``place`` puts a tree's leaves as ``DTensor``s under their
``Sharding``s (the counterpart of ``jax.device_put(tree, shardings)``), so
a rank holds its shard of each leaf the rules split over ``data`` and the
whole of each leaf they leave replicated.  Under ``use_mesh`` the models
call ``unshard_fsdp`` on one block's parameters at a time (the reference's
per-layer gathers) and on the embedding's and the head's once a step: each
split leaf comes back whole, all-gathered over ``data`` in flat buckets of
one dtype, as a plain local tensor the kernels and ``functional_call``
take.  The gather's backward is its transpose: a split leaf's gradient
goes back to its shard as a reduce-scatter over ``data`` (the sum over the
ranks' rows divided by the batch axes' size, as ``all_reduce_mean``
divides), and a replicated leaf's takes the mean all-reduce over the batch
axes.  ``DTensor``'s own backward of a gather to ``Replicate`` would keep
each rank's gradient of its own rows (it assumes the upstream gradient is
the same on every rank, which a split batch breaks).  A pod mesh
reduce-scatters over ``data`` and then all-reduces the shard over
``pod``.  The collectives run on the group's own transport (gloo takes
CUDA tensors in its all-gather and reduce-scatter on the card's build) and
each is counted for ``utils.flop_cost`` by its operand bytes.

Tensor parallelism (the ``model`` axis): the rules split every 2-D
weight's output dim (torch dim 0), the vocabulary and the feedback's
injection dim over ``model``.  The reference's GSPMD keeps every value's
global meaning and computes each product on the pieces; the port computes
the same global values from the pieces.  The dense products are
column-parallel (``nn/linear.py``): a module whose parts are named in its
call of the FSDP gather (``unshard_fsdp(tree, parts)``, the patterns of
``COLUMN_SPLIT``) gets those model-split leaves as this rank's rows, and
runs its product on them: this rank's columns of the output, from the whole
input (``copy_to_model``: identity; backward the SUM all-reduce of the
ranks' partial input gradients).  The dense decoder block keeps q, k and v
on this rank's heads, attends on them and gathers the heads before ``o``;
it gathers the FFN's gate·up before ``down``; ``o``'s and ``down``'s
columns are gathered back into the residual stream, which stays whole on
every rank (``act_btd``), and so do the logits.  Every other model-split
leaf is gathered whole by the FSDP gather (``gather_from_model``: an
all-gather along the split dim; backward this rank's slice of the leaf's
gradient, which every rank computes whole), except those a module reads as
its piece (``SPLIT_READS``), so those modules run the one process's
products on whole leaves.  A part runs on its gathered weights by rule:
the model decides its parts once a mesh (``DecoderBlock.column_parts``:
attention whose kv heads do not divide over the axis is not split, a split
in the middle of a head) and reports what it left whole
(``column_fallbacks``, with ``left_whole``: a leaf the divisibility
fallback left whole runs whole).  The split products' columns are not the
whole product's bits (the card's f32 cuBLAS picks its algorithm by width,
``tools/gemm_width_probe.py``): a training step splits the blocks and keeps
the head on its gathered weight, a sharded serving call
(``serving_call``, entered by ``serve.decode.serving``) splits the head
too, and ``tools/tp_split_ablation.py`` measures each part against the
1e-5 training gate.  Each rank projects the error
through its rows of B(k) (``algos/dfa.py``,
``core/photonics.ColumnWindow``) and the columns are gathered.  The
vocabulary-parallel lookup sums the ranks' rows (``reduce_from_model``: a
SUM all-reduce; backward identity).  Whether a leaf is split is read from
the leaf itself (its placement, or its local size against the whole),
never from the mesh alone, so a leaf the divisibility fallback left whole
is computed whole.  The collectives are ``dist.all_reduce`` and
``dist.all_gather_into_tensor`` on the group's own transport, counted as
the FSDP ones are; ``DTensor``'s redistribute is not used (its functional
collectives crash on gloo with CUDA tensors on the card's torch 2.11).

The experts of a mixture of experts split over ``model`` (the ``experts``
rule, expert parallelism): each rank runs its experts on its slice of the
whole (E, C, d) dispatch buffer (``split_to_model``: a narrow; backward
the all-gather of the pieces' gradients) and the expert outputs are
gathered along E, so each expert's product is the one process's and the
routing and the combine run whole.
"""

from __future__ import annotations

import contextlib
import math
import types
import typing

import torch

from repro_torch.utils.flop_cost import collective
from repro_torch.utils.tree import leaves, named_leaves, path_map, tree_map

MODEL = "model"
FSDP = "data"
POD = "pod"


class P(tuple):
    """A partition spec: one entry per dim, a mesh axis name, a tuple of
    names or None (the counterpart of ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# active mesh
# ---------------------------------------------------------------------------

_ACTIVE: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` for annotate / unshard_fsdp within the block."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh():
    return _ACTIVE[-1] if _ACTIVE else None


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> tuple:
    """Mesh axes the batch dim is sharded over (pod joins data if present)."""
    return (POD, FSDP) if POD in mesh.mesh_dim_names else (FSDP,)


# ---------------------------------------------------------------------------
# parameter placement rules (the reference's tables)
# ---------------------------------------------------------------------------
# Each rule is (substring, spec); first match wins, "" is the catch-all.
# Specs are written for the *trailing* dims of a leaf — ``_fit_spec``
# right-aligns them (stacked layer axes get leading None) and the
# divisibility fallback drops any axis that does not divide the dim.

PARAM_RULES: tuple = (
    ("experts", P(MODEL, FSDP, None)),   # (E, d_in, d_out): expert parallel
    ("embed", P(MODEL, FSDP)),           # (V, d): vocab on model
    ("norm", P()),                       # tiny scale vectors: replicate
    ("/ln", P()),
    ("ln1", P()), ("ln2", P()), ("ln3", P()), ("ln_enc", P()),
    ("", P(FSDP, MODEL)),                # default 2D weight (d_in, d_out)
)

# The model-split leaves a module reads as this rank's piece, which the
# FSDP gather leaves split (``unshard_fsdp``): the stacked experts (expert
# parallel, ``nn/moe.py``) and the vocabulary table
# (``nn/embeddings.lookup``), matched in the leaf's reference path.
SPLIT_READS: tuple = ("experts", "tok/table")

# The column-parallel parts (``nn/linear.py``): each part's leaves, as
# patterns of their reference paths within the tree a module gathers.  The
# decoder block's q, k and v (on this rank's heads), its ``o``, its gated
# FFN's gate and up, and its ``down``; multi-head latent attention's q_down
# and kv_down (``latent``) and q_up, k_up and v_up (``heads``, on this
# rank's heads); a mixture of experts' shared experts (``shared``: gate and
# up; ``shared_down``); the LM's head (vocabulary split); an MLP's dense
# layer, whose subtree is its weight and bias.  No part's patterns match
# another block part's leaf (``attn/q/`` is not in ``attn/q_up/``,
# ``ffn/gate/`` not in ``ffn/shared/gate/``).  A caller names the parts it computes
# column-parallel (``unshard_fsdp``): a training step the blocks', a
# sharded serving call the head's too.
COLUMN_SPLIT = types.MappingProxyType({
    "attn": ("attn/q/", "attn/k/", "attn/v/"), "o": ("attn/o/",),
    "latent": ("attn/q_down/", "attn/kv_down/"),
    "heads": ("attn/q_up/", "attn/k_up/", "attn/v_up/"),
    "ffn": ("ffn/gate/", "ffn/up/"), "down": ("ffn/down/",),
    "shared": ("ffn/shared/gate/", "ffn/shared/up/"), "shared_down": ("ffn/shared/down/",),
    "head": ("out/",), "layer": ("w", "b")})


def _part_of(ref: str, parts: dict | None) -> str | None:
    """The part of ``parts`` (name -> patterns) whose patterns match the
    reference path ``ref``, or None."""
    return next((name for name, patterns in (parts or {}).items()
                 if any(p in ref for p in patterns)), None)


def left_whole(tree, parts: dict | None) -> dict:
    """The leaves of ``parts`` in a placed tree that the divisibility
    fallback left whole on the active mesh's model axis, by part: they run
    on their whole weights.  {} without a model axis above 1."""
    mesh = current_mesh()
    if mesh is None or model_index(mesh)[1] == 1:
        return {}
    out = {}
    for k, x in named_leaves(tree):
        part = _part_of(ref_path(k), parts)
        if part is not None and is_dtensor(x) and _model_dim(x) is None:
            out[part] = f"{ref_path(k)} {tuple(x.shape)} left whole by the divisibility fallback"
    return out

# Feedback matrices are (L, d_inject, d_tap): shard the injection dim on
# model (it is the photonic projection's output dim), replicate d_tap.
FEEDBACK_RULES: tuple = (
    ("", P(None, MODEL, None)),
)

_RENAME = {"weight": "w", "bias": "b"}


def ref_path(path: str) -> str:
    """A port path -> the reference's: dots split names like slashes, layer
    indices drop out (the reference stacks layers on a leading axis), and a
    Linear's ``weight`` / ``bias`` are its ``w`` / ``b``.  A reference path
    comes back unchanged."""
    parts = [p for part in path.split("/") for p in part.split(".") if not p.isdigit()]
    if parts:
        parts[-1] = _RENAME.get(parts[-1], parts[-1])
    return "/".join(parts)


def _transposed(path: str, ndim: int) -> bool:
    """A Linear weight, which the port stores (..., d_out, d_in)."""
    return ndim >= 2 and path.split("/")[-1].split(".")[-1] == "weight"


def spec_for_path(path: str, rules: tuple = PARAM_RULES):
    """-> (spec, rule_substring) for a parameter path, port or reference."""
    ref = ref_path(path)
    for pat, spec in rules:
        if pat in ref:
            return spec, pat
    return P(), ""


def _fit_spec(spec, ndim: int) -> P:
    """Right-align ``spec`` to an ndim-rank leaf: pad leading None for
    stacked layer axes, drop leading entries when the leaf has fewer dims
    (a (d_out,) bias keeps the weight spec's trailing MODEL entry)."""
    entries = tuple(spec)
    if len(entries) > ndim:
        entries = entries[len(entries) - ndim:]
    elif len(entries) < ndim:
        entries = (None,) * (ndim - len(entries)) + entries
    return P(*entries)


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _axis_size(mesh, entry) -> int:
    sizes = _axis_sizes(mesh)
    return math.prod(sizes[a] for a in _axes(entry))


def _divisible(spec, shape, mesh) -> P:
    """Drop spec entries whose mesh-axis product does not divide the dim —
    the odd-vocab fallback (73448 is not 16-way shardable)."""
    names = set(mesh.mesh_dim_names)
    out = []
    for dim, entry in zip(shape, tuple(spec)):
        if entry is None or any(a not in names for a in _axes(entry)):
            out.append(None)
        elif dim % _axis_size(mesh, entry) != 0:
            out.append(None)
        else:
            out.append(entry)
    return P(*out)


def _oriented(path: str, ndim: int, rules: tuple) -> P:
    """A leaf's rule fitted to its rank, the last two entries swapped for a
    torch-layout weight."""
    spec = _fit_spec(spec_for_path(path, rules)[0], ndim)
    if _transposed(path, ndim):
        spec = P(*spec[:-2], spec[-1], spec[-2])
    return spec


def leaf_spec(path: str, shape, mesh, rules: tuple = PARAM_RULES) -> P:
    """The spec of one port leaf: its rule fitted to its rank (a weight's
    last two entries swapped), then the divisibility fallback."""
    return _divisible(_oriented(path, len(shape), rules), shape, mesh)


def placements(spec, mesh) -> tuple:
    """A spec -> ``DTensor`` placements, one per mesh dim: ``Shard(d)`` where
    the mesh dim splits tensor dim d, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec) if entry is not None and name in _axes(entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


class Sharding(typing.NamedTuple):
    """Where a leaf lives: the mesh, the spec and its ``DTensor`` placements
    (the counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: typing.Any
    spec: P
    placements: tuple


def named(mesh, spec) -> Sharding:
    return Sharding(mesh, P(*spec), placements(spec, mesh))


def make_param_shardings(mesh, tree, rules: tuple = PARAM_RULES):
    """A ``Sharding`` for every tensor leaf of a parameter tree (a flat
    ``state_dict``-named dict or nested dicts); a non-tensor leaf (a step
    count) is replicated."""

    def assign(path, leaf):
        shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
        return named(mesh, leaf_spec(path, shape, mesh, rules) if shape else P())

    return path_map(assign, tree)


def make_batch_shardings(mesh, tree):
    """Batch inputs: dim 0 over (pod, data) when divisible, the rest
    replicated."""
    b = batch_axes(mesh)
    n = _axis_size(mesh, b)

    def assign(path, leaf):
        del path
        spec = [None] * leaf.ndim
        if leaf.ndim >= 1 and leaf.shape[0] % n == 0:
            spec[0] = b if len(b) > 1 else b[0]
        return named(mesh, P(*spec))

    return path_map(assign, tree)


def replicated(mesh) -> Sharding:
    return named(mesh, P())


# ---------------------------------------------------------------------------
# data parallelism: replicated state, split batch
# ---------------------------------------------------------------------------


def data_group(mesh):
    """The process group of the mesh's ``data`` axis, over which the batch
    is split and the gradients are averaged.  A pod mesh splits the batch
    over two mesh dims; data parallelism runs on ``make_data_mesh``."""
    if POD in mesh.mesh_dim_names:
        raise ValueError("data-parallel training runs on a (data, model) mesh "
                         "(launch.mesh.make_data_mesh), not a pod mesh")
    return mesh.get_group(FSDP)


def batch_group(mesh):
    """The process group of the batch axes: ``data``, or on a pod mesh the
    ranks of (pod, data) that share this rank's ``model`` coordinate (made
    once a mesh, by every rank of the mesh)."""
    if POD not in mesh.mesh_dim_names:
        return mesh.get_group(FSDP)
    group = getattr(mesh, "_repro_batch_group", None)
    if group is None:
        import torch.distributed as dist
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        with unset_fake_temporarily():  # the rank grid is host data, also in a fake world
            grid = mesh.mesh.reshape(-1, mesh.mesh.shape[-1]).tolist()  # (pod·data, model)
        me = dist.get_rank()
        for m in range(len(grid[0])):
            ranks = [row[m] for row in grid]
            made = dist.new_group(ranks)
            if me in ranks:
                group = made
        mesh._repro_batch_group = group
    return group


def data_index(mesh) -> tuple[int, int]:
    """(this rank's index on the batch axes, their size)."""
    sizes = _axis_sizes(mesh)
    index = 0
    for a in batch_axes(mesh):
        index = index * sizes[a] + mesh.get_local_rank(a)
    return index, _axis_size(mesh, batch_axes(mesh))


def _bucket(tensors, limit: int):
    """The tensors' indices in groups of one dtype and at most ``limit``
    elements (a larger tensor alone), in order within a group."""
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for group in by_dtype.values():
        bucket, size = [], 0
        for i in group:
            if bucket and size + tensors[i].numel() > limit:
                yield bucket
                bucket, size = [], 0
            bucket.append(i)
            size += tensors[i].numel()
        if bucket:
            yield bucket


BUCKET_ELEMENTS = 1 << 24  # 64 MiB of f32 a collective


def _flat_collective(tensors, op, limit: int = BUCKET_ELEMENTS) -> None:
    """Run ``op(flat)`` on each bucket of ``tensors`` flattened into one
    buffer, then copy the result back into the tensors (in place; a tensor
    listed twice is taken once)."""
    tensors = list({id(t): t for t in tensors}.values())
    for index in _bucket(tensors, limit):
        bucket = [tensors[i] for i in index]
        flat = torch.cat([t.reshape(-1) for t in bucket])
        op(flat)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_mean(tensors, group, world: int, limit: int = BUCKET_ELEMENTS) -> None:
    """Mean all-reduce of ``tensors`` over ``group``, in place, in flat
    buckets of one dtype and at most ``limit`` elements: a sum, then a
    division by ``world`` (gloo has no ``ReduceOp.AVG``).  A failed
    collective raises."""
    import torch.distributed as dist

    def reduce(flat):
        with collective("all-reduce", flat.numel() * flat.element_size()):
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(world)

    _flat_collective(tensors, reduce, limit)


def replicate(mesh, tree):
    """Every tensor leaf of ``tree`` replicated over the mesh: broadcast
    in place from the mesh's first rank, in flat buckets -> ``tree``.  The
    placement of the state for pure data-parallel training."""
    import torch.distributed as dist

    group = data_group(mesh)
    src = dist.get_global_rank(group, 0)
    _flat_collective(tensor_leaves(tree),
                     lambda flat: dist.broadcast(flat, src=src, group=group))
    return tree


def tensor_leaves(tree) -> list:
    """The tree's tensor leaves, detached (a step count is left out)."""
    return [x.detach() for x in leaves(tree) if isinstance(x, torch.Tensor)]


class BatchRows(typing.NamedTuple):
    """This rank's rows of each microbatch of a split global batch: its
    first row, its row count and the microbatch's global row count."""

    start: int
    count: int
    total: int


def batch_rows(mesh, n: int, microbatches: int = 1) -> BatchRows | None:
    """The rows ``put_batch`` gives this rank of an ``n``-row batch, or
    None where ``n`` does not split into ``microbatches`` x the batch
    axes' size (the batch is then replicated)."""
    index, world = data_index(mesh)
    mb = max(1, microbatches)
    if n % (world * mb):
        return None
    count = n // (world * mb)
    return BatchRows(index * count, count, n // mb)


class LocalBatch(dict):
    """This rank's rows of a global batch, keyed as the batch; ``rows`` is
    its ``BatchRows``, or None where the batch is replicated."""

    rows: BatchRows | None = None


def put_batch(mesh, batch, device=None, microbatches: int = 1) -> LocalBatch:
    """Host -> device transfer of this rank's rows of a global batch: dim 0
    split over the data axes, or the whole batch where its size does not
    divide (the replication fallback, as ``make_batch_shardings``).

    Microbatch i of the global batch is its rows [i·n/mb, (i+1)·n/mb), as
    the reference's reshape of the global array gives; a rank holds its
    share of each microbatch, the microbatches one after another, so that
    splitting its rows into ``microbatches`` equal parts gives its share of
    each."""
    from repro_torch.data.pipeline import to_device

    tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
    sizes = {t.shape[0] if t.ndim else None for t in tensors.values()}
    n = sizes.pop() if len(sizes) == 1 else None
    rows = batch_rows(mesh, n, microbatches) if n is not None else None
    if rows is not None:
        starts = [i * rows.total + rows.start for i in range(max(1, microbatches))]
        tensors = {k: torch.cat([t[a:a + rows.count] for a in starts])
                   for k, t in tensors.items()}
    out = LocalBatch(to_device(tensors, device if device is not None else "cpu"))
    out.rows = rows
    return out


# ---------------------------------------------------------------------------
# activation annotations
# ---------------------------------------------------------------------------
# Named constraint points for the models.  _B marks the batch dim (bound to
# batch_axes(mesh) at call time).

_B = "__batch__"

ACT_RULES: dict[str, tuple] = {
    "act_btd": (_B, None, None),          # residual stream (B, S, D)
    "tape_lbsd": (None, _B, None, MODEL), # DFA tape: model-sharded feature
    "logits": (_B, None, MODEL),          # (B, S, V): vocab on model
    "delta_tm": (_B, MODEL),              # projected error (T, M)
    "expert_ecd": (MODEL, None, None),    # MoE buffers (E, C, D)
}


def _redistribute(x, mesh, spec):
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(spec, mesh))


def annotate(x, name: str):
    """Redistribute a ``DTensor`` to the rule's placements; identity
    without a mesh, for an unknown name or a plain tensor (the
    tensor-parallel models' activations are plain tensors, whole on every
    rank)."""
    mesh = current_mesh()
    if mesh is None or name not in ACT_RULES:
        return x
    b = batch_axes(mesh)
    entries = tuple((b if len(b) > 1 else b[0]) if e is _B else e for e in ACT_RULES[name])
    spec = _divisible(_fit_spec(P(*entries), x.ndim), x.shape, mesh)
    return _redistribute(x, mesh, spec)


# ---------------------------------------------------------------------------
# tensor parallelism: the model-axis operators
# ---------------------------------------------------------------------------


def model_group(mesh):
    """The process group of the mesh's ``model`` axis (the ranks that share
    this rank's batch coordinates)."""
    return mesh.get_group(MODEL)


def model_index(mesh) -> tuple[int, int]:
    """(this rank's coordinate on ``model``, the axis's size); (0, 1)
    without a mesh or a ``model`` axis."""
    if mesh is None or MODEL not in mesh.mesh_dim_names:
        return 0, 1
    return mesh.get_local_rank(MODEL), _axis_sizes(mesh)[MODEL]


def tp_group():
    """(the model group, this rank's coordinate, the axis's size) of the
    active mesh; (None, 0, 1) without a model axis above 1."""
    mesh = current_mesh()
    index, size = model_index(mesh)
    return (model_group(mesh) if size > 1 else None), index, size


def _all_reduce(x, group):
    """A SUM all-reduce of a copy of ``x`` over ``group``."""
    import torch.distributed as dist

    out = x.contiguous().clone()
    with collective("all-reduce", out.numel() * out.element_size()):
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _all_gather(x, dim: int, group, size: int):
    """The ranks' pieces of ``group`` joined along ``dim``, in rank order."""
    import torch.distributed as dist

    flat = x.contiguous().reshape(-1)
    whole = flat.new_empty(size * flat.numel())
    with collective("all-gather", flat.numel() * flat.element_size()):
        dist.all_gather_into_tensor(whole, flat, group=group)
    return _join(whole.view(size, *x.shape), dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, index, size):
        ctx.dim, ctx.index, ctx.n = dim, index, x.shape[dim]
        return _all_gather(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n).contiguous(), None, None, None, None


class _SplitToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, index, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        n = x.shape[dim] // size
        return x.narrow(dim, index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group, ctx.size), None, None, None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def sum_over(x, group):
    """The SUM of the ranks' ``x`` over ``group`` (an all-reduce), where
    every rank's loss reads the sum: the backward all-reduces the ranks'
    cotangents, so that the mean of the ranks' gradients (the trainer's)
    is the sum's one gradient (a data-parallel step's global batch
    statistic, ``nn/moe.py``)."""
    return _SumOver.apply(x, group)


def _reduce_scatter(x, dim: int, group, size: int):
    """The SUM over ``group`` of the ranks' ``x``, this rank's 1/size of it
    along ``dim`` in rank order (a reduce-scatter)."""
    import torch.distributed as dist

    flat = _pieces(x.contiguous(), dim, size).reshape(-1)
    shape = list(x.shape)
    shape[dim] //= size
    mine = flat.new_empty(flat.numel() // size)
    with collective("reduce-scatter", flat.numel() * flat.element_size()):
        dist.reduce_scatter_tensor(mine, flat, op=dist.ReduceOp.SUM, group=group)
    return mine.view(shape)


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        return _reduce_scatter(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group, ctx.size), None, None, None


class _GatherOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        return _all_gather(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group, ctx.size), None, None, None


def scatter_sum(x, dim: int, group, size: int):
    """This rank's 1/size along ``dim`` of the SUM of the ranks' ``x`` over
    ``group`` (a reduce-scatter; the backward all-gathers): the data ranks'
    partial buffers of a whole batch, each rank keeping its share
    (``nn/moe.py``)."""
    return _ScatterSum.apply(x, dim, group, size)


def gather_over(x, dim: int, group, size: int):
    """The ranks' pieces of ``group`` joined along ``dim`` (an all-gather),
    where every rank's loss reads the whole: the backward reduce-scatters
    the ranks' cotangents, as ``sum_over``'s all-reduces them."""
    return _GatherOver.apply(x, dim, group, size)


def copy_to_model(x):
    """Enter a split product with a tensor every model rank holds whole:
    identity; the backward sums the ranks' partial gradients (a SUM
    all-reduce over ``model``).  Identity without a model axis above 1."""
    group, _, size = tp_group()
    return x if size == 1 else _CopyToModel.apply(x, group)


def reduce_from_model(x):
    """The SUM over ``model`` of the ranks' terms (an all-reduce); the
    backward is the identity: each term's gradient is the sum's."""
    group, _, size = tp_group()
    return x if size == 1 else _ReduceFromModel.apply(x, group)


def gather_from_model(x, dim: int = -1):
    """The ranks' pieces joined along ``dim`` (an all-gather over
    ``model``); the backward takes this rank's slice of the gradient, which
    every rank holds whole because what follows the gather is computed
    alike on every rank (a partitioned use enters through
    ``copy_to_model`` first)."""
    group, index, size = tp_group()
    return x if size == 1 else _GatherFromModel.apply(x, dim % x.ndim, group, index, size)


def split_to_model(x, dim: int = 0):
    """This rank's piece of a tensor every model rank holds whole: its
    slice of ``dim`` (the dual of ``gather_from_model``); the backward
    all-gathers the ranks' gradients of their pieces along ``dim``, so the
    whole gradient is every rank's, each piece computed by its owner.
    Identity without a model axis above 1."""
    group, index, size = tp_group()
    if size == 1:
        return x
    if x.shape[dim] % size:
        raise ValueError(f"a dim of {x.shape[dim]} does not split over {size} model ranks")
    return _SplitToModel.apply(x, dim % x.ndim, group, index, size)


# ---------------------------------------------------------------------------
# FSDP: placement, the per-block gather and its transpose
# ---------------------------------------------------------------------------


def is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor) or type(x) in (torch.Tensor, torch.nn.Parameter):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def place_leaf(x: torch.Tensor, sharding: Sharding, dtype=None):
    """A logical tensor, held whole by every rank -> its ``DTensor`` under
    ``sharding``: each rank keeps its own shard (``src_data_rank=None``: no
    collective), on the mesh's device type, in ``dtype`` (default its own)."""
    from torch.distributed.tensor import distribute_tensor

    local = x.detach().to(device=sharding.mesh.device_type, dtype=dtype or x.dtype)
    return distribute_tensor(local, sharding.mesh, sharding.placements, src_data_rank=None)


def place(tree, shardings):
    """``jax.device_put(tree, shardings)``: every tensor leaf placed under
    the ``Sharding`` at its path of ``shardings`` (a tree of the same
    structure, e.g. from ``make_param_shardings``); other leaves (a step
    count) as they are."""
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, shardings[i]) for i, v in enumerate(tree))
    return place_leaf(tree, shardings) if isinstance(tree, torch.Tensor) else tree


def local(x):
    """A ``DTensor``'s shard on this rank; anything else itself."""
    return x.to_local() if is_dtensor(x) else x


def like(ref, x: torch.Tensor):
    """``x``, this rank's shard, as a ``DTensor`` with ``ref``'s mesh and
    placements (``x`` itself where ``ref`` is not a ``DTensor``)."""
    if not is_dtensor(ref):
        return x
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x, ref.device_mesh, ref.placements, run_check=False,
                              shape=ref.shape, stride=ref.stride())


def to_local(tree):
    """Every ``DTensor`` leaf of ``tree`` as its local shard."""
    return tree_map(local, tree)


def full_tensor(x):
    """A ``DTensor``'s whole (logical) tensor on every rank, as a plain
    tensor: its local shard all-gathered over each mesh dim that splits it,
    the innermost first (anything else comes back as it is).  Every rank
    calls it.  ``DTensor.full_tensor`` does the same through functional
    collectives, which crash (SIGSEGV) on gloo with CUDA tensors on the
    card's torch 2.11; ``dist.all_gather_into_tensor`` runs there."""
    if not is_dtensor(x):
        return x
    import torch.distributed as dist

    mesh, out = x.device_mesh, x.to_local()
    for i in reversed(range(mesh.ndim)):
        p = x.placements[i]
        if not p.is_shard():
            continue
        n = mesh.size(i)
        flat = out.contiguous().reshape(-1)
        whole = flat.new_empty(n * flat.numel())
        with collective("all-gather", flat.numel() * flat.element_size()):
            dist.all_gather_into_tensor(whole, flat, group=mesh.get_group(i))
        out = _join(whole.view(n, *out.shape), p.dim)
    return out


def _join(pieces: torch.Tensor, d: int) -> torch.Tensor:
    """(n, *shard) pieces -> the whole tensor, the pieces in order along
    dim d (the layout of ``Shard(d)`` over n ranks)."""
    shape = list(pieces.shape[1:])
    shape[d] *= pieces.shape[0]
    return pieces.movedim(0, d).reshape(shape)


def _pieces(whole: torch.Tensor, d: int, n: int) -> torch.Tensor:
    """The inverse of ``_join``: a whole tensor -> (n, shard numel), rank
    r's piece of dim d in row r."""
    shape = (*whole.shape[:d], n, whole.shape[d] // n, *whole.shape[d + 1:])
    return whole.reshape(shape).movedim(d, 0).reshape(n, -1)


def local_batch(mesh, batch, microbatches: int = 1) -> LocalBatch:
    """A batch placed by ``make_batch_shardings`` -> this rank's rows, as
    ``put_batch`` gives them (``rows`` None where the batch is
    replicated).  With ``microbatches`` its rows are read as its share of
    each microbatch in turn (``put_batch``'s layout)."""
    n = {v.shape[0] for v in batch.values()}
    split = len(n) == 1 and all(
        is_dtensor(v) and any(getattr(p, "dim", None) == 0 for p in v.placements)
        for v in batch.values())
    out = LocalBatch({k: local(v) for k, v in batch.items()})
    out.rows = batch_rows(mesh, n.pop(), microbatches) if split else None
    return out


def _fsdp_dim(x) -> int | None:
    """The tensor dim a ``DTensor`` splits over ``data``, or None."""
    p = x.placements[x.device_mesh.mesh_dim_names.index(FSDP)]
    return p.dim if p.is_shard() else None


class _Plan:
    """How one gather's leaves sit on the mesh: each leaf's dim split over
    ``data`` (None: replicated there), the data group and its size, and
    the batch axes' group and size."""

    def __init__(self, mesh, dims: list, limit: int = BUCKET_ELEMENTS):
        self.dims = dims
        self.limit = limit
        self.mesh = mesh
        self.group = mesh.get_group(FSDP)
        self.world = mesh.size(mesh.mesh_dim_names.index(FSDP))
        self.pod = mesh.get_group(POD) if POD in mesh.mesh_dim_names else None
        self.batch_group = batch_group(mesh)
        self.batch_world = data_index(mesh)[1]

    def _split(self):
        return [i for i, d in enumerate(self.dims) if d is not None]

    def gather(self, shards) -> list:
        """All-gather every split leaf over ``data`` (one flat buffer a
        bucket); a replicated leaf is its shard."""
        import torch.distributed as dist

        out = list(shards)
        split = self._split()
        for index in _bucket([shards[i] for i in split], self.limit):
            index = [split[i] for i in index]
            flat = torch.cat([shards[i].reshape(-1) for i in index])
            full = flat.new_empty(self.world * flat.numel())
            with collective("all-gather", flat.numel() * flat.element_size()):
                dist.all_gather_into_tensor(full, flat, group=self.group)
            full = full.view(self.world, -1)
            offset = 0
            for i in index:
                n = shards[i].numel()
                part = full[:, offset: offset + n].reshape(self.world, *shards[i].shape)
                out[i] = _join(part, self.dims[i])
                offset += n
        return out

    def reduce(self, grads) -> list:
        """The gather's transpose: each split leaf's full-size gradient
        reduce-scattered to its shard over ``data`` (then all-reduced over
        ``pod``), a replicated leaf's mean all-reduced over the batch axes;
        both divided by the batch axes' size."""
        import torch.distributed as dist

        split = self._split()
        # the replicated leaves' gradients are reduced in place: copies
        out = [g if d is not None else g.clone() for g, d in zip(grads, self.dims)]
        for index in _bucket([grads[i] for i in split], self.limit):
            index = [split[i] for i in index]
            rows = [_pieces(grads[i], self.dims[i], self.world) for i in index]
            flat = torch.cat(rows, dim=1).reshape(-1)
            mine = flat.new_empty(flat.numel() // self.world)
            with collective("reduce-scatter", flat.numel() * flat.element_size()):
                dist.reduce_scatter_tensor(mine, flat, op=dist.ReduceOp.SUM, group=self.group)
            if self.pod is not None:
                with collective("all-reduce", mine.numel() * mine.element_size()):
                    dist.all_reduce(mine, op=dist.ReduceOp.SUM, group=self.pod)
            mine.div_(self.batch_world)
            offset = 0
            for i, row in zip(index, rows):
                d, n = self.dims[i], row.shape[1]
                shape = list(grads[i].shape)
                shape[d] //= self.world
                out[i] = mine[offset: offset + n].view(shape)
                offset += n
        replicated = [g for g, d in zip(out, self.dims) if d is None]
        if replicated:
            all_reduce_mean(replicated, self.batch_group, self.batch_world, self.limit)
        return out


class _Gather(torch.autograd.Function):
    """Plain shards -> plain whole tensors (``_Plan.gather``); backward
    ``_Plan.reduce``."""

    @staticmethod
    def forward(ctx, plan, *shards):
        ctx.plan = plan
        return tuple(plan.gather(shards))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.plan.reduce(grads))


def gather_fsdp(xs: list) -> list:
    """ZeRO-3 gather of ``DTensor`` leaves of one mesh -> plain local
    tensors, each with its ``data`` split undone (a leaf split over
    ``model`` stays split).  Differentiable: the gradient of each result
    reaches its ``DTensor`` leaf as ``_Plan.reduce`` gives it, with the
    leaf's placements."""
    if not xs:
        return []
    plan = _Plan(xs[0].device_mesh, [_fsdp_dim(x) for x in xs])
    if plan.batch_world == 1 and model_index(plan.mesh)[1] > 1:
        # a tensor-parallel mesh with one rank on the batch axes: nothing to
        # gather or reduce (a world of one keeps the collectives)
        return [x.to_local() for x in xs]
    return list(_Gather.apply(plan, *(x.to_local() for x in xs)))


def _model_dim(x) -> int | None:
    """The tensor dim a ``DTensor`` splits over ``model``, or None."""
    names = x.device_mesh.mesh_dim_names
    if MODEL not in names:
        return None
    p = x.placements[names.index(MODEL)]
    return p.dim if p.is_shard() else None


def unshard_fsdp(tree, parts: dict | None = None):
    """ZeRO-3 gather of a tree's ``DTensor`` leaves (``gather_fsdp``, one
    call: one flat all-gather a dtype bucket) -> the same tree of plain
    tensors, its other leaves as they are.  Identity without a mesh.  A
    leaf split over ``model`` is gathered whole there too
    (``gather_from_model``), unless its path holds one of ``SPLIT_READS``
    or matches one of ``parts`` (name -> ``COLUMN_SPLIT`` patterns, the
    parts the caller computes column-parallel): those stay this rank's
    piece."""
    if current_mesh() is None:
        return tree
    named = [(k, x) for k, x in named_leaves(tree) if is_dtensor(x)]
    out = {}
    for (k, x), g in zip(named, gather_fsdp([x for _, x in named])):
        d, ref = _model_dim(x), ref_path(k)
        if (d is not None and _part_of(ref, parts) is None
                and not any(s in ref for s in SPLIT_READS)):
            g = gather_from_model(g, d)
        out[k] = g
    return path_map(lambda k, x: out[k] if k in out else x, tree)


def max_over_model(x):
    """The MAX over ``model`` of the ranks' values of ``x`` (an all-reduce;
    not differentiable: serving's log-sum-exp combine).  Identity without a
    model axis above 1."""
    group, _, size = tp_group()
    if size == 1:
        return x
    import torch.distributed as dist

    out = x.contiguous().clone()
    with collective("all-reduce", out.numel() * out.element_size()):
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


# ---------------------------------------------------------------------------
# serving: caches split over ``model`` (``serve.decode.cache_shardings``)
# ---------------------------------------------------------------------------

_CACHE_SPLIT: list = []


_SERVING: list = []


@contextlib.contextmanager
def serving_call():
    """Within the block a sharded serving call runs
    (``serve.decode.serving``): a module computes column-parallel the parts
    serving splits beyond a training step's (the LM's vocabulary-split
    head, ``TransformerLM.head_logits``)."""
    _SERVING.append(True)
    try:
        yield
    finally:
        _SERVING.pop()


def in_serving_call() -> bool:
    """Whether a sharded serving call is running (``serving_call``)."""
    return bool(_SERVING)


@contextlib.contextmanager
def split_caches(dims: dict):
    """Within the block, a serving model's cache leaf ``name`` holds this
    rank's piece of dim ``dims[name]`` (its per-layer dim: the stacked
    leaf's dim less one) over ``model``; a name absent or None is whole."""
    _CACHE_SPLIT.append(dict(dims))
    try:
        yield
    finally:
        _CACHE_SPLIT.pop()


def active_cache_split() -> dict:
    """The innermost ``split_caches`` dims (empty outside one)."""
    return dict(_CACHE_SPLIT[-1]) if _CACHE_SPLIT else {}


def cache_split(name: str):
    """(the per-layer dim of cache leaf ``name`` split over ``model``, this
    rank's coordinate, the axis's size), or None where the leaf is whole."""
    dim = _CACHE_SPLIT[-1].get(name) if _CACHE_SPLIT else None
    if dim is None:
        return None
    index, size = model_index(current_mesh())
    return (dim, index, size) if size > 1 else None


def model_dim(x) -> int | None:
    """The tensor dim a ``DTensor`` splits over ``model``, or None (a plain
    tensor: None)."""
    return _model_dim(x) if is_dtensor(x) else None
