"""Fault-tolerant checkpointing: atomic snapshots, keep-k rotation, the
newest step, restore into a template.  Counterpart of
``repro/train/checkpoint.py``, with the port's own file format.

A snapshot is a training state (nested dicts of tensors and Python
scalars) flattened to names ``"params/blocks.0.attn.q.weight"``,
``"opt/mom/head.out.weight"``, ``"step"``: dict keys joined by "/", list
and tuple items by "#i", as the reference names its leaves.  The leaves go
to host memory and into one ``torch.save`` file (read back with
``weights_only=True``: tensors and scalars only, no code).  The reference
packs raw bytes with msgpack; the two formats do not read each other.

Writes are atomic (a temporary file, ``fsync``, ``os.replace``), so a crash
mid-write never corrupts the newest snapshot.  ``load`` with a template
rebuilds the template's structure, with every tensor cast to the
template's dtype and placed on its device.

Elastic restore (the reference's contract): a snapshot holds *logical*
tensors, whatever the layout they were saved from.  ``save`` of a tree with
``DTensor`` leaves gathers each (every rank calls it) and rank 0 writes;
``load(..., shardings=)`` places each leaf under a new mesh's
``dist.sharding.Sharding`` (from ``make_param_shardings``), each rank
taking its own shard of the logical tensor, so a snapshot taken on one
mesh restores on a mesh of another size.  The format is the same with or
without a mesh.
"""

from __future__ import annotations

import os
import re

import torch

from repro_torch.dist.sharding import Sharding, full_tensor, is_dtensor, place_leaf

VERSION = 1


def _flatten(tree, prefix: str = "", out: dict | None = None) -> dict:
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}/{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}#{i}", out)
    else:
        out[prefix] = tree
    return out


def _to_host(x):
    if is_dtensor(x):
        x = full_tensor(x)  # a collective: every rank gathers the logical tensor
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return x


def save(path: str, tree, step: int | None = None):
    """Atomic write of a snapshot of ``tree``.  With ``DTensor`` leaves every
    rank calls it: each leaf is gathered, rank 0 writes, and no rank
    returns before the file is in place."""
    flat = _flatten(tree)
    sharded = any(is_dtensor(v) for v in flat.values())
    payload = {"version": VERSION, "step": -1 if step is None else int(step),
               "leaves": {k: _to_host(v) for k, v in flat.items()}}
    if sharded:
        import torch.distributed as dist

        if dist.get_rank() == 0:
            _write(path, payload)
        dist.barrier()
    else:
        _write(path, payload)


def _write(path: str, payload: dict):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _restore_leaf(saved, like, sharding=None):
    if isinstance(like, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or tuple(saved.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {getattr(saved, 'shape', saved)} does not fit "
                             f"the template's {tuple(like.shape)}")
        if sharding is not None:
            # the logical tensor is read on every rank: each keeps its shard
            return place_leaf(saved, sharding, like.dtype)
        return saved.to(device=like.device, dtype=like.dtype)
    return type(like)(saved) if isinstance(like, (int, float)) else saved


def load(path: str, template=None, shardings=None):
    """Restore -> (tree, step).  Without a template the tree is the flat
    {name: leaf} dict on the CPU; with one it has the template's structure,
    dtypes and devices.  ``shardings``: a tree of the template's structure
    (``dist.sharding.make_param_shardings``) whose leaves place the
    restored tensors as ``DTensor``s on their mesh — the elastic restore."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    leaves, step = payload["leaves"], payload["step"]
    if template is None:
        return leaves, step
    missing = set(_flatten(template)) - set(leaves)
    if missing:
        raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]} …")
    flat_shard = _flatten_shardings(shardings)

    def rebuild(node, prefix=""):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, f"{prefix}#{i}") for i, v in enumerate(node))
        return _restore_leaf(leaves[prefix], node, flat_shard.get(prefix))

    return rebuild(template), step


def _flatten_shardings(shardings) -> dict:
    """A tree of ``Sharding``s (NamedTuples, not tuples of leaves) -> the
    names ``_flatten`` gives the template's leaves."""
    out = {}

    def visit(node, prefix):
        if isinstance(node, Sharding):
            out[prefix] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                visit(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(v, f"{prefix}#{i}")

    if shardings is not None:
        visit(shardings, "")
    return out


class CheckpointManager:
    """Step-tagged snapshots in one directory, keeping the newest ``keep``."""

    PAT = re.compile(r"ckpt_(\d+)\.pt$")

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:09d}.pt")

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(self.PAT.match, os.listdir(self.dir)) if m)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree):
        save(self._path(step), tree, step=step)
        for old in self.all_steps()[: -self.keep]:
            try:
                os.remove(self._path(old))
            except FileNotFoundError:
                pass

    def restore(self, template, step: int | None = None, shardings=None):
        """-> (tree, step) of ``step`` (default the newest), or (None, None)
        for an empty directory."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        return load(self._path(step), template, shardings)
