"""Carry weights and caches between the reference's layout and the port's.

The reference keeps parameters in a pytree: nested dicts whose ``blocks``
subtree stacks every layer on a leading axis (``stack_init``), with
``Linear`` weights ``w`` in (in, out) layout and biases ``b``.  The port
keeps a ``state_dict``: one ``blocks.{i}`` entry per layer, ``weight`` in
torch layout (out, in), ``bias``.  Every other leaf keeps its name.

This module takes and returns numpy arrays only (pass the reference's
arrays through ``numpy.asarray``); it imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

_RENAME = {"w": "weight", "b": "bias"}


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def layout_map(params):
    """Yield ``(torch_name, leaf, layer, transpose)`` for every leaf of a
    reference pytree: ``layer`` is the index into a stacked ``blocks`` leaf
    (None elsewhere), ``transpose`` is True for ``Linear`` weights.  Leaves
    may be arrays or shape structs; nothing is read."""
    for path, leaf in _walk(params):
        last = path[-1]
        tail = path[1:-1] + (_RENAME.get(last, last),)
        transpose = last == "w"
        if path[0] == "blocks":
            for i in range(leaf.shape[0]):
                yield ".".join(("blocks", str(i)) + tail), leaf, i, transpose
        else:
            yield ".".join(path[:1] + tail), leaf, None, transpose


def torch_shapes(params) -> dict:
    """{torch_name: shape} of the port's parameters for a reference pytree
    of arrays or shape structs (e.g. ``model.param_shapes()``)."""
    out = {}
    for name, leaf, layer, transpose in layout_map(params):
        shape = tuple(leaf.shape[1:] if layer is not None else leaf.shape)
        out[name] = shape[::-1] if transpose else shape
    return out


def state_dict_from_reference(params) -> dict:
    """The reference's parameter pytree (numpy leaves) -> the port's
    ``state_dict`` (CPU tensors; ``load_state_dict`` copies them to the
    model's device and dtype)."""
    out = {}
    for name, leaf, layer, transpose in layout_map(params):
        arr = np.asarray(leaf)
        if layer is not None:
            arr = arr[layer]
        if transpose:
            arr = arr.T
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out


def caches_to_reference(caches) -> dict:
    """The port's caches -> the reference's stacked (L, B, S, KVH, D)
    numpy arrays.  The port already keeps the stacked layout."""
    return {name: t.detach().float().cpu().numpy() for name, t in caches.items()}
