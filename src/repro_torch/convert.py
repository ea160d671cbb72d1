"""Carry weights, feedback and caches between the reference's layout and
the port's.

The reference keeps parameters in a pytree: nested dicts whose stacked
segments (``blocks``; recurrentgemma's ``grp_rec1``, ``grp_rec2``,
``grp_attn`` and ``tail_rec``; whisper's ``enc`` and ``dec``) stack every
layer on a leading axis
(``stack_init``), with ``Linear`` weights ``w`` in (in, out) layout and
biases ``b``.  The port keeps a ``state_dict``: one ``{segment}.{i}``
entry per layer, ``weight`` in torch layout (out, in), ``bias``.  A
stacked weight (a mixture of experts' ``experts.gate.w`` (E, in, out))
swaps its last two axes to (E, out, in).
Every other leaf keeps its name, as do
bare-array leaves beside the layers (MLA's ``attn.q_norm_scale`` and
``attn.kv_norm_scale``, Mamba's ``A_log``, the RG-LRU's ``lambda``,
whisper's ``embed.pos`` and ``embed.audio.pos``) and the LayerNorms'
``scale`` and ``bias``.

The MLP's tree, ``{"embed": {}, "h0": {"w": (1, 784, 800), "b": (1, 800)},
"h1": ..., "head": {"w", "b"}}``, stacks each one-block segment ``h{i}`` on
an L = 1 axis; the port's ``h{i}`` is the block itself, so that axis is
dropped (``h0.weight`` (800, 784)).  Gradient trees have the parameters'
layout and convert the same way.  DFA feedback (``{"h0": (1, 800, 10), ...,
"embed": (800, 10)}``) is already in the bank's (M, K) layout on both sides.
Serving caches (attention ``{"k", "v"}``, MLA ``{"c_kv", "k_rope"}``, Mamba
``{"ssm", "conv"}``) keep their stacked layout; recurrentgemma's nested
per-segment caches (``{"grp_rec1": {"h", "conv"}, "grp_attn": {"k", "v"},
...}``) are the port's flat ``grp_rec1.h``, ``grp_attn.k``, ....  The
emulated hardware's drift state ``{"drift", "cal"}`` and a dead-ring
mask keep their layout too; they convert between numpy and tensors.

This module takes and returns numpy arrays only (pass the reference's
arrays through ``numpy.asarray``); it imports no JAX.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_RENAME = {"w": "weight", "b": "bias"}
_SEGMENT = re.compile(r"h\d+$")  # the MLP's one-block segments
# the stacked segments, one layer per index of the leading axis
_STACKED = ("blocks", "grp_rec1", "grp_rec2", "grp_attn", "tail_rec", "enc", "dec")


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def layout_map(params):
    """Yield ``(torch_name, leaf, layer, transpose)`` for every leaf of a
    reference pytree: ``layer`` is the index into a stacked leaf (a stacked
    segment or a one-block segment ``h{i}``; None elsewhere), ``transpose``
    is True for ``Linear`` weights.  Leaves may be arrays or shape structs;
    nothing is read."""
    for path, leaf in _walk(params):
        last = path[-1]
        name = path[:-1] + (_RENAME.get(last, last),)  # a top-level leaf: its own name
        transpose = last == "w"
        if path[0] in _STACKED:
            for i in range(leaf.shape[0]):
                yield ".".join((path[0], str(i)) + name[1:]), leaf, i, transpose
        else:
            yield ".".join(name), leaf, 0 if _SEGMENT.match(path[0]) else None, transpose


def torch_shapes(params) -> dict:
    """{torch_name: shape} of the port's parameters for a reference pytree
    of arrays or shape structs (e.g. ``model.param_shapes()``)."""
    out = {}
    for name, leaf, layer, transpose in layout_map(params):
        shape = tuple(leaf.shape[1:] if layer is not None else leaf.shape)
        out[name] = shape[:-2] + shape[-2:][::-1] if transpose else shape
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
        if transpose and arr.ndim >= 2:
            arr = np.swapaxes(arr, -1, -2)
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out


def feedback_from_reference(fb, device=None) -> dict:
    """The reference's feedback tree (numpy leaves) -> the port's feedback
    dict of f32 tensors on ``device``, shapes unchanged."""
    return {name: torch.from_numpy(np.array(b, dtype=np.float32)).to(device)
            for name, b in fb.items()}


def caches_to_reference(caches) -> dict:
    """The port's serving caches -> the reference's stacked numpy arrays,
    leaf for leaf: the attention caches ``{"k", "v"}`` (L, B, S, KVH, D),
    MLA's latent caches ``{"c_kv"}`` (L, B, S, r) and ``{"k_rope"}`` (L,
    B, S, rope), or the Mamba states ``{"ssm"}`` (L, B, H, N, P) and
    ``{"conv"}`` (L, B, K-1, C).  A flat ``segment.leaf`` name nests as
    ``{segment: {leaf: ...}}`` (recurrentgemma).  The port already keeps
    the stacked layout; values come back in f32."""
    out = {}
    for name, t in caches.items():
        *segment, leaf = name.split(".")
        node = out
        for part in segment:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return out


def caches_from_reference(caches, like) -> dict:
    """The reference's stacked caches (numpy leaves, nested per segment
    where the model has several) -> tensors with the dtype and device of
    the port's caches ``like`` (``init_caches``)."""
    def leaf(name):
        node = caches
        for part in name.split("."):
            node = node[part]
        return node

    return {name: torch.from_numpy(np.array(leaf(name), dtype=np.float32)).to(
        device=t.device, dtype=t.dtype) for name, t in like.items()}


def hw_state_from_reference(hw, device=None) -> dict:
    """The reference's hardware state ``{"drift", "cal"}`` (numpy leaves,
    (n_buses, rows, cols)) -> the port's f32 tensors on ``device``."""
    return {name: torch.from_numpy(np.array(hw[name], dtype=np.float32)).to(device)
            for name in ("drift", "cal")}


def hw_state_to_reference(hw) -> dict:
    """The port's hardware state -> numpy f32 arrays, as the reference's."""
    return {name: hw[name].detach().float().cpu().numpy() for name in ("drift", "cal")}


def dead_ring_mask_from_reference(mask, device=None):
    """A dead-ring mask (numpy, any layout) -> an f32 tensor on ``device``."""
    return torch.from_numpy(np.array(mask, dtype=np.float32)).to(device)


def dead_ring_mask_to_reference(mask):
    """A dead-ring mask tensor -> numpy f32, as the reference's."""
    return mask.detach().float().cpu().numpy()
