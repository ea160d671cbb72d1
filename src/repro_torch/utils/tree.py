"""Parameter-tree utilities: counting, casting, path-wise maps.
Counterpart of ``repro/utils/tree.py``.

A tree is a tensor, or a dict, list or tuple of trees: the port's flat
parameter dicts (``DFAModel.param_dict``'s dotted ``state_dict`` names) and
nested dicts (a trainer state, a reference-style pytree).  Leaves are taken
in the dicts' own order (the reference's ``jax.tree_util`` sorts dict keys,
so sums over leaves may round differently).  A path joins the keys from the
root with "/", as the reference's does; a flat dict's dotted name is one key.
"""

from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and trees of its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def named_leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """[(path, leaf)] in the tree's order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += named_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def leaves(tree) -> list[torch.Tensor]:
    return [x for _, x in named_leaves(tree)]


def param_count(tree) -> int:
    return sum(x.numel() for x in leaves(tree))


def param_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def cast(tree, dtype):
    """Floating-point leaves cast to ``dtype``; the rest as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype), tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_dot(a, b):
    """Sum over all leaves of <a, b> (float32 accumulation)."""
    return sum(leaves(tree_map(lambda x, y: (x.float() * y.float()).sum(), a, b)))


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ x²) over every leaf, in f32."""
    return torch.sqrt(sum((x.float() ** 2).sum() for x in leaves(tree)))


def path_map(fn, tree):
    """``tree_map`` where ``fn`` receives ("a/b/c", leaf)."""
    names = iter(named_leaves(tree))
    return tree_map(lambda x: fn(next(names)[0], x), tree)


def tree_allclose(a, b, rtol=1e-5, atol=1e-6) -> bool:
    la, lb = leaves(a), leaves(b)
    if len(la) != len(lb):
        return False
    return all(torch.allclose(x.detach().cpu().double(), y.detach().cpu().double(),
                              rtol=rtol, atol=atol) for x, y in zip(la, lb))
