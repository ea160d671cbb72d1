"""Module base of the port.

Counterpart of ``repro/nn/module.py``.  The reference keeps parameters in
pytrees made by ``Module.init(key)``; the port keeps them in
``torch.nn.Module``s.  A module allocates its parameters empty on its
device when it is built, and ``init(seed)`` draws them: every child gets
``seed`` folded with its attribute name, the counterpart of ``named_key``.
The reference stacks a scanned layer axis; the port holds a
``ModuleList`` (``convert.py`` maps one layout onto the other).
"""

from __future__ import annotations

import torch

from repro_torch.utils import prng


def empty_param(shape, dtype, device) -> torch.nn.Parameter:
    return torch.nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def init_children(module: torch.nn.Module, seed: int) -> None:
    """``init`` every child (through plain containers) from folded seeds."""
    for name, child in module.named_children():
        s = prng.fold(seed, name)
        if isinstance(child, Module):
            child.init(s)
        else:
            init_children(child, s)


class Module(torch.nn.Module):
    """Base class: leaf modules override ``init`` to draw their own
    parameters; composite modules inherit this one."""

    def init(self, seed: int) -> "Module":
        init_children(self, seed)
        return self
