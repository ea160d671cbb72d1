"""Opt-in runtime sanitizers: finiteness checks on the photonic signal
chain and on the outputs of a training or serving step.  Counterpart of
``repro/lint/runtime.py``.

* ``check_finite(x, name)`` — raises ``NonFiniteError`` when an element of
  ``x`` is NaN or infinite, ONLY inside an active ``debug_checks()``
  context.  Outside it, it is literally ``return x``: no work, no device
  sync.  The photonic products (``core.photonics.photonic_matmul``, the
  ``cuda`` backend, ``channel.emulated_matmul``) call it on their outputs.
* ``checked(fn)`` — ``fn`` run inside ``debug_checks()``, with every
  floating-point tensor of its result checked finite (one device-to-host
  read for all of them).  Eager PyTorch raises at the first failed check,
  so the wrapped function returns ``fn``'s own result; the reference's
  ``checkify`` returns ``(error, out)`` for the caller to throw.

The Trainer wraps its train step, and the serving Engine its prefill and
decode steps, in ``checked`` when built with ``debug_checks=True``.  The
reference's ``RecompileSentinel`` counts JAX retraces; eager PyTorch has
no trace cache to count, so it has no counterpart here.
"""

from __future__ import annotations

import contextlib
import functools

import torch

_DEBUG_STACK: list = []


class NonFiniteError(RuntimeError):
    """A checked tensor holds a NaN or an infinity."""


def debug_checks_enabled() -> bool:
    return bool(_DEBUG_STACK)


@contextlib.contextmanager
def debug_checks():
    """Arm ``check_finite`` for the dynamic extent of the block."""
    _DEBUG_STACK.append(True)
    try:
        yield
    finally:
        _DEBUG_STACK.pop()


def check_finite(x, name: str):
    """Raise when ``x`` holds a non-finite element and sanitizers are armed;
    identity otherwise.  Returns ``x`` so call sites stay expressions."""
    if _DEBUG_STACK and not bool(torch.isfinite(x).all()):
        raise NonFiniteError(f"non-finite values in {name} (debug_checks)")
    return x


def _float_tensors(tree, path=""):
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            yield path or "output", tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _float_tensors(v, f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _float_tensors(v, f"{path}[{i}]")


def check_tree(tree, what: str):
    """Raise ``NonFiniteError`` naming every floating-point tensor of
    ``tree`` (nested dicts, lists, tuples) that holds a non-finite element;
    one transfer per device for all the flags."""
    by_device: dict = {}
    for name, t in _float_tensors(tree):
        by_device.setdefault(t.device, []).append((name, t))
    bad = []
    for items in by_device.values():
        flags = torch.stack([torch.isfinite(t).all() for _, t in items]).tolist()
        bad += [name for (name, _), ok in zip(items, flags) if not ok]
    if bad:
        raise NonFiniteError(f"non-finite values in {what}: {', '.join(bad)} (debug_checks)")
    return tree


def checked(fn, name: str | None = None):
    """``fn`` with the sanitizers armed while it runs and its result
    checked finite; raises ``NonFiniteError`` at the first failure."""
    what = name or getattr(fn, "__qualname__", "output")

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with debug_checks():
            out = fn(*args, **kwargs)
        return check_tree(out, what)

    return run
