"""Deterministic seed derivation: ``(seed, *names_or_ints) -> int``.

Counterpart of ``repro/utils/prng.py``.  JAX threads ``fold_in``'d keys;
the port derives a plain integer seed from the same path of names and
integers and hands it to a ``torch.Generator`` where numbers are drawn.
Names hash with the same sha256 prefix as the reference, so a name means
the same 32-bit value in both packages (the streams themselves differ).
"""

from __future__ import annotations

import hashlib

import torch

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _name_to_int(name: str) -> int:
    # Stable across processes (unlike hash()).
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")


def _mix64(x: int) -> int:
    """splitmix64 finaliser: a bijection of 64-bit integers."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
    return x ^ (x >> 31)


def fold(seed: int, *names_or_ints) -> int:
    """Fold names and integers into ``seed``; the result fits a
    ``torch.Generator`` seed (63 bits)."""
    s = int(seed) & _MASK64
    for item in names_or_ints:
        v = _name_to_int(item) if isinstance(item, str) else int(item) & _MASK64
        s = _mix64(s ^ _mix64((v + _GOLDEN) & _MASK64))
    return s & (_MASK64 >> 1)


def consume(seed: int) -> int:
    """Mark ``seed`` as spent: identity at runtime, a kill to the linter.

    Pass a key through ``consume`` at its FINAL use site —
    ``generator(consume(key), device)`` — and ``repro_torch.lint`` (RL001)
    flags any later use of the same binding instead of silently allowing
    one more stream equal to the one already drawn.
    """
    return seed


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def step_key(seed: int, step: int, name: str = "") -> int:
    """Seed for a given training step: training noise and data are a pure
    function of (seed, step), so a restart at step k replays the stream."""
    return fold(seed, name, int(step)) if name else fold(seed, int(step))
