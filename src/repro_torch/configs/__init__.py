"""Architecture registry.  Slice 1 registers qwen1.5-0.5b only; the
reference's other architectures are ported in later slices."""

from __future__ import annotations

from repro_torch.configs import qwen1_5_0_5b
from repro_torch.configs.base import Arch

_MODULES = [qwen1_5_0_5b]

REGISTRY: dict[str, Arch] = {m.ARCH.name: m.ARCH for m in _MODULES}

ASSIGNED: tuple[str, ...] = tuple(REGISTRY)


def get(name: str) -> Arch:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["Arch", "REGISTRY", "ASSIGNED", "get"]
