"""Architecture registry.  The port registers qwen1.5-0.5b, minicpm3-4b,
qwen3-1.7b, granite-8b, qwen2-moe-a2.7b, kimi-k2-1t-a32b, mamba2-130m and
recurrentgemma-9b (served and trained) and mnist_mlp (trained), in the
reference's order; the reference's other architectures (internvl2-2b,
whisper-small) are ported in later slices."""

from __future__ import annotations

from repro_torch.configs import (
    granite_8b,
    kimi_k2_1t_a32b,
    mamba2_130m,
    minicpm3_4b,
    mnist_mlp,
    qwen1_5_0_5b,
    qwen2_moe_a2_7b,
    qwen3_1_7b,
    recurrentgemma_9b,
)
from repro_torch.configs.base import Arch

_MODULES = [qwen1_5_0_5b, minicpm3_4b, qwen3_1_7b, granite_8b, qwen2_moe_a2_7b, kimi_k2_1t_a32b,
            mamba2_130m, recurrentgemma_9b, mnist_mlp]

REGISTRY: dict[str, Arch] = {m.ARCH.name: m.ARCH for m in _MODULES}

# the language models (the reference's ASSIGNED leaves out the paper's MLP)
ASSIGNED: tuple[str, ...] = tuple(n for n in REGISTRY if n != "mnist_mlp")


def list_archs() -> list[str]:
    return list(REGISTRY)


def get(name: str) -> Arch:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["Arch", "REGISTRY", "ASSIGNED", "get", "list_archs"]
