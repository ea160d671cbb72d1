"""Architecture registry: the reference's ten assigned architectures
(qwen1.5-0.5b, minicpm3-4b, qwen3-1.7b, granite-8b, qwen2-moe-a2.7b,
kimi-k2-1t-a32b, mamba2-130m, internvl2-2b, recurrentgemma-9b and
whisper-small, served and trained) and the paper's mnist_mlp (trained), in
the reference's order."""

from __future__ import annotations

from repro_torch.configs import (
    granite_8b,
    internvl2_2b,
    kimi_k2_1t_a32b,
    mamba2_130m,
    minicpm3_4b,
    mnist_mlp,
    qwen1_5_0_5b,
    qwen2_moe_a2_7b,
    qwen3_1_7b,
    recurrentgemma_9b,
    whisper_small,
)
from repro_torch.configs.base import SHAPES, Arch, ShapeCase, token_specs

_MODULES = [qwen1_5_0_5b, minicpm3_4b, qwen3_1_7b, granite_8b, qwen2_moe_a2_7b, kimi_k2_1t_a32b,
            mamba2_130m, internvl2_2b, recurrentgemma_9b, whisper_small, mnist_mlp]

REGISTRY: dict[str, Arch] = {m.ARCH.name: m.ARCH for m in _MODULES}

# the language models (the reference's ASSIGNED leaves out the paper's MLP)
ASSIGNED: tuple[str, ...] = tuple(n for n in REGISTRY if n != "mnist_mlp")


def list_archs() -> list[str]:
    return list(REGISTRY)


def get(name: str) -> Arch:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["Arch", "REGISTRY", "ASSIGNED", "SHAPES", "ShapeCase", "get", "list_archs",
           "token_specs"]
