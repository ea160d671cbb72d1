"""Roofline helpers: parameter counts, the model-FLOPs yardstick and the
roofline terms of a step.  Counterpart of ``repro/launch/analysis.py``.

The reference prices a step on a TPU v5e from its compiled HLO.  The port
prices it on the card it runs on, from ``utils.flop_cost.StepCost`` (the
step's FLOPs and bytes, counted as it runs) and the CUDA allocator's peak.
"""

from __future__ import annotations

import re

from repro_torch.utils.tree import named_leaves, param_bytes, param_count

# NVIDIA H100 80GB HBM3 (SXM) data-sheet peaks, per card
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, H100 SXM dense bf16 tensor cores
PEAK_FLOPS_F32 = 67e12  # FLOP/s, H100 SXM f32 (CUDA cores, no TF32)
HBM_BW = 3.35e12  # B/s, H100 SXM HBM3
NVLINK_BW = 450e9  # B/s per direction, H100 SXM NVLink 4

# the routed experts' parameters (``nn/moe.py``: ``{...}.ffn.experts.{gate,up,down}``)
_EXPERTS = re.compile(r"(^|[./])experts[./]")


def tree_param_count(tree) -> int:
    return int(param_count(tree))


def tree_param_bytes(tree) -> int:
    return int(param_bytes(tree))


def active_param_count(params_tree, model) -> int:
    """MoE-aware active parameter count (routed experts scaled by top_k/E)."""
    moe = getattr(getattr(model, "cfg", None), "moe", None)
    total = 0.0
    for path, leaf in named_leaves(params_tree):
        n = float(leaf.numel())
        if moe is not None and _EXPERTS.search(path):
            n *= moe.top_k / moe.n_experts
        total += n
    return int(total)


def model_flops_reference(n_params_active: int, n_tokens: int, kind: str) -> float:
    """MODEL_FLOPS yardstick: 6·N·D for training, 2·N·D for fwd-only.

    (For DFA the backward differs structurally from BP — the ratio
    step FLOPs / MODEL_FLOPS surfaces exactly that.)"""
    if kind == "train":
        return 6.0 * n_params_active * n_tokens
    return 2.0 * n_params_active * n_tokens


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float, chips: int, *,
                   peak_flops: float = PEAK_FLOPS_BF16) -> dict:
    """The step's least time by compute, memory and collectives on
    ``chips`` cards; ``peak_flops`` is the peak of the step's dtype (the
    port's training steps run in f32: ``PEAK_FLOPS_F32``)."""
    t_compute = flops / (chips * peak_flops)
    t_memory = hbm_bytes / (chips * HBM_BW)
    t_coll = coll_bytes / (chips * NVLINK_BW)
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    bound = max(t_compute, t_memory, t_coll)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": bound,
        # roofline fraction: how much of the bound is useful compute
        "compute_fraction": (t_compute / bound) if bound > 0 else 0.0,
    }


def cost_analysis_dict(cost) -> dict:
    """XLA's ``cost_analysis()`` keys that a ``StepCost`` has: ``flops`` and
    ``bytes accessed``."""
    return {"flops": float(cost.flops), "bytes accessed": float(cost.mem_bytes)}


def memory_analysis_dict(device, argument_bytes: int = 0) -> dict:
    """XLA's ``memory_analysis()`` keys from the CUDA caching allocator's
    peak since the last ``torch.cuda.reset_peak_memory_stats``:
    ``argument_size_in_bytes`` (the caller's inputs, ``argument_bytes``),
    ``temp_size_in_bytes`` (the peak above them) and ``total_hbm_bytes``
    (the peak).  Empty off the card, where no allocator keeps a peak."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {}
    peak = int(torch.cuda.max_memory_allocated(device))
    return {"argument_size_in_bytes": int(argument_bytes),
            "temp_size_in_bytes": peak - int(argument_bytes),
            "total_hbm_bytes": peak}
