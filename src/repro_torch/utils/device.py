"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import os

import torch


def local_rank() -> int | None:
    """This process's index on its host under a launcher (``torchrun`` sets
    ``LOCAL_RANK``), else None."""
    value = os.environ.get("LOCAL_RANK")
    return int(value) if value not in (None, "") else None


def faking() -> bool:
    """True inside a ``FakeTensorMode`` (the dry-run's fake world): tensors
    are shapes on a device that is never touched."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Asking for CUDA where there is none raises:
    an entry point never moves to the CPU on its own (inside a
    ``FakeTensorMode`` the card is a fake device, never touched).

    Under a launcher a rank drives its own card: ``cuda`` without an index
    resolves to ``cuda:LOCAL_RANK``, made the current device with
    ``torch.cuda.set_device`` before any CUDA work."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and faking():
        return dev  # a fake device: nothing runs on it
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    rank = local_rank()
    if dev.type == "cuda" and dev.index is None and rank is not None:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    return dev
