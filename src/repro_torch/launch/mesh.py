"""Production and host meshes on ``torch.distributed``.  Counterpart of
``repro/launch/mesh.py``.

Functions, not module-level constants: importing this module touches no
process group and no device.  A mesh is a ``DeviceMesh`` over the ranks of
the default process group, one rank per card (``torchrun --nproc-per-node
N`` starts them).  Single pod: 16×16 = 256 ranks on ("data", "model");
multi-pod: 2×16×16 = 512 with a leading "pod" axis.  The ranks fill the
mesh in row-major order, so the ``model`` axis (tensor parallelism) is the
innermost: its groups are consecutive ranks.

``init_process_group`` starts the default group where none exists: from a
launcher's environment (``torchrun`` sets ``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``), else a group of one rank on an in-process store.  NCCL
drives CUDA tensors, gloo CPU tensors.
"""

from __future__ import annotations

import math
import os

import torch

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def world_size() -> int:
    """Ranks of the default process group (1 where none is initialised)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def launched_world() -> int:
    """Ranks a launcher started (``WORLD_SIZE``), 1 without one."""
    return int(os.environ.get("WORLD_SIZE") or 1)


def default_device_type() -> str:
    """"cuda" for a group that drives cards, else "cpu": the device type
    of a mesh made without one."""
    import torch.distributed as dist

    if dist.is_initialized():
        return "cuda" if dist.get_backend() == "nccl" else "cpu"
    return "cuda" if torch.cuda.is_available() else "cpu"


def init_process_group(device_type: str) -> None:
    """Start the default process group if none is up: NCCL for ``cuda``,
    gloo for ``cpu``; the launcher's rendezvous (``env://``) under one,
    else a world of one rank on an in-process store."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if launched_world() > 1 or "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _mesh(shape: tuple, axes: tuple, device_type: str | None):
    """A DeviceMesh over the first prod(shape) ranks of the default group."""
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    return DeviceMesh(device_type or default_device_type(),
                      torch.arange(n).view(*shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = POD_AXES if multi_pod else AXES
    n = math.prod(shape)
    found = world_size()
    if found < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, found {found} — start one rank per card "
            f"with torchrun (--nnodes x --nproc-per-node = {n}) before building it")
    return _mesh(shape, axes, device_type)


def make_host_mesh(n_devices: int | None = None, model_axis: int = 1,
                   device_type: str | None = None):
    """Small mesh over the group's ranks (tests / examples): (n //
    model_axis, model_axis) on ("data", "model"), rank r at (r //
    model_axis, r % model_axis): a ``model`` group is model_axis
    consecutive ranks, a ``data`` group the ranks model_axis apart."""
    n = world_size() if n_devices is None else n_devices
    if n > world_size():
        raise RuntimeError(f"a mesh of {n} devices needs {n} ranks, found {world_size()}")
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"a model axis of {model_axis} does not divide {n} devices")
    return _mesh((n // model_axis, model_axis), AXES, device_type)


def make_data_mesh(n_devices: int | None = None, device_type: str | None = None):
    """Pure data-parallel mesh: every rank on the ``data`` axis and a
    size-1 ``model`` axis so the ``dist.sharding`` rules still resolve.

    This is the mesh the Trainer uses for data-parallel ``fit``: the state
    is replicated, the batch's rows are split, and the gradients are
    mean-all-reduced over ``data`` (``train/trainer.py``)."""
    n = world_size() if n_devices is None else n_devices
    if n > world_size():
        raise RuntimeError(f"a mesh of {n} devices needs {n} ranks, found {world_size()}")
    return _mesh((n, 1), AXES, device_type)
