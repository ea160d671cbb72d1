"""The reference's cache placement in its own process, on 512 forced host
devices: ``python tests/_cache_spec_reference.py OUT.json``.

For every arch of ``repro.configs.ASSIGNED``, ``decode_32k`` and
``long_500k`` and both production meshes, the PartitionSpec that
``repro.serve.decode.cache_shardings`` gives each leaf of the full-width
caches (built abstractly, ``jax.eval_shape``), by its "/"-joined path: each
entry None or a list of axis names.  jax 0.9's ``jax.make_mesh`` makes
Explicit axes, so the meshes are made with Auto axes, as before that
version."""

import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import configs  # noqa: E402
from repro.serve.decode import cache_shardings  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _entry(e):
    if e is None:
        return None
    return list(e) if isinstance(e, tuple) else [e]


def _walk(caches, shardings, prefix=""):
    for k, v in caches.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _walk(v, shardings[k], path)
        else:
            spec = [_entry(e) for e in shardings[k].spec]
            yield path, {"spec": spec + [None] * (len(v.shape) - len(spec)),
                         "shape": list(v.shape)}


def main(dst: str) -> None:
    out = {}
    for mesh_kind, (shape, names) in MESHES.items():
        mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
        for arch in configs.ASSIGNED:
            model = configs.get(arch).make_model(jax.numpy.bfloat16)
            for name in ("decode_32k", "long_500k"):
                case = configs.SHAPES[name]
                caches = jax.eval_shape(lambda: model.init_caches(case.global_batch,
                                                                  case.seq_len))
                for path, leaf in _walk(caches, cache_shardings(mesh, caches)):
                    out[f"{mesh_kind}|{arch}|{name}|{path}"] = leaf
    with open(dst, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
