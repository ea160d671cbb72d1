"""The reference's sharded DFA step in its own process, on four forced host
devices: ``python tests/_fsdp_reference.py IN.npz OUT.npz``.

For every case in IN (``{case}|params|a/b/c``, ``{case}|fb|...`` and
``{case}|batch|...`` arrays; ``{case}|arch`` and ``{case}|mesh``, a name of
``MESHES``, among them model axes above 1) it runs
``repro``'s ``dfa`` value_and_grad under ``jax.jit`` with the dry-run's
``in_shardings`` (``make_param_shardings``, ``FEEDBACK_RULES``,
``make_batch_shardings``) and the gradients sharded as the parameters,
noise off, inside ``use_mesh``, and writes ``{case}|loss`` and
``{case}|grads|a/b/c``.  jax 0.9's ``jax.make_mesh`` makes Explicit axes, on
which the reference's ``with_sharding_constraint`` refuses to run, so the
meshes are made with Auto axes (``axis_types``), as before that version.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import algos, configs  # noqa: E402
from repro.algos.dfa import DFAConfig  # noqa: E402
from repro.dist import sharding  # noqa: E402

MESHES = {"data": ((4, 1), ("data", "model")), "pod": ((2, 2, 1), ("pod", "data", "model")),
          # tensor parallelism: a model axis above 1 (a mesh of fewer than
          # four devices takes the first ones)
          "tp12": ((1, 2), ("data", "model")), "tp14": ((1, 4), ("data", "model")),
          "tp22": ((2, 2), ("data", "model")), "tp212": ((2, 1, 2), ("pod", "data", "model"))}


def nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(v)
    return out


def flatten(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def main(src: str, dst: str) -> None:
    data = dict(np.load(src))
    cases = sorted({k.split("|")[0] for k in data})
    out = {}
    for case in cases:
        part = {k[len(case) + 1:]: v for k, v in data.items() if k.startswith(case + "|")}
        tree = {what: nest({k[len(what) + 1:]: v for k, v in part.items()
                            if k.startswith(what + "|")}) for what in ("params", "fb", "batch")}
        shape, names = MESHES[str(part["mesh"])]
        mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape),
                             devices=jax.devices()[:int(np.prod(shape))])
        model = configs.get(str(part["arch"])).make_smoke()
        vg = algos.get("dfa").value_and_grad(model, DFAConfig(backend="ref"))
        p_sh = sharding.make_param_shardings(mesh, tree["params"])
        f_sh = sharding.make_param_shardings(mesh, tree["fb"], sharding.FEEDBACK_RULES)
        b_sh = sharding.make_batch_shardings(mesh, tree["batch"])
        rep = sharding.replicated(mesh)

        def step(params, fb, batch):
            (loss, _), grads = vg(params, fb, batch, jax.random.PRNGKey(7))
            return loss, grads

        with sharding.use_mesh(mesh):
            fn = jax.jit(step, in_shardings=(p_sh, f_sh, b_sh), out_shardings=(rep, p_sh))
            loss, grads = fn(tree["params"], tree["fb"], tree["batch"])
        out[f"{case}|loss"] = np.asarray(loss)
        out.update({f"{case}|grads|{k}": v for k, v in flatten(grads).items()})
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
