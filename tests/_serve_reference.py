"""The reference's sharded serving in its own process, on four forced host
devices: ``python tests/_serve_reference.py IN.npz OUT.npz``.

For every arch in IN (``{arch}|params|a/b/c``, ``{arch}|tokens``,
``{arch}|n_valid``, ``{arch}|max_len`` and whisper's ``{arch}|enc``) it
builds ``repro``'s smoke model on a (2, 2) ("data", "model") mesh and runs,
under ``jax.jit`` with the dry-run's shardings (the parameters by
``make_param_shardings``, the caches by ``serve.decode.cache_shardings``,
the tokens and the lengths by ``make_batch_shardings``) and inside
``use_mesh``, ``make_prefill_step`` over the tokens and then greedy
``make_serve_step`` decode steps, digital (no photonic context); whisper
decodes against its encoder output without a prefill.  It writes
``{arch}|prefill`` (the last logits) and ``{arch}|decode`` (steps, B, 1,
V).  jax 0.9's ``jax.make_mesh`` makes Explicit axes, on which the
reference's ``with_sharding_constraint`` refuses to run, so the mesh is
made with Auto axes.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from _fsdp_reference import nest  # noqa: E402
from repro import configs  # noqa: E402
from repro.dist import sharding  # noqa: E402
from repro.serve.decode import cache_shardings, make_prefill_step, make_serve_step  # noqa: E402

STEPS = 3


def main(src: str, dst: str) -> None:
    data = dict(np.load(src))
    archs = sorted({k.split("|")[0] for k in data})
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rep = sharding.replicated(mesh)
    out = {}
    for arch in archs:
        part = {k[len(arch) + 1:]: v for k, v in data.items() if k.startswith(arch + "|")}
        params = nest({k[len("params|"):]: v for k, v in part.items()
                       if k.startswith("params|")})
        model = configs.get(arch).make_smoke()
        tokens = jnp.asarray(part["tokens"], jnp.int32)
        b = tokens.shape[0]
        caches = model.init_caches(b, int(part["max_len"]))
        p_sh = sharding.make_param_shardings(mesh, params)
        c_sh = cache_shardings(mesh, caches)
        bsh = lambda x: sharding.make_batch_shardings(mesh, {"t": x})["t"]
        clen = jnp.zeros((b,), jnp.int32)
        with sharding.use_mesh(mesh):
            params = jax.device_put(params, p_sh)
            caches = jax.device_put(caches, c_sh)
            if "enc" in part:
                enc = jnp.asarray(part["enc"])
                enc = jax.device_put(enc, bsh(enc))
                tok = tokens[:, :1]
                step = jax.jit(make_serve_step(model, whisper_enc=True),
                               in_shardings=(p_sh, bsh(tok), c_sh, bsh(clen), bsh(enc)),
                               out_shardings=(bsh(tok), rep, c_sh))
                extra = (enc,)
            else:
                n_valid = jnp.asarray(part["n_valid"], jnp.int32)
                pstep = jax.jit(make_prefill_step(model),
                                in_shardings=(p_sh, bsh(tokens), bsh(n_valid), c_sh, bsh(clen)),
                                out_shardings=(rep, c_sh, bsh(clen)))
                last, caches, clen = pstep(params, jax.device_put(tokens, bsh(tokens)),
                                           jax.device_put(n_valid, bsh(n_valid)), caches,
                                           jax.device_put(clen, bsh(clen)))
                out[f"{arch}|prefill"] = np.asarray(last, np.float32)
                tok = jnp.argmax(last, axis=-1).astype(jnp.int32)[:, None]
                step = jax.jit(make_serve_step(model),
                               in_shardings=(p_sh, bsh(tok), c_sh, bsh(clen)),
                               out_shardings=(bsh(tok), rep, c_sh))
                extra = ()
            logits = []
            for _ in range(STEPS):
                tok, clen = jax.device_put(tok, bsh(tok)), jax.device_put(clen, bsh(clen))
                tok, lg, caches = step(params, tok, caches, clen, *extra)
                clen = clen + 1
                logits.append(np.asarray(lg, np.float32))
        out[f"{arch}|decode"] = np.stack(logits)
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
