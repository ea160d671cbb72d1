"""The sharded training step.  Counterpart of ``repro/launch/dryrun.py``'s
``build_train`` (with ``_make_model`` and ``_dfa_config``), for the
reference's baseline variant; its ``build_prefill``, ``build_decode``,
``run_cell``, ``main`` and the ``opt`` variant (``VARIANT``, the opt
configs and kimi-k2's microbatches) are not ported yet.

The reference lowers and compiles its step under the production meshes.
The port runs it: ``build_train(arch, mesh)`` returns ``fn(params, fb,
opt_state, batch, seed) -> (params, opt_state, loss)`` and its arguments,
placed as the reference's ``in_shardings`` place them (``DTensor``s: the
parameters and the momentum by ``make_param_shardings``, ZeRO-3 over
``data``; the feedback by ``FEEDBACK_RULES``; the batch by
``make_batch_shardings``; the seed replicated).  ``fn`` runs the ``dfa``
algorithm under ``use_mesh(mesh)``, so the models gather each block's
parameters (``dist.sharding.unshard_fsdp``) and their gradients come back
to the shards through the gather's reduce-scatter; the trainer's
``_grads`` runs each projection in this rank's row window of the global
batch.  SGD momentum (lr 0.01, momentum 0.9) then updates each rank's
shards.  The outputs carry the reference's ``out_shardings``: the
parameters' and the momentum's placements, the loss replicated.

Once the state is placed, the model module's own parameters are released
(``DFAModel.release_parameters``): a rank holds its parameter and momentum
shards, its rows of the feedback (split over ``model``) and, during the
step, one gathered block beside the embedding's and the head's leaves.

The mesh is (data, model) or (pod, data, model).  A ``model`` axis above 1
runs tensor parallelism (``dist.sharding``'s model-axis operators): the
dense transformer family and the MLP compute on each leaf's model-split
piece, every projection runs on this rank's rows of B(k), and the loss and
every gradient are the one process's.  The other families, the ``emu``
backend and ``dfa-layerwise`` raise there (``ROADMAP.md`` queue 1).

Usage::

    from repro_torch.launch import dryrun, mesh as mesh_lib

    mesh_lib.init_process_group("cuda")
    mesh = mesh_lib.make_host_mesh(device_type="cuda")  # (ranks, 1)
    # or tensor parallel: make_host_mesh(model_axis=2) -> (ranks // 2, 2)
    fn, args, extra = dryrun.build_train("qwen1.5-0.5b", mesh)
    params, opt_state, loss = fn(*args)
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import algos, configs
from repro_torch.algos.dfa import DFAConfig
from repro_torch.core import photonics
from repro_torch.core.feedback import FeedbackConfig
from repro_torch.data.tokens import MarkovTokens
from repro_torch.dist import sharding
from repro_torch.train.optimizer import SGDM
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


def _make_model(arch, dtype=torch.bfloat16, device=None):
    return arch.make_model(dtype, device=device)


def _dfa_config() -> DFAConfig:
    """The paper system's training config: off-chip BPD noise in the
    feedback path, bf16 feedback."""
    return DFAConfig(photonics=photonics.preset("offchip_bpd"), backend="ref",
                     feedback=FeedbackConfig(dtype=torch.bfloat16))


def example_batch(arch, model, shape: configs.ShapeCase, seed: int, dtype) -> dict:
    """A host batch of ``shape``'s global size: ``token_specs`` filled by
    ``MarkovTokens`` from ``seed``, and ``arch.input_extras`` (the frontend
    stubs' inputs) drawn from a normal at 0.1."""
    specs = dict(configs.token_specs(shape.global_batch, shape.seq_len))
    specs.update(arch.input_extras(shape.global_batch, "train", dtype=dtype))
    batch = MarkovTokens(model.cfg.vocab_size, shape.seq_len, shape.global_batch,
                         seed).batch(0)
    rng = np.random.default_rng((seed, 7))
    out = {}
    for k, spec in specs.items():
        x = batch[k] if k in batch else rng.normal(size=tuple(spec.shape)) * 0.1
        out[k] = torch.as_tensor(np.asarray(x)).to(spec.dtype)
        assert tuple(out[k].shape) == tuple(spec.shape), (k, out[k].shape, spec.shape)
    return out


def build_train(arch, mesh, *, shape="train_4k", dfa: DFAConfig | None = None,
                smoke: bool = False, dtype=torch.bfloat16, device=None, seed: int = 0,
                batch: dict | None = None):
    """-> (fn, (params, fb, opt_state, batch, seed), extra): the reference's
    sharded DFA step on ``mesh`` and its placed arguments.

    ``arch``: a name or an ``Arch``; ``smoke`` builds its smoke model.
    ``shape`` (a ``SHAPES`` name or a ``ShapeCase``) sizes the synthetic
    batch (``example_batch``, from ``seed`` folded with "batch") unless
    ``batch`` (a host batch) is given.
    ``dfa`` replaces ``_dfa_config()``.  ``mesh`` is a (data, model) or
    (pod, data, model) mesh, its ``model`` axis 1 or above.  The
    parameters are drawn from
    ``seed`` and the feedback from ``seed`` folded with "feedback", as
    ``Trainer.init_state`` draws them, so ``fn`` on a world of one is the
    trainer's single-device step.  ``extra`` holds the model, the trainer,
    ``value_and_grad`` (``fn``'s gradient half: ((loss, metrics), grads)
    with ``DTensor`` gradients), the in / out shardings and the batch's
    token count."""
    arch = configs.get(arch) if isinstance(arch, str) else arch
    device = resolve_device(device)
    model = arch.make_smoke(device=device) if smoke else _make_model(arch, dtype, device)
    cfg = dfa or _dfa_config()
    opt = SGDM(lr=0.01, momentum=0.9)
    algo = algos.get("dfa")
    trainer = Trainer(model, TrainerConfig(algo="dfa", dfa=cfg, optimizer=opt,
                                           data_parallel=False), device=device, mesh=mesh)
    shape = configs.SHAPES[shape] if isinstance(shape, str) else shape
    if batch is None:
        batch = example_batch(arch, model, shape, prng.fold(seed, "batch"),
                              next(model.parameters()).dtype)

    model.init(seed)
    params = {k: v.detach() for k, v in model.named_parameters()}
    fb = algo.init_extra_state(model, prng.fold(seed, "feedback"), cfg)
    params_sh = sharding.make_param_shardings(mesh, params)
    fb_sh = sharding.make_param_shardings(mesh, fb, sharding.FEEDBACK_RULES)
    batch_sh = sharding.make_batch_shardings(mesh, batch)
    rep = sharding.replicated(mesh)
    placed = sharding.place(params, params_sh)
    del params
    model.release_parameters()
    opt_state = opt.init(placed)
    opt_sh = sharding.make_param_shardings(mesh, opt_state)

    def value_and_grad(params, fb, batch, seed):
        with sharding.use_mesh(mesh):
            return trainer._grads(params, sharding.to_local(fb),
                                  sharding.local_batch(mesh, batch), int(sharding.local(seed)))

    def train_step(params, fb, opt_state, batch, seed):
        (loss, _metrics), grads = value_and_grad(params, fb, batch, seed)
        new_params, new_opt, _ = opt.update(grads, opt_state, params)
        return new_params, new_opt, sharding.place_leaf(loss, rep)

    args = (placed, sharding.place(fb, fb_sh), opt_state, sharding.place(batch, batch_sh), seed)
    extra = {"model": model, "trainer": trainer, "value_and_grad": value_and_grad,
             "in_shardings": (params_sh, fb_sh, opt_sh, batch_sh, rep),
             "out_shardings": (params_sh, opt_sh, rep),
             "tokens": int(batch["tokens"].numel() if "tokens" in batch
                           else next(iter(batch.values())).shape[0]), "kind": "train"}
    return train_step, args, extra
