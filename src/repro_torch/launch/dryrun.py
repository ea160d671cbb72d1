"""Multi-pod dry-run: every (architecture × input shape × mesh) cell's
per-rank FLOPs, bytes, collectives and memory.  Counterpart of
``repro/launch/dryrun.py``.

The reference lowers and compiles each cell's step on 512 placeholder
host devices and reads XLA's analyses.  The port runs rank 0's step
instead, in one process, on a fake world: a process group of 256
(single pod, (16, 16) on ("data", "model")) or 512 ranks (multi pod, (2,
16, 16) with "pod" in front) on ``torch.distributed``'s ``fake`` backend
(``FakeStore``), a ``DeviceMesh`` over it, and the state and the batch as
fake ``cuda`` tensors under a ``FakeTensorMode`` (fake ``cpu`` tensors
where the build has no CUDA: ``fake_device``): every operation runs on
shapes, every collective returns at once, no kernel runs.
Each rank's numbers:

* FLOPs and bytes: ``utils.flop_cost.measure`` (``step_cost``'s count, the
  device branch);
* collectives: the same count at the port's own collective helpers, and a
  second one from the dispatched c10d ops (``utils.hlo``): the two must
  agree (``collectives_agree``);
* argument bytes: the rank's placed shards;
* peak: ``torch.distributed._tools.mem_tracker.MemTracker`` over the step,
  the arguments included, in ``launch.analysis.memory_analysis_dict``'s
  keys.

Given a real mesh (``run_cell(..., mesh=)``) the same cell runs real
tensors on the mesh's devices and reads the CUDA allocator's peak.

The builders, each -> (fn, args, extra) with the arguments placed as the
reference's ``in_shardings``:

* ``build_train``: the sharded DFA step, ``fn(params, fb, opt_state,
  batch, seed) -> (params, opt_state, loss)``: the parameters and the
  momentum by ``make_param_shardings`` (ZeRO-3 over ``data``), the
  feedback by ``FEEDBACK_RULES``, the batch by ``make_batch_shardings``.
  The models gather each block's parameters (``dist.sharding.
  unshard_fsdp``), the gradients return to the shards through the gather's
  reduce-scatter, and SGD momentum (lr 0.01, momentum 0.9) updates each
  rank's shards.  A ``model`` axis above 1 runs tensor parallelism
  (``dist.sharding``): every family, the ``emu`` backend and
  ``dfa-layerwise`` included; it splits the storage of the parameters and
  the momentum, the feedback projections, the experts' products (expert
  parallel), and the decoder blocks' products (the dense, latent-attention
  and mixture-of-experts blocks' parts, ``DecoderBlock.column_parts``) and
  the serving head's (column-parallel, ``nn/linear.py``), so a rank counts
  1/m of their FLOPs
  and the activations' all-gathers and partial-gradient all-reduces; the
  other families' products run on gathered weights (``ROADMAP.md``).
  Once the state is placed the module's own parameters are released
  (``DFAModel.release_parameters``);
* ``build_prefill``: ``serve.decode.make_prefill``'s forward over a
  placed (B, S) batch, ``fn(params, batch) -> logits``;
* ``build_decode``: one ``make_serve_step(with_params=True)`` step against
  caches placed by ``serve.decode.cache_shardings``, ``fn(params, token,
  caches, cache_len[, enc]) -> (next token, logits, caches)`` (whisper
  decodes against its encoder output).

``VARIANT["name"] = "opt"`` (``--variant opt``) builds each arch's
``make_opt`` config where it has one, freezes the norm scales in the DFA
blocks and runs kimi-k2's training step in 4 microbatches, as the
reference.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch qwen3-1.7b ...] [--shape train_4k ...] [--mesh single|multi|both] \\
        [--out results/dryrun.json] [--hlo-dir results/hlo] [--variant baseline|opt]

or one sharded step on real ranks::

    from repro_torch.launch import dryrun, mesh as mesh_lib

    mesh_lib.init_process_group("cuda")
    mesh = mesh_lib.make_host_mesh(device_type="cuda")  # (ranks, 1)
    fn, args, extra = dryrun.build_train("qwen1.5-0.5b", mesh)
    params, opt_state, loss = fn(*args)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import numpy as np
import torch

from repro_torch import algos, configs
from repro_torch.algos.dfa import DFAConfig
from repro_torch.core import photonics
from repro_torch.core.feedback import FeedbackConfig
from repro_torch.data.tokens import MarkovTokens
from repro_torch.dist import sharding
from repro_torch.launch import analysis
from repro_torch.launch.mesh import AXES, POD_AXES
from repro_torch.serve.decode import cache_shardings, make_prefill, make_serve_step
from repro_torch.train.optimizer import SGDM
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.utils import flop_cost, hlo, prng
from repro_torch.utils.device import faking, resolve_device
from repro_torch.utils.tree import leaves

VARIANT = {"name": "baseline"}  # set by main(): the variant is process-wide

MESHES = {"single": (16, 16), "multi": (2, 16, 16)}


def _make_model(arch, dtype=torch.bfloat16, device=None):
    if VARIANT["name"] == "opt" and arch.make_opt is not None:
        return arch.make_opt(dtype, device=device)
    return arch.make_model(dtype, device=device)


def _dfa_config(dtype=torch.bfloat16) -> DFAConfig:
    """The paper system's training config: off-chip BPD noise in the
    feedback path, the feedback in the model's dtype (bf16 at full width;
    a smoke model's f32); the norm scales frozen in the ``opt`` variant."""
    return DFAConfig(photonics=photonics.preset("offchip_bpd"), backend="ref",
                     feedback=FeedbackConfig(dtype=dtype),
                     freeze_norms=(VARIANT["name"] == "opt"))


def _microbatches(arch) -> int:
    """kimi-k2's training step runs in 4 microbatches in the ``opt``
    variant: the tape, the error, the logits and the expert buffers scale
    with the microbatch."""
    return 4 if VARIANT["name"] == "opt" and arch.name == "kimi-k2-1t-a32b" else 1


def _model(arch, smoke: bool, dtype, device):
    return arch.make_smoke(device=device) if smoke else _make_model(arch, dtype, device)


def model_extras(arch, model, batch: int, kind: str, dtype) -> dict:
    """``arch.input_extras`` at ``model``'s own widths (a smoke model's
    frames or patches are narrower than the full config's)."""
    specs = arch.input_extras(batch, kind, dtype=dtype)
    c = model.cfg
    if "frames" in specs:
        specs["frames"] = torch.empty((batch, c.n_frames, c.d_model), dtype=dtype, device="meta")
    if "patch_embeds" in specs:
        v = c.vision
        specs["patch_embeds"] = torch.empty((batch, v.n_patches, v.d_vision), dtype=dtype,
                                            device="meta")
    return specs


def example_batch(arch, model, shape: configs.ShapeCase, seed: int, dtype,
                  kind: str = "train") -> dict:
    """A host batch of ``shape``'s global size: ``token_specs`` filled by
    ``MarkovTokens`` from ``seed``, and the frontend stubs' inputs
    (``model_extras``) drawn from a normal at 0.1.  Inside a
    ``FakeTensorMode`` (the fake world) the same shapes, zeros: nothing is
    drawn."""
    specs = dict(configs.token_specs(shape.global_batch, shape.seq_len))
    specs.update(model_extras(arch, model, shape.global_batch, kind, dtype))
    if faking():
        return {k: torch.zeros(tuple(s.shape), dtype=s.dtype) for k, s in specs.items()}
    batch = MarkovTokens(model.cfg.vocab_size, shape.seq_len, shape.global_batch,
                         seed).batch(0)
    rng = np.random.default_rng((seed, 7))
    out = {}
    for k, spec in specs.items():
        x = batch[k] if k in batch else rng.normal(size=tuple(spec.shape)) * 0.1
        out[k] = torch.as_tensor(np.asarray(x)).to(spec.dtype)
        assert tuple(out[k].shape) == tuple(spec.shape), (k, out[k].shape, spec.shape)
    return out


def _case(shape) -> configs.ShapeCase:
    return configs.SHAPES[shape] if isinstance(shape, str) else shape


def build_train(arch, mesh, *, shape="train_4k", dfa: DFAConfig | None = None,
                smoke: bool = False, dtype=torch.bfloat16, device=None, seed: int = 0,
                batch: dict | None = None):
    """-> (fn, (params, fb, opt_state, batch, seed), extra): the reference's
    sharded DFA step on ``mesh`` and its placed arguments.

    ``arch``: a name or an ``Arch``; ``smoke`` builds its smoke model.
    ``shape`` (a ``SHAPES`` name or a ``ShapeCase``) sizes the synthetic
    batch (``example_batch``, from ``seed`` folded with "batch") unless
    ``batch`` (a host batch) is given.
    ``dfa`` replaces ``_dfa_config`` (in the model's dtype).  ``mesh`` is a (data, model) or
    (pod, data, model) mesh, its ``model`` axis 1 or above.  The
    parameters are drawn from
    ``seed`` and the feedback from ``seed`` folded with "feedback", as
    ``Trainer.init_state`` draws them, so ``fn`` on a world of one is the
    trainer's single-device step.  ``extra`` holds the model, the trainer,
    ``value_and_grad`` (``fn``'s gradient half: ((loss, metrics), grads)
    with ``DTensor`` gradients), the in / out shardings, the placed
    parameters and the batch's token count."""
    arch = configs.get(arch) if isinstance(arch, str) else arch
    device = resolve_device(device)
    model = _model(arch, smoke, dtype, device)
    cfg = dfa or _dfa_config(next(model.parameters()).dtype)
    opt = SGDM(lr=0.01, momentum=0.9)
    algo = algos.get("dfa")
    microbatches = _microbatches(arch)
    trainer = Trainer(model, TrainerConfig(algo="dfa", dfa=cfg, optimizer=opt,
                                           microbatches=microbatches, data_parallel=False),
                      device=device, mesh=mesh)
    shape = _case(shape)
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
                                  sharding.local_batch(mesh, batch, microbatches),
                                  int(sharding.local(seed)))

    def train_step(params, fb, opt_state, batch, seed):
        (loss, _metrics), grads = value_and_grad(params, fb, batch, seed)
        new_params, new_opt, _ = opt.update(grads, opt_state, params)
        return new_params, new_opt, sharding.place_leaf(loss, rep)

    args = (placed, sharding.place(fb, fb_sh), opt_state, sharding.place(batch, batch_sh), seed)
    extra = {"model": model, "trainer": trainer, "value_and_grad": value_and_grad,
             "in_shardings": (params_sh, fb_sh, opt_sh, batch_sh, rep),
             "out_shardings": (params_sh, opt_sh, rep), "params": placed,
             "tokens": int(batch["tokens"].numel() if "tokens" in batch
                           else next(iter(batch.values())).shape[0]), "kind": "train"}
    return train_step, args, extra


def _serving_model(arch, mesh, smoke, dtype, device, seed):
    """The model of ``seed`` and its parameters placed by
    ``make_param_shardings`` (the caller releases the module's own once
    it has built what reads them)."""
    arch = configs.get(arch) if isinstance(arch, str) else arch
    device = resolve_device(device)
    model = _model(arch, smoke, dtype, device)
    model.init(seed)
    params = {k: v.detach() for k, v in model.named_parameters()}
    placed = sharding.place(params, sharding.make_param_shardings(mesh, params))
    return arch, model, placed


def build_prefill(arch, mesh, *, shape="prefill_32k", smoke: bool = False,
                  dtype=torch.bfloat16, device=None, seed: int = 0, batch: dict | None = None):
    """-> (fn, (params, batch), extra): ``make_prefill``'s forward of a
    ``shape`` (B, S) batch (tokens, and the frontend stubs' inputs; whisper
    its frames) on ``mesh``, the parameters placed by
    ``make_param_shardings``, the batch by ``make_batch_shardings``."""
    arch, model, placed = _serving_model(arch, mesh, smoke, dtype, device, seed)
    shape = _case(shape)
    if batch is None:
        full = example_batch(arch, model, shape, prng.fold(seed, "batch"),
                             next(iter(placed.values())).dtype, kind="prefill")
        batch = {k: v for k, v in full.items() if k != "labels"}
    model.release_parameters()
    extra = {"params": placed, "model": model, "tokens": shape.global_batch * shape.seq_len,
             "kind": "prefill"}
    placed_batch = sharding.place(batch, sharding.make_batch_shardings(mesh, batch))
    return make_prefill(model), (placed, placed_batch), extra


def build_decode(arch, mesh, shape="decode_32k", *, smoke: bool = False,
                 dtype=torch.bfloat16, device=None, seed: int = 0):
    """-> (fn, (params, token, caches, cache_len[, enc]), extra): one decode
    step of ``make_serve_step(with_params=True)`` at ``shape``'s batch
    against caches of its sequence length, placed by ``cache_shardings``;
    the token, the lengths and whisper's encoder output by
    ``make_batch_shardings``.  The caches are zeros and every length 0
    (the reference passes shapes alone)."""
    arch, model, placed = _serving_model(arch, mesh, smoke, dtype, device, seed)
    shape = _case(shape)
    b, s = shape.global_batch, shape.seq_len
    dt = next(iter(placed.values())).dtype
    caches = model.init_caches(b, s)
    model.release_parameters()
    caches = sharding.place(caches, cache_shardings(mesh, caches))
    dev = model.device
    host = {"token": torch.zeros((b, 1), dtype=torch.int64, device=dev),
            "cache_len": torch.zeros((b,), dtype=torch.int64, device=dev)}
    whisper = arch.name == "whisper-small"
    if whisper:
        host["enc"] = torch.zeros((b, model.cfg.n_frames, model.cfg.d_model), dtype=dt,
                                  device=dev)
    put = sharding.place(host, sharding.make_batch_shardings(mesh, host))
    args = (placed, put["token"], caches, put["cache_len"]) + ((put["enc"],) if whisper else ())
    extra = {"params": placed, "model": model, "tokens": b, "kind": "decode"}
    return make_serve_step(model, whisper_enc=whisper, with_params=True), args, extra


# ---------------------------------------------------------------------------
# the fake world and one cell
# ---------------------------------------------------------------------------


def mesh_shape(mesh_kind: str) -> tuple:
    """"single" -> (16, 16), "multi" -> (2, 16, 16), "AxB" / "AxBxC" ->
    that shape."""
    if mesh_kind in MESHES:
        return MESHES[mesh_kind]
    return tuple(int(n) for n in mesh_kind.split("x"))


@contextlib.contextmanager
def fake_world(shape: tuple):
    """A fake process group of prod(``shape``) ranks (this process rank 0;
    every collective returns at once) and a ``DeviceMesh`` of ``shape`` over
    it on ``fake_device()``, the axes ("data", "model") or ("pod", "data",
    "model"); the group is destroyed on exit.
    The caller enters ``FakeTensorMode`` for the tensors."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a fake world needs this process without a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    try:
        axes = POD_AXES if len(shape) == 3 else AXES
        yield DeviceMesh(fake_device(), torch.arange(math.prod(shape)).view(*shape),
                         mesh_dim_names=axes)
    finally:
        dist.destroy_process_group()


def _local_tensors(tree) -> list:
    """This rank's pieces of every tensor of ``tree``."""
    return [sharding.local(x) for x in leaves(tree) if isinstance(x, torch.Tensor)]


BUILDERS = {"train": build_train, "prefill": build_prefill, "decode": build_decode}


class _NoModules:
    """Stands in for ``MemTracker``'s module tracker: one global scope, no
    module hooks (their backward hooks break ``torch.autograd.grad`` over
    leaves, which the DFA engine calls, and the models run their blocks
    through ``functional_call`` on plain tensors)."""

    parents = frozenset({"Global"})
    is_bw = False

    def register_user_hooks(self, *hooks):
        del hooks

    def clear_user_hooks(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return None


def _peak_tracker():
    """A ``MemTracker`` that keeps the device's peak, without per-module
    statistics."""
    from torch.distributed._tools.mem_tracker import MemTracker

    tracker = MemTracker()
    tracker._mod_tracker = _NoModules()
    return tracker


def fake_device() -> str:
    """The fake world's device type: ``cuda`` where this build and machine
    have CUDA, else ``cpu`` (a CPU-only build cannot copy into a fake CUDA
    tensor).  Either way no kernel runs and nothing is allocated, and the
    counts are the same: ``step_cost`` counts one device's operations."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _measure_cell(arch, case, mesh, fake: bool, smoke: bool, hlo_path=None) -> dict:
    """Build and run the cell's step once on ``mesh`` -> the record's
    counts."""
    device = mesh.device_type
    fn, args, extra = BUILDERS[case.kind](arch, mesh, shape=case, smoke=smoke, device=device)
    local = _local_tensors(args)
    arg_bytes = sum(x.numel() * x.element_size() for x in local)
    tracker = None
    if fake:
        tracker = _peak_tracker()
        tracker.track_external(*local)
    elif torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    recorder = hlo.record()
    with tracker if tracker is not None else contextlib.nullcontext(), recorder:
        _, cost = flop_cost.measure(fn, *args)
    if tracker is not None:
        peak = max((v["Total"] for d, v in tracker.get_tracker_snapshot("peak").items()
                    if torch.device(d).type == device), default=0)  # the step's device only
        memory = analysis.memory_analysis_dict(device, arg_bytes, peak=peak)
    else:
        memory = analysis.memory_analysis_dict(device, arg_bytes)
    stats = hlo.analyze_collectives(recorder.rec)
    counted = {k: v for k, v in cost.coll_bytes_by_kind.items() if v}
    if hlo_path:
        os.makedirs(os.path.dirname(os.path.abspath(hlo_path)), exist_ok=True)
        with open(hlo_path, "w") as f:
            f.write("\n".join(recorder.rec.lines()) + "\n")
    return {
        "chips": int(mesh.mesh.numel()),
        "tokens": extra["tokens"],
        "n_params": analysis.tree_param_count(extra["params"]),
        "n_params_active": analysis.active_param_count(extra["params"], extra["model"]),
        "param_bytes": analysis.tree_param_bytes(extra["params"]),
        "argument_bytes": arg_bytes,
        "cost": analysis.cost_analysis_dict(cost),
        "memory": memory,
        "hlo_cost": cost.as_dict(),
        "collectives": {
            "total_bytes": stats.total_bytes,
            "total_count": stats.total_count,
            "bytes_by_kind": dict(stats.bytes_by_kind),
            "count_by_kind": dict(stats.count_by_kind),
        },
        "collectives_agree": (dict(stats.bytes_by_kind) == counted
                              and dict(stats.count_by_kind)
                              == {k: v for k, v in cost.coll_count_by_kind.items() if v}),
    }


def run_cell(arch_name: str, shape_name: str, mesh_kind: str, hlo_dir=None, *, mesh=None,
             shape: configs.ShapeCase | None = None, smoke: bool = False) -> dict:
    """One cell's record, with the reference's keys.  On a fake world of
    ``mesh_kind``'s shape ("single", "multi" or "AxB[xC]"), or on ``mesh``
    (a real mesh of this process's group) where given; ``shape`` replaces
    ``SHAPES[shape_name]`` (a reduced cell), ``smoke`` runs the smoke
    model.  A full-attention arch's ``long_500k`` is skipped, as the
    reference skips it."""
    arch = configs.get(arch_name)
    case = shape or configs.SHAPES[shape_name]
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind, "kind": case.kind,
           "variant": VARIANT["name"]}
    if shape_name == "long_500k" and not arch.sub_quadratic:
        rec["status"] = "skip"
        rec["reason"] = ("full-attention arch: 512k dense-KV decode is infeasible by design "
                         "(DESIGN.md §6)")
        return rec
    hlo_path = (os.path.join(hlo_dir, f"{arch_name}__{shape_name}__{mesh_kind}.collectives.txt")
                if hlo_dir else None)
    t0 = time.monotonic()  # a duration: immune to wall-clock steps
    try:
        if mesh is not None:
            rec.update(_measure_cell(arch, case, mesh, False, smoke, hlo_path))
        else:
            from torch._subclasses.fake_tensor import FakeTensorMode

            with fake_world(mesh_shape(mesh_kind)) as fake_mesh, \
                    FakeTensorMode(allow_non_fake_inputs=True):
                rec.update(_measure_cell(arch, case, fake_mesh, True, smoke, hlo_path))
    except Exception as ex:  # a cell's failure is its record
        rec["status"] = "error"
        rec["reason"] = f"{type(ex).__name__}: {ex}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        rec["seconds"] = round(time.monotonic() - t0, 1)
        return rec
    rec["seconds"] = round(time.monotonic() - t0, 1)
    rec["status"] = "ok"
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=list(configs.ASSIGNED))
    ap.add_argument("--shape", nargs="*", default=list(configs.SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--hlo-dir", default=None,
                    help="write each cell's collective record here")
    ap.add_argument("--variant", choices=["baseline", "opt"], default="baseline")
    args = ap.parse_args(argv)
    VARIANT["name"] = args.variant

    meshes = {"single": ["single"], "multi": ["multi"], "both": ["single", "multi"]}[args.mesh]

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    key_of = lambda r: (r["arch"], r["shape"], r["mesh"], r.get("variant", "baseline"))
    done = {key_of(r) for r in results if r.get("status") == "ok"}

    for arch_name in args.arch:
        for shape_name in args.shape:
            for mesh_kind in meshes:
                key = (arch_name, shape_name, mesh_kind, args.variant)
                if key in done:
                    print(f"[skip-done] {key}", flush=True)
                    continue
                print(f"[cell] {arch_name} × {shape_name} × {mesh_kind} …", flush=True)
                rec = run_cell(arch_name, shape_name, mesh_kind, args.hlo_dir)
                status = rec["status"]
                info = rec.get("reason", "")[:120] if status != "ok" else (
                    f"{rec.get('seconds', 0)}s "
                    f"flops={rec.get('cost', {}).get('flops', 0):.3g} "
                    f"coll={rec.get('collectives', {}).get('total_bytes', 0):.3g}B")
                print(f"  -> {status} {info}", flush=True)
                results = [r for r in results if key_of(r) != key]
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"done: {n_ok} ok, {n_skip} skip, {n_err} error", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
