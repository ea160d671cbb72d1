"""Rank-side scenarios of the port's data-parallel CPU tests.

``spawn(scenario, world, **kw)`` starts ``world`` processes with the
``spawn`` start method, each joining a gloo process group on localhost,
runs ``SCENARIOS[scenario](rank, world, **kw)`` in each and returns their
results by rank; a rank that raises, hangs past ``timeout`` or exits
nonzero fails the call.  This module imports torch and the port only (no
JAX): the tests compare what the ranks return with the reference in the
test process.
"""

from __future__ import annotations

import contextlib
import socket
import traceback

import numpy as np
import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, scenario, kw, queue):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        queue.put((rank, SCENARIOS[scenario](rank, world, **kw), None))
    except BaseException:  # reported to the test, then re-raised: the rank exits nonzero
        queue.put((rank, None, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def spawn(scenario: str, world: int, timeout: float = 240.0, **kw) -> list:
    """Run a scenario on ``world`` gloo ranks -> [result of rank 0, ...]."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, scenario, kw, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in procs:  # drain before joining
            rank, out, err = queue.get(timeout=timeout)
            results[rank] = out
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if errors:
        raise AssertionError("\n".join(errors))
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return [results[r] for r in range(world)]


# ---------------------------------------------------------------------------
# shared by the ranks and the test process
# ---------------------------------------------------------------------------


def session(data_parallel, **kw):
    from repro_torch import api

    return api.build_session(device="cpu", data_parallel=data_parallel, log_every=10**9, **kw)


def load_state(sess, params, fb):
    """A fresh state of ``sess`` holding the given numpy parameters and
    feedback."""
    state = sess.init_state()
    for k, v in params.items():
        state["params"][k] = torch.from_numpy(np.array(v))
    state["fb"] = {k: torch.from_numpy(np.array(v)) for k, v in fb.items()}
    return state


def np_tree(tree) -> dict:
    return {k: v.detach().float().numpy().copy() for k, v in tree.items()}


def grads_of(sess, state, batch, rng=7, window="global"):
    """((loss, metrics), grads) of one step through the trainer, as numpy.
    ``window``: "global" (the trainer's own), or under a mesh a rank-local
    stand-in: "local_scale" (s_a of this rank's rows only) or
    "local_noise" (this rank's own draw from the key)."""
    from repro_torch.core import photonics
    from repro_torch.hardware import drift

    trainer = sess.trainer
    put = trainer.put(batch)
    ctx = contextlib.nullcontext()
    if window != "global":
        rows = put.rows
        start, total = (rows.start, rows.total) if window == "local_scale" else (0, rows.count)
        group = None if window == "local_scale" else trainer._group
        local = photonics.RowWindow(start, rows.count, total, group)
        ctx = _forced_window(trainer, local)
    hw = state.get("hw")
    hw_ctx = drift.use_state(hw) if hw is not None else contextlib.nullcontext()
    with ctx, hw_ctx:
        (loss, metrics), grads = trainer._grads(state["params"], state["fb"], put, rng)
    return float(loss), {k: float(v) for k, v in metrics.items()}, np_tree(grads)


@contextlib.contextmanager
def _forced_window(trainer, window):
    """The trainer's windows replaced by ``window`` (a rank that took its
    scale or its noise from its own rows)."""
    original = trainer._window
    trainer._window = lambda rows: None if rows is None else window
    try:
        yield
    finally:
        trainer._window = original


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def _mlp(rank, world, params, fb, batch, odd, fit_dir, fit_steps, emu):
    from repro_torch.bench import report
    from repro_torch.data import mnist, pipeline

    out = {}
    for algo in ("dfa", "bp"):
        s = session(True, arch="mnist_mlp", smoke=True, algo=algo)
        out[f"ideal_{algo}"] = grads_of(s, load_state(s, params, fb), batch)
    # fit from the snapshot the test wrote at step 0 (every rank reads it)
    x, y = mnist.procedural_digits(256, seed=0)
    pipe = pipeline.ArrayClassification(x[:, :64], y, 32, seed=0)
    s = session(True, arch="mnist_mlp", smoke=True, ckpt_dir=fit_dir)
    state, _ = s.fit(pipe.batch, fit_steps, verbose=False)
    out["fit"] = np_tree(state["params"])
    # noise on: offchip_bpd through the bank kernel's plain version (input mode)
    s = session(True, arch="mnist_mlp", smoke=True, hardware="offchip_bpd", backend="cuda")
    st = load_state(s, params, fb)
    for window in ("global", "local_scale", "local_noise"):
        out[f"offchip_{window}"] = grads_of(s, st, batch, window=window)
    out["rows"] = tuple(s.trainer.put(batch).rows)
    out["multiplier"] = (report._shard_multiplier(s.mesh, batch),
                         report._shard_multiplier(s.mesh, odd))
    out["odd_rows"] = s.trainer.put(odd).rows
    out["offchip_odd"] = grads_of(s, st, odd)
    # dfa-fused's step: each block's gradient averaged before its update
    s = session(True, arch="mnist_mlp", smoke=True, hardware="offchip_bpd", backend="cuda",
                algo="dfa-fused")
    st = load_state(s, params, fb)
    new_p, _, loss = s.fused_step()(st["params"], st["fb"], st["opt"], s.trainer.put(batch), 7)
    out["fused"] = (float(loss), np_tree(new_p))
    # microbatches compose as the global batch's
    s = session(True, arch="mnist_mlp", smoke=True, hardware="offchip_bpd", backend="cuda",
                microbatches=2)
    out["micro"] = grads_of(s, load_state(s, params, fb), batch)
    out["mean"] = _mean_of_rank(s.trainer, rank)
    out["emu"] = _emu(rank, world, **emu)
    return out


def _mean_of_rank(trainer, rank):
    """The trainer's mean all-reduce on tensors of two dtypes, in buckets of
    at most 5 elements (a tensor listed twice is reduced once)."""
    from repro_torch.dist import sharding

    f = [torch.full((n,), float(rank + n)) for n in (3, 4, 7)]
    d = torch.full((2,), float(rank), dtype=torch.float64)
    sharding.all_reduce_mean([*f, d, f[0]], trainer._group, trainer._world, limit=5)
    return [t.numpy() for t in (*f, d)]


def _emu(rank, world, params, fb, batch):
    out = {}
    for kernel in ("ref", "cuda"):
        s = session(True, arch="mnist_mlp", smoke=True, hardware="emu_offchip", backend="emu",
                    emu_kernel=kernel)
        st = load_state(s, params, fb)
        for window in ("global", "local_noise"):
            out[f"{kernel}_{window}"] = grads_of(s, st, batch, window=window)
        new, _ = s.step(st, batch)
        out[f"{kernel}_hw"] = np_tree(new["hw"])
    return out


def _lm(rank, world, params, fb, batch, launcher_args):
    from repro_torch.launch import train as launch

    out = {}
    for hardware in ("ideal", "offchip_bpd"):
        s = session(True, arch="qwen1.5-0.5b", smoke=True, hardware=hardware, backend="cuda")
        st = load_state(s, params, fb)
        for window in ("global", "local_noise"):
            out[f"{hardware}_{window}"] = grads_of(s, st, batch, window=window)
    out["launcher"] = launch.main(launcher_args)
    return out


def _rule_index(shape, sharding, mesh) -> tuple:
    """This rank's slice of a whole tensor of ``shape`` under a
    ``Sharding``: each split dim cut into the mesh axis's size, this rank's
    chunk by its coordinate (an index of slices)."""
    index = [slice(None)] * len(shape)
    for d, entry in enumerate(sharding.spec):
        if entry is None:
            continue
        size = shape[d] // mesh.size(mesh.mesh_dim_names.index(entry))
        c = mesh.get_local_rank(entry)
        index[d] = slice(c * size, (c + 1) * size)
    return tuple(index)


def _rule_slice(full, sharding, mesh):
    return full[_rule_index(full.shape, sharding, mesh)]


def _shards_are_the_rules(placed, shardings, params, mesh) -> int:
    """Raise unless every local shard is its rule's slice -> the count of
    leaves split on some axis."""
    split = 0
    for k, t in placed.items():
        expect = _rule_slice(torch.from_numpy(params[k]), shardings[k], mesh)
        if not torch.equal(t.to_local(), expect):
            raise AssertionError(f"{k}: the local shard is not the rule's slice")
        split += any(e is not None for e in shardings[k].spec)
    return split


def _elastic_save(rank, world, params, path, data, model):
    """Place the parameters by PARAM_RULES on a (data, model) mesh and save."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import checkpoint

    mesh = mesh_lib.make_host_mesh(data * model, model_axis=model, device_type="cpu")
    sh = sharding.make_param_shardings(mesh, {k: torch.from_numpy(v) for k, v in params.items()})
    placed = {k: distribute_tensor(torch.from_numpy(v), mesh, sh[k].placements,
                                   src_data_rank=None) for k, v in params.items()}
    split = _shards_are_the_rules(placed, sh, params, mesh)
    checkpoint.save(path, {"params": placed}, step=7)
    return {"split": split}


def _elastic_load(rank, world, params, path, batch):
    """Restore under a mesh of this world's size: each shard the rule's, the
    logical tensors the saved ones bit for bit, and the smoke model's loss."""
    from repro_torch import configs
    from repro_torch.dist import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import checkpoint

    mesh = mesh_lib.make_host_mesh(world, device_type="cpu")
    template = {k: torch.zeros(v.shape) for k, v in params.items()}
    sh = sharding.make_param_shardings(mesh, template)
    restored, step = checkpoint.load(path, {"params": template}, shardings={"params": sh})
    placed = restored["params"]
    split = _shards_are_the_rules(placed, sh, params, mesh)
    full = {k: t.full_tensor() for k, t in placed.items()}
    exact = all(torch.equal(full[k], torch.from_numpy(v)) for k, v in params.items())
    model = configs.get("qwen3-1.7b").make_smoke(device="cpu")
    model.load_state_dict(full)
    with torch.no_grad():
        loss, _ = model.loss(model.param_dict(), {k: torch.from_numpy(v).long()
                                                  for k, v in batch.items()})
    return {"step": step, "split": split, "exact": exact, "loss": float(loss)}


# ---------------------------------------------------------------------------
# FSDP: launch/dryrun.build_train's sharded step
# ---------------------------------------------------------------------------

FSDP_MESHES = {"data": (4, 1), "pod": (2, 2, 1)}
FSDP_HARDWARE = ("ideal", "offchip_bpd")


def fsdp_mesh(shape):
    """A (data, model) or (pod, data, model) mesh over the group's first
    ranks, on the CPU."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import mesh as mesh_lib

    axes = mesh_lib.AXES if len(shape) == 2 else mesh_lib.POD_AXES
    n = int(np.prod(shape))
    return DeviceMesh("cpu", torch.arange(n).view(*shape), mesh_dim_names=axes)


def fsdp_step(arch, mesh, hardware, params, fb, batch, seed=0, dfa=None):
    """``build_train``'s step of the smoke ``arch`` on ``mesh`` (the bank
    kernel's plain version on ``hardware``, or the ``dfa`` config given)
    with the given numpy parameters and feedback placed as its arguments
    -> (fn, args, extra)."""
    from repro_torch.algos.dfa import DFAConfig
    from repro_torch.core import photonics
    from repro_torch.dist import sharding
    from repro_torch.launch import dryrun

    cfg = dfa or DFAConfig(photonics=photonics.preset(hardware), backend="cuda")
    host = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    fn, args, extra = dryrun.build_train(arch, mesh, smoke=True, dfa=cfg, device="cpu",
                                         batch=host, seed=seed)
    p_sh, f_sh = extra["in_shardings"][:2]
    placed = sharding.place({k: torch.from_numpy(np.array(v)) for k, v in params.items()}, p_sh)
    fb = sharding.place({k: torch.from_numpy(np.array(v)) for k, v in fb.items()}, f_sh)
    return fn, (placed, fb, extra["trainer"].cfg.optimizer.init(placed), args[3], 7), extra


def fsdp_grads(extra, args) -> tuple:
    """(loss, whole gradients as numpy) of the sharded step's gradient half
    (every rank gathers them)."""
    from repro_torch.dist import sharding

    (loss, _), grads = extra["value_and_grad"](args[0], args[1], args[3], args[4])
    return float(loss), np_tree({k: sharding.full_tensor(g) for k, g in grads.items()})


def replicate_backward_gather(xs):
    """The negative control of ``sharding.gather_fsdp``: ``DTensor``'s own
    redistribute to ``Replicate`` over data and ``to_local``, whose backward
    keeps each rank's gradient of its own rows."""
    from torch.distributed.tensor import Replicate

    out = []
    for x in xs:
        placements = list(x.placements)
        placements[x.device_mesh.mesh_dim_names.index("data")] = Replicate()
        out.append(x.redistribute(x.device_mesh, placements).to_local())
    return out


def _collective_expectation(params, metrics) -> dict:
    """The collective bytes a sharded dfa step must count, from its placed
    parameters: every split leaf's shard all-gathered in the forward, and a
    block's again in its recompute, its full gradient reduce-scattered; the
    replicated leaves' gradients and the metrics (f32 scalars; the loss is
    the metrics' "loss", reduced once) mean-all-reduced, and one 4-byte MAX
    of s_a: every projection reads the one tapped error."""
    from repro_torch.dist import sharding

    split = {k for k, x in params.items() if sharding._fsdp_dim(x) is not None}
    local = {k: x.to_local().numel() * x.element_size() for k, x in params.items()}
    full = {k: x.numel() * x.element_size() for k, x in params.items()}
    block = {k for k in params if not k.startswith(("embed.", "head."))}
    return {"all-gather": sum(local[k] * (2 if k in block else 1) for k in split),
            "reduce-scatter": sum(full[k] for k in split),
            "all-reduce": sum(full[k] for k in params if k not in split)
            + 4 * len(metrics) + 4}


def _fsdp(rank, world, cases, moe, ckpt):
    """Every family's sharded step on both meshes, noise off and on, with
    the checks of the first case on the data mesh; qwen2-moe against the
    replicated data-parallel step; the step's collective bytes and a
    data-parallel step's; the sharded checkpoint (2, 1) -> (4, 1)."""
    from repro_torch.dist import sharding
    from repro_torch.utils import flop_cost

    out = {"grads": {}}
    first = next(iter(cases))
    for kind, shape in FSDP_MESHES.items():
        mesh = fsdp_mesh(shape)
        for arch, case in cases.items():
            for hardware in FSDP_HARDWARE:
                fn, args, extra = fsdp_step(arch, mesh, hardware, **case)
                out["grads"][kind, arch, hardware] = fsdp_grads(extra, args)
            out.setdefault("shards", {})[kind, arch] = _shards_are_the_rules(
                args[0], extra["in_shardings"][0], case["params"], mesh)
            out.setdefault("full_tensor", {})[kind, arch] = all(
                torch.equal(sharding.full_tensor(x), x.full_tensor()) for x in args[0].values())
        if kind != "data":
            continue
        fn, args, extra = fsdp_step(first, mesh, "offchip_bpd", **cases[first])
        out["released"] = (all(p.is_meta for p in extra["model"].parameters()),
                           extra["model"].device.type)
        new_p, new_o, loss = fn(*args)
        out["placements"] = (
            all(new_p[k].placements == args[0][k].placements
                and new_o["mom"][k].placements == args[2]["mom"][k].placements for k in new_p),
            new_o["step"], tuple(type(p).__name__ for p in loss.placements))
        out["step"] = (float(loss.to_local()), np_tree({k: sharding.full_tensor(v)
                                                         for k, v in new_p.items()}))
        out["algos"] = _fsdp_algos(mesh, extra, args)
        gather = sharding.gather_fsdp
        sharding.gather_fsdp = replicate_backward_gather
        try:
            out["control"] = fsdp_grads(extra, args)
        finally:
            sharding.gather_fsdp = gather
        fn, args, extra = fsdp_step(first, mesh, "ideal", **cases[first])
        (_, metrics), _ = extra["value_and_grad"](args[0], args[1], args[3], args[4])
        _, cost = flop_cost.measure(fn, *args)
        out["cost"] = (dict(cost.coll_bytes_by_kind), cost.as_dict(),
                       _collective_expectation(args[0], metrics))
        s = session(True, arch=first, smoke=True, hardware="ideal", backend="cuda")
        st = load_state(s, cases[first]["params"], cases[first]["fb"])
        cost = s.trainer.step_cost(st, cases[first]["batch"])
        _, metrics, grads = grads_of(s, st, cases[first]["batch"])
        out["dp_cost"] = (dict(cost.coll_bytes_by_kind), 4 * sum(g.size for g in grads.values())
                          + 4 * len(metrics) + 4)
        fn, args, extra = fsdp_step("qwen2-moe-a2.7b", mesh, "offchip_bpd", **moe)
        out["moe"] = fsdp_grads(extra, args)
        s = session(True, arch="qwen2-moe-a2.7b", smoke=True, hardware="offchip_bpd",
                    backend="cuda")
        out["moe_dp"] = grads_of(s, load_state(s, moe["params"], moe["fb"]), moe["batch"])
    out["ckpt"] = _fsdp_checkpoint(rank, first, **ckpt)
    return out if rank == 0 else {k: out[k] for k in ("ckpt",)}


def _fsdp_algos(mesh, extra, args) -> dict:
    """bp and dfa-layerwise gradients and the dfa-fused step on the sharded
    state: bp reaches the gathers through autograd, the other two through
    the block recompute."""
    from repro_torch import algos
    from repro_torch.dist import sharding
    from repro_torch.train.trainer import Trainer, TrainerConfig

    trainer, model = extra["trainer"], extra["model"]
    cfg, opt = trainer.cfg.dfa, trainer.cfg.optimizer
    batch, fb = sharding.local_batch(mesh, args[3]), sharding.to_local(args[1])
    out = {}
    with sharding.use_mesh(mesh):
        for algo in ("bp", "dfa-layerwise"):
            t = Trainer(model, TrainerConfig(algo=algo, dfa=cfg, data_parallel=False),
                        device="cpu", mesh=mesh)
            (loss, _), grads = t._grads(args[0], fb, batch, args[4])
            out[algo] = (float(loss), np_tree({k: sharding.full_tensor(g)
                                               for k, g in grads.items()}))
        step = algos.get("dfa-fused").fused_step(model, cfg, opt, reduce=trainer.mean_tree)
        with trainer.window(batch):
            params, _, loss = step(args[0], fb, args[2], batch, args[4])
        out["dfa-fused"] = (float(loss), np_tree({k: sharding.full_tensor(p)
                                                  for k, p in params.items()}))
    return out


def _fsdp_checkpoint(rank, arch, params, fb, batches, path):
    """Ranks 0-1 take a sharded step on a (2, 1) mesh and save its state;
    every rank restores it on (4, 1) and steps: the losses of the second
    step on both meshes (ranks 2-3 join the save's barrier)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import checkpoint

    two = mesh_lib.make_host_mesh(2, device_type="cpu")  # every rank builds it
    out = {}
    if rank < 2:
        fn, args, extra = fsdp_step(arch, two, "offchip_bpd", params, fb, batches[0])
        p, o, loss = fn(*args)
        checkpoint.save(path, {"params": p, "opt": o}, step=1)
        fn2, args2, _ = fsdp_step(arch, two, "offchip_bpd", params, fb, batches[1])
        out["two"] = float(fn2(p, args2[1], o, args2[3], 8)[2].to_local())
    else:
        dist.barrier()
    four = fsdp_mesh((4, 1))
    fn, args, extra = fsdp_step(arch, four, "offchip_bpd", params, fb, batches[1])
    p_sh, _, o_sh = extra["in_shardings"][:3]
    state, step = checkpoint.load(path, {"params": args[0], "opt": args[2]},
                                  shardings={"params": p_sh, "opt": o_sh})
    out["four"] = (step, float(fn(state["params"], args[1], state["opt"], args[3], 8)[2]
                               .to_local()))
    return out


# ---------------------------------------------------------------------------
# tensor parallelism: build_train's step on meshes with a model axis
# ---------------------------------------------------------------------------

TP_MESHES = {"tp12": (1, 2), "tp14": (1, 4), "tp22": (2, 2), "tp212": (2, 1, 2)}
TP_ARCHS = {"tp12": ("qwen1.5-0.5b", "mnist_mlp"), "tp14": ("qwen1.5-0.5b", "qwen3-1.7b"),
            "tp22": ("qwen1.5-0.5b",), "tp212": ("qwen1.5-0.5b",)}
TP_STEPS = 2
def _tp_mesh(name):
    """``TP_MESHES[name]`` over the group's first ranks (every rank builds
    it); the 2-D ones through ``launch.mesh.make_host_mesh``."""
    from repro_torch.launch import mesh as mesh_lib

    shape = TP_MESHES[name]
    if len(shape) == 2:
        return mesh_lib.make_host_mesh(shape[0] * shape[1], model_axis=shape[1],
                                       device_type="cpu")
    return fsdp_mesh(shape)


def _tp(rank, world, cases, ckpt):
    """Every mesh's sharded step (noise off and on) for its archs, two
    noisy steps' shards, the groups; on (1, 2) the operators, bp and
    dfa-fused and the collective bytes; on (1, 4) the modules; the (2, 2)
    checkpoint restored on (4, 1)."""
    import torch.distributed as dist

    from repro_torch.dist import sharding
    from repro_torch.utils import prng

    out = {"grads": {}, "shards": {}, "groups": {}}
    for name in TP_MESHES:
        mesh = _tp_mesh(name)
        if rank >= mesh.mesh.numel():
            continue
        out["groups"][name] = (dist.get_process_group_ranks(sharding.model_group(mesh)),
                               sharding.model_index(mesh))
        for arch in TP_ARCHS[name]:
            for hardware in FSDP_HARDWARE:
                _, args, extra = fsdp_step(arch, mesh, hardware, **cases[arch])
                out["grads"][name, arch, hardware] = fsdp_grads(extra, args)
        arch = TP_ARCHS[name][0]
        fn, (p, fb, o, batch, _), extra = fsdp_step(arch, mesh, "offchip_bpd", **cases[arch])
        for i in range(TP_STEPS):
            p, o, _ = fn(p, fb, o, batch, prng.step_key(0, i, "noise"))
        out["shards"][name] = {k: (v.to_local().numpy().copy(),
                                   _rule_index(v.shape, extra["in_shardings"][0][k], mesh))
                               for k, v in p.items()}
        if name == "tp12":
            out["operators"] = _tp_operators(mesh)
            _, args, extra = fsdp_step(arch, mesh, "offchip_bpd", **cases[arch])
            out["algos"] = _tp_algos(mesh, extra, args)
            out["cost"] = _tp_cost(mesh, cases[arch])
        if name == "tp14":
            out["modules"] = _tp_modules(mesh)
    try:
        from repro_torch.launch import mesh as mesh_lib

        mesh_lib.make_host_mesh(4, model_axis=3, device_type="cpu")
    except ValueError as e:
        out["indivisible"] = str(e)
    out["ckpt"] = _tp_checkpoint(rank, **ckpt)
    keep = ("shards", "groups", "operators", "modules", "ckpt")
    return out if rank == 0 else {k: out[k] for k in keep if k in out}


def _tp_operators(mesh) -> dict:
    """The model-axis operators and ``annotate`` on the active mesh against
    one-process autograd of the same function of the whole tensors (every
    rank draws the whole inputs): the largest |difference| of each."""
    from repro_torch.dist import sharding

    with sharding.use_mesh(mesh):
        return _operators_on(sharding, *sharding.model_index(mesh))


def _operators_on(sharding, index, size) -> dict:
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(3, 8, generator=gen)
    w = torch.randn(size, 3, 8, generator=gen)  # one weight a rank
    n = 8 // size
    mine = slice(index * n, (index + 1) * n)

    def diff(a, b):
        return float((a - b).abs().max())

    out = {}
    # copy: sum_r <copy(x), w_r> -> d/dx = sum_r w_r
    xg = x.clone().requires_grad_()
    (g,) = torch.autograd.grad((sharding.copy_to_model(xg) * w[index]).sum(), xg)
    out["copy_to_model"] = diff(g, w.sum(0))
    # gather: <gather(x_r), w_0>, the same on every rank -> d/dx_r = w_0's piece
    xr = x[:, mine].clone().requires_grad_()
    y = sharding.gather_from_model(xr, -1)
    (g,) = torch.autograd.grad((y * w[0]).sum(), xr)
    out["gather_from_model"] = max(diff(y, x), diff(g, w[0][:, mine]))
    # split: <split(x), w_r's piece> on each rank, the pieces' gradients
    # gathered -> d/dx = every rank's piece of its own w_r
    xg = x.clone().requires_grad_()
    y = sharding.split_to_model(xg, -1)
    (g,) = torch.autograd.grad((y * w[index][:, mine]).sum(), xg)
    expect = torch.cat([w[r][:, r * n:(r + 1) * n] for r in range(size)], dim=-1)
    out["split_to_model"] = max(diff(y, x[:, mine]), diff(g, expect))
    # reduce: sum_r x_r -> d/dx_r = the upstream gradient
    xr = (x * (index + 1)).requires_grad_()
    y = sharding.reduce_from_model(xr)
    (g,) = torch.autograd.grad((y * w[0]).sum(), xr)
    out["reduce_from_model"] = max(diff(y, x * size * (size + 1) / 2), diff(g, w[0]))
    # annotate: the models' activations are plain tensors, whole on every
    # rank, and every rule leaves them as they are
    x3 = x.reshape(1, 3, 8)
    out["annotate"] = float(any(sharding.annotate(x3, name) is not x3
                                for name in sharding.ACT_RULES))
    return out


def _tp_modules(mesh) -> dict:
    """Whisper's plain MLP, the gated FFN, the MLP's dense block and an
    attention layer whose q, k and v all split in the middle of a head (2
    heads of 16 over 4 ranks), their leaves placed by the rules (each rank
    holding its pieces) and read through the FSDP gather, against the whole
    modules in this process: the output and every parameter's gradient,
    largest |difference|."""
    from torch.func import functional_call

    from repro_torch.dist import sharding
    from repro_torch.nn.attention import Attention
    from repro_torch.nn.linear import MLP, DenseBlock, GatedMLP

    out = {}
    for name, module in (("mlp", MLP(32, 64)), ("gated_mlp", GatedMLP(32, 64)),
                         ("dense_block", DenseBlock(32, 64)),
                         ("attention", Attention(32, 2, 2, head_dim=16, qkv_bias=True))):
        module.init(5)
        x = torch.randn(2, 6, 32, generator=torch.Generator().manual_seed(3))
        whole = {k: v.detach().requires_grad_() for k, v in module.named_parameters()}
        y = functional_call(module, whole, (x,))
        expect = torch.autograd.grad((y * y).sum(), list(whole.values()))
        with sharding.use_mesh(mesh):
            leaves = {k: v.requires_grad_() for k, v in sharding.place(
                whole, sharding.make_param_shardings(mesh, whole)).items()}
            assert all(v.to_local().shape != v.shape for v in leaves.values()), name
            y_tp = functional_call(module, sharding.unshard_fsdp(leaves), (x,))
            got = torch.autograd.grad((y_tp * y_tp).sum(), list(leaves.values()))
            got = [sharding.full_tensor(g) for g in got]
        out[name] = max([float((y_tp - y).abs().max())]
                        + [float((g - e).abs().max()) for g, e in zip(got, expect)])
    return out


def _tp_algos(mesh, extra, args) -> dict:
    """bp (autograd through the operators end to end) and the dfa-fused
    step on the sharded state of the (1, 2) mesh."""
    from repro_torch import algos
    from repro_torch.dist import sharding
    from repro_torch.train.trainer import Trainer, TrainerConfig

    trainer, model = extra["trainer"], extra["model"]
    cfg, opt = trainer.cfg.dfa, trainer.cfg.optimizer
    batch, fb = sharding.local_batch(mesh, args[3]), sharding.to_local(args[1])
    with sharding.use_mesh(mesh):
        t = Trainer(model, TrainerConfig(algo="bp", dfa=cfg, data_parallel=False),
                    device="cpu", mesh=mesh)
        (loss, _), grads = t._grads(args[0], fb, batch, args[4])
        out = {"bp": (float(loss), np_tree({k: sharding.full_tensor(g)
                                             for k, g in grads.items()}))}
        step = algos.get("dfa-fused").fused_step(model, cfg, opt, reduce=trainer.mean_tree)
        with trainer.window(batch):
            params, _, loss = step(args[0], fb, args[2], batch, args[4])
        out["dfa-fused"] = (float(loss), np_tree({k: sharding.full_tensor(p)
                                                  for k, p in params.items()}))
    return out


def _tp_cost(mesh, case) -> tuple:
    """``step_cost``'s collective bytes of a sharded dfa step's gradients by
    kind, and the operand bytes the ``torch.distributed`` calls saw."""
    from repro_torch.utils import flop_cost

    _, args, extra = fsdp_step("qwen1.5-0.5b", mesh, "offchip_bpd", **case)
    seen: dict = {}
    restore = _counted_calls(seen)
    try:
        _, cost = flop_cost.measure(extra["value_and_grad"], args[0], args[1], args[3], args[4])
    finally:
        restore()
    return dict(cost.coll_bytes_by_kind), seen


def _tp_checkpoint(rank, arch, params, fb, batches, path):
    """A step on the (2, 2) mesh saved through ``train/checkpoint.py`` and
    restored on (4, 1): the logical tensors equal, and the next step's loss
    on both meshes."""
    from repro_torch.dist import sharding
    from repro_torch.train import checkpoint

    two = _tp_mesh("tp22")
    fn, args, _ = fsdp_step(arch, two, "offchip_bpd", params, fb, batches[0])
    p, o, _ = fn(*args)
    checkpoint.save(path, {"params": p, "opt": o}, step=1)
    whole = {k: sharding.full_tensor(v) for k, v in p.items()}
    fn2, args2, _ = fsdp_step(arch, two, "offchip_bpd", params, fb, batches[1])
    loss22 = float(fn2(p, args2[1], o, args2[3], 8)[2].to_local())
    four = fsdp_mesh((4, 1))
    fn, args, extra = fsdp_step(arch, four, "offchip_bpd", params, fb, batches[1])
    p_sh, _, o_sh = extra["in_shardings"][:3]
    state, step = checkpoint.load(path, {"params": args[0], "opt": args[2]},
                                  shardings={"params": p_sh, "opt": o_sh})
    same = all(torch.equal(sharding.full_tensor(state["params"][k]), v) for k, v in whole.items())
    loss41 = float(fn(state["params"], args[1], state["opt"], args[3], 8)[2].to_local())
    return {"step": step, "same": same, "loss22": loss22, "loss41": loss41}


def _counted_calls(seen: dict):
    """Wrap ``torch.distributed``'s collectives to add each one's operand
    bytes to ``seen`` by kind -> the function that restores them."""
    import torch.distributed as dist

    kinds = {"all_gather_into_tensor": ("all-gather", 1), "all_reduce": ("all-reduce", 0),
             "reduce_scatter_tensor": ("reduce-scatter", 1)}
    saved = {n: getattr(dist, n) for n in kinds}

    def wrap(name):
        kind, at = kinds[name]

        def call(*a, **kw):
            seen[kind] = seen.get(kind, 0) + a[at].numel() * a[at].element_size()
            return saved[name](*a, **kw)

        return call

    for name in kinds:
        setattr(dist, name, wrap(name))

    def restore():
        for name, fn in saved.items():
            setattr(dist, name, fn)

    return restore


def _tp_card(rank, world, seed, seq, batch):
    """Full-width qwen1.5-0.5b's tensor-parallel step on a (1, 2) mesh of
    two ranks on one card (gloo), f32, offchip_bpd through the bank kernel:
    each piece against an independent init, the bank launches a step, the
    resident bytes' share of the replicated state, ``step_cost``'s
    collective bytes against the calls', and on rank 0 step 1's loss and
    gradients and the parameters after 2 steps against the one process's
    (the largest max |diff| / max |one process| over the leaves)."""
    from repro_torch import api, configs
    from repro_torch.algos.dfa import DFAConfig
    from repro_torch.core import photonics
    from repro_torch.data import tokens
    from repro_torch.dist import sharding
    from repro_torch.kernels import photonic_matmul as pm
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.utils import flop_cost, prng

    arch, device = "qwen1.5-0.5b", "cuda"
    dfa = DFAConfig(photonics=photonics.preset("offchip_bpd"), backend="cuda")
    mesh = mesh_lib.make_host_mesh(2, model_axis=2, device_type=device)
    vocab = configs.get(arch).make_model(device="meta").cfg.vocab_size
    gen = tokens.MarkovTokens(vocab, seq, batch, seed)
    keys = [prng.step_key(seed, i, "noise") for i in range(2)]
    fn, (p, fb, o, b0, _), extra = dryrun.build_train(
        arch, mesh, dfa=dfa, dtype=torch.float32, device=device, seed=seed,
        batch={k: torch.as_tensor(v) for k, v in gen.batch(0).items()})
    full = api.build_model(arch, dtype=torch.float32, device=device, seed=seed)
    slices = {k: _rule_index(v.shape, extra["in_shardings"][0][k], mesh)
              for k, v in full.named_parameters()}
    pieces = all(torch.equal(p[k].to_local(), v.detach()[slices[k]])
                 for k, v in full.named_parameters())
    del full
    replicated = 2 * sum(x.numel() * x.element_size() for x in p.values())
    resident = sum(x.to_local().numel() * x.element_size()
                   for tree in (p, o["mom"]) for x in tree.values())
    seen: dict = {}
    restore = _counted_calls(seen)
    pm.launches = 0
    try:
        ((loss1, _), grads), cost = flop_cost.measure(extra["value_and_grad"], p, fb, b0,
                                                      keys[0])
    finally:
        restore()
    launches = [pm.launches]
    grads1 = {k: sharding.full_tensor(g).cpu() for k, g in grads.items()}
    p, o, _ = extra["trainer"].cfg.optimizer.update(grads, o, p)
    del grads
    b1 = sharding.place({k: torch.as_tensor(v) for k, v in gen.batch(1).items()},
                        extra["in_shardings"][3])
    pm.launches = 0
    p, o, loss2 = fn(p, fb, o, b1, keys[1])
    launches.append(pm.launches)
    params2 = {k: sharding.full_tensor(v).cpu() for k, v in p.items()}
    out = {"pieces": pieces, "share": resident / replicated, "launches": launches,
           "counted": dict(cost.coll_bytes_by_kind), "seen": seen, "loss1": float(loss1),
           "loss2": float(loss2.to_local())}
    del fn, p, fb, o, b0, b1, extra
    torch.cuda.empty_cache()
    if rank != 0:
        return out
    s = api.build_session(arch=arch, smoke=False, dtype=torch.float32, seed=seed, algo="dfa",
                          hardware="offchip_bpd", backend="cuda", data_parallel=False,
                          log_every=10**9, device=device)
    state = s.init_state()
    (one_loss, _), one = s.trainer._grads(state["params"], state["fb"],
                                          s.trainer.put(gen.batch(0)), keys[0])

    def worst(got, expect):
        return max(float((got[k].double() - e.double().cpu()).abs().max()
                         / max(float(e.abs().max()), 1e-30)) for k, e in expect.items())

    out.update(one_loss=float(one_loss), grad_err=worst(grads1, one))
    del one
    for i in range(2):
        state, _ = s.step(state, gen.batch(i))
    out["params2_err"] = worst(params2, state["params"])
    return out


# ---------------------------------------------------------------------------
# tensor parallelism for the other families, the emu backend and
# dfa-layerwise
# ---------------------------------------------------------------------------

TPF_MOE = "qwen2-moe-a2.7b"
TPF_ARCHS = {"tp12": (TPF_MOE, "minicpm3-4b", "mamba2-130m", "recurrentgemma-9b",
                      "whisper-small", "internvl2-2b"),
             "tp14": (TPF_MOE,)}
TPF_EMU_KERNELS = ("ref", "cuda")  # the unfused chain and the kernel's plain version
# (output columns, bank rows) of the emu column checks: panels shared by
# every rank's window; on (1, 4) also windows of 10 columns in panels of 30,
# where only the last rank's ends on a panel's edge, and of 25 in panels of
# 8, where a neighbour's widened window reaches only the rank's edge rows
TPF_EMU_COLUMNS = {"tp12": ((130, 50),), "tp14": ((132, 50), (40, 30), (100, 8))}


def _tp_families(rank, world, cases, emu, layerwise):
    """Each family's sharded step (noise off and on) on its meshes, two
    noisy steps' pieces and, for the MoE, the expert FLOPs and the
    collective bytes; on (1, 2) the emu backend's step (both kernels) and
    dfa-layerwise's gradients; on both meshes the emu product's columns
    against one process's."""
    from repro_torch.utils import flop_cost, prng

    out = {"grads": {}, "shards": {}, "moe": {}, "emu_columns": {}}
    for name, archs in TPF_ARCHS.items():
        mesh = _tp_mesh(name)
        if rank >= mesh.mesh.numel():
            continue
        for arch in archs:
            for hardware in FSDP_HARDWARE:
                _, args, extra = fsdp_step(arch, mesh, hardware, **cases[arch])
                out["grads"][name, arch, hardware] = fsdp_grads(extra, args)
            fn, (p, fb, o, batch, _), extra = fsdp_step(arch, mesh, "offchip_bpd",
                                                        **cases[arch])
            for i in range(TP_STEPS):
                p, o, _ = fn(p, fb, o, batch, prng.step_key(0, i, "noise"))
            out["shards"][name, arch] = {
                k: (v.to_local().numpy().copy(), _rule_index(v.shape, extra["in_shardings"][0][k],
                                                             mesh)) for k, v in p.items()}
        _, args, extra = fsdp_step(TPF_MOE, mesh, "offchip_bpd", **cases[TPF_MOE])
        seen: dict = {}
        restore = _counted_calls(seen)
        try:
            _, cost = flop_cost.measure(extra["value_and_grad"], args[0], args[1], args[3],
                                        args[4])
        finally:
            restore()
        local = {k: v.to_local().shape[0] for k, v in args[0].items() if ".experts." in k}
        out["moe"][name] = {"experts": cost.region_flops.get("experts", 0),
                            "counted": dict(cost.coll_bytes_by_kind), "seen": seen,
                            "local_experts": local}
        out["emu_columns"][name] = {case: _tp_emu_columns(mesh, *case)
                                    for case in TPF_EMU_COLUMNS[name]}
        if name == "tp12":
            out["emu"] = {kernel: _tp_emu_step(mesh, kernel, **emu) for kernel in TPF_EMU_KERNELS}
            out["layerwise"] = _tp_layerwise(mesh, **layerwise)
    return out if rank == 0 else {k: out[k] for k in ("shards", "moe", "emu_columns")}


def _tp_emu_columns(mesh, m, rows) -> dict:
    """This rank's columns of an emu_offchip product of ``m`` columns on a
    bank of ``rows`` rows (its rows of B, a bank panel shared with a
    neighbour) in its column window, through both kernels, against the
    one-process product's columns: equal bit for bit, and the largest
    |difference| / max |product|."""
    import dataclasses

    from repro_torch.core import photonics
    from repro_torch.dist import sharding

    cfg = dataclasses.replace(photonics.preset("emu_offchip"), bank_rows=rows)
    index, size = sharding.model_index(mesh)
    gen = torch.Generator().manual_seed(21)
    a, b = torch.randn(6, 90, generator=gen), torch.randn(m, 90, generator=gen)
    n = m // size
    mine = slice(index * n, (index + 1) * n)
    out = {"window": (index * n, n)}
    for kernel in TPF_EMU_KERNELS:
        backend = photonics.EmulatedMRRBackend(emu_kernel=kernel)
        full = backend.matmul(a, b, cfg, key=5)
        window = photonics.ColumnWindow(index * n, n, m, sharding.model_group(mesh))
        with photonics.column_window(window):
            part = backend.matmul(a, b[mine], cfg, key=5)
        out[kernel] = (torch.equal(part, full[:, mine]),
                       float((part - full[:, mine]).abs().max() / full.abs().max()))
    return out


def _tp_emu_step(mesh, kernel, arch, params, fb, batch):
    """The smoke ``arch``'s sharded dfa step on emu_offchip through
    ``kernel`` on ``mesh``, at the session's initial hardware state (as
    ``grads_of`` runs one process)."""
    from repro_torch.hardware import drift

    s = session(False, arch=arch, smoke=True, hardware="emu_offchip", backend="emu",
                emu_kernel=kernel)
    hw = s.init_state()["hw"]
    _, args, extra = fsdp_step(arch, mesh, "emu_offchip", params, fb, batch,
                               dfa=s.trainer.cfg.dfa)
    with drift.use_state(hw):
        return fsdp_grads(extra, args)


def _tp_layerwise(mesh, arch, params, fb, batch):
    """dfa-layerwise's gradients on the sharded state of ``mesh`` (noise
    on): the readout through each B(k) gathered whole, the projection on
    the rank's rows."""
    from repro_torch.dist import sharding
    from repro_torch.train.trainer import Trainer, TrainerConfig

    _, args, extra = fsdp_step(arch, mesh, "offchip_bpd", params, fb, batch)
    cfg = extra["trainer"].cfg.dfa
    with sharding.use_mesh(mesh):
        t = Trainer(extra["model"], TrainerConfig(algo="dfa-layerwise", dfa=cfg,
                                                  data_parallel=False), device="cpu", mesh=mesh)
        (loss, _), grads = t._grads(args[0], sharding.to_local(args[1]),
                                    sharding.local_batch(mesh, args[3]), args[4])
        return float(loss), np_tree({k: sharding.full_tensor(g) for k, g in grads.items()})


# ---------------------------------------------------------------------------
# sharded serving (serve.decode's params-taking steps on placed state)
# ---------------------------------------------------------------------------

SERVE_MESHES = {"serve41": (4, 1), "serve22": (2, 2), "serve14": (1, 4)}
SERVE_STEPS = 3


def serve_model(arch, params, device="cpu"):
    """The smoke ``arch`` holding ``params`` (numpy, the port's names)."""
    from repro_torch import configs

    model = configs.get(arch).make_smoke(device=device)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return model


def serve_run(model, mesh, case, hardware=None, backend="cuda", steps=SERVE_STEPS, key=11,
              device="cpu"):
    """Prefill ``case["tokens"]`` (B, C) with ``case["n_valid"]`` into caches
    of ``case["max_len"]`` slots, then ``steps`` greedy decode steps, through
    the params-taking serve steps: on ``mesh`` the parameters placed by
    ``make_param_shardings``, the caches by ``cache_shardings`` and the
    tokens by ``make_batch_shardings``; one process where ``mesh`` is None.
    ``hardware`` (a preset name) runs the photonic forward through
    ``backend`` with keys folded from ``key``.  whisper decodes against
    ``case["enc"]`` without a prefill.  -> numpy: the prefill's last logits,
    the decode logits (steps, B, 1, V), the greedy tokens, the caches after
    the last step, and each cache leaf's split (its per-layer dim over
    ``model``, or None)."""
    from repro_torch.core import photonics
    from repro_torch.dist import sharding
    from repro_torch.serve import decode as sd
    from repro_torch.utils import prng

    def fwd(i):
        if hardware is None:
            return contextlib.nullcontext()
        return photonics.forward_execution(photonics.preset(hardware), backend,
                                           key=prng.fold(key, i))

    def put(name, x):
        x = torch.as_tensor(np.asarray(x)).to(device)
        if mesh is None:
            return x
        return sharding.place_leaf(x, sharding.make_batch_shardings(mesh, {name: x})[name])

    whole = lambda x: sharding.full_tensor(x) if sharding.is_dtensor(x) else x
    b = case["tokens"].shape[0]
    params = {k: v.detach() for k, v in model.named_parameters()}
    caches = model.init_caches(b, case["max_len"])
    if mesh is not None:
        params = sharding.place(params, sharding.make_param_shardings(mesh, params))
        caches = sharding.place(caches, sd.cache_shardings(mesh, caches))
    split = {k: sharding.model_dim(v) for k, v in caches.items()}
    clen = put("len", np.zeros(b, np.int64))
    out = {}
    with torch.no_grad():
        if "enc" in case:
            enc = put("enc", case["enc"])
            tok = put("tok", case["tokens"][:, :1])
            step = sd.make_serve_step(model, whisper_enc=True, with_params=True)
            extra = (enc,)
        else:
            pstep = sd.make_prefill_step(model, with_params=True)
            with fwd(0):
                last, caches, clen = pstep(params, put("tokens", case["tokens"]),
                                           put("n_valid", case["n_valid"]), caches, clen)
            out["prefill"] = whole(last).float().cpu().numpy()
            tok = put("tok", whole(last).argmax(-1)[:, None].cpu().numpy())
            step = sd.make_serve_step(model, with_params=True)
            extra = ()
        logits, tokens = [], []
        for i in range(steps):
            with fwd(i + 1):
                tok, lg, caches = step(params, tok, caches, clen, *extra)
            clen = clen + 1
            logits.append(lg.float().cpu().numpy())
            tokens.append(whole(tok).cpu().numpy())
    out["decode"] = np.stack(logits)
    out["tokens"] = np.stack(tokens)
    out["caches"] = {k: whole(v).float().cpu().numpy() for k, v in caches.items()}
    out["split"] = split
    return out


def rel(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = (np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float64)
            for x in (a, b))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _serve_compare(got, one) -> dict:
    """The sharded run's distances from the one process's: relative for
    the logits, absolute for the caches, and whether the tokens agree."""
    out = {k: rel(got[k], one[k]) for k in ("prefill", "decode") if k in one}
    out["caches"] = max(float(np.abs(got["caches"][k] - one["caches"][k]).max())
                        for k in one["caches"])
    out["tokens"] = bool(np.array_equal(got["tokens"], one["tokens"]))
    out["split"] = got["split"]
    return out


def _seq_attention(mesh) -> dict:
    """The sequence rule at one layer: an ``Attention`` whose kv heads (1)
    and head_dim (6) do not divide a model axis of 4, its (B, 8, 1, 6)
    cache split by slots, decode and prefill against the whole cache's."""
    from repro_torch.dist import sharding
    from repro_torch.nn.attention import Attention
    from repro_torch.serve import decode as sd

    torch.manual_seed(0)
    attn = Attention(24, 2, 1, head_dim=6).init(3)
    b, slots = 4, 8
    cache = {k: torch.randn(b, slots, 1, 6) for k in ("k", "v")}
    x1, x4 = torch.randn(b, 1, 24), torch.randn(b, 3, 24)
    clen, n_valid = torch.tensor([0, 3, 5, 7]), torch.tensor([3, 2, 3, 1])
    with torch.no_grad():
        want = (attn.decode(x1, cache, clen), attn.prefill(x4, cache, clen, n_valid))
        spec = sd.cache_spec(mesh, (1, b, slots, 1, 6))
        stacked = {k: sharding.place_leaf(v[None], sharding.named(mesh, spec))
                   for k, v in cache.items()}
        dims = {k: sharding.model_dim(v) - 1 for k, v in stacked.items()}
        local = {k: sharding.local(v)[0] for k, v in stacked.items()}
        with sharding.use_mesh(mesh), sharding.split_caches(dims):
            got = (attn.decode(x1, local, clen), attn.prefill(x4, local, clen, n_valid))
    index, size = sharding.model_index(mesh)
    n = slots // size
    return {"dims": dims,
            "y": max(rel(g[0], w[0]) for g, w in zip(got, want)),
            "cache": max(float((g[1][k] - w[1][k][:, index * n:(index + 1) * n]).abs().max())
                         for g, w in zip(got, want) for k in ("k", "v"))}


def _shard_serve(rank, world, cases):
    """Every case's smoke model served sharded on each of ``SERVE_MESHES``
    against its one process, noise off and on (offchip_bpd through the bank
    kernel's plain version: each rank's rows of the global draw), and the
    sequence rule at one layer on (1, 4).  Rank 0 returns the distances,
    and the noise-off logits of (2, 2) for the comparison with the
    reference."""
    from repro_torch.launch import mesh as mesh_lib

    meshes = {name: mesh_lib.make_host_mesh(world, model_axis=shape[1], device_type="cpu")
              for name, shape in SERVE_MESHES.items()}
    out = {"compare": {}, "logits": {}}
    for arch, case in cases.items():
        model = serve_model(arch, case["params"])
        for hardware in (None, "offchip_bpd"):
            one = serve_run(model, None, case, hardware)
            for name, mesh in meshes.items():
                got = serve_run(model, mesh, case, hardware)
                out["compare"][arch, name, hardware] = _serve_compare(got, one)
                if hardware is None and name == "serve22":
                    out["logits"][arch] = {k: got[k] for k in ("prefill", "decode")
                                           if k in got}
    out["seq_attention"] = _seq_attention(meshes["serve14"])
    return out if rank == 0 else None


CARD_SERVE = {"qwen1.5-0.5b": 16, "minicpm3-4b": 1024, "qwen2-moe-a2.7b": 16}  # slots


def _shard_serve_card(rank, world, cases):
    """The smoke models served on the card over gloo on (2, 1) and (1, 2),
    offchip_bpd through the bank kernel, each forward's launches counted:
    rank 0's distances from its one process and both ranks' launches."""
    from repro_torch.kernels import photonic_matmul as pm
    from repro_torch.launch import mesh as mesh_lib

    out = {}
    for arch, case in cases.items():
        model = serve_model(arch, case["params"], device="cuda")
        one = serve_run(model, None, case, "offchip_bpd", device="cuda") if rank == 0 else None
        for m in (1, 2):
            mesh = mesh_lib.make_host_mesh(world, model_axis=m, device_type="cuda")
            pm.launches = 0
            got = serve_run(model, mesh, case, "offchip_bpd", device="cuda")
            out[arch, m] = {"launches": pm.launches}
            if rank == 0:
                out[arch, m].update(_serve_compare(got, one))
    return out


def _dryrun(rank, world, cells):
    """``launch.dryrun.run_cell`` of each smoke cell ([arch, shape name,
    kind, seq_len, global_batch, mesh kind]) on a real (data, model) mesh
    of the mesh kind's shape over the gloo ranks -> rank 0's records."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib

    out = []
    for arch, name, kind, seq, batch, mesh_kind in cells:
        data, model = dryrun.mesh_shape(mesh_kind)
        mesh = mesh_lib.make_host_mesh(data * model, model_axis=model, device_type="cpu")
        case = configs.ShapeCase(name, kind, seq, batch)
        out.append(dryrun.run_cell(arch, name, mesh_kind, mesh=mesh, shape=case, smoke=True))
    return out if rank == 0 else None


# ---------------------------------------------------------------------------
# the column-parallel split of the dense blocks' products
# ---------------------------------------------------------------------------

SPLIT_ARCHS = ("qwen1.5-0.5b", "qwen3-1.7b", "mnist_mlp", "minicpm3-4b", "qwen2-moe-a2.7b")
SPLIT_MOE = "qwen2-moe-a2.7b"
SPLIT_COST_MESHES = ("tp12", "tp14")  # the batch whole: no FSDP gather to count
SPLIT_SERVE_MESHES = ("tp12", "tp14", "tp22")
# the meshes that split the batch over the data axes: there the mixture of
# experts routes the global batch (its capacity and queue positions), sums
# the ranks' dispatch buffers and runs the experts on its share of the
# slots (digital) or on the whole buffer (photonic, outside the row window)
SPLIT_BATCH_MESHES = ("tp22", "tp212")
SPLIT_ROWS = 200  # a split layer's rows: whole 50-row bank panels on m = 2 and 4


@contextlib.contextmanager
def column_calls(calls: list):
    """Each column-parallel product in the block appended to ``calls`` as
    (its region, the rows it ran on, the whole weight's rows)."""
    from repro_torch.nn.linear import Linear

    columns = Linear.columns

    def record(self, x, weight=None):
        w = self.weight if weight is None else weight
        calls.append((self.region, w.shape[-2], self.out_dim))
        return columns(self, x, weight)

    Linear.columns = record
    try:
        yield calls
    finally:
        Linear.columns = columns


@contextlib.contextmanager
def bank_products(products: list):
    """Each product a ``Linear`` hands the bank (``Linear.product``, its
    one call of ``forward_matmul``) appended to ``products`` as (its
    region, the rows it ran on, the whole weight's rows, whether its rows
    were whole (no row window), the first column of its column window or
    None)."""
    from repro_torch.core import photonics
    from repro_torch.nn.linear import Linear

    product = Linear.product

    def record(self, x, w):
        columns = photonics.active_columns()
        products.append((self.region, w.shape[-2], self.out_dim,
                         photonics.active_window() is None,
                         None if columns is None else columns.start))
        return product(self, x, w)

    Linear.product = record
    try:
        yield products
    finally:
        Linear.product = product


def _split_layer(mesh, backend) -> dict:
    """A model-split ``Linear`` (``SPLIT_ROWS`` rows, a bias) placed by the
    rules and read through the FSDP gather as its ``layer`` part, its
    photonic forward (offchip_bpd on ``ref``, emu_offchip on ``emu``: each
    rank's columns in its column window, gathered) against the whole
    layer's in one process: max |diff| / max |whole| and bit for bit."""
    from torch.func import functional_call

    from repro_torch.core import photonics
    from repro_torch.dist import sharding
    from repro_torch.nn.linear import Linear

    gen = torch.Generator().manual_seed(8)
    layer = Linear(48, SPLIT_ROWS, use_bias=True).init(4)
    whole = {k: torch.randn(v.shape, generator=gen) * 0.1 for k, v in layer.named_parameters()}
    x = torch.randn(6, 48, generator=gen)
    cfg = photonics.preset("emu_offchip" if backend == "emu" else "offchip_bpd")
    with torch.no_grad():
        with photonics.forward_execution(cfg, backend, key=11):
            want = functional_call(layer, whole, (x,))
        with sharding.use_mesh(mesh):
            local = sharding.unshard_fsdp(
                sharding.place(whole, sharding.make_param_shardings(mesh, whole)),
                {"layer": sharding.COLUMN_SPLIT["layer"]})
            rows = local["weight"].shape[0]
            with photonics.forward_execution(cfg, backend, key=11):
                got = functional_call(layer, local, (x,))
    return {"rows": rows, "rel": rel(got, want), "equal": bool(torch.equal(got, want))}


def _serving_head_fallback(mesh, case) -> dict:
    """The MLP's 10-row head placed by the rules on ``mesh``, read as a
    column-parallel part -> what ``sharding.left_whole`` reports and the
    rows the FSDP gather hands over."""
    from repro_torch.dist import sharding

    head = {k: torch.from_numpy(np.array(v)) for k, v in case["params"].items()
            if k.startswith("head.")}
    parts = {"head": ("head/",)}
    with sharding.use_mesh(mesh):
        placed = sharding.place(head, sharding.make_param_shardings(mesh, head))
        rows = sharding.unshard_fsdp(placed, parts)["head.weight"].shape[0]
        return {"left_whole": sharding.left_whole(placed, parts), "rows": rows}


def _fallback_models(mesh) -> dict:
    """On ``mesh`` (a model axis of 4): the smoke minicpm3 with 2 heads (a
    split of q_up, k_up and v_up in the middle of a head) and the smoke
    qwen2-moe with 6 experts (its router's 6 rows and its stacked experts
    do not split over 4: the divisibility fallback leaves them whole), each
    placed by the rules -> its forward loss on its pieces and one
    process's, the parts it reports whole (``column_fallbacks``) and the
    products that ran split."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.dist import sharding
    from repro_torch.models.transformer import TransformerLM

    out = {}
    for name, arch in (("mla", "minicpm3-4b"), ("router", SPLIT_MOE)):
        cfg = configs.get(arch).make_smoke(device="meta").cfg
        cfg = (dataclasses.replace(cfg, n_heads=2, n_kv_heads=2) if name == "mla" else
               dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=6)))
        model = TransformerLM(cfg, device="cpu").init(5)
        params = {k: v.detach() for k, v in model.named_parameters()}
        gen = torch.Generator().manual_seed(6)
        tokens = torch.randint(0, cfg.vocab_size, (4, 8), generator=gen)
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
        with torch.no_grad():
            one = float(model.loss(params, batch)[0])
            with sharding.use_mesh(mesh):
                placed = sharding.place(params, sharding.make_param_shardings(mesh, params))
                with column_calls([]) as calls:
                    loss = float(model.loss(placed, batch)[0])
                fallbacks = model.column_fallbacks(placed)
        out[name] = {"loss": loss, "one": one, "calls": calls, "fallbacks": fallbacks}
    return out


def _serving_fallbacks(model, mesh) -> dict:
    """The parts ``model`` reports whole in a sharded serving call on
    ``mesh`` (``column_fallbacks`` inside ``sharding.serving_call``)."""
    from repro_torch.dist import sharding

    params = {k: v.detach() for k, v in model.named_parameters()}
    with sharding.use_mesh(mesh), sharding.serving_call():
        return model.column_fallbacks(
            sharding.place(params, sharding.make_param_shardings(mesh, params)))


def _tp_split(rank, world, cases, serve):
    """The dense blocks' column-parallel products: each arch's sharded step
    (noise off and on) on every ``TP_MESHES`` mesh, with the products that
    ran split and the fallbacks recorded; on (1, 2) and (1, 4)
    ``step_cost``'s regions and collectives of the noisy step beside the
    calls', and a split layer on ``ref`` and ``emu``; on
    ``SPLIT_SERVE_MESHES`` each serving case against its one process (noise
    off and on) with the products that ran split."""
    from repro_torch.dist import sharding
    from repro_torch.utils import flop_cost

    out = {"grads": {}, "calls": {}, "bank": {}, "fallbacks": {}, "flops": {},
           "cost": {}, "layer": {}, "serve": {}, "serve_products": {}, "serve_fallbacks": {},
           "prefill": {}}
    for name in TP_MESHES:
        mesh = _tp_mesh(name)
        if rank >= mesh.mesh.numel():
            continue
        for arch in SPLIT_ARCHS:
            for hardware in FSDP_HARDWARE:
                _, args, extra = fsdp_step(arch, mesh, hardware, **cases[arch])
                with column_calls([]) as calls, bank_products([]) as products:
                    out["grads"][name, arch, hardware] = fsdp_grads(extra, args)
                out["calls"][name, arch, hardware] = calls
                out["bank"][name, arch, hardware] = products
            with sharding.use_mesh(mesh):
                out["fallbacks"][name, arch] = extra["model"].column_fallbacks(args[0])
            if name not in SPLIT_COST_MESHES:
                continue
            _, args, extra = fsdp_step(arch, mesh, "offchip_bpd", **cases[arch])
            seen: dict = {}
            restore = _counted_calls(seen)
            try:
                _, cost = flop_cost.measure(extra["value_and_grad"], args[0], args[1],
                                            args[3], args[4])
            finally:
                restore()
            out["flops"][name, arch] = dict(cost.region_flops)
            out["cost"][name, arch] = (dict(cost.coll_bytes_by_kind), seen)
        if name in SPLIT_COST_MESHES:
            out["layer"][name] = {b: _split_layer(mesh, b) for b in ("ref", "emu")}
        if name == "tp14":
            out["head_fallback"] = _serving_head_fallback(mesh, cases["mnist_mlp"])
            out["fallback_models"] = _fallback_models(mesh)
        served = serve if name in SPLIT_SERVE_MESHES else (
            {SPLIT_MOE: serve[SPLIT_MOE]} if name in SPLIT_BATCH_MESHES else {})
        for arch, case in served.items():
            model = serve_model(arch, case["params"])
            out["serve_fallbacks"][name, arch] = _serving_fallbacks(model, mesh)
            for hardware in (None, "offchip_bpd")[name not in SPLIT_SERVE_MESHES:]:
                one = serve_run(model, None, case, hardware) if rank == 0 else None
                with column_calls([]) as calls, bank_products([]) as products:
                    got = serve_run(model, mesh, case, hardware)
                out["serve"][name, arch, hardware] = (
                    _serve_compare(got, one) if rank == 0 else None, calls,
                    got if hardware is None and name == "tp22" else None)
                if hardware is not None:
                    out["serve_products"][name, arch] = products
            if name not in SPLIT_SERVE_MESHES:
                continue
            one = _prefill_run(model, None, case) if rank == 0 else None
            with column_calls([]) as calls:
                got = _prefill_run(model, mesh, case)
            out["prefill"][name, arch] = (
                _rel(got, one) if rank == 0 else None, calls)
    return out


def _prefill_run(model, mesh, case, key=11):
    """``serve.decode.make_prefill``'s forward (``build_prefill``'s) of
    ``case["tokens"]`` on offchip_bpd (``ref``): on ``mesh`` the parameters
    placed by ``make_param_shardings`` and the tokens by
    ``make_batch_shardings``; one process where ``mesh`` is None -> the
    logits, whole."""
    from repro_torch.core import photonics
    from repro_torch.dist import sharding
    from repro_torch.serve import decode as sd

    params = {k: v.detach() for k, v in model.named_parameters()}
    tokens = torch.as_tensor(np.asarray(case["tokens"]))
    if mesh is not None:
        params = sharding.place(params, sharding.make_param_shardings(mesh, params))
        tokens = sharding.place_leaf(
            tokens, sharding.make_batch_shardings(mesh, {"tokens": tokens})["tokens"])
    with torch.no_grad(), photonics.forward_execution(photonics.preset("offchip_bpd"), "ref",
                                                      key=key):
        logits = sd.make_prefill(model)(params, {"tokens": tokens})
    return sharding.full_tensor(logits) if sharding.is_dtensor(logits) else logits


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


SCENARIOS = {"mlp": _mlp, "lm": _lm, "elastic_save": _elastic_save,
             "elastic_load": _elastic_load, "fsdp": _fsdp, "tp": _tp, "tp_card": _tp_card,
             "tp_families": _tp_families, "shard_serve": _shard_serve,
             "shard_serve_card": _shard_serve_card, "dryrun": _dryrun, "tp_split": _tp_split}
