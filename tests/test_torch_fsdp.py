"""The port's FSDP execution (``launch/dryrun.build_train``'s sharded step on
ZeRO-3 ``DTensor`` state) on four gloo ranks on the CPU, against the port's
one process and the reference's sharded step.

One spawn of four ranks (``tests/_dist_ranks.py``, scenario "fsdp") runs
every check and returns its numbers; the reference's sharded step runs at
the same time in its own process on four forced host devices
(``tests/_fsdp_reference.py``).  For the smoke mnist_mlp, qwen3 (qk-norm),
mamba2, recurrentgemma and whisper on the (4, 1) data mesh and the (2, 2, 1)
pod mesh: the loss and every gradient leaf within 1e-5 of its max |g| of
the port's one-process step (noise off, and on: offchip_bpd in input mode,
each rank's rows of the one global draw) and of the reference's sharded
step (noise off); every shard the rule's slice.  On the first family: the
step's outputs carry its inputs' placements and equal the one-process
update, the module's own parameters hold no storage, ``DTensor``'s plain
``Replicate`` backward misses the check, the collective bytes that
``step_cost`` counts equal what the leaves give (and a data-parallel step's
all-reduce its gradients' bytes), and a (2, 1) state saved through
``train/checkpoint.py`` steps to the same loss on (4, 1) and in one process.
qwen2-moe's sharded step equals the port's replicated data-parallel step
(its routing is per rank, a recorded difference from one process)."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _dist_ranks as ranks  # noqa: E402
from repro import algos as jalgos  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.algos import dfa as jdfa  # noqa: E402
from repro.data import mnist as jmnist  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.train import lm_batches  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402

WORLD = 4
TOL = 1e-5  # loss and gradients of a step (ROADMAP)
ARCHS = ["qwen3-1.7b", "mnist_mlp", "mamba2-130m", "recurrentgemma-9b", "whisper-small"]
MESHES = list(ranks.FSDP_MESHES)
SEQ, BATCH = 16, 8
HERE = os.path.dirname(os.path.abspath(__file__))


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _case(arch, seed):
    """The reference's smoke model of ``arch`` (norms and biases moved off
    their initial values, so every path shows), its feedback and a batch:
    (reference trees, port numpy arrays)."""
    jm = jconfigs.get(arch).make_smoke()
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(size=x.shape).astype(np.float32) * 0.05,
        jax.jit(jm.init)(key))
    jf = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jalgos.get("dfa").init_extra_state(jm, k, jdfa.DFAConfig()))(
        jax.random.fold_in(key, 1)))
    if arch == "mnist_mlp":
        x, y = jmnist.procedural_digits(32, seed=seed)
        batch = {"x": x[:, :64], "y": y}
    else:
        cfg = tconfigs.get(arch).make_smoke(device="meta").cfg
        batch = lm_batches(arch, cfg, SEQ, BATCH, seed)(0)
    port = {"params": {k: v.numpy() for k, v in convert.state_dict_from_reference(jp).items()},
            "fb": {k: v.numpy() for k, v in convert.feedback_from_reference(jf).items()},
            "batch": batch}
    return {"params": jp, "fb": jf, "batch": batch}, port


def _reference_inputs(path, ref_cases):
    data = {}
    for mesh in MESHES:
        for arch, tree in ref_cases.items():
            case = f"{mesh}-{arch}"
            data[f"{case}|arch"], data[f"{case}|mesh"] = np.array(arch), np.array(mesh)
            for what in ("params", "fb", "batch"):
                for k, v in _flatten(tree[what]).items():
                    v = v.astype(np.int32) if v.dtype.kind in "iu" else v
                    data[f"{case}|{what}|{k}"] = v
    np.savez(path, **data)


def _one_process(arch, hardware, case, batch=None, rng=7):
    s = ranks.session(False, arch=arch, smoke=True, hardware=hardware, backend="cuda")
    return ranks.grads_of(s, ranks.load_state(s, case["params"], case["fb"]),
                          case["batch"] if batch is None else batch, rng=rng)


@pytest.fixture(scope="module")
def fsdp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    ref_cases, cases = {}, {}
    for i, arch in enumerate(ARCHS):
        ref_cases[arch], cases[arch] = _case(arch, i)
    _, moe = _case("qwen2-moe-a2.7b", 9)
    ref_in, ref_out = str(tmp / "ref_in.npz"), str(tmp / "ref_out.npz")
    _reference_inputs(ref_in, ref_cases)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "_fsdp_reference.py"), ref_in,
                             ref_out], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    first = ARCHS[0]
    later = lm_batches(first, tconfigs.get(first).make_smoke(device="meta").cfg, SEQ, BATCH,
                       0)(1)
    ckpt = {**cases[first], "batches": [cases[first]["batch"], later],
            "path": str(tmp / "fsdp.pt")}
    del ckpt["batch"]
    try:
        out = ranks.spawn("fsdp", WORLD, cases=cases, moe=moe, ckpt=ckpt)
        one = {(arch, hw): _one_process(arch, hw, cases[arch])
               for arch in ARCHS for hw in ranks.FSDP_HARDWARE}
        # the checkpoint's second step in one process: the saved state's loss
        s = ranks.session(False, arch=first, smoke=True, hardware="offchip_bpd", backend="cuda")
        st = ranks.load_state(s, cases[first]["params"], cases[first]["fb"])
        saved, step = tckpt.load(ckpt["path"], {"params": st["params"], "opt": st["opt"]})
        (loss2, _), _ = s.trainer._grads(saved["params"], st["fb"], s.trainer.put(later), 8)
        _, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    ref = dict(np.load(ref_out))
    return {"cases": cases, "ranks": out, "one": one, "ref": ref, "moe": moe,
            "ckpt_one": (step, float(loss2))}


def _scale(expect: dict, k: str, arch: str) -> float:
    """A leaf's max |g|; whisper's rope-less key bias has an exactly zero
    gradient that comes back as rounding noise, so it is held to its
    layer's value-bias gradient (as ``tests/test_torch_whisper.py`` does)."""
    if arch == "whisper-small" and k.endswith(".k.bias"):
        k = k[:-len("k.bias")] + "v.bias"
    return max(float(np.abs(expect[k]).max()), 1e-30)


def _worst(got: dict, expect: dict, arch: str) -> float:
    assert sorted(got) == sorted(expect)
    return max(float(np.abs(np.asarray(got[k]) - np.asarray(expect[k])).max())
               / _scale(expect, k, arch) for k in expect)


@pytest.mark.parametrize("hardware", ranks.FSDP_HARDWARE)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_step_equals_one_process(fsdp, mesh, arch, hardware):
    loss, grads = fsdp["ranks"][0]["grads"][mesh, arch, hardware]
    one_loss, _, one_grads = fsdp["one"][arch, hardware]
    assert loss == pytest.approx(one_loss, abs=TOL * abs(one_loss))
    assert _worst(grads, one_grads, arch) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_step_equals_the_references_sharded_step(fsdp, mesh, arch):
    case = f"{mesh}-{arch}"
    ref = fsdp["ref"]
    jgrads = _nest({k[len(case) + len("|grads|"):]: v for k, v in ref.items()
                    if k.startswith(f"{case}|grads|")})
    expect = {k: v.numpy() for k, v in convert.state_dict_from_reference(jgrads).items()}
    loss, grads = fsdp["ranks"][0]["grads"][mesh, arch, "ideal"]
    ref_loss = float(ref[f"{case}|loss"])
    assert loss == pytest.approx(ref_loss, abs=TOL * abs(ref_loss))
    assert _worst(grads, expect, arch) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_every_shard_is_the_rules_slice(fsdp, mesh, arch):
    """Checked on every rank (a rank raises otherwise); most leaves split."""
    split = fsdp["ranks"][0]["shards"][mesh, arch]
    assert split >= len(fsdp["cases"][arch]["params"]) // 3


@pytest.mark.parametrize("mesh", MESHES)
def test_full_tensor_is_dtensors(fsdp, mesh):
    """``sharding.full_tensor`` (the port's all-gather, which the card's
    gloo runs on CUDA tensors) = ``DTensor.full_tensor`` bit for bit."""
    assert all(ok for (m, _), ok in fsdp["ranks"][0]["full_tensor"].items() if m == mesh)


def test_outputs_carry_the_input_placements(fsdp):
    same, step, loss_placements = fsdp["ranks"][0]["placements"]
    assert same and step == 1
    assert loss_placements == ("Replicate", "Replicate")


def test_sharded_update_equals_one_process(fsdp):
    """SGD momentum on each rank's shards: p - 0.01 g from zero momentum."""
    arch = ARCHS[0]
    loss, params = fsdp["ranks"][0]["step"]
    one_loss, _, grads = fsdp["one"][arch, "offchip_bpd"]
    assert loss == pytest.approx(one_loss, abs=TOL * abs(one_loss))
    for k, p in fsdp["cases"][arch]["params"].items():
        expect = p - np.float32(0.01) * grads[k]
        assert np.abs(params[k] - expect).max() <= TOL * np.abs(expect).max(), k


@pytest.mark.parametrize("algo", ["bp", "dfa-layerwise", "dfa-fused"])
def test_other_algorithms_on_sharded_state_equal_one_process(fsdp, algo):
    """bp through autograd's pass over the gathers, dfa-layerwise and the
    fused step through the block recompute's."""
    arch = ARCHS[0]
    case = fsdp["cases"][arch]
    loss, got = fsdp["ranks"][0]["algos"][algo]
    s = ranks.session(False, arch=arch, smoke=True, hardware="offchip_bpd", backend="cuda",
                      algo=algo)
    st = ranks.load_state(s, case["params"], case["fb"])
    if algo == "dfa-fused":
        params, _, one_loss = s.fused_step()(st["params"], st["fb"], st["opt"],
                                             s.trainer.put(case["batch"]), 7)
        expect, one_loss = ranks.np_tree(params), float(one_loss)
    else:
        one_loss, _, expect = ranks.grads_of(s, st, case["batch"])
    assert loss == pytest.approx(one_loss, abs=TOL * abs(one_loss))
    assert _worst(got, expect, arch) <= TOL


def test_replicate_backward_misses_the_check(fsdp):
    """DTensor's own backward of the gather keeps each rank's gradient of
    its own rows: far off the one-process step."""
    arch = ARCHS[0]
    loss, grads = fsdp["ranks"][0]["control"]
    one_loss, _, one_grads = fsdp["one"][arch, "offchip_bpd"]
    assert loss == pytest.approx(one_loss, abs=TOL * abs(one_loss))
    assert _worst(grads, one_grads, arch) > 100 * TOL


def test_module_parameters_hold_no_storage(fsdp):
    released, device = fsdp["ranks"][0]["released"]
    assert released and device == "cpu"


def test_step_cost_counts_the_sharded_collectives(fsdp):
    by_kind, as_dict, expect = fsdp["ranks"][0]["cost"]
    assert by_kind == expect
    assert as_dict["collective_bytes"] == float(sum(expect.values())) > 0
    assert as_dict["coll_bytes_by_kind"] == {k: float(v) for k, v in expect.items()}


def test_step_cost_counts_the_data_parallel_all_reduce(fsdp):
    """The gradients and the metrics (the loss among them) in the mean
    all-reduce, and the one MAX of s_a."""
    by_kind, expect = fsdp["ranks"][0]["dp_cost"]
    assert by_kind == {"all-reduce": expect}


def test_one_process_counts_no_collectives(fsdp):
    s = ranks.session(False, arch="mnist_mlp", smoke=True, hardware="offchip_bpd",
                      backend="cuda")
    case = fsdp["cases"]["mnist_mlp"]
    cost = s.trainer.step_cost(ranks.load_state(s, case["params"], case["fb"]), case["batch"])
    assert cost.coll_bytes_by_kind == {} and cost.as_dict()["collective_bytes"] == 0.0


def test_sharded_checkpoint_restores_on_other_meshes(fsdp):
    """A (2, 1) state saved through ``train/checkpoint.py``: its next step's
    loss on (2, 1), restored on (4, 1) and restored in one process."""
    ck = [r["ckpt"] for r in fsdp["ranks"]]
    two = ck[0]["two"]
    assert ck[1]["two"] == two
    step, one = fsdp["ckpt_one"]
    assert step == 1
    for r in ck:
        assert r["four"][0] == 1
        assert r["four"][1] == pytest.approx(two, abs=TOL * abs(two))
    assert one == pytest.approx(two, abs=TOL * abs(two))


def test_moe_sharded_step_equals_replicated_data_parallel(fsdp):
    loss, grads = fsdp["ranks"][0]["moe"]
    dp_loss, _, dp_grads = fsdp["ranks"][0]["moe_dp"]
    assert loss == pytest.approx(dp_loss, abs=TOL * abs(dp_loss))
    assert _worst(grads, dp_grads, "qwen2-moe-a2.7b") <= TOL


# ---------------------------------------------------------------------------
# without the spawn
# ---------------------------------------------------------------------------


def test_gathers_are_the_identity_without_a_mesh():
    tree = {"attn.q.weight": torch.zeros(8, 8), "norm1.scale": torch.ones(8)}
    assert tsh.unshard_fsdp(tree) is tree
    x = torch.zeros(2, 3, 8)
    assert tsh.annotate(x, "act_btd") is x


def test_build_train_defaults_are_the_references():
    from repro.configs import base as jbase
    from repro.launch import dryrun as jdryrun

    got, expect = dryrun._dfa_config(), jdryrun._dfa_config()
    assert got.backend == expect.backend == "ref"
    assert got.photonics.noise_std == expect.photonics.noise_std
    assert got.feedback.dtype == torch.bfloat16 and got.freeze_norms is False
    assert {k: (v.kind, v.seq_len, v.global_batch) for k, v in tconfigs.SHAPES.items()} == {
        k: (v.kind, v.seq_len, v.global_batch) for k, v in jbase.SHAPES.items()}
    specs = tconfigs.token_specs(4, 8)
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        k: tuple(v.shape) for k, v in jbase.token_specs(4, 8).items()}
    assert all(v.is_meta for v in specs.values())


@pytest.fixture()
def world_of_one():
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield tmesh.make_host_mesh(1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_a_world_of_one_is_the_trainers_step_bit_for_bit(world_of_one):
    """``build_train`` on a (1, 1) mesh, two steps, against the trainer's
    single-device steps from the same seed: loss, parameters and momentum
    bit for bit."""
    from repro_torch.algos.dfa import DFAConfig
    from repro_torch.core import photonics
    from repro_torch.utils import prng

    arch, seed = "qwen1.5-0.5b", 3
    cfg = tconfigs.get(arch).make_smoke(device="meta").cfg
    data = lm_batches(arch, cfg, SEQ, BATCH, 0)
    dfa = DFAConfig(photonics=photonics.preset("offchip_bpd"), backend="cuda")
    host = {k: torch.as_tensor(v) for k, v in data(0).items()}
    fn, (p, fb, o, _, _), _ = dryrun.build_train(arch, world_of_one, smoke=True, dfa=dfa,
                                                 device="cpu", batch=host, seed=seed)
    s = ranks.session(False, arch=arch, smoke=True, hardware="offchip_bpd", backend="cuda",
                      seed=seed)
    state = s.init_state()
    b_sh = tsh.make_batch_shardings(world_of_one, host)
    for step in range(2):
        batch = {k: torch.as_tensor(v) for k, v in data(step).items()}
        p, o, loss = fn(p, fb, o, tsh.place(batch, b_sh), prng.step_key(seed, step, "noise"))
        state, metrics = s.step(state, data(step))
        assert float(loss.to_local()) == float(metrics["loss"])
    for k, v in state["params"].items():
        assert torch.equal(p[k].to_local(), v), k
        assert torch.equal(o["mom"][k].to_local(), state["opt"]["mom"][k]), k
