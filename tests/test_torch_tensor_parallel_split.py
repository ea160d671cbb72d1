"""The dense blocks' products split over the ``model`` axis: column-parallel
products (``nn/linear.py``) on each rank's rows of every weight of the
dense decoder block, the LM head and the MLP, in ``launch/dryrun.
build_train``'s sharded DFA step and in sharded serving, on four gloo ranks
on the CPU, against the port's one process and the reference's sharded
steps.

One spawn of four ranks (``tests/_dist_ranks.py``, scenario "tp_split")
runs every check and returns its numbers; the reference's sharded DFA step
(``tests/_fsdp_reference.py``) and sharded serving
(``tests/_serve_reference.py``, on (2, 2), noise off) run at the same time
in their own processes.  The smoke qwen1.5, qwen3 and mnist_mlp on (1, 2),
(1, 4), (2, 2) and (2, 1, 2): the loss and every gradient leaf within 1e-5
of its max |g| of the port's one process, noise off and on (offchip_bpd in
input mode: each rank's window of the one global draw), and of the
reference's sharded step (noise off); every product the rules split ran on
the rank's rows, and a part that could not split fell back by rule and
the model reports it (qwen3's 2 kv heads on a model axis of 4); training
keeps the head on its gathered weight (the card's gate,
``TransformerLM.head_logits``).  ``step_cost``'s FLOPs of each split product a rank at 1/m of one
process's, and its collective bytes equal to those handed to
``torch.distributed``.  A split layer's photonic forward on ``ref`` and
``emu`` equal to the one process's columns.  qwen1.5 and qwen3 served on
(1, 2), (1, 4) and (2, 2) with the products split, within 1e-4 of one
process (noise off and on) and of the reference (noise off)."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _dist_ranks as ranks  # noqa: E402
from test_torch_fsdp import _case, _flatten, _nest, _one_process, _worst  # noqa: E402
from test_torch_shard_serve import _case as _serve_case  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.utils import flop_cost  # noqa: E402

WORLD = 4
TOL = 1e-5  # a step's loss and gradients (ROADMAP)
SERVE_TOL = 1e-4  # serving logits
ARCHS = ranks.SPLIT_ARCHS
SEEDS = {"qwen1.5-0.5b": 30, "qwen3-1.7b": 31, "mnist_mlp": 32}
SERVE = ("qwen1.5-0.5b", "qwen3-1.7b")
MESHES = list(ranks.TP_MESHES)
PAIRS = [(mesh, arch) for mesh in MESHES for arch in ARCHS]
HERE = os.path.dirname(os.path.abspath(__file__))
BLOCK = {"attn.q", "attn.k", "attn.v", "attn.o", "ffn.gate", "ffn.up", "ffn.down"}


def _model_size(mesh) -> int:
    return ranks.TP_MESHES[mesh][-1]


def _split_regions(mesh, arch, serving=False) -> set:
    """The products the rules split on ``mesh``: every dense block's, and in
    serving the head's (training keeps it on its gathered weight); qwen3's
    attention falls back where its 2 kv heads do not divide the axis, and
    the MLP's 10-row head where 10 does not."""
    m = _model_size(mesh)
    if arch == "mnist_mlp":
        return {"h0", "h1"} | ({"head"} if serving and 10 % m == 0 else set())
    attn = {"attn.q", "attn.k", "attn.v"} if (4 if arch == "qwen1.5-0.5b" else 2) % m == 0 \
        else set()
    return (BLOCK - {"attn.q", "attn.k", "attn.v"}) | attn | ({"head"} if serving else set())


def _ref_process(script, data, tmp, name):
    src, dst = str(tmp / f"{name}_in.npz"), str(tmp / f"{name}_out.npz")
    np.savez(src, **data)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [HERE, os.path.join(HERE, "..", "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, script), src, dst], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, dst


def _one_flops(arch, case) -> dict:
    """``step_cost``'s regions of one process's noisy step (the key the
    sharded step takes)."""
    s = ranks.session(False, arch=arch, smoke=True, hardware="offchip_bpd", backend="cuda")
    st = ranks.load_state(s, case["params"], case["fb"])
    _, cost = flop_cost.measure(s.trainer._grads, st["params"], st["fb"],
                                s.trainer.put(case["batch"]), 7)
    return dict(cost.region_flops)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("split")
    ref_cases, cases = {}, {}
    for arch, seed in SEEDS.items():
        ref_cases[arch], cases[arch] = _case(arch, seed)
    train = {}
    for mesh, arch in PAIRS:
        case = f"{mesh}-{arch}"
        train[f"{case}|arch"], train[f"{case}|mesh"] = np.array(arch), np.array(mesh)
        for what in ("params", "fb", "batch"):
            for k, v in _flatten(ref_cases[arch][what]).items():
                train[f"{case}|{what}|{k}"] = v.astype(np.int32) if v.dtype.kind in "iu" else v
    serve, served = {}, {}
    for i, arch in enumerate(SERVE):
        jp, serve[arch] = _serve_case(arch, 40 + i)
        served.update({f"{arch}|params|{k}": v for k, v in _flatten(jp).items()})
        served.update({f"{arch}|{k}": np.asarray(serve[arch][k])
                       for k in ("tokens", "n_valid", "max_len")})
    procs = [_ref_process("_fsdp_reference.py", train, tmp, "train"),
             _ref_process("_serve_reference.py", served, tmp, "serve")]
    threads = torch.get_num_threads()
    try:
        out = ranks.spawn("tp_split", WORLD, timeout=300, cases=cases, serve=serve)
        torch.set_num_threads(1)  # as each rank runs
        one = {(arch, hw): _one_process(arch, hw, cases[arch])
               for arch in ARCHS for hw in ranks.FSDP_HARDWARE}
        flops = {arch: _one_flops(arch, cases[arch]) for arch in ARCHS}
        logs = [proc.communicate(timeout=300)[0] for proc, _ in procs]
    finally:
        torch.set_num_threads(threads)
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
    for (proc, _), log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]
    return {"ranks": out, "one": one, "flops": flops,
            "ref": {name: dict(np.load(dst)) for name, (_, dst) in zip(("train", "serve"), procs)}}


@pytest.mark.parametrize("hardware", ranks.FSDP_HARDWARE)
@pytest.mark.parametrize("mesh,arch", PAIRS)
def test_split_step_equals_one_process(split, mesh, arch, hardware):
    loss, grads = split["ranks"][0]["grads"][mesh, arch, hardware]
    one_loss, _, one_grads = split["one"][arch, hardware]
    assert loss == pytest.approx(one_loss, abs=TOL * abs(one_loss))
    assert _worst(grads, one_grads, arch) <= TOL


@pytest.mark.parametrize("mesh,arch", PAIRS)
def test_split_step_equals_the_references_sharded_step(split, mesh, arch):
    case = f"{mesh}-{arch}"
    ref = split["ref"]["train"]
    jgrads = _nest({k[len(case) + len("|grads|"):]: v for k, v in ref.items()
                    if k.startswith(f"{case}|grads|")})
    expect = {k: v.numpy() for k, v in convert.state_dict_from_reference(jgrads).items()}
    loss, grads = split["ranks"][0]["grads"][mesh, arch, "ideal"]
    ref_loss = float(ref[f"{case}|loss"])
    assert loss == pytest.approx(ref_loss, abs=TOL * abs(ref_loss))
    assert _worst(grads, expect, arch) <= TOL


@pytest.mark.parametrize("mesh,arch", PAIRS)
def test_every_split_product_ran_on_the_ranks_rows(split, mesh, arch):
    """On every rank, the products of each part the rules split ran
    column-parallel, each on 1/m of the whole weight's rows, in the forward
    and again in the block's recompute; nothing else did."""
    m = _model_size(mesh)
    n = int(np.prod(ranks.TP_MESHES[mesh]))
    for r in range(n):
        calls = split["ranks"][r]["calls"][mesh, arch, "offchip_bpd"]
        assert {region for region, _, _ in calls} == _split_regions(mesh, arch), r
        assert all(rows * m == whole for _, rows, whole in calls), (r, calls)


def test_a_mid_head_split_falls_back_and_is_recorded(split):
    """qwen3's 2 kv heads on a model axis of 4 would split k and v in the
    middle of a head: its attention runs on gathered weights (o and the FFN
    still split), and the model's ``column_fallbacks`` says so; on m = 2
    nothing falls back, nor for qwen1.5 and the MLP."""
    for r in range(WORLD):
        got = split["ranks"][r]["fallbacks"]["tp14", "qwen3-1.7b"]
        assert set(got) == {"attn"} and "middle of a head" in got["attn"], got
        assert split["ranks"][r]["fallbacks"]["tp14", "qwen1.5-0.5b"] == {}
        assert split["ranks"][r]["fallbacks"]["tp14", "mnist_mlp"] == {}
    for r in range(2):
        assert split["ranks"][r]["fallbacks"]["tp12", "qwen3-1.7b"] == {}


def test_a_part_the_divisibility_fallback_left_whole_is_recorded(split):
    """The MLP's 10-row head on a model axis of 4, read as a column-parallel
    part: the leaf arrives whole (10 does not split over 4), runs whole, and
    ``sharding.left_whole`` reports it."""
    for r in range(WORLD):
        got = split["ranks"][r]["head_fallback"]
        assert got["rows"] == 10, got
        assert set(got["left_whole"]) == {"head"}, got
        assert "divisibility" in got["left_whole"]["head"], got


@pytest.mark.parametrize("mesh", list(ranks.SPLIT_COST_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_each_split_products_flops_a_rank_are_one_mth(split, mesh, arch):
    """``step_cost``'s FLOPs of each split product (its region: forward,
    recompute and backward) on every rank = one process's / m; a product
    left whole = one process's."""
    m = _model_size(mesh)
    one = split["flops"][arch]
    regions = _split_regions(mesh, arch)
    for r in range(_model_size(mesh)):
        got = split["ranks"][r]["flops"][mesh, arch]
        assert set(got) == set(one), r
        for name, flops in one.items():
            assert flops > 0, name
            assert got[name] * (m if name in regions else 1) == flops, (r, name, got[name], flops)


@pytest.mark.parametrize("mesh", list(ranks.SPLIT_COST_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_step_cost_counts_the_split_collectives(split, mesh, arch):
    """By kind, the operand bytes ``step_cost`` counted = those the step
    handed ``torch.distributed``: the columns' all-gathers and the partial
    input gradients' all-reduces among them."""
    for r in range(_model_size(mesh)):
        counted, seen = split["ranks"][r]["cost"][mesh, arch]
        assert counted == seen, r
        assert counted["all-gather"] > 0 and counted["all-reduce"] > 0, counted


@pytest.mark.parametrize("backend", ["ref", "emu"])
@pytest.mark.parametrize("mesh", list(ranks.SPLIT_COST_MESHES))
def test_a_split_layer_gives_the_one_process_columns(split, mesh, backend):
    """A model-split layer's photonic forward in each rank's column window
    (s_b the whole weight's MAX, the noise its columns of the global draw;
    emu: its whole bank panels at the kernel's ``col_base``), gathered:
    the one process's output (emu bit for bit; ref within 1e-6, a narrower
    product's rounding)."""
    m = _model_size(mesh)
    for r in range(m):
        got = split["ranks"][r]["layer"][mesh][backend]
        assert got["rows"] * m == ranks.SPLIT_ROWS
        assert got["rel"] <= 1e-6, got
        if backend == "emu":
            assert got["equal"], got


@pytest.mark.parametrize("hardware", [None, "offchip_bpd"], ids=["digital", "offchip_bpd"])
@pytest.mark.parametrize("mesh", list(ranks.SPLIT_SERVE_MESHES))
@pytest.mark.parametrize("arch", SERVE)
def test_split_serving_matches_one_process(split, arch, mesh, hardware):
    got, _, _ = split["ranks"][0]["serve"][mesh, arch, hardware]
    assert got["prefill"] <= SERVE_TOL and got["decode"] <= SERVE_TOL, got
    assert got["tokens"], got
    assert got["caches"] <= 1e-5, got


@pytest.mark.parametrize("mesh", list(ranks.SPLIT_SERVE_MESHES))
@pytest.mark.parametrize("arch", SERVE)
def test_split_serving_runs_every_forward_on_the_ranks_rows(split, arch, mesh):
    """Each forward (the prefill and every decode step) runs each split
    product once on every rank, on 1/m of the whole weight's rows: the
    blocks' and the vocabulary-split head's."""
    m = _model_size(mesh)
    n = int(np.prod(ranks.TP_MESHES[mesh]))
    regions = _split_regions(mesh, arch, serving=True)
    per_forward = 2 * len(regions - {"head"}) + 1  # two layers and the head
    for r in range(n):
        _, calls, _ = split["ranks"][r]["serve"][mesh, arch, "offchip_bpd"]
        assert {region for region, _, _ in calls} == regions, r
        assert len(calls) == per_forward * (1 + ranks.SERVE_STEPS), (r, len(calls))
        assert all(rows * m == whole for _, rows, whole in calls), r


@pytest.mark.parametrize("mesh", list(ranks.SPLIT_SERVE_MESHES))
@pytest.mark.parametrize("arch", SERVE)
def test_split_build_prefill_splits_the_head(split, arch, mesh):
    """``make_prefill``'s forward (``build_prefill``'s: the training
    forward, no tape) in a sharded serving call runs the head
    vocabulary-split on every rank, as the serving steps do, within 1e-4
    of one process with the noise on."""
    m = _model_size(mesh)
    n = int(np.prod(ranks.TP_MESHES[mesh]))
    dist, _ = split["ranks"][0]["prefill"][mesh, arch]
    assert dist <= 1e-4, dist
    for r in range(n):
        _, calls = split["ranks"][r]["prefill"][mesh, arch]
        assert {region for region, _, _ in calls} == _split_regions(mesh, arch, serving=True), r
        assert [rows * m for region, rows, _ in calls if region == "head"] == [
            whole for region, _, whole in calls if region == "head"] != [], r


@pytest.mark.parametrize("arch", SERVE)
def test_split_serving_matches_reference(split, arch):
    """On (2, 2), noise off: the split serve's prefill and decode logits
    within 1e-4 of ``repro``'s jitted steps under the same shardings."""
    _, _, got = split["ranks"][0]["serve"]["tp22", arch, None]
    ref = split["ref"]["serve"]
    for what in ("prefill", "decode"):
        assert ranks.rel(got[what], ref[f"{arch}|{what}"]) <= SERVE_TOL, what
