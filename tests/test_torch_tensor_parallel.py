"""Tensor parallelism on the ``model`` axis: ``launch/dryrun.build_train``'s
sharded step computing on model-split pieces through the port's own
model-axis operators (``dist.sharding``), on four gloo ranks on the CPU,
against the port's one process and the reference's sharded step.

One spawn of four ranks (``tests/_dist_ranks.py``, scenario "tp") runs
every check and returns its numbers; the reference's sharded step runs at
the same time in its own process on four forced host devices
(``tests/_fsdp_reference.py``, given the model-axis meshes).  The smoke
qwen1.5 on (1, 2), (1, 4), (2, 2) and (2, 1, 2), qwen3 on (1, 4) (its 2 kv
heads of 16 split in the middle of a head) and mnist_mlp on (1, 2): the
loss and every gradient leaf within 1e-5 of its max |g| of the port's one
process (noise off, and on: offchip_bpd in input mode, each rank's window
of the one global draw) and of the reference's sharded step (noise off);
every shard after two noisy steps the rule's slice of the one process's
parameters.  Also: the operators and ``annotate`` against one-process
autograd, whisper's MLP, the gated FFN, the dense block and a mid-head
attention on local pieces, bp and dfa-fused on split state,
``step_cost``'s collective bytes against what ``torch.distributed`` was
handed, and a (2, 2) checkpoint restored on (4, 1).  Without the spawn: the
column window, a model axis of 1, and the names ported beside them."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _dist_ranks as ranks  # noqa: E402
import jax  # noqa: E402
from test_torch_fsdp import _case, _flatten, _one_process, _worst  # noqa: E402

from repro.core import photonics as jph  # noqa: E402
from repro.nn import embeddings as jemb  # noqa: E402
from repro.nn import initializers as jinit  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import photonics as tph  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import total_noise  # noqa: E402
from repro_torch.launch.train import lm_batches  # noqa: E402
from repro_torch.nn import embeddings as temb  # noqa: E402
from repro_torch.nn import initializers as tinit  # noqa: E402

WORLD = 4
TOL = 1e-5  # loss and gradients of a step (ROADMAP)
PAIRS = [(mesh, arch) for mesh, archs in ranks.TP_ARCHS.items() for arch in archs]
SEEDS = {"qwen1.5-0.5b": 0, "qwen3-1.7b": 1, "mnist_mlp": 2}
FIRST = "qwen1.5-0.5b"
SEQ, BATCH = 16, 8
HERE = os.path.dirname(os.path.abspath(__file__))


def _reference_inputs(path, ref_cases):
    data = {}
    for mesh, arch in PAIRS:
        case = f"{mesh}-{arch}"
        data[f"{case}|arch"], data[f"{case}|mesh"] = np.array(arch), np.array(mesh)
        for what in ("params", "fb", "batch"):
            for k, v in _flatten(ref_cases[arch][what]).items():
                data[f"{case}|{what}|{k}"] = v.astype(np.int32) if v.dtype.kind in "iu" else v
    np.savez(path, **data)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    ref_cases, cases = {}, {}
    for arch, seed in SEEDS.items():
        ref_cases[arch], cases[arch] = _case(arch, seed)
    ref_in, ref_out = str(tmp / "ref_in.npz"), str(tmp / "ref_out.npz")
    _reference_inputs(ref_in, ref_cases)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "_fsdp_reference.py"), ref_in,
                             ref_out], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    first = cases[FIRST]
    later = lm_batches(FIRST, tconfigs.get(FIRST).make_smoke(device="meta").cfg, SEQ, BATCH,
                       0)(1)
    ckpt = {"arch": FIRST, "params": first["params"], "fb": first["fb"],
            "batches": [first["batch"], later], "path": str(tmp / "tp.pt")}
    threads = torch.get_num_threads()
    try:
        out = ranks.spawn("tp", WORLD, cases=cases, ckpt=ckpt)
        # one thread, as each rank runs: the CPU's GEMMs then split their work
        # alike on both sides
        torch.set_num_threads(1)
        one = {(arch, hw): _one_process(arch, hw, cases[arch])
               for arch in SEEDS for hw in ranks.FSDP_HARDWARE}
        # two noisy steps of the trainer (keys step_key(0, i, "noise"))
        s = ranks.session(False, arch=FIRST, smoke=True, hardware="offchip_bpd", backend="cuda")
        state = ranks.load_state(s, first["params"], first["fb"])
        for _ in range(ranks.TP_STEPS):
            state, _ = s.step(state, first["batch"])
        steps = ranks.np_tree(state["params"])
        _, stderr = proc.communicate(timeout=600)
    finally:
        torch.set_num_threads(threads)
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    return {"cases": cases, "ranks": out, "one": one, "steps": steps, "ref": dict(np.load(ref_out))}


@pytest.mark.parametrize("hardware", ranks.FSDP_HARDWARE)
@pytest.mark.parametrize("mesh,arch", PAIRS)
def test_sharded_step_equals_one_process(tp, mesh, arch, hardware):
    loss, grads = tp["ranks"][0]["grads"][mesh, arch, hardware]
    one_loss, _, one_grads = tp["one"][arch, hardware]
    assert loss == pytest.approx(one_loss, abs=TOL * abs(one_loss))
    assert _worst(grads, one_grads, arch) <= TOL


@pytest.mark.parametrize("hardware", ranks.FSDP_HARDWARE)
def test_the_cards_layout_is_one_process_bit_for_bit(tp, hardware):
    """The card's run on the CPU: qwen1.5 on (1, 2), every row on every
    rank.  The dense products run column-parallel (attention on the rank's
    heads): on one thread the CPU's narrower products give the whole
    product's columns bit for bit, so the loss is the one process's bit for
    bit; an input gradient is the SUM of the ranks' partial products, a
    reordered sum, so the gradients sit within 1e-5 of it, not on its bits
    (with every product on its gathered weight, every gradient was)."""
    mesh, arch = "tp12", FIRST
    loss, grads = tp["ranks"][0]["grads"][mesh, arch, hardware]
    one_loss, _, one_grads = tp["one"][arch, hardware]
    assert loss == one_loss
    assert _worst(grads, one_grads, arch) <= TOL


@pytest.mark.parametrize("mesh,arch", PAIRS)
def test_sharded_step_equals_the_references_sharded_step(tp, mesh, arch):
    from test_torch_fsdp import _nest

    case = f"{mesh}-{arch}"
    ref = tp["ref"]
    jgrads = _nest({k[len(case) + len("|grads|"):]: v for k, v in ref.items()
                    if k.startswith(f"{case}|grads|")})
    expect = {k: v.numpy() for k, v in convert.state_dict_from_reference(jgrads).items()}
    loss, grads = tp["ranks"][0]["grads"][mesh, arch, "ideal"]
    ref_loss = float(ref[f"{case}|loss"])
    assert loss == pytest.approx(ref_loss, abs=TOL * abs(ref_loss))
    assert _worst(grads, expect, arch) <= TOL


@pytest.mark.parametrize("mesh", list(ranks.TP_MESHES))
def test_every_shard_after_two_steps_is_the_rules_slice(tp, mesh):
    """Every rank's piece of every leaf after two noisy steps = the rule's
    slice of the one process's parameters (within 1e-5 of its max); most
    leaves are split."""
    n = int(np.prod(ranks.TP_MESHES[mesh]))
    split = 0
    for r in range(n):
        for k, (piece, index) in tp["ranks"][r]["shards"][mesh].items():
            expect = tp["steps"][k][index]
            assert piece.shape == expect.shape, k
            assert np.abs(piece - expect).max() <= TOL * np.abs(tp["steps"][k]).max(), (r, k)
            split += piece.shape != tp["steps"][k].shape
    assert split >= n * len(tp["steps"]) // 2


@pytest.mark.parametrize("mesh", list(ranks.TP_MESHES))
def test_model_groups_are_the_innermost_axis(tp, mesh):
    """``make_host_mesh(model_axis=)`` and the pod mesh fill row-major: a
    rank's model group is its run of ``model`` consecutive ranks."""
    shape = ranks.TP_MESHES[mesh]
    m = shape[-1]
    for r in range(int(np.prod(shape))):
        group, (index, size) = tp["ranks"][r]["groups"][mesh]
        assert group == list(range(r - r % m, r - r % m + m))
        assert (index, size) == (r % m, m)


def test_an_indivisible_model_axis_raises(tp):
    assert "does not divide 4 devices" in tp["ranks"][0]["indivisible"]


@pytest.mark.parametrize("op", ["copy_to_model", "gather_from_model", "split_to_model",
                                "reduce_from_model", "annotate"])
def test_operators_equal_one_process_autograd(tp, op):
    """Forward and gradient of each operator on both (1, 2) ranks against
    the same function of the whole tensors in one process: exact."""
    for r in range(2):
        assert tp["ranks"][r]["operators"][op] == 0.0, r


@pytest.mark.parametrize("module", ["mlp", "gated_mlp", "dense_block", "attention"])
def test_modules_on_local_pieces_equal_whole(tp, module):
    """Whisper's plain MLP, the gated FFN, the dense block, and an
    attention layer whose q, k and v split in the middle of a head on
    (1, 4), each rank holding its pieces and the module reading them
    through the FSDP gather: output and every parameter's gradient against
    the whole module."""
    for r in range(WORLD):
        assert tp["ranks"][r]["modules"][module] <= 1e-5, r


@pytest.mark.parametrize("algo", ["bp", "dfa-fused"])
def test_bp_and_dfa_fused_on_split_state_equal_one_process(tp, algo):
    """bp differentiates through the operators end to end; the fused step
    updates each rank's pieces as its block's gradients come."""
    case = tp["cases"][FIRST]
    loss, got = tp["ranks"][0]["algos"][algo]
    s = ranks.session(False, arch=FIRST, smoke=True, hardware="offchip_bpd", backend="cuda",
                      algo=algo)
    st = ranks.load_state(s, case["params"], case["fb"])
    if algo == "dfa-fused":
        params, _, one_loss = s.fused_step()(st["params"], st["fb"], st["opt"],
                                             s.trainer.put(case["batch"]), 7)
        expect, one_loss = ranks.np_tree(params), float(one_loss)
    else:
        one_loss, _, expect = ranks.grads_of(s, st, case["batch"])
    assert loss == pytest.approx(one_loss, abs=TOL * abs(one_loss))
    assert _worst(got, expect, FIRST) <= TOL


def test_step_cost_counts_the_model_axis_collectives(tp):
    """By kind, the operand bytes ``step_cost`` counted = those the step
    handed ``torch.distributed``; on (1, 2) every collective is the model
    axis's (the data axis is one rank: the FSDP gather issues none).  The
    dense products are column-parallel, so no weight is gathered: the
    gathers are each block's (B·S, rows) columns of its heads (q's rows),
    of ``o``, of gate·up (gate's rows) and of ``down``, in the forward and
    again in the block's recompute, the head's weight once (training keeps
    it whole), and each projection's (B·S, d / 2) columns of δ, the blocks'
    and the embedding's; the all-reduces hold the lookup's (B, S, d) sum
    and the partial input gradients of the recompute's products."""
    counted, seen = tp["ranks"][0]["cost"]
    assert counted == seen
    assert set(counted) == {"all-gather", "all-reduce"}
    params = tp["cases"][FIRST]["params"]
    rows = {k: piece.shape[0] for k, (piece, _) in tp["ranks"][0]["shards"]["tp12"].items()
            if piece.shape != params[k].shape}
    d_model = params["embed.tok.table"].shape[1]
    blocks = sorted({k.split(".")[1] for k in params if k.startswith("blocks.")})
    t = BATCH * SEQ
    columns = sum(rows[f"blocks.{i}.{leaf}.weight"] for i in blocks
                  for leaf in ("attn.q", "attn.o", "ffn.gate", "ffn.down"))
    deltas = (len(blocks) + 1) * 4 * t * d_model // 2
    head = 4 * rows["head.out.weight"] * d_model
    assert counted["all-gather"] == 4 * t * 2 * columns + head + deltas
    dx = sum(2 * rows[f"blocks.{i}.{leaf}.weight"] for i in blocks
             for leaf in ("attn.q", "ffn.gate")) + len(blocks) * 2 * d_model
    assert counted["all-reduce"] >= 4 * t * (d_model + dx)


def test_checkpoint_restores_from_2x2_on_4x1(tp):
    for r in range(WORLD):
        ck = tp["ranks"][r]["ckpt"]
        assert ck["step"] == 1 and ck["same"]
        assert ck["loss41"] == pytest.approx(ck["loss22"], abs=TOL * abs(ck["loss22"]))


# ---------------------------------------------------------------------------
# without the spawn
# ---------------------------------------------------------------------------


class _Group:
    pass


def test_a_model_axis_of_one_is_the_identity():
    x = torch.randn(2, 3, 8)
    for op in (tsh.copy_to_model, tsh.reduce_from_model, tsh.gather_from_model,
               tsh.split_to_model):
        assert op(x) is x
    assert tsh.model_index(None) == (0, 1)
    assert tph.active_columns() is None


@pytest.mark.parametrize("start,count,total", [(0, 3, 6), (3, 3, 6), (4, 2, 8)])
def test_column_window_noise_is_the_global_draws_columns(start, count, total):
    cfg = tph.PRESETS["offchip_bpd"]
    full = total_noise(9, (12, total), 40, cfg, "cpu")
    with tph.column_window(tph.ColumnWindow(start, count, total)):
        part = total_noise(9, (12, count), 40, cfg, "cpu")
        with tph.row_window(tph.RowWindow(1, 1, 3)):  # and rows [4, 8) of 12
            both = total_noise(9, (4, count), 40, cfg, "cpu")
    assert torch.equal(part, full[:, start:start + count])
    assert torch.equal(both, full[4:8, start:start + count])


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_a_column_window_gives_its_columns_of_the_global_product(backend):
    """Columns [4, 8) of a 12-column product through the rows of B they
    need, whose s_b is the whole B's (its max lies in them): those columns
    of the one-pass product, its noise included."""
    gen = torch.Generator().manual_seed(0)
    a, b = torch.randn(6, 40, generator=gen), torch.randn(12, 40, generator=gen)
    b[5, 3] = 50.0  # the whole weight's max lies in the window's rows
    cfg = tph.PRESETS["offchip_bpd"]
    full = tph.get_backend(backend).matmul(a, b, cfg, key=5)
    with tph.column_window(tph.ColumnWindow(4, 4, 12)):
        part = tph.get_backend(backend).matmul(a, b[4:8], cfg, key=5)
    torch.testing.assert_close(part, full[:, 4:8], rtol=1e-6, atol=1e-5)


def test_column_window_takes_one_max_per_weight_and_refuses():
    import torch.distributed as dist

    calls = []
    window = tph.ColumnWindow(0, 5, 10, _Group())
    orig = dist.all_reduce
    dist.all_reduce = lambda t, op=None, group=None: calls.append((op, group))
    try:
        b = torch.randn(5, 8)
        assert torch.equal(window.bmax(b), b.abs().amax())
        window.bmax(b.reshape(5, 8))
        assert len(calls) == 1 and calls[0][0] == dist.ReduceOp.MAX
    finally:
        dist.all_reduce = orig
    cfg = tph.PRESETS["offchip_bpd"]
    with tph.column_window(tph.ColumnWindow(0, 5, 10)):
        with pytest.raises(ValueError, match="window of 5"):
            window.bmax(torch.randn(4, 8))
        with pytest.raises(ValueError, match="stacked"):
            tph.normalise_operands(torch.randn(3, 4, 8), torch.randn(3, 5, 8), cfg)
        with pytest.raises(ValueError, match="prng"):
            ops.photonic_matmul(torch.randn(4, 8), torch.randn(5, 8), cfg, key=1,
                                noise_mode="prng")
    # the emu backend widens columns that share a bank panel (50 rows) with
    # another rank's through the model group, and the kernel takes whole
    # panels only
    with tph.column_window(tph.ColumnWindow(25, 25, 50)):
        with pytest.raises(ValueError, match="needs its model group"):
            tph.get_backend("emu").matmul(torch.randn(4, 8), torch.randn(25, 8),
                                          tph.PRESETS["emu_offchip"], key=1)
    from repro_torch.kernels import emu_matmul as em

    with pytest.raises(ValueError, match="whole number of panels"):
        em.check_operands(torch.zeros(2, 1, 1, 20), torch.zeros(1, 1, 50, 1, 20), None, 1,
                          None, col_base=25)


def test_sharded_leaves_of_both_axes_place_and_join():
    """A torch-layout weight splits d_out over ``model`` and d_in over
    ``data``; the feedback's injection dim, the vocabulary and a bias go on
    ``model`` (the reference's tables, read through a (2, 2) layout)."""
    from test_torch_dist import _Mesh

    mesh = _Mesh(data=2, model=2)
    assert tuple(tsh.leaf_spec("blocks.0.attn.q.weight", (64, 64), mesh)) == ("model", "data")
    assert tuple(tsh.leaf_spec("blocks.0.attn.q.bias", (64,), mesh)) == ("model",)
    assert tuple(tsh.leaf_spec("embed.tok.table", (128, 64), mesh)) == ("model", "data")
    assert tuple(tsh.leaf_spec("head.out.weight", (128, 64), mesh)) == ("model", "data")
    assert tuple(tsh.leaf_spec("blocks", (2, 64, 64), mesh, tsh.FEEDBACK_RULES)) == (
        None, "model", None)
    whole = torch.arange(24.0).reshape(4, 6)
    pieces = tsh._pieces(whole, 1, 2).reshape(2, 4, 3)
    assert torch.equal(tsh._join(pieces, 1), whole)


@pytest.mark.parametrize("value", [1.0, 4.5, 8.0, 12.25])
def test_resolution_names_are_the_references(value):
    assert tph.resolution_to_sigma(value) == jph.resolution_to_sigma(value)
    assert tph.bits_to_std(value) == jph.bits_to_std(value)
    sigma = tph.resolution_to_sigma(value)
    assert tph.std_to_bits(sigma) == jph.std_to_bits(sigma) == pytest.approx(value, abs=1e-12)


@pytest.mark.parametrize("offset", [3, [0, 5, 9]])
def test_positions_from_offset_is_the_references(offset):
    got = temb.positions_from_offset(3, 4, offset)
    expect = np.asarray(jemb.positions_from_offset(3, 4, np.asarray(offset)))
    assert np.array_equal(got.numpy(), expect)


@pytest.mark.parametrize("name", ["zeros", "ones"])
def test_constant_initializers_are_the_references(name):
    got = getattr(tinit, name)(None, (3, 5), torch.float32, "cpu")
    expect = np.asarray(getattr(jinit, name)(jax.random.PRNGKey(0), (3, 5)))
    assert np.array_equal(got.numpy(), expect)


def test_random_initializers_match_the_references_law():
    """Other streams, the same law: glorot's std sqrt(2 / (fan_in +
    fan_out)) (the draw itself a unit normal scaled by it) and uniform_sym's
    range and variance, against the reference's draws."""
    shape = (400, 600)
    gen = torch.Generator().manual_seed(0)
    got = tinit.glorot_normal()(gen, shape, torch.float32, "cpu")
    unit = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    assert torch.equal(got, unit * np.float32(np.sqrt(2.0 / 1000)))
    expect = np.asarray(jinit.glorot_normal()(jax.random.PRNGKey(0), shape))
    assert float(got.std()) == pytest.approx(float(expect.std()), rel=0.01)
    got = tinit.uniform_sym(0.3)(gen, shape, torch.float32, "cpu")
    expect = np.asarray(jinit.uniform_sym(0.3)(jax.random.PRNGKey(0), shape))
    assert -0.3 <= float(got.min()) and float(got.max()) < 0.3
    assert float(got.std()) == pytest.approx(float(expect.std()), rel=0.01)
