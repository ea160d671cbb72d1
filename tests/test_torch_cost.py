"""The port's step cost model on the CPU against the reference:
``utils/tree`` function by function, the bytes ``utils.flop_cost`` counts
for single operations against ``repro.utils.hlo_cost`` on the same jitted
operation, loops and views, each kernel's bytes helper against its hand
formula, a smoke LM step's bytes against the reference's, and
``launch/analysis`` on parameters carried across by ``repro_torch.convert``.
Every case feeds both packages the same seeded numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.launch import analysis as janalysis  # noqa: E402
from repro.utils import hlo_cost  # noqa: E402
from repro.utils import tree as jtree  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import dfa_gradient as dg  # noqa: E402
from repro_torch.kernels import emu_matmul as em  # noqa: E402
from repro_torch.kernels import photonic_matmul as pm  # noqa: E402
from repro_torch.launch import analysis  # noqa: E402
from repro_torch.utils import flop_cost, tree  # noqa: E402

ARCH = "qwen1.5-0.5b"
QWEN2MOE = "qwen2-moe-a2.7b"


def _trees(seed=0):
    """The same nested tree for both packages: f32, bf16 and int32 leaves
    under sorted keys (the reference's leaf order)."""
    rng = np.random.default_rng(seed)
    raw = {"a": {"b": rng.standard_normal((3, 4)).astype(np.float32),
                 "c": rng.integers(-5, 5, (5,)).astype(np.int32)},
           "d": rng.standard_normal((2, 2, 3)).astype(np.float32),
           "e": {"f": {"g": rng.standard_normal((7,)).astype(np.float32)}}}
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    to_t = lambda t: ({k: to_t(v) for k, v in t.items()} if isinstance(t, dict)  # noqa: E731
                      else torch.from_numpy(t.copy()))
    return raw, to_j(raw), to_t(raw)


def _leaves_np(t):
    return [np.asarray(x) for _, x in tree.named_leaves(t)]


# ---------------------------------------------------------------------------
# utils/tree against repro.utils.tree
# ---------------------------------------------------------------------------

def test_counts_names_and_paths_match_the_reference():
    _, j, t = _trees()
    assert tree.param_count(t) == jtree.param_count(j) == 3 * 4 + 5 + 12 + 7
    assert tree.param_bytes(t) == jtree.param_bytes(j)
    names = [n for n, _ in tree.named_leaves(t)]
    assert names == [n for n, _ in jtree.named_leaves(j)] == ["a/b", "a/c", "d", "e/f/g"]
    for (_, x), (_, y) in zip(tree.named_leaves(t), jtree.named_leaves(j)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    mapped = tree.path_map(lambda n, x: len(n) + x.numel(), t)
    jmapped = jtree.path_map(lambda n, x: len(n) + x.size, j)
    assert mapped == jmapped
    # the port's flat dicts: a dotted name is one key
    flat = {"blocks.0.attn.q.weight": torch.zeros(2, 3), "embed.tok.table": torch.zeros(4)}
    assert [n for n, _ in tree.named_leaves(flat)] == list(flat)
    assert tree.param_count(flat) == 10 and tree.param_bytes(flat) == 40


def test_cast_zeros_add_scale_match_the_reference():
    _, j, t = _trees()
    _, j2, t2 = _trees(seed=1)
    cast, jcast = tree.cast(t, torch.bfloat16), jtree.cast(j, jnp.bfloat16)
    assert [x.dtype for x in tree.leaves(cast)] == [torch.bfloat16, torch.int32,
                                                   torch.bfloat16, torch.bfloat16]
    for x, y in zip(_leaves_np(tree.cast(cast, torch.float32)),
                    jax.tree_util.tree_leaves(jtree.cast(jcast, jnp.float32))):
        np.testing.assert_array_equal(x, np.asarray(y))
    zeros = tree.tree_zeros_like(t, torch.float64)
    assert all(x.dtype == torch.float64 and not x.any() for x in tree.leaves(zeros))
    assert [x.shape for x in tree.leaves(zeros)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jtree.tree_zeros_like(j))]
    for got, expect in ((tree.tree_add(t, t2), jtree.tree_add(j, j2)),
                        (tree.tree_scale(t, 0.37), jtree.tree_scale(j, 0.37))):
        for x, y in zip(_leaves_np(got), jax.tree_util.tree_leaves(expect)):
            np.testing.assert_allclose(x, np.asarray(y), rtol=1e-6, atol=1e-6)


def test_dot_norm_and_allclose_match_the_reference():
    _, j, t = _trees()
    _, j2, t2 = _trees(seed=1)
    assert float(tree.tree_dot(t, t2)) == pytest.approx(float(jtree.tree_dot(j, j2)), rel=1e-6)
    assert tree.tree_dot(t, t2).dtype == torch.float32
    assert float(tree.global_norm(t)) == pytest.approx(float(jtree.global_norm(j)), rel=1e-6)
    assert tree.tree_allclose(t, t) and jtree.tree_allclose(j, j)
    assert tree.tree_allclose(t, t2) == jtree.tree_allclose(j, j2) is False
    nudged = tree.tree_add(t, tree.tree_scale(tree.cast(t, torch.float32), 1e-7))
    assert tree.tree_allclose(t, nudged) == jtree.tree_allclose(
        j, jtree.tree_add(j, jtree.tree_scale(jtree.cast(j, jnp.float32), 1e-7)))
    assert not tree.tree_allclose(t, {"a": t["a"]})


def test_the_optimizer_clips_with_the_shared_global_norm():
    from repro_torch.train import optimizer

    _, _, t = _trees()
    grads = {n: x.float() for n, x in tree.named_leaves(t)}
    clipped, norm = optimizer.clip_by_global_norm(grads, 1.0)
    assert torch.equal(norm, torch.sqrt(sum((x.float() ** 2).sum() for x in grads.values())))
    assert torch.equal(norm, tree.global_norm(grads))
    assert float(tree.global_norm(clipped)) == pytest.approx(1.0, rel=1e-6)


# ---------------------------------------------------------------------------
# bytes of single operations against repro.utils.hlo_cost
# ---------------------------------------------------------------------------

def _operands(n=256, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)).astype(np.float32),
            rng.standard_normal((n, n)).astype(np.float32))


def _hlo_bytes(fn, *args):
    text = jax.jit(fn).lower(*(jnp.asarray(a) for a in args)).compile().as_text()
    return hlo_cost.analyze(text).mem_bytes


def _port_bytes(fn, *args):
    _, cost = flop_cost.measure(fn, *(torch.from_numpy(a) for a in args))
    return cost


@pytest.mark.parametrize("op", ["matmul", "add"])
def test_single_op_bytes_equal_the_reference(op):
    """An f32 256 x 256 matmul and an elementwise add: both operands read
    and the output written, 3·256·256·4 bytes, in both counts."""
    a, b = _operands()
    fn = (lambda x, y: x @ y) if op == "matmul" else (lambda x, y: x + y)
    cost = _port_bytes(fn, a, b)
    assert cost.mem_bytes == _hlo_bytes(fn, a, b) == 3 * 256 * 256 * 4
    assert cost.as_dict() == {"flops": float(cost.flops), "mem_bytes": float(cost.mem_bytes),
                              "collective_bytes": 0.0, "coll_bytes_by_kind": {}}


def test_row_reduction_bytes_against_the_reference():
    """A row sum: the port reads the (256, 256) input and writes the (256,)
    output.  XLA's CPU compiler splits the reduction in two fusions, a
    windowed partial sum to (256, 8) and the final sum, each reading the
    f32 init constant: it counts the (256, 8) intermediate written and read
    and the constant twice on top, exactly 2·256·8·4 + 2·4 bytes more."""
    a, _ = _operands()
    fn = lambda x: x.sum(1)  # noqa: E731
    cost = _port_bytes(fn, a)
    assert cost.mem_bytes == 256 * 256 * 4 + 256 * 4
    assert _hlo_bytes(fn, a) == cost.mem_bytes + 2 * 256 * 8 * 4 + 2 * 4


def test_a_loop_counts_each_run_and_views_count_nothing():
    a, b = (torch.from_numpy(x) for x in _operands(64))
    one = flop_cost.measure(lambda: a @ b)[1]
    for n in (1, 3, 5):
        cost = flop_cost.measure(lambda: [a @ b for _ in range(n)])[1]
        assert cost.mem_bytes == n * one.mem_bytes == n * 3 * 64 * 64 * 4
        assert cost.flops == one.flops  # the same product on the same operands: once
    views = flop_cost.measure(lambda: (a.view(-1), a.t(), a.T.reshape(64, 64)[1:], a.detach(),
                                       a[:, None].expand(64, 8, 64), a.unsqueeze(0)))[1]
    assert views.mem_bytes == 0
    # a stride-0 operand counts its stored elements once
    row = torch.ones(64)
    bcast = flop_cost.measure(lambda: a + row.expand(64, 64))[1]
    assert bcast.mem_bytes == (64 * 64 + 64 + 64 * 64) * 4
    # an in-place update reads and writes its input; a copy only writes its destination
    c = a.clone()
    assert flop_cost.measure(lambda: c.add_(b))[1].mem_bytes == 3 * 64 * 64 * 4
    assert flop_cost.measure(lambda: c.copy_(b))[1].mem_bytes == 2 * 64 * 64 * 4
    assert flop_cost.measure(lambda: torch.empty(64, 64))[1].mem_bytes == 0


def test_count_launch_adds_the_kernels_bytes():
    def fn():
        flop_cost.count_launch(100, 4096)
        flop_cost.count_launch(50, 1024)

    cost = flop_cost.measure(fn)[1]
    assert (cost.kernel_flops, cost.kernel_bytes, cost.kernel_launches) == (150, 5120, 2)
    assert cost.mem_bytes == 5120 and cost.flops == 150
    flop_cost.count_launch(1, 1)  # free with no measurement under way


# ---------------------------------------------------------------------------
# each kernel's bytes helper against its hand formula
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e", [1, 60])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("noise", [False, True])
def test_bank_and_dfa_gradient_bytes(e, itemsize, noise):
    t, m, k = 4, 2816, 1024
    a, b, out = e * t * k * itemsize, e * m * k * itemsize, e * t * m * 4
    eta = t * m * 4 if noise else 0  # one (T, M) noise operand for every index
    assert pm.launch_bytes(t, m, k, itemsize, e=e, noise=noise) == a + b + out + eta
    assert dg.launch_bytes(t, m, k, itemsize, e=e, noise=noise) == a + b + out + eta + e * t * m * 4
    # the wrapper's (FLOPs, bytes) from the operands
    shape = (e,) if e > 1 else ()
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    x, w = torch.empty(*shape, t, k, dtype=dtype), torch.empty(*shape, m, k, dtype=dtype)
    flops, nbytes = pm.launch_cost(x, w, torch.empty(t, m) if noise else None)
    assert flops == 2 * e * t * k * m and nbytes == a + b + out + eta


@pytest.mark.parametrize("e", [1, 60])
@pytest.mark.parametrize("masked", [False, True])
def test_emu_bytes(e, masked):
    t, q, nj, c, nm, rows = 4096, 2, 26, 20, 21, 50
    batch = (e,) if e > 1 else ()
    a_shape, d_shape = (*batch, t, q, nj, c), (*batch, nm, q, rows, nj, c)
    expect = (e * t * q * nj * c * 2 + e * nm * q * rows * nj * c * 4
              + (q * rows * c * 4 if masked else 0) + e * t * nm * rows * 4)
    assert em.launch_bytes(a_shape, 2, d_shape, masked) == expect


# ---------------------------------------------------------------------------
# a smoke LM step and launch/analysis against the reference
# ---------------------------------------------------------------------------

def test_smoke_lm_step_bytes_lie_above_the_reference(capsys):
    """The same dfa step (smoke qwen1.5, batch 4 x 16, ideal, ``ref``):
    eager mode writes every intermediate that XLA keeps inside a fusion,
    so the port's bytes lie above the reference's."""
    js = japi.build_session(arch=ARCH, smoke=True, algo="dfa", hardware="ideal", backend="ref",
                            data_parallel=False)
    ts = api.build_session(arch=ARCH, smoke=True, algo="dfa", hardware="ideal", backend="ref",
                           device="cpu")
    batch = jtokens.MarkovTokens(ts.model.cfg.vocab_size, 16, 4, 0).batch(0)
    ref = js.step_cost(js.init_state(), {k: jnp.asarray(v) for k, v in batch.items()})
    cost = ts.step_cost(ts.init_state(), batch)
    assert cost.kernel_launches == 0 and cost.kernel_bytes == 0
    assert cost.mem_bytes >= ref.mem_bytes > 0
    with capsys.disabled():
        print(f"\n[cost] smoke {ARCH} dfa step: port {cost.mem_bytes} B, reference "
              f"{int(ref.mem_bytes)} B, ratio {cost.mem_bytes / ref.mem_bytes:.4f}")


@pytest.mark.parametrize("arch", [ARCH, QWEN2MOE])
def test_param_counts_and_model_flops_match_the_reference(arch):
    jm = jconfigs.get(arch).make_smoke()
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = tconfigs.get(arch).make_smoke(device="cpu")
    tp = convert.state_dict_from_reference(jax.tree_util.tree_map(np.asarray, jp))
    tm.load_state_dict(tp)
    params = tm.param_dict()
    assert analysis.tree_param_count(params) == janalysis.tree_param_count(jp)
    assert analysis.tree_param_bytes(params) == janalysis.tree_param_bytes(jp)
    active = analysis.active_param_count(params, tm)
    assert active == janalysis.active_param_count(jp, jm)
    assert (active < analysis.tree_param_count(params)) == (arch == QWEN2MOE)
    for kind in ("train", "serve"):
        assert analysis.model_flops_reference(active, 4 * 16, kind) == \
            janalysis.model_flops_reference(active, 4 * 16, kind)


def test_roofline_terms_and_the_card_constants():
    """The reference's terms at the card's peaks; the dtype's peak by keyword."""
    terms = analysis.roofline_terms(67e12, 3.35e12, 0.0, 1)
    assert terms["t_compute_s"] == pytest.approx(67 / 989)
    assert terms["t_memory_s"] == pytest.approx(1.0) and terms["dominant"] == "memory"
    f32 = analysis.roofline_terms(67e12, 3.35e12, 0.0, 1, peak_flops=analysis.PEAK_FLOPS_F32)
    assert f32["t_compute_s"] == pytest.approx(1.0) and f32["bound_s"] == pytest.approx(1.0)
    coll = analysis.roofline_terms(0.0, 0.0, 900e9, 2)
    assert coll["dominant"] == "collective" and coll["t_collective_s"] == pytest.approx(1.0)
    assert set(terms) == set(janalysis.roofline_terms(1.0, 1.0, 1.0, 1))
    cost = flop_cost.StepCost(flops=10, counted_flops=10, kernel_flops=0, kernel_launches=0,
                              mem_bytes=20)
    assert analysis.cost_analysis_dict(cost) == {"flops": 10.0, "bytes accessed": 20.0}
    assert analysis.memory_analysis_dict("cpu", 5) == {}
