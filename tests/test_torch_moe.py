"""The mixture-of-experts family: the port against the reference on the CPU.

``nn/moe.py``'s routing (dispatch, combine, aux terms, drops), its einsum
and gather dispatch and its group loop; the batched bank product that the
stacked experts run (``forward_matmul`` over an (E, M, K) weight: each
expert's own scales, one shared noise draw, one key), on the ``ref``
backend, the ``cuda`` backend's plain version and the ``emu`` backend;
and the smoke qwen2-moe-a2.7b and kimi-k2-1t-a32b models: logits,
``decode_step``, ``prefill_step``, the engine's greedy tokens, the key
numbering, dfa / bp gradients with the aux loss, both launchers and
``step_cost``.  The reference's parameters and feedback are carried
across by ``convert`` and inputs come from a seeded numpy generator.  The
full-width layouts (14.32 B and 1.04 T parameters) are checked on the
meta device."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import algos as jalgos  # noqa: E402
from repro import api as japi  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.algos import dfa as jdfa  # noqa: E402
from repro.core import photonics as jph  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.hardware import channel as jch  # noqa: E402
from repro.hardware import drift as jdrift  # noqa: E402
from repro.hardware import mrr as jmrr  # noqa: E402
from repro.nn.moe import MoE as JMoE  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch import algos as talgos  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.algos import dfa as tdfa  # noqa: E402
from repro_torch.configs import kimi_k2_1t_a32b as tkimi  # noqa: E402
from repro_torch.configs import qwen2_moe_a2_7b as tqwen2moe  # noqa: E402
from repro_torch.core import photonics as tph  # noqa: E402
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.hardware import channel as tch  # noqa: E402
from repro_torch.hardware import drift as tdrift  # noqa: E402
from repro_torch.hardware import mrr as tmrr  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import photonic_matmul as pm  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.nn.moe import MoE  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import Request as TRequest  # noqa: E402

QWEN2MOE, KIMI = "qwen2-moe-a2.7b", "kimi-k2-1t-a32b"
VOCAB, SEQ, BATCH = 128, 16, 4
TOL = 1e-5  # of each tensor's max |value|: logits, outputs and gradients (ROADMAP)
BANK_TOL = 2e-5  # f32 bank products (ROADMAP)
PROMPTS = [[5, 17, 99, 3, 42], [7, 8], [120]]
LAYER = dict(d_model=32, d_ff_expert=48, n_experts=8, top_k=2, n_shared_experts=2,
             d_ff_shared=24)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, expect, tol=TOL, what=""):
    got, expect = _np(got), _np(expect)
    assert got.shape == expect.shape, (what, got.shape, expect.shape)
    scale = max(np.abs(expect).max(), 1e-30)
    assert np.abs(got - expect).max() <= tol * scale, (what, np.abs(got - expect).max(), scale)


def _layer_pair(seed=3, **kw):
    """The reference's MoE layer and its parameters, and the port's layer
    carrying them."""
    jl = JMoE(**LAYER, **kw)
    jp = jl.init(jax.random.PRNGKey(seed))
    tl = MoE(**LAYER, **kw, device="cpu")
    tl.load_state_dict(convert.state_dict_from_reference(_to_np(jp)))
    return jl, jp, tl


def _x(shape, seed=11):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["cap1.25", "drops"])
def test_route_matches_reference(capacity_factor):
    """Dispatch equal, combine and the aux terms within 1e-6, on 64 tokens;
    at capacity factor 0.5 a quarter of the (token, k) pairs at least are
    dropped in position-in-expert order."""
    jl, jp, tl = _layer_pair(capacity_factor=capacity_factor)
    x = _x((64, 32))
    jcomb, jdisp, jaux = jax.jit(jl._route)(jp, jnp.asarray(x))
    with torch.no_grad():
        comb, disp, aux = tl._route(_t(x))
    assert tl.capacity(64) == jdisp.shape[-1] == int(capacity_factor * 2 * 64 / 8)
    np.testing.assert_array_equal(_np(disp), np.asarray(jdisp))
    np.testing.assert_allclose(_np(comb), np.asarray(jcomb), atol=1e-6, rtol=0)
    for k in ("lb_loss", "z_loss", "dropped_frac"):
        assert float(aux[k]) == pytest.approx(float(jaux[k]), abs=1e-6), k
    dropped = float(aux["dropped_frac"])
    assert (dropped >= 0.25) if capacity_factor < 1 else (dropped < 0.25)
    # every slot holds at most one token, every kept (token, k) one slot
    assert float(disp.sum((0,)).max()) <= 1.0
    assert float(disp.sum()) == pytest.approx((1 - dropped) * 64 * 2)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["cap1.25", "drops"])
def test_forward_matches_reference(dispatch, capacity_factor):
    """The layer's output and aux terms within 1e-5 of the reference's, the
    output unchanged when serving asks for no aux terms, and the port's
    gather dispatch equal to its einsum dispatch."""
    jl, jp, tl = _layer_pair(dispatch=dispatch, capacity_factor=capacity_factor)
    x = _x((4, 16, 32))
    jy, jaux = jax.jit(jl.__call__)(jp, jnp.asarray(x))
    with torch.no_grad():
        y, aux = tl(_t(x))
        y_serve, no_aux = tl(_t(x), with_aux=False)
    _close(y, jy, what="y")
    assert no_aux is None and torch.equal(y_serve, y)
    for k in jaux:
        assert float(aux[k]) == pytest.approx(float(jaux[k]), abs=1e-6), k
    other = "gather" if dispatch == "einsum" else "einsum"
    tl.dispatch = other
    with torch.no_grad():
        y2, _ = tl(_t(x))
    _close(y2, y, tol=1e-6, what=f"{other} = {dispatch}")


def test_group_loop_matches_reference_scan():
    """128 tokens at group_size 32 (B 2, chunk 16: four groups along the
    sequence): the output, the mean aux terms and the input gradient
    against the reference's scan over groups."""
    jl, jp, tl = _layer_pair(group_size=32, capacity_factor=1.0)
    x = _x((2, 64, 32), seed=12)
    jy, jaux = jax.jit(jl.__call__)(jp, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y, aux = tl(xt)
    _close(y, jy, what="y")
    for k in jaux:
        assert float(aux[k].detach()) == pytest.approx(float(jaux[k]), abs=1e-6), k
    (y.square().sum() + aux["lb_loss"] + aux["z_loss"]).backward()
    jg = jax.jit(jax.grad(lambda v: (lambda o: jnp.sum(jnp.square(o[0])) + o[1]["lb_loss"]
                                     + o[1]["z_loss"])(jl(jp, v))))(jnp.asarray(x))
    _close(xt.grad, jg, what="input gradient")
    with torch.no_grad():  # serving's call: the same output, no aux terms
        y_serve, no_aux = tl(_t(x), with_aux=False)
    assert no_aux is None and torch.equal(y_serve, y.detach())
    # one group alone differs: the loop really routes group by group
    tl.group_size = 4096
    with torch.no_grad():
        assert not torch.allclose(tl(_t(x))[0], y.detach(), atol=1e-4)


def _counting(calls):
    @dataclasses.dataclass(frozen=True)
    class Counting(tph.PhotonicBackend):
        name: str = "counting"

        def matmul(self, a, b, cfg, key=None, *, mask=None):
            calls.append((tph.active_forward().calls, tuple(b.shape)))
            return tph.photonic_matmul(a, b, cfg, key=key, mask=mask)

    return Counting()


def test_keys_are_numbered_as_the_reference_numbers_them():
    """Inside one layer: three expert keys, the same for every group of the
    group loop (the reference traces its scan body once), then the shared
    experts' three; the reference's own numbering, read from the same
    counter under its jitted layer."""
    jl, jp, tl = _layer_pair(group_size=32, capacity_factor=1.0)
    x = _x((2, 64, 32), seed=12)
    jcalls, tcalls = [], []

    @dataclasses.dataclass(frozen=True)
    class JCounting(jph.PhotonicBackend):
        name: str = "jcounting"

        def matmul(self, a, b, cfg, key=None, *, mask=None):
            jcalls.append(jph.active_forward().calls)
            return jph.photonic_matmul(a, b, cfg, key=key, mask=mask)

    def jrun(p, v):
        with jph.forward_execution(jph.PRESETS["ideal"], JCounting(), jax.random.PRNGKey(0)):
            return jl(p, v)[0]

    jax.jit(jrun)(jp, jnp.asarray(x))
    with torch.no_grad(), tph.forward_execution(tph.PRESETS["ideal"], _counting(tcalls), 0):
        tl(_t(x))
    assert jcalls == [1, 2, 3, 4, 5, 6]
    assert [c for c, _ in tcalls] == [1, 2, 3] * 4 + [4, 5, 6]
    assert [s for _, s in tcalls[:3]] == [(8, 48, 32), (8, 48, 32), (8, 32, 48)]


# ---------------------------------------------------------------------------
# the batched bank product
# ---------------------------------------------------------------------------

SCALES = np.array([1.0, 2.0, 4.0], np.float32)[:, None, None]


def _stack(seed=21, t=6, k=40, m=24):
    """x (3, T, K) and w (3, M, K) with the weights scaled 1, 2 and 4."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, t, k)).astype(np.float32)
    w = rng.standard_normal((m, k)).astype(np.float32)[None] * SCALES
    return x, w


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_batched_seam_matches_vmapped_reference(backend):
    """``forward_matmul`` on a stacked weight, noise off with 8-bit inputs
    and weights, against ``jax.vmap(forward_matmul)`` on the reference's
    ``ref`` backend within 2e-5: each expert normalised by its own
    scales."""
    x, w = _stack()
    cfg = dict(noise_std=0.0, weight_bits=8, input_bits=8)

    def jrun(xv, wv):
        with jph.forward_execution(jph.PhotonicConfig(**cfg), "ref"):
            return jax.vmap(jph.forward_matmul)(xv, wv)

    expect = jax.jit(jrun)(jnp.asarray(x), jnp.asarray(np.swapaxes(w, 1, 2)))
    with tph.forward_execution(tph.PhotonicConfig(**cfg), backend):
        got = tph.forward_matmul(_t(x), _t(w))
    _close(got, expect, tol=BANK_TOL)
    # the digital branch: x @ w.mT, in both packages
    _close(tph.forward_matmul(_t(x), _t(w)),
           jax.vmap(jph.forward_matmul)(jnp.asarray(x), jnp.asarray(np.swapaxes(w, 1, 2))),
           tol=1e-6)


@pytest.mark.parametrize("backend", ["ref", "cuda", "reference"])
def test_noise_is_one_draw_shared_by_every_expert(backend):
    """The same inputs through weights scaled 1, 2 and 4, noise on: each
    expert's output over its own scale is the same, noise included, so
    every expert has its own s_b and all share one draw in normalised
    units.  ``reference`` runs the check on the reference's vmap, the
    semantics the port keeps."""
    x, w = _stack(seed=22)
    x = np.broadcast_to(x[:1], x.shape).copy()
    cfg = dict(noise_std=0.098)
    if backend == "reference":
        def jrun(xv, wv, key):
            with jph.forward_execution(jph.PhotonicConfig(**cfg), "ref", key):
                return jax.vmap(jph.forward_matmul)(xv, wv)

        out = np.asarray(jax.jit(jrun)(jnp.asarray(x), jnp.asarray(np.swapaxes(w, 1, 2)),
                                       jax.random.PRNGKey(7)))
    else:
        with tph.forward_execution(tph.PhotonicConfig(**cfg), backend, 7):
            out = _np(tph.forward_matmul(_t(x), _t(w)))
    per_scale = out / SCALES
    np.testing.assert_allclose(per_scale[1], per_scale[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(per_scale[2], per_scale[0], rtol=1e-5, atol=1e-5)
    exact = np.einsum("etk,emk->etm", x, w) / SCALES
    assert np.abs(per_scale[0] - exact[0]).max() > 1e-3  # the noise is there


@pytest.mark.parametrize("mode", ["none", "input", "prng"])
def test_cuda_plain_batched_equals_single_calls(mode):
    """The ``cuda`` backend's plain version on a batch equals E 2-D plain
    calls bit for bit, the (T, M) noise or seed the same at every index;
    and ``ops.photonic_matmul`` on a batch equals per-expert 2-D calls with
    the same key, each with its own scales."""
    rng = np.random.default_rng(23)
    a = _t(rng.uniform(-1, 1, (3, 5, 40)).astype(np.float32))
    b = _t(rng.uniform(-1, 1, (3, 24, 40)).astype(np.float32))
    kw = {"none": {}, "input": {"noise": 0.1 * _t(rng.standard_normal((5, 24)).astype(
        np.float32))}, "prng": {"seed": 99, "sigma_step": 0.05}}[mode]
    got = pm.photonic_matmul_cuda(a, b, **kw)
    assert got.shape == (3, 5, 24) and got.dtype == torch.float32
    for e in range(3):
        assert torch.equal(got[e], pm.photonic_matmul_cuda(a[e], b[e], **kw)), e
    cfg = tph.PhotonicConfig(noise_std=0.098, weight_bits=6)
    wide = b * _t(SCALES)
    out = kops.photonic_matmul(a, wide, cfg, key=5)
    for e in range(3):
        torch.testing.assert_close(out[e], kops.photonic_matmul(a[e], wide[e], cfg, key=5),
                                   rtol=0, atol=0)


def test_emu_backend_runs_each_expert_with_one_key():
    """The ``emu`` backend on a stacked weight: one 2-D emulated product a
    expert with the same key, stacked."""
    x, w = _stack(seed=24, t=3, k=40, m=20)
    cfg = tph.PRESETS["emu_offchip"]
    with tph.forward_execution(cfg, "emu", 9):
        got = tph.forward_matmul(_t(x), _t(w))
    for e in range(3):
        expect = tch.emulated_matmul(_t(x[e]), _t(w[e]), cfg, key=tph.prng.fold(9, 1),
                                         kernel="auto")
        assert torch.equal(got[e], expect), e


def _emu_pair(noise_std):
    """The same quiet emu device in both packages (crosstalk on, no heater
    DAC, no drift steps: the reference traces its products, and XLA then
    multiplies by reciprocals where the port divides), with read noise
    ``noise_std``, and one nonzero drift residual (1, 50, 20) for it."""
    mrr = dict(drift_sigma=0.0, heater_bits=None, crosstalk=0.01)
    jc = jph.PhotonicConfig(noise_std=noise_std, mrr=jmrr.MRRConfig(**mrr))
    tc = tph.PhotonicConfig(noise_std=noise_std, mrr=tmrr.MRRConfig(**mrr))
    r = np.random.default_rng(27).uniform(-0.1, 0.1, (1, 50, 20)).astype(np.float32)
    jhw = {"drift": jnp.asarray(r), "cal": jnp.zeros((1, 50, 20), jnp.float32)}
    return (jc, jhw), (tc, convert.hw_state_from_reference(_to_np(jhw)))


@pytest.mark.parametrize("kernel", ["ref", "cuda"])
def test_emu_seam_matches_vmapped_reference(kernel):
    """The ``emu`` backend on a stacked weight under a drifted device,
    against ``jax.vmap(forward_matmul)`` under the reference's emu backend
    on the same inputs, within 1e-5: each expert normalised by its own
    scales (weights scaled 1, 2 and 4) and one drift residual for all.
    ``cuda`` on CPU tensors is the emu kernel's plain version, held to the
    reference's fused twin."""
    x, w = _stack(seed=25)
    (jc, jhw), (tc, thw) = _emu_pair(0.0)
    jback = jph.EmulatedMRRBackend(emu_kernel="ref" if kernel == "ref" else "xla")

    def jrun(xv, wv, hw):
        with jdrift.use_state(hw), jph.forward_execution(jc, jback):
            return jax.vmap(jph.forward_matmul)(xv, wv)

    expect = np.asarray(jax.jit(jrun)(jnp.asarray(x), jnp.asarray(np.swapaxes(w, 1, 2)), jhw))
    with tdrift.use_state(thw), tph.forward_execution(tc, tph.EmulatedMRRBackend(
            emu_kernel=kernel)):
        got = tph.forward_matmul(_t(x), _t(w))
    _close(got, expect, what=kernel)
    with tph.forward_execution(tc, tph.EmulatedMRRBackend(emu_kernel=kernel)):
        clean = _np(tph.forward_matmul(_t(x), _t(w)))
    assert np.abs(clean - expect).max() > 1e-3 * np.abs(expect).max()  # the residual is there


def test_emu_stack_shares_one_noise_draw_with_the_reference():
    """Noise on: the emu backend on the stack with one key against
    ``jax.vmap(channel.emulated_matmul)`` with that key unbatched, the
    port's integer key carrying the reference key's two seed words, on a
    drifted device within 1e-5: every expert draws the same noise, as
    under the reference's vmap (the emu kernel's plain version against
    the reference's fused twin)."""
    x, w = _stack(seed=26)
    (jc, jhw), (tc, thw) = _emu_pair(0.098)
    jkey = jax.random.PRNGKey(11)
    hi, lo = (int(v) for v in np.asarray(jax.random.key_data(jkey)).reshape(-1)[-2:])

    def jrun(xv, wv, hw):
        with jdrift.use_state(hw):
            return jax.vmap(lambda a, b: jch.emulated_matmul(a, b, jc, key=jkey, kernel="xla"))(
                xv, wv)

    expect = np.asarray(jax.jit(jrun)(jnp.asarray(x), jnp.asarray(w), jhw))
    back = tph.EmulatedMRRBackend(emu_kernel="cuda")
    with tdrift.use_state(thw):
        got = back.matmul(_t(x), _t(w), tc, key=(hi << 32) | lo)
        quiet = back.matmul(_t(x), _t(w), dataclasses.replace(tc, noise_std=0.0))
    _close(got, expect)
    assert np.abs(_np(got) - _np(quiet)).max() > 1e-3 * np.abs(expect).max()  # noise is on


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[QWEN2MOE, KIMI])
def pair(request):
    """(reference model, params, feedback), (port model with those
    parameters, its flat params, feedback) for one smoke config."""
    arch = request.param
    jm = jconfigs.get(arch).make_smoke()
    key = jax.random.PRNGKey(0)
    jp = jax.jit(jm.init)(key)
    jf = jax.jit(lambda k: jalgos.get("dfa").init_extra_state(jm, k, jdfa.DFAConfig()))(
        jax.random.fold_in(key, 1))
    tm = tconfigs.get(arch).make_smoke(device="cpu")
    tp = convert.state_dict_from_reference(_to_np(jp))
    assert sorted(tp) == sorted(tm.param_dict())
    tm.load_state_dict(tp)
    return arch, (jm, jp, jf), (tm, tp, convert.feedback_from_reference(_to_np(jf)))


def _batch(step=0):
    b = jtokens.MarkovTokens(VOCAB, SEQ, BATCH, seed=0).batch(step)
    return {k: jnp.asarray(v) for k, v in b.items()}, to_device(b, "cpu")


FULL = {  # (n_layers, parameters in billions, 2 decimals, expert gate (E, M, K))
    QWEN2MOE: (24, 14.32, (60, 1408, 2048)),
    KIMI: (61, 1044.86, (384, 2048, 7168)),
}


@pytest.mark.parametrize("arch", [QWEN2MOE, KIMI])
def test_full_width_layout_matches_reference_without_allocation(arch):
    """full() on the meta device: the reference's names, shapes and count
    after ``convert.torch_shapes`` (stacked experts (E, out, in)), and its
    ``forward_gemm_specs``; opt() the same layout."""
    jm = jconfigs.get(arch).make_model(jnp.bfloat16)
    tm = tconfigs.get(arch).make_model(torch.bfloat16, device="meta")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == convert.torch_shapes(jm.param_shapes())
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(jm.param_shapes()))
    layers, billions, gate = FULL[arch]
    assert tm.cfg.n_layers == layers and round(n / 1e9, 2) == billions
    assert got["blocks.0.ffn.experts.gate.weight"] == gate
    assert got["blocks.0.ffn.experts.down.weight"] == (gate[0], gate[2], gate[1])
    assert tm.forward_gemm_specs() == jm.forward_gemm_specs()
    opt = (tqwen2moe if arch == QWEN2MOE else tkimi).opt(torch.bfloat16, device="meta")
    assert {k: tuple(p.shape) for k, p in opt.named_parameters()} == got
    assert opt.cfg.moe.dispatch == "einsum"


def test_forward_parts_match_reference(pair):
    """The DFA tape, x_final, logits, the loss with the summed aux term,
    and the serving forward."""
    arch, (jm, jp, _), (tm, tp, _) = pair
    jbatch, tbatch = _batch()

    @jax.jit
    def parts(p, b):
        xf, saved, auxes = jm.run_segments(p, jm.embed(p, b))
        return (saved["blocks"].inputs, xf, auxes["blocks"], jm.head_logits(p, xf, b),
                jm.loss(p, b))

    jtape, jxf, jaux, jlogits, (jl, jmet) = parts(jp, jbatch)
    xf, saved, auxes = tm.run_segments(tp, tm.embed(tp, tbatch))
    _close(saved["blocks"].inputs, jtape, what="tape")
    _close(xf, jxf, what="x_final")
    assert float(auxes["blocks"]) == pytest.approx(float(jaux), abs=1e-6) and float(jaux) > 0
    _close(tm.head_logits(tp, xf, tbatch), jlogits, tol=1e-4, what="logits")
    loss, met = tm.loss(tp, tbatch)
    assert float(loss) == pytest.approx(float(jl), abs=TOL)
    assert float(met["aux_loss"]) == pytest.approx(float(jmet["aux_loss"]), abs=1e-6)
    with torch.no_grad():
        _close(tm(tbatch["tokens"]), jlogits, tol=1e-4, what=(arch, "serving forward"))


def test_decode_and_prefill_steps_match_reference(pair):
    """Five decode steps of 3 slots (cap 1 a expert), then a prefill step
    of a 4-token chunk with n_valid (4, 2, 0): logits within 1e-4 and the
    caches against the reference's."""
    arch, (jm, jp, _), (tm, _, _) = pair
    rng = np.random.default_rng(5)
    toks = rng.integers(0, VOCAB, (3, 5))
    jcache, tcache = jm.init_caches(3, 12), tm.init_caches(3, 12)
    jstep = jax.jit(jm.decode_step)
    for t in range(5):
        clen = np.full((3,), t)
        jl, jcache = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jcache, jnp.asarray(clen))
        with torch.no_grad():
            tl, tcache = tm.decode_step(_t(toks[:, t:t + 1]), tcache, _t(clen))
        _close(tl, jl, tol=1e-4, what=(arch, "decode", t))
    for name, ref in _to_np(jcache).items():
        _close(tcache[name], ref, what=name)
    chunk = rng.integers(0, VOCAB, (3, 4))
    clen, n_valid = np.array([5, 5, 5]), np.array([4, 2, 0])
    jl, jnew = jax.jit(jm.prefill_step)(jp, jnp.asarray(chunk), jcache, jnp.asarray(clen),
                                        jnp.asarray(n_valid))
    with torch.no_grad():
        tl, tnew = tm.prefill_step(_t(chunk), tcache, _t(clen), _t(n_valid))
    _close(tl, jl, tol=1e-4, what=(arch, "prefill"))
    for name, ref in _to_np(jnew).items():
        _close(tnew[name], ref, what=name)


@pytest.mark.parametrize("chunk", [4, 1])
def test_engine_matches_reference(pair, chunk):
    """Greedy tokens and engine stats equal to the reference's engine on
    the ideal bank, 2 slots for 3 requests (the ``cuda`` backend's plain
    version on CPU tensors)."""
    arch, (jm, jp, _), (tm, _, _) = pair
    jeng = JEngine(jm, jp, batch_slots=2, max_len=32, prefill_chunk=chunk, backend="ref",
                   photonics=jph.PRESETS["ideal"])
    teng = TEngine(tm, batch_slots=2, max_len=32, prefill_chunk=chunk, backend="cuda",
                   photonics=tph.PRESETS["ideal"])
    jreqs = [JRequest(prompt=list(p), max_new=6) for p in PROMPTS]
    treqs = [TRequest(prompt=list(p), max_new=6) for p in PROMPTS]
    jeng.run(jreqs)
    teng.run(treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs], arch
    assert all(r.done and len(r.out) == 6 for r in treqs)
    assert teng.stats == jeng.stats


@pytest.mark.parametrize("kernel", ["ref", "cuda"])
def test_emu_engine_matches_reference(pair, kernel):
    """Greedy tokens and engine stats equal to the reference's engine on
    the emu backend (emu_ideal, a drift-free device), 2 slots for 3
    requests: the experts' stacked products through the emu backend's
    per-expert loop, on both emu kernels."""
    arch, (jm, jp, _), (tm, _, _) = pair
    kw = dict(batch_slots=2, max_len=32, prefill_chunk=4)
    jeng = JEngine(jm, jp, backend="emu", photonics=jph.PRESETS["emu_ideal"], **kw)
    teng = TEngine(tm, backend=tph.EmulatedMRRBackend(emu_kernel=kernel),
                   photonics=tph.PRESETS["emu_ideal"], **kw)
    jreqs = [JRequest(prompt=list(p), max_new=4) for p in PROMPTS]
    treqs = [TRequest(prompt=list(p), max_new=4) for p in PROMPTS]
    jeng.run(jreqs)
    teng.run(treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs], (arch, kernel)
    assert all(r.done and len(r.out) == 4 for r in treqs)
    assert teng.stats == jeng.stats


def test_serving_runs_ten_bank_products_a_layer(pair):
    """Every forward routes 4 attention products, the 3 expert products
    (one batched product each over the stacked (E, M, K) weights) and the
    shared experts' 3 a layer, and the head; every layer draws the same
    keys, as under the reference's scan."""
    arch, _, (tm, _, _) = pair
    calls = []
    eng = TEngine(tm, batch_slots=2, max_len=32, prefill_chunk=4, backend=_counting(calls),
                  photonics=tph.PRESETS["ideal"])
    eng.run([TRequest(prompt=list(p), max_new=3) for p in PROMPTS])
    forwards = eng.stats["prefill_steps"] + eng.stats["decode_steps"]
    c, m = tm.cfg, tm.cfg.moe
    assert len(calls) == (10 * c.n_layers + 1) * forwards
    layer = [s for _, s in calls[:10]]
    d_sh = m.n_shared_experts * m.d_ff_shared
    assert layer[4:] == [(m.n_experts, m.d_ff_expert, c.d_model)] * 2 + [
        (m.n_experts, c.d_model, m.d_ff_expert), (d_sh, c.d_model), (d_sh, c.d_model),
        (c.d_model, d_sh)]
    assert [k for k, _ in calls[:10 * c.n_layers + 1]] == list(range(1, 11)) * c.n_layers + [11]


def _assert_tree_close(tgrads, jgrads):
    expect = convert.state_dict_from_reference(_to_np(jgrads))
    assert sorted(tgrads) == sorted(expect)
    for k in expect:
        _close(tgrads[k], expect[k], what=k)


@pytest.mark.parametrize("algo,hardware,backend", [
    ("dfa", "quant", "cuda"), ("dfa", "ideal", "ref"), ("bp", "ideal", "ref")])
def test_value_and_grad_matches_reference(pair, algo, hardware, backend):
    """Loss, ``aux_loss`` and every gradient within 1e-5: the router's
    (through the combine weights and the aux loss injected with cotangent
    1), the stacked experts', the shared experts' and the embedding's."""
    arch, (jm, jp, jf), (tm, tp, tf) = pair
    jbatch, tbatch = _batch()
    hw = dict(noise_std=0.0, weight_bits=8, input_bits=8) if hardware == "quant" else {}
    jcfg = jdfa.DFAConfig(photonics=jph.PhotonicConfig(**hw), backend="ref")
    tcfg = tdfa.DFAConfig(photonics=tph.PhotonicConfig(**hw), backend=backend)
    if algo == "bp":
        (jl, jmet), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jbatch),
                                                    has_aux=True))(jp)
    else:
        (jl, jmet), jg = jax.jit(jalgos.get(algo).value_and_grad(jm, jcfg))(
            jp, jf, jbatch, jax.random.PRNGKey(1))
    (tl, tmet), tg = talgos.get(algo).value_and_grad(tm, tcfg)(tp, tf, tbatch, 1)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)
    assert float(tmet["aux_loss"]) == pytest.approx(float(jmet["aux_loss"]), abs=1e-6)
    _assert_tree_close(tg, jg)
    assert float(tg["blocks.0.ffn.router.weight"].abs().max()) > 0
    assert float(tg["embed.tok.table"].abs().max()) > 0


# ---------------------------------------------------------------------------
# the launchers and step_cost
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [QWEN2MOE, KIMI])
def test_launchers_run_on_cpu(arch, tmp_path, capsys):
    final = ttrain.main(["--arch", arch, "--batch", "2", "--seq", "8", "--device", "cpu",
                         "--preset", "offchip_bpd", "--backend", "cuda", "--steps", "2",
                         "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[step 2/2]" in out and "[final]" in out and np.isfinite(final["ce_loss"])
    assert np.isfinite(final["aux_loss"]) and final["aux_loss"] > 0
    assert list(tmp_path.glob("ckpt_*.pt"))
    tserve.main(["--arch", arch, "--backend", "cuda", "--hardware", "offchip_bpd",
                 "--device", "cpu", "--requests", "3", "--max-new", "3"])
    assert "[serve] 3 requests, 9 tokens" in capsys.readouterr().out
    assert arch in tconfigs.ASSIGNED


def test_step_cost_matches_reference():
    """Matrix-product FLOPs of one dfa step of the smoke qwen2-moe at batch
    4 × seq 16 (T = 64 tokens, cap 32) against the reference's HLO count,
    with the difference pinned.  Each block's recompute runs two products
    whose values its gradient never reads, which XLA drops as dead code:
    the shared experts' down projection (2·T·d_sh·d, as the dense models'
    down projection) and the combine product ``tec,ecd->td`` (2·T·E·C·d;
    the gradient reads the experts' outputs, not y).  And the reference's
    backward contracts the combine weights' gradient over the experts as a
    dot (2·T·K·E), where torch's einsum backward multiplies and sums."""
    batch = jtokens.MarkovTokens(VOCAB, SEQ, BATCH, 0).batch(0)
    js = japi.build_session(arch=QWEN2MOE, smoke=True, algo="dfa", hardware="ideal",
                            backend="ref", data_parallel=False)
    expect = js.step_cost(js.init_state(), {k: jnp.asarray(v) for k, v in batch.items()}).flops
    ts = api.build_session(arch=QWEN2MOE, smoke=True, algo="dfa", hardware="ideal",
                           backend="ref", device="cpu")
    cost = ts.step_cost(ts.init_state(), batch)
    c, m = ts.model.cfg, ts.model.cfg.moe
    t, d = BATCH * SEQ, c.d_model
    cap = ts.model.blocks[0].ffn.capacity(t)
    extra = c.n_layers * (2 * t * m.n_shared_experts * m.d_ff_shared * d
                          + 2 * t * m.n_experts * cap * d - 2 * t * m.top_k * m.n_experts)
    assert cost.kernel_launches == 0
    assert cost.flops == expect + extra, (cost.flops, expect, extra, cost.flops - expect)
