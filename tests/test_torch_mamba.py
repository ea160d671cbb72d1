"""The Mamba-2 family: the port against the reference on the CPU.

The smoke mamba2 (2 layers, d 32, d_state 16, head_dim 16, chunk 8, vocab
128) with the reference's parameters and feedback carried across by
``convert``; inputs from a seeded numpy generator.  The SSD block (fused
and ``split_proj``, two chunks and the one-chunk fallback), its decode
against its chunked forward, ``decode_step``, the masked decode-scan
prefill, the engine's greedy tokens, one training step's loss and every
gradient for dfa / dfa-layerwise / bp and a quiet emulated device, the
padded vocabulary, both launchers, the probe's rows and ``step_cost``.
The full-width layout (mamba2-130m, 167.6 M parameters) is checked on the
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
from repro.hardware import drift as jdrift  # noqa: E402
from repro.hardware import mrr as jmrr  # noqa: E402
from repro.models.mamba import MambaConfig as JMambaConfig  # noqa: E402
from repro.models.mamba import MambaLM as JMambaLM  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro.obs.introspect import AlignmentProbe as JProbe  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import decode as jdecode  # noqa: E402
from repro_torch import algos as talgos  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.algos import dfa as tdfa  # noqa: E402
from repro_torch.configs import mamba2_130m as tmamba  # noqa: E402
from repro_torch.core import photonics as tph  # noqa: E402
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.hardware import drift as tdrift  # noqa: E402
from repro_torch.hardware import mrr as tmrr  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.mamba import MambaConfig, MambaLM  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402
from repro_torch.obs.introspect import AlignmentProbe  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import Request as TRequest  # noqa: E402
from repro_torch.serve import decode as tdecode  # noqa: E402

ARCH = "mamba2-130m"
VOCAB, SEQ, BATCH = 128, 16, 4
TOL = 1e-5  # of each tensor's max |value|: logits, loss and gradients (ROADMAP)
BLOCK = dict(d_model=32, d_state=16, head_dim=16, chunk=8)
PROMPTS = [[5, 17, 99, 3, 42], [7, 8], [120]]
QUANT = dict(noise_std=0.0, weight_bits=8, input_bits=8)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, expect, tol=TOL, what=""):
    got, expect = _np(got), _np(expect)
    assert got.shape == expect.shape, (what, got.shape, expect.shape)
    scale = max(np.abs(expect).max(), 1e-30)
    assert np.abs(got - expect).max() <= tol * scale, (what, np.abs(got - expect).max(), scale)


@pytest.fixture(scope="module")
def pair():
    """(reference model, params, feedback), (port model with those
    parameters, its flat params, feedback)."""
    jm = jconfigs.get(ARCH).make_smoke()
    key = jax.random.PRNGKey(0)
    jp = jax.jit(jm.init)(key)
    jf = jax.jit(lambda k: jalgos.get("dfa").init_extra_state(jm, k, jdfa.DFAConfig()))(
        jax.random.fold_in(key, 1))
    tm = tconfigs.get(ARCH).make_smoke(device="cpu")
    tp = convert.state_dict_from_reference(_to_np(jp))
    assert sorted(tp) == sorted(tm.param_dict())
    tm.load_state_dict(tp)
    return (jm, jp, jf), (tm, tp, convert.feedback_from_reference(_to_np(jf)))


def _batch(step=0, seq=SEQ, batch=BATCH):
    b = jtokens.MarkovTokens(VOCAB, seq, batch, seed=0).batch(step)
    return {k: jnp.asarray(v) for k, v in b.items()}, to_device(b, "cpu")


def _block_pair(split):
    jb = jssm.Mamba2Block(split_proj=split, **BLOCK)
    jp = jb.init(jax.random.PRNGKey(3))
    tb = tssm.Mamba2Block(split_proj=split, device="cpu", **BLOCK)
    tb.load_state_dict(convert.state_dict_from_reference(_to_np(jp)))
    return jb, jp, tb


# ---------------------------------------------------------------------------
# the SSD block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,channels", [(4, 96), (2, 5)])
def test_causal_conv1d_matches_reference(k, channels):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, channels)).astype(np.float32)
    w = rng.standard_normal((k, channels)).astype(np.float32)
    b = rng.standard_normal((channels,)).astype(np.float32)
    expect = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_array_equal(_np(got), np.asarray(expect))


def test_softplus_is_the_reference_function_everywhere():
    """logaddexp(x, 0), with no linear cut-off above 20."""
    x = np.array([-80.0, -20.0, -1.0, 0.0, 0.5, 19.9, 20.1, 35.0, 90.0], np.float32)
    np.testing.assert_allclose(_np(tssm.softplus(torch.from_numpy(x))),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-7, atol=0)


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split_proj"])
@pytest.mark.parametrize("seq", [16, 12], ids=["two_chunks", "one_chunk_fallback"])
def test_block_forward_matches_reference(split, seq):
    jb, jp, tb = _block_pair(split)
    u = np.random.default_rng(1).standard_normal((2, seq, 32)).astype(np.float32)
    with torch.no_grad():
        got = tb(torch.from_numpy(u))
    _close(got, jax.jit(jb.__call__)(jp, jnp.asarray(u)), what=(split, seq))


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split_proj"])
def test_block_decode_equals_chunked_forward(split):
    """Token-by-token decode reproduces the chunked forward at every
    position (tests/test_perf_features.py's bound), and each decode step
    matches the reference's decode."""
    jb, jp, tb = _block_pair(split)
    u = np.random.default_rng(2).standard_normal((2, 16, 32)).astype(np.float32)
    tu = torch.from_numpy(u)
    outs = []
    cache, jcache = tb.init_cache(2), jb.init_cache(2)
    jdec = jax.jit(jb.decode)
    with torch.no_grad():
        full = tb(tu)
        for t in range(16):
            o, cache = tb.decode(tu[:, t:t + 1], cache, torch.full((2,), t))
            jo, jcache = jdec(jp, jnp.asarray(u[:, t:t + 1]), jcache, jnp.full((2,), t))
            _close(o, jo, what=t)
            outs.append(o)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(full), rtol=1e-4, atol=2e-5)
    for name in ("ssm", "conv"):
        _close(cache[name], jcache[name], what=name)


def test_masked_exponent_keeps_gradients_finite():
    """A steep decay (large A and dt) makes exp(diff) above the diagonal
    overflow; the double ``where`` keeps every gradient finite."""
    _, _, tb = _block_pair(False)
    with torch.no_grad():
        tb.A_log.fill_(6.0)
        tb.dt_bias.fill_(8.0)
    u = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 16, 32)).astype(np.float32))
    tb(u).square().sum().backward()
    assert all(bool(torch.isfinite(p.grad).all()) for p in tb.parameters())


# ---------------------------------------------------------------------------
# the model and its layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["full", "opt"])
def test_full_width_layout_matches_reference_without_allocation(variant):
    """mamba2-130m at full width on the meta device: the reference's
    names, shapes and count (167.6 M: 90.4 M in blocks, 38.6 M each in the
    untied embedding and head), and 49 bank products a token (97 with the
    split projections)."""
    jarch = jconfigs.get(ARCH)
    jm = (jarch.make_model if variant == "full" else jarch.make_opt)(jnp.bfloat16)
    tm = (tmamba.full if variant == "full" else tmamba.opt)(torch.bfloat16, device="meta")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == convert.torch_shapes(jm.param_shapes())
    assert all(p.is_meta and p.dtype == torch.bfloat16 for p in tm.parameters())
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(int(np.prod(s.shape))
                    for s in jax.tree_util.tree_leaves(jm.param_shapes()))
    cfg = tm.cfg
    blocks = sum(p.numel() for k, p in tm.named_parameters() if k.startswith("blocks."))
    if variant == "full":
        assert round(n / 1e6, 1) == 167.6 and round(blocks / 1e6, 1) == 90.4
        assert cfg.d_model * cfg.v_padded == 38_615_040
        mixer = tm.blocks[0].mixer
        assert (mixer.d_inner, mixer.n_heads, mixer.conv_dim) == (1536, 24, 1792)
        assert tuple(mixer.in_proj.weight.shape) == (3352, 768)
        assert tm.forward_gemm_specs() == jm.forward_gemm_specs()
        assert len(tm.forward_gemm_specs()) == 24 * 2 + 1 == 49
    else:
        assert cfg.v_padded == 50432 and cfg.split_proj
        assert sum(1 for k in got if k.endswith(".weight") and ".mixer." in k) == 24 * 4


def test_forward_parts_match_reference(pair):
    (jm, jp, _), (tm, tp, _) = pair
    jbatch, tbatch = _batch()
    assert tm.d_tap == jm.d_tap == 32 and tm.error_tap == "hidden"
    (spec,) = tm.segment_specs()
    (jspec,) = jm.segment_specs()
    assert (spec.name, spec.n_layers, spec.d_inject) == (jspec.name, jspec.n_layers,
                                                         jspec.d_inject)
    jx0 = jax.jit(jm.embed)(jp, jbatch)
    jxf, jtape = jax.jit(lambda p, x: (lambda r: (r[0], r[1]["blocks"].inputs))(
        jm.run_segments(p, x)))(jp, jx0)
    x0 = tm.embed(tp, tbatch)
    xf, saved, auxes = tm.run_segments(tp, x0)
    np.testing.assert_array_equal(_np(x0), np.asarray(jx0))
    _close(saved["blocks"].inputs, jtape, what="tape")
    _close(xf, jxf, what="x_final")
    assert set(auxes) == {"blocks"} and float(auxes["blocks"]) == 0.0
    _close(tm.head_logits(tp, xf, tbatch), jax.jit(jm.head_logits)(jp, jxf, jbatch),
           what="logits")
    (jl, _), (tl, _) = jax.jit(jm.loss)(jp, jbatch), tm.loss(tp, tbatch)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)
    # make_prefill is this forward's logits
    _close(tdecode.make_prefill(tm)(tp, tbatch), jax.jit(jdecode.make_prefill(jm))(jp, jbatch),
           what="make_prefill")


def test_decode_step_matches_reference(pair):
    """Five decode steps of 3 slots from zero state: logits within 1e-5 of
    max|logit| and the stacked caches carried back by ``convert``."""
    (jm, jp, _), (tm, _, _) = pair
    toks = np.random.default_rng(5).integers(0, VOCAB, (3, 5))
    jcache, tcache = jm.init_caches(3, 8), tm.init_caches(3, 8)
    jstep = jax.jit(jm.decode_step)
    assert {n: tuple(t.shape) for n, t in tcache.items()} == {
        n: tuple(t.shape) for n, t in jcache.items()}
    assert tcache["ssm"].dtype == torch.float32
    for t in range(5):
        clen = np.full((3,), t)
        jl, jcache = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jcache, jnp.asarray(clen))
        with torch.no_grad():
            tl, tcache = tm.decode_step(torch.from_numpy(toks[:, t:t + 1]), tcache,
                                        torch.from_numpy(clen))
        _close(tl, jl, what=t)
    back = convert.caches_to_reference(tcache)
    for name, ref in _to_np(jcache).items():
        _close(back[name], ref, what=name)
    again = convert.caches_from_reference(back, tcache)
    assert all(torch.equal(again[n], tcache[n]) for n in tcache)


def test_masked_decode_scan_prefill_matches_reference(pair):
    """One prefill step over a chunk of 4 with n_valid (4, 2, 0) on a
    carried state: the last valid logits, the new caches (the slot with
    nothing valid untouched) and the advanced lengths."""
    (jm, jp, _), (tm, _, _) = pair
    rng = np.random.default_rng(6)
    toks = rng.integers(0, VOCAB, (3, 4))
    n_valid = np.array([4, 2, 0])
    jcache = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.1),
        jm.init_caches(3, 8))
    tcache = convert.caches_from_reference(_to_np(jcache), tm.init_caches(3, 8))
    clen = np.array([3, 1, 2])
    jlast, jnew, jlen = jax.jit(jdecode.make_prefill_step(jm))(
        jp, jnp.asarray(toks), jnp.asarray(n_valid), jcache, jnp.asarray(clen))
    with torch.no_grad():
        tlast, tnew, tlen = tdecode.make_prefill_step(tm)(
            torch.from_numpy(toks), torch.from_numpy(n_valid), tcache, torch.from_numpy(clen))
    assert tlast.dtype == torch.float32 and tuple(tlast.shape) == (3, VOCAB)
    _close(tlast, jlast, what="last")
    assert float(tlast[2].abs().max()) == 0.0
    np.testing.assert_array_equal(_np(tlen), np.asarray(jlen))
    for name in ("ssm", "conv"):
        _close(tnew[name], jnew[name], what=name)
        assert torch.equal(tnew[name][:, 2], tcache[name][:, 2])


def test_prefill_scan_repeats_the_noise_keys_at_every_position(pair):
    """The reference traces its scan body once, so every token position of
    a chunk (and every layer within it) draws the same folded keys; the
    port's decode-scan hands the backend the same sequence at each
    position."""
    _, (tm, _, _) = pair
    seen = []

    @dataclasses.dataclass(frozen=True)
    class Recording(tph.PhotonicBackend):
        name: str = "recording"

        def matmul(self, a, b, cfg, key=None, *, mask=None):
            seen.append(key)
            return tph.photonic_matmul(a, b, cfg, key=key, mask=mask)

    toks = torch.tensor([[1, 2, 3], [4, 5, 6]])
    with torch.no_grad(), tph.forward_execution(tph.PRESETS["offchip_bpd"], Recording(), 7):
        tdecode.make_prefill_step(tm)(toks, torch.tensor([3, 2]), tm.init_caches(2, 8),
                                      torch.zeros(2, dtype=torch.long))
    per_token = 2 * tm.cfg.n_layers + 1
    assert len(seen) == 3 * per_token
    one = [tph.prng.fold(7, i) for i in (1, 2)] * tm.cfg.n_layers + [tph.prng.fold(7, 3)]
    assert seen == one * 3


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _serve_pair(jm, jp, tm, chunk, **kw):
    jeng = JEngine(jm, jp, batch_slots=2, max_len=32, prefill_chunk=chunk, backend="ref",
                   photonics=jph.PRESETS["ideal"])
    teng = TEngine(tm, batch_slots=2, max_len=32, prefill_chunk=chunk, backend="cuda",
                   photonics=tph.PRESETS["ideal"], **kw)
    jreqs = [JRequest(prompt=list(p), max_new=6) for p in PROMPTS]
    treqs = [TRequest(prompt=list(p), max_new=6) for p in PROMPTS]
    jeng.run(jreqs)
    teng.run(treqs)
    return jeng, jreqs, teng, treqs


@pytest.mark.parametrize("chunk", [4, 1])
def test_engine_matches_reference(pair, chunk):
    """Greedy tokens and engine stats equal to the reference's engine on
    the ideal bank (the port's ``cuda`` backend runs its kernel's plain
    version on CPU tensors), 2 slots for 3 requests, and the same tokens at
    either chunk size."""
    (jm, jp, _), (tm, _, _) = pair
    jeng, jreqs, teng, treqs = _serve_pair(jm, jp, tm, chunk)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done and len(r.out) == 6 for r in treqs)
    assert teng.stats == jeng.stats
    if chunk == 4:
        assert teng.stats["prefill_steps"] == 3
        _, _, _, one = _serve_pair(jm, jp, tm, 1)
        assert [r.out for r in one] == [r.out for r in treqs]
    for name, ref in _to_np(jeng.caches).items():
        _close(teng.caches[name], ref, tol=1e-4, what=name)


@pytest.mark.parametrize("backend", ["emu", "emu-kernel", "ref"])
def test_emu_ideal_serving_matches_digital(pair, backend):
    """tests/test_serving.py's check on the port: greedy serving through the
    ideal emulated bank (the unfused chain, and the emu kernel's plain
    version) and the ref bank equals the digital engine token for token."""
    _, (tm, _, _) = pair
    prompt = [(7 * i + 3) % 64 for i in range(6)]

    def serve(**kw):
        eng = TEngine(tm, batch_slots=2, max_len=32, prefill_chunk=4, **kw)
        req = TRequest(prompt=list(prompt), max_new=8)
        eng.run([req])
        return req.out

    be = {"emu": "emu", "ref": "ref",
          "emu-kernel": tph.EmulatedMRRBackend(emu_kernel="cuda")}[backend]
    cfg = dataclasses.replace(tph.PRESETS["emu_ideal"], mrr=tmrr.MRRConfig.ideal())
    assert serve(backend=be, photonics=cfg) == serve()


# ---------------------------------------------------------------------------
# one training step against the reference
# ---------------------------------------------------------------------------

# A_log's gradient (one number a head) sums every (batch, position) term,
# of both signs, through the cumsum's backward: the two frameworks'
# summation orders leave it up to 2.3e-5 of its max (bp on the smoke model)
A_LOG_TOL = 5e-5


def _assert_tree_close(tgrads, jgrads):
    expect = convert.state_dict_from_reference(_to_np(jgrads))
    assert sorted(tgrads) == sorted(expect)
    for k in expect:
        _close(tgrads[k], expect[k], tol=A_LOG_TOL if k.endswith(".A_log") else TOL, what=k)


@pytest.mark.parametrize("algo,hardware,backend", [
    ("dfa", "ideal", "cuda"), ("dfa", "quant", "ref"), ("dfa-layerwise", "ideal", "cuda"),
    ("bp", "ideal", "ref")])
def test_value_and_grad_matches_reference(pair, algo, hardware, backend):
    """Loss and every gradient, the embedding table's included."""
    (jm, jp, jf), (tm, tp, tf) = pair
    jbatch, tbatch = _batch()
    hw = dict(QUANT) if hardware == "quant" else {}
    jcfg = jdfa.DFAConfig(photonics=jph.PhotonicConfig(**hw), backend="ref")
    tcfg = tdfa.DFAConfig(photonics=tph.PhotonicConfig(**hw), backend=backend)
    if algo == "bp":
        jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jbatch)[0]))(jp)
    else:
        (jl, _), jg = jax.jit(jalgos.get(algo).value_and_grad(jm, jcfg))(
            jp, jf, jbatch, jax.random.PRNGKey(1))
    (tl, tmet), tg = talgos.get(algo).value_and_grad(tm, tcfg)(tp, tf, tbatch, 1)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)
    _assert_tree_close(tg, jg)
    assert float(torch.abs(tg["embed.tok.table"]).max()) > 0
    assert all(float(tg[k].abs().max()) > 0 for k in tg if k.endswith("in_proj.weight"))


def test_emu_step_matches_reference(pair):
    """One dfa step through the emulated banks on a quiet device
    (crosstalk on, a carried drift residual, no read / shot / drift noise,
    no heater DAC or ADC), the port's kernel path (plain version on the
    CPU) against the reference's unfused chain."""
    (jm, jp, jf), (tm, tp, tf) = pair
    jbatch, tbatch = _batch()
    mkw = dict(drift_sigma=0.0, heater_bits=None, crosstalk=0.01)
    jc = jph.PhotonicConfig(noise_std=0.0, mrr=jmrr.MRRConfig(**mkw))
    tc = tph.PhotonicConfig(noise_std=0.0, mrr=tmrr.MRRConfig(**mkw))
    r = np.random.default_rng(50).uniform(-0.1, 0.1, (1, 50, 20)).astype(np.float32)
    jhw = {"drift": jnp.asarray(r), "cal": jnp.zeros((1, 50, 20), jnp.float32)}
    thw = convert.hw_state_from_reference(_to_np(jhw))
    jcfg = jdfa.DFAConfig(photonics=jc, backend=jph.EmulatedMRRBackend(emu_kernel="ref"))
    tcfg = tdfa.DFAConfig(photonics=tc, backend=tph.EmulatedMRRBackend(emu_kernel="cuda"))
    def jstep(hw, p, f, b, key):
        with jdrift.use_state(hw):
            return jalgos.get("dfa").value_and_grad(jm, jcfg)(p, f, b, key)

    (jl, _), jg = jax.jit(jstep)(jhw, jp, jf, jbatch, jax.random.PRNGKey(1))
    with tdrift.use_state(thw):
        (tl, _), tg = talgos.get("dfa").value_and_grad(tm, tcfg)(tp, tf, tbatch, 1)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)
    _assert_tree_close(tg, jg)


def test_vocab_padding_loss_invariant_to_pad_columns():
    """tests/test_perf_features.py's check on the port: padded logits are
    masked to -1e30, so the pad rows of the head do not move the loss, and
    the port's loss equals the reference's."""
    cfg = dict(name="t", n_layers=2, d_model=32, vocab_size=100, d_state=16, head_dim=16,
               chunk=8)
    jm = JMambaLM(JMambaConfig(pad_vocab_to=128, **cfg))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = MambaLM(MambaConfig(pad_vocab_to=128, **cfg), device="cpu")
    tp = convert.state_dict_from_reference(_to_np(jp))
    tm.load_state_dict(tp)
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.long),
             "labels": torch.ones((2, 16), dtype=torch.long)}
    loss1, _ = tm.loss(tp, batch)
    tp2 = dict(tp)
    tp2["head.out.weight"] = tp["head.out.weight"].clone()
    tp2["head.out.weight"][100:] += 7.0
    loss2, _ = tm.loss(tp2, batch)
    assert float(loss1) == pytest.approx(float(loss2), rel=1e-6)
    jl, _ = jax.jit(jm.loss)(jp, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    assert float(loss1) == pytest.approx(float(jl), abs=TOL)
    logits = tm.head_logits(tp, tm.run_segments(tp, tm.embed(tp, batch))[0], batch)
    assert logits.shape[-1] == 128 and float(logits[..., 100:].max()) < -1e29
    with torch.no_grad():
        dl, _ = tm.decode_step(torch.zeros((2, 1), dtype=torch.long), tm.init_caches(2),
                               torch.zeros(2, dtype=torch.long))
    assert float(dl[..., 100:].max()) < -1e29


# ---------------------------------------------------------------------------
# the launchers, the probe and step_cost
# ---------------------------------------------------------------------------

def test_launchers_run_mamba_on_cpu(tmp_path, capsys):
    final = ttrain.main(["--arch", ARCH, "--batch", "4", "--seq", "16", "--device", "cpu",
                         "--preset", "offchip_bpd", "--backend", "cuda", "--steps", "2",
                         "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[step 2/2]" in out and "[final]" in out and np.isfinite(final["ce_loss"])
    assert list(tmp_path.glob("ckpt_*.pt"))
    tserve.main(["--arch", ARCH, "--backend", "cuda", "--hardware", "offchip_bpd",
                 "--device", "cpu", "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 9 tokens" in out
    assert ARCH in tconfigs.ASSIGNED


@pytest.fixture(scope="module")
def session_pair():
    js = japi.build_session(arch=ARCH, smoke=True, algo="dfa", hardware="ideal",
                            backend="ref", data_parallel=False)
    jstate = js.init_state()
    ts = api.build_session(arch=ARCH, smoke=True, algo="dfa", hardware="ideal",
                           backend="ref", device="cpu")
    tstate = ts.init_state()
    tstate["params"] = convert.state_dict_from_reference(jax.device_get(jstate["params"]))
    tstate["fb"] = convert.feedback_from_reference(jax.device_get(jstate["fb"]))
    return (js, jstate), (ts, tstate)


def test_probe_rows_match_reference(session_pair):
    (js, jstate), (ts, tstate) = session_pair
    batch = jtokens.MarkovTokens(VOCAB, SEQ, BATCH, 0).batch(0)
    want = jax.device_get(JProbe(js.trainer).probe(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = {k: float(v) for k, v in AlignmentProbe(ts.trainer).probe(
        tstate, ts.trainer.put(batch)).items()}
    assert sorted(got) == sorted(want)
    assert {k[len("align_"):] for k in got if k.startswith("align_")} == {
        "blocks", "embed", "head", "global"}
    for k, v in got.items():
        if k.startswith("align_"):
            assert abs(v - float(want[k])) <= 1e-5, k
        else:  # sums of squares of gradients within 1e-5 of their max
            assert v == pytest.approx(float(want[k]), rel=5e-5), k
    assert got["align_head"] == pytest.approx(1.0, abs=1e-5)


def test_step_cost_matches_reference(session_pair):
    """Matrix-product FLOPs of one dfa step against the reference's HLO
    count at batch 4 × seq 16.  The port counts 2·T·d_model·d_inner
    more per block: the out_proj that each block's recompute runs and
    whose value the gradient never reads (the last product before the
    injected δ), which XLA drops as dead code.  Every other product (the
    projections, the SSD einsums, the head, the DFA projections) is
    counted alike."""
    (js, jstate), (ts, tstate) = session_pair
    batch = jtokens.MarkovTokens(VOCAB, SEQ, BATCH, 0).batch(0)
    expect = js.step_cost(jstate, {k: jnp.asarray(v) for k, v in batch.items()}).flops
    cost = ts.step_cost(tstate, batch)
    cfg = ts.model.cfg
    extra = cfg.n_layers * 2 * BATCH * SEQ * cfg.d_model * cfg.expand * cfg.d_model
    assert cost.kernel_launches == 0
    assert cost.flops == expect + extra, (cost.flops, expect, extra)
