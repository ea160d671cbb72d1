"""whisper-small and its layers: the port against the reference on the CPU.

LayerNorm, the plain GELU MLP and both frontend stubs; ``Attention`` with
the flags whisper sets (no rope, non-causal, output bias), forward and
decode; ``CrossAttention`` with and without its query chunks; and the smoke
whisper (2 + 2 layers, d 48, 32 frames, vocab 128) with the reference's
parameters and feedback carried across by ``convert``: the forward's parts
(the pooled encoder feedback, positions tiled past max_target), ``encode``,
``decode_step``, greedy tokens through ``make_serve_step(whisper_enc=True)``,
6 bank products a layer (cross attention and the head digital) and their
noise keys, dfa / dfa-fused / dfa-layerwise / bp gradients and a quiet emu
step, the launcher, the registry and the full-width layout on the meta
device.  Inputs come from seeded numpy generators."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import algos as jalgos  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import nn as jnn  # noqa: E402
from repro.algos import dfa as jdfa  # noqa: E402
from repro.core import photonics as jph  # noqa: E402
from repro.hardware import drift as jdrift  # noqa: E402
from repro.hardware import mrr as jmrr  # noqa: E402
from repro.nn import frontends as jfront  # noqa: E402
from repro.nn import linear as jlinear  # noqa: E402
from repro.nn import norms as jnorms  # noqa: E402
from repro.serve import decode as jdecode  # noqa: E402
from repro.train import SGDM as JSGDM  # noqa: E402
from repro_torch import algos as talgos  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.algos import dfa as tdfa  # noqa: E402
from repro_torch.configs import whisper_small as twh  # noqa: E402
from repro_torch.core import photonics as tph  # noqa: E402
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.hardware import drift as tdrift  # noqa: E402
from repro_torch.hardware import mrr as tmrr  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.nn import attention as tatt  # noqa: E402
from repro_torch.nn import frontends as tfront  # noqa: E402
from repro_torch.nn import linear as tlinear  # noqa: E402
from repro_torch.nn import norms as tnorms  # noqa: E402
from repro_torch.serve import decode as tdecode  # noqa: E402
from repro_torch.train import SGDM  # noqa: E402

ARCH = "whisper-small"
VOCAB, SEQ, BATCH = 128, 16, 4
TOL = 1e-5  # of each tensor's max |value|: loss and gradients (ROADMAP)
LOGIT_TOL = 1e-4  # serving logits and encoder outputs (ROADMAP)
LAYER_TOL = 1e-6  # LayerNorm, MLP and the frontend stubs alone
QUANT = dict(noise_std=0.0, weight_bits=8, input_bits=8)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, expect, tol=TOL, what=""):
    got, expect = _np(got), _np(expect)
    assert got.shape == expect.shape, (what, got.shape, expect.shape)
    scale = max(np.abs(expect).max(), 1e-30)
    assert np.abs(got - expect).max() <= tol * scale, (what, np.abs(got - expect).max(), scale)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _load(module, jparams):
    sd = convert.state_dict_from_reference(_to_np(jparams))
    assert sorted(sd) == sorted(k for k, _ in module.named_parameters())
    module.load_state_dict(sd)
    return module


@pytest.fixture(scope="module")
def pair():
    """(reference model, params, feedback), (port model with those
    parameters, its flat params, feedback)."""
    jm = jconfigs.get(ARCH).make_smoke()
    key = jax.random.PRNGKey(0)
    jp = jax.jit(jm.init)(key)
    # non-trivial norms and biases, so that every parameter's path shows
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x) + _rand(x.shape, x.size, 0.05)),
                                jp)
    jf = jax.jit(lambda k: jalgos.get("dfa").init_extra_state(jm, k, jdfa.DFAConfig()))(
        jax.random.fold_in(key, 1))
    tm = _load(tconfigs.get(ARCH).make_smoke(device="cpu"), jp)
    tp = convert.state_dict_from_reference(_to_np(jp))
    return (jm, jp, jf), (tm, tp, convert.feedback_from_reference(_to_np(jf)))


def _batch(tm, step=0, seq=SEQ, batch=BATCH):
    b = ttrain.lm_batches(ARCH, tm.cfg, seq, batch, 0)(step)
    return {k: jnp.asarray(v) for k, v in b.items()}, to_device(b, "cpu")


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_bias", [True, False])
def test_layernorm_matches_reference(use_bias):
    jl = jnorms.LayerNorm(24, use_bias=use_bias)
    jp = jax.tree_util.tree_map(lambda x: x + _rand(x.shape, 1, 0.3), jl.init(None))
    tl = _load(tnorms.LayerNorm(24, use_bias=use_bias, device="cpu"), jp)
    x = _rand((3, 5, 24), 2, 3.0) + 1.5
    with torch.no_grad():
        _close(tl(_t(x)), jl(jp, jnp.asarray(x)), tol=LAYER_TOL)
        y16 = tl(_t(x).to(torch.bfloat16))
    assert y16.dtype == torch.bfloat16
    assert tnorms.LayerNorm(8, device="cpu").init(0).bias.abs().max() == 0


def test_mlp_matches_reference():
    jl = jlinear.MLP(32, 64)
    jp = jl.init(jax.random.PRNGKey(3))
    jp = jax.tree_util.tree_map(lambda x: x + _rand(x.shape, 4, 0.05), jp)
    tl = _load(tlinear.MLP(32, 64, device="cpu"), jp)
    x = _rand((2, 7, 32), 5)
    with torch.no_grad():
        _close(tl(_t(x)), jl(jp, jnp.asarray(x)), tol=LAYER_TOL)


def test_frontend_stubs_match_reference():
    """The audio stub (frames + pos[:T], LayerNorm) at T below max_frames,
    and the vision stub (LayerNorm, then the digital projection)."""
    ja = jfront.AudioFrontendStub(16, max_frames=12)
    jpa = ja.init(jax.random.PRNGKey(6))
    ta = _load(tfront.AudioFrontendStub(16, max_frames=12, device="cpu"), jpa)
    frames = _rand((2, 9, 16), 7)
    jv = jfront.VisionFrontendStub(24, 16)
    jpv = jax.tree_util.tree_map(lambda x: x + _rand(x.shape, 8, 0.1),
                                 jv.init(jax.random.PRNGKey(9)))
    tv = _load(tfront.VisionFrontendStub(24, 16, device="cpu"), jpv)
    patches = _rand((2, 5, 24), 10)
    with torch.no_grad():
        _close(ta(_t(frames)), ja(jpa, jnp.asarray(frames)), tol=LAYER_TOL)
        _close(tv(_t(patches)), jv(jpv, jnp.asarray(patches)), tol=LAYER_TOL)
    seen = []
    with tph.forward_execution(tph.PRESETS["ideal"], _recording(seen, "shape")):
        tv(_t(patches))
    assert seen == []  # digital, as the reference's raw ``@``
    own = tfront.AudioFrontendStub(16, max_frames=12, device="cpu").init(3)
    assert 0.005 < float(own.pos.detach().std()) < 0.015


def _attn_pair(**kw):
    ja = jnn.Attention(d_model=24, n_heads=3, n_kv_heads=3, qkv_bias=True, **kw)
    jp = jax.tree_util.tree_map(lambda x: x + _rand(x.shape, 11, 0.05),
                                ja.init(jax.random.PRNGKey(12)))
    ta = _load(tatt.Attention(24, 3, 3, qkv_bias=True, device="cpu", **kw), jp)
    return ja, jp, ta


@pytest.mark.parametrize("causal", [False, True], ids=["encoder", "decoder"])
def test_whisper_attention_matches_reference(causal):
    """``Attention(rope=False, out_bias=True)``, non-causal (the encoder)
    and causal (the decoder's self-attention): the forward within 1e-5 of
    the reference's, 10 decode steps within 1e-5 of the reference's decode
    and the caches carried back; the causal decode equals its forward."""
    ja, jp, ta = _attn_pair(out_bias=True, rope=False, causal=causal)
    assert ta.o.bias is not None and not ta.rope and ta.causal == causal
    x = _rand((2, 10, 24), 13)
    with torch.no_grad():
        full = ta(_t(x))
    _close(full, ja(jp, jnp.asarray(x)), what="forward")
    cache, jcache = ta.init_cache(2, 16), ja.init_cache(2, 16)
    jdec = jax.jit(ja.decode)
    outs = []
    with torch.no_grad():
        for t in range(10):
            o, cache = ta.decode(_t(x[:, t:t + 1]), cache, torch.full((2,), t))
            jo, jcache = jdec(jp, jnp.asarray(x[:, t:t + 1]), jcache, jnp.full((2,), t))
            _close(o, jo, what=t)
            outs.append(o)
    for name in ("k", "v"):
        _close(cache[name], jcache[name], what=name)
    if causal:
        _close(torch.cat(outs, 1), full, tol=LOGIT_TOL)
    else:
        assert not torch.allclose(torch.cat(outs, 1), full, atol=1e-3)


@pytest.mark.parametrize("s,q_chunk", [(12, 2048), (12, 4), (10, 4)],
                         ids=["one_chunk", "chunked", "ragged_unchunked"])
def test_cross_attention_matches_reference(s, q_chunk):
    """``CrossAttention``: q / v / o biased, k not, every product digital;
    with queries chunked (s > q_chunk, s % q_chunk == 0) and not, within
    1e-5 of the reference's; chunking changes nothing."""
    jc = jnn.CrossAttention(d_model=24, n_heads=3)
    jp = jax.tree_util.tree_map(lambda x: x + _rand(x.shape, 14, 0.05),
                                jc.init(jax.random.PRNGKey(15)))
    tc = _load(tatt.CrossAttention(24, 3, device="cpu"), jp)
    assert tc.k.bias is None and tc.q.bias is not None
    x, enc = _rand((2, s, 24), 16), _rand((2, 7, 24), 17)
    seen = []
    with torch.no_grad(), tph.forward_execution(tph.PRESETS["ideal"],
                                                _recording(seen, "shape")):
        got = tc(_t(x), _t(enc), q_chunk=q_chunk)
        whole = tc(_t(x), _t(enc))
    assert seen == []
    _close(got, jc(jp, jnp.asarray(x), jnp.asarray(enc), q_chunk=q_chunk))
    _close(got, whole, tol=1e-6)


# ---------------------------------------------------------------------------
# the model and its layout
# ---------------------------------------------------------------------------

def test_full_width_layout_matches_reference_without_allocation():
    """whisper-small at full width on the meta device: the reference's
    names, shapes and count (279.6 M), both stacked segments (12 + 12),
    the frames' input extras, and the opt() vocabulary padding."""
    jm = jconfigs.get(ARCH).make_model(jnp.bfloat16)
    tm = twh.full(torch.bfloat16, device="meta")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == convert.torch_shapes(jm.param_shapes())
    assert all(p.is_meta and p.dtype == torch.bfloat16 for p in tm.parameters())
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(jm.param_shapes()))
    assert n == 279_631_872
    assert [(s.name, s.n_layers) for s in tm.segment_specs()] == [
        (s.name, s.n_layers) for s in jm.segment_specs()] == [("enc", 12), ("dec", 12)]
    c = tm.cfg
    assert (c.d_model, c.n_heads, c.d_ff, c.vocab_size, c.n_frames, c.max_target) == (
        768, 12, 3072, 51865, 1500, 448)
    extras = tconfigs.get(ARCH).input_extras(8, "train")
    jextras = jconfigs.get(ARCH).input_extras(8, "train")
    assert {k: tuple(v.shape) for k, v in extras.items()} == {
        k: tuple(v.shape) for k, v in jextras.items()} == {"frames": (8, 1500, 768)}
    assert extras["frames"].is_meta and extras["frames"].dtype == torch.bfloat16
    assert twh.opt(device="meta").cfg.v_padded == jconfigs.get(ARCH).make_opt().cfg.v_padded


@pytest.mark.parametrize("seq", [SEQ, 80], ids=["seq16", "seq80_past_max_target"])
def test_forward_parts_match_reference(pair, seq):
    """embed ({"enc", "dec"}; past the smoke max_target of 64 the positions
    tile), both tapes (the decoder's extras the encoder's raw output), the
    final hidden state, the logits and the loss."""
    (jm, jp, _), (tm, tp, _) = pair
    jbatch, tbatch = _batch(tm, seq=seq, batch=2)
    assert tm.d_tap == jm.d_tap == 48 and tm.error_tap == "hidden"
    jx0 = jax.jit(jm.embed)(jp, jbatch)
    jxf, jtapes, jenc = jax.jit(lambda p, x: (lambda r: (
        r[0], {n: sv.inputs for n, sv in r[1].items()}, r[1]["dec"].extras))(
        jm.run_segments(p, x)))(jp, jx0)
    with torch.no_grad():
        x0 = tm.embed(tp, tbatch)
        xf, saved, auxes = tm.run_segments(tp, x0)
        logits = tm.head_logits(tp, xf, tbatch)
    assert sorted(x0) == ["dec", "enc"] and auxes == {}
    for name in x0:
        _close(x0[name], jx0[name], tol=1e-6, what=name)
    assert sorted(saved) == sorted(jtapes) == ["dec", "enc"]
    for name in saved:
        _close(saved[name].inputs, jtapes[name], what=name)
    _close(saved["dec"].extras, jenc, what="enc_final")
    assert saved["enc"].extras is None
    _close(xf, jxf, what="x_final")
    _close(logits, jax.jit(jm.head_logits)(jp, jxf, jbatch), what="logits")
    (jl, _), (tl, _) = jax.jit(jm.loss)(jp, jbatch), tm.loss(tp, tbatch)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)


def test_encode_and_decode_step_match_reference(pair):
    """``encode`` (through ln_enc) and 20 decode steps of 3 slots from
    zero caches against it within 1e-4 of the reference's, the caches
    carried back; a token's decode logits equal the training forward's at
    its position when the decoder attends to the same encoder output; a
    position past max_target decodes with the last learned position, as
    the reference clamps it."""
    (jm, jp, _), (tm, _, _) = pair
    frames = _rand((3, 32, 48), 20, 0.1)
    with torch.no_grad():
        enc = tm.encode(_t(frames))
    jenc = jax.jit(jm.encode)(jp, jnp.asarray(frames))
    _close(enc, jenc, tol=LOGIT_TOL, what="encode")
    toks = np.random.default_rng(21).integers(0, VOCAB, (3, 20))
    jcache, tcache = jm.init_caches(3, 24), tm.init_caches(3, 24)
    assert tuple(tcache["k"].shape) == (2, 3, 24, 4, 12)
    assert convert.caches_to_reference(tcache).keys() == jcache.keys()
    jstep = jax.jit(jm.decode_step)
    for t in range(20):
        clen = np.full((3,), t)
        jl, jcache = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jenc, jcache, jnp.asarray(clen))
        with torch.no_grad():
            tl, tcache = tm.decode_step(_t(toks[:, t:t + 1]), enc, tcache, _t(clen))
        _close(tl, jl, tol=LOGIT_TOL, what=t)
    back = convert.caches_to_reference(tcache)
    for name, ref in _to_np(jcache).items():
        _close(back[name], ref, tol=LOGIT_TOL, what=name)
    # decode = the training forward, fed the same encoder output
    with torch.no_grad():
        dec0 = tm.embed(tm.param_dict(), {"frames": _t(frames), "tokens": _t(toks)})["dec"]
        x = dec0
        for layer in tm.dec:
            x, _ = layer(x, enc)
        full = tm.head["ln"](x) @ tm.head["out"].weight.T
        cache = tm.init_caches(3, 24)
        for t in range(20):
            tl, cache = tm.decode_step(_t(toks[:, t:t + 1]), enc, cache, torch.full((3,), t))
            _close(tl[:, 0], full[:, t], tol=LOGIT_TOL, what=("forward", t))
        # past max_target the position stays at its last row
        tl, _ = tm.decode_step(_t(toks[:, :1]), enc, tm.init_caches(3, 80), torch.full((3,), 70))
    jl, _ = jstep(jp, jnp.asarray(toks[:, :1]), jenc, jm.init_caches(3, 80), jnp.full((3,), 70))
    assert tm.cfg.max_target == 64
    _close(tl, jl, tol=LOGIT_TOL, what="past max_target")


def test_serve_step_greedy_tokens_match_reference(pair):
    """``make_serve_step(model, whisper_enc=True)`` on the ideal bank (the
    port's ``cuda`` backend, plain version on the CPU; the reference's
    ``ref``): 3 clips encoded once, a 4-token prompt fed a token at a time,
    then 12 greedy tokens, equal to the reference's."""
    (jm, jp, _), (tm, _, _) = pair
    frames = _rand((3, 32, 48), 22, 0.1)
    prompt = np.random.default_rng(23).integers(0, VOCAB, (3, 4))
    serve_step = jdecode.make_serve_step(jm, whisper_enc=True)

    def ideal(fn):
        def run(*args):
            with jph.forward_execution(jph.PRESETS["ideal"], "ref"):
                return fn(*args)
        return jax.jit(run)

    jstep, jencode = ideal(serve_step), ideal(jm.encode)
    enc = jencode(jp, jnp.asarray(frames))
    caches, out = jm.init_caches(3, 24), []
    for t in range(16):
        tok = jnp.asarray(prompt[:, t:t + 1]) if t < 4 else nxt
        nxt, _, caches = jstep(jp, tok, caches, jnp.full((3,), t), enc)
        out.append(np.asarray(nxt))
    jout = np.concatenate(out, axis=1)
    tstep = tdecode.make_serve_step(tm, whisper_enc=True)
    with torch.no_grad(), tph.forward_execution(tph.PRESETS["ideal"], "cuda"):
        enc = tm.encode(_t(frames))
        caches, out = tm.init_caches(3, 24), []
        tok = _t(prompt[:, :1])
        for t in range(16):
            tok = _t(prompt[:, t:t + 1]) if t < 4 else tok
            nxt, logits, caches = tstep(tok, caches, torch.full((3,), t), enc)
            assert nxt.dtype == torch.int32 and tuple(logits.shape) == (3, 1, VOCAB)
            out.append(nxt)
            tok = nxt
    assert _np(torch.cat(out, 1)).astype(np.int64).tolist() == jout.astype(np.int64).tolist()


def _recording(seen, what):
    @dataclasses.dataclass(frozen=True)
    class Recording(tph.PhotonicBackend):
        name: str = "recording"

        def matmul(self, a, b, cfg, key=None, *, mask=None):
            seen.append(key if what == "key" else
                        (tuple(a.shape), tuple(b.shape)) if what == "ab" else tuple(b.shape))
            return tph.photonic_matmul(a, b, cfg, key=key, mask=mask)

    return Recording()


def test_serving_counts_the_bank_products_and_keys(pair):
    """``encode`` routes 6 products a layer through the bank (q, k, v, o
    48×48, fc1 96×48, fc2 48×96), ``decode_step`` 6 a decoder layer:
    cross attention and the head are digital.  Each call's layers draw
    keys 1–6, as under the reference's ``lax.scan``."""
    _, (tm, _, _) = pair
    layer = sorted([(48, 48)] * 4 + [(96, 48), (48, 96)])
    for what in ("shape", "key"):
        seen = []
        backend = _recording(seen, what)
        with torch.no_grad():
            with tph.forward_execution(tph.PRESETS["offchip_bpd"], backend, 7):
                enc = tm.encode(_t(_rand((2, 32, 48), 24, 0.1)))
            n_enc = len(seen)
            with tph.forward_execution(tph.PRESETS["offchip_bpd"], backend, 7):
                tm.decode_step(torch.zeros((2, 1), dtype=torch.long), enc,
                               tm.init_caches(2, 8), torch.zeros(2, dtype=torch.long))
        assert n_enc == 6 * 2 and len(seen) == 6 * 2 + 6 * 2
        if what == "shape":
            for i in range(4):
                assert sorted(seen[6 * i:6 * i + 6]) == layer
        else:
            assert seen == [tph.prng.fold(7, i) for i in range(1, 7)] * 4


# ---------------------------------------------------------------------------
# one training step against the reference
# ---------------------------------------------------------------------------

def _assert_tree_close(tgrads, jgrads, tol=TOL, grads=True):
    """Every tensor within 1e-5 of its max |value|, but for ``grads`` the self
    attention's key bias: without rope it adds q·b to every score of a
    query, which the softmax removes, so its gradient is 0 in exact
    arithmetic and both packages return rounding noise (up to 5.5e-9,
    1.8× its own max, on this model).  It is held within 1e-5 of its
    attention's value-bias gradient instead."""
    expect = convert.state_dict_from_reference(_to_np(jgrads))
    assert sorted(tgrads) == sorted(expect)
    for k in expect:
        if grads and k.endswith(".k.bias"):
            scale = float(expect[k[:-len("k.bias")] + "v.bias"].abs().max())
            assert float((tgrads[k] - expect[k]).abs().max()) <= tol * scale, k
            assert float(expect[k].abs().max()) <= 1e-5 * scale, k  # zero up to rounding
        else:
            _close(tgrads[k], expect[k], tol=tol, what=k)


@pytest.mark.parametrize("algo,hardware,backend", [
    ("dfa", "ideal", "cuda"), ("dfa", "quant", "ref"), ("dfa-layerwise", "ideal", "cuda"),
    ("bp", "ideal", "ref")])
def test_value_and_grad_matches_reference(pair, algo, hardware, backend):
    """Loss and every gradient within 1e-5 of their max: the audio stub's
    (embed.audio.pos, embed.audio.ln) through the pooled encoder feedback,
    the decoder's positions, the cross attention's; ``head.ln_enc``'s
    exactly zero, as the reference's (only serving reads it)."""
    (jm, jp, jf), (tm, tp, tf) = pair
    jbatch, tbatch = _batch(tm)
    hw = dict(QUANT) if hardware == "quant" else {}
    jcfg = jdfa.DFAConfig(photonics=jph.PhotonicConfig(**hw), backend="ref")
    tcfg = tdfa.DFAConfig(photonics=tph.PhotonicConfig(**hw), backend=backend)
    if algo == "bp":
        jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jbatch)[0]))(jp)
    else:
        (jl, _), jg = jax.jit(jalgos.get(algo).value_and_grad(jm, jcfg))(
            jp, jf, jbatch, jax.random.PRNGKey(1))
    (tl, _), tg = talgos.get(algo).value_and_grad(tm, tcfg)(tp, tf, tbatch, 1)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)
    _assert_tree_close(tg, jg)
    for k in ("head.ln_enc.scale", "head.ln_enc.bias"):
        assert float(tg[k].abs().max()) == 0.0
    for k in ("embed.audio.pos", "embed.audio.ln.scale", "embed.pos", "embed.tok.table",
              "dec.1.cross.k.weight", "enc.0.attn.o.bias"):
        assert float(tg[k].abs().max()) > 0, k


def test_fused_step_matches_reference(pair):
    """dfa-fused: the parameters and momentum after one SGDM step, and
    the same as dfa followed by ``SGDM.update``."""
    (jm, jp, jf), (tm, tp, tf) = pair
    jbatch, tbatch = _batch(tm)
    jopt, topt = JSGDM(lr=0.05, momentum=0.9), SGDM(lr=0.05, momentum=0.9)
    jmom = jax.tree_util.tree_map(lambda x: x + 0.01, jopt.init(jp)["mom"])
    js = {"mom": jmom, "step": jnp.int32(3)}
    ts = {"mom": convert.state_dict_from_reference(_to_np(jmom)), "step": 3}
    jp2, js2, jl = jax.jit(jdfa.make_fused_train_step(jm, jdfa.DFAConfig(), jopt))(
        jp, jf, js, jbatch, jax.random.PRNGKey(2))
    tp2, ts2, tl = talgos.get("dfa-fused").fused_step(tm, tdfa.DFAConfig(backend="cuda"),
                                                      topt)(tp, tf, ts, tbatch, 2)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)
    _assert_tree_close(tp2, jp2, grads=False)
    _assert_tree_close(ts2["mom"], js2["mom"], grads=False)
    (_, _), g = talgos.get("dfa").value_and_grad(tm, tdfa.DFAConfig(backend="cuda"))(
        tp, tf, tbatch, 2)
    tp3, _, _ = topt.update(g, ts, tp)
    assert all(torch.equal(tp2[k], tp3[k]) for k in tp3)


def test_encoder_feedback_is_the_pooled_broadcast_error(pair):
    """The encoder's projections take the decoder error's mean over target
    positions (B rows), the decoder's and the embedding's every position
    (B·S rows), as the reference's; the encoder's δ is that projection
    broadcast over every frame, and ``dfa-layerwise`` keeps the global
    error for the encoder alone."""
    (jm, _, _), (tm, tp, tf) = pair
    _, tbatch = _batch(tm)
    seen = []
    cfg = tdfa.DFAConfig(backend=_recording(seen, "ab"))
    talgos.get("dfa").value_and_grad(tm, cfg)(tp, tf, tbatch, 1)
    rows = [a[0] for a, _ in seen]
    assert rows == [BATCH] * 2 + [BATCH * SEQ] * 2 + [BATCH * SEQ]
    fwd = tdfa.forward_with_error(tm, tp, tdfa.DFAConfig(), tbatch)
    enc_spec, dec_spec = tm.segment_specs()
    jenc, jdec = jm.segment_specs()
    assert jenc.adapt_error is not None and jdec.adapt_error is None is dec_spec.adapt_error
    e = fwd["e_tap"]
    pooled = enc_spec.adapt_error(e)
    np.testing.assert_allclose(_np(pooled), np.asarray(jenc.adapt_error(jnp.asarray(_np(e)))),
                               rtol=1e-6, atol=1e-7)
    delta = tdfa.dfa_delta(tdfa.DFAConfig(backend="cuda"))(
        enc_spec, pooled, tf["enc"][0], 0, torch.zeros((BATCH, 32, 48)))
    assert tuple(delta.shape) == (BATCH, 32, 48)
    assert torch.equal(delta, delta[:, :1].expand_as(delta))
    np.testing.assert_allclose(_np(delta[:, 0]), _np(pooled[:, 0] @ tf["enc"][0].T),
                               rtol=1e-5, atol=1e-6)
    seen.clear()
    talgos.get("dfa-layerwise").value_and_grad(tm, cfg)(tp, tf, tbatch, 1)
    assert [a[0] for a, _ in seen] == rows


def test_emu_step_matches_reference(pair):
    """One dfa step through the emulated banks on a quiet device
    (crosstalk on, a carried drift residual, no read / shot / drift noise,
    no heater DAC or ADC): the port's kernel path (plain version on the
    CPU) against the reference's unfused chain."""
    (jm, jp, jf), (tm, tp, tf) = pair
    jbatch, tbatch = _batch(tm)
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


# ---------------------------------------------------------------------------
# the launcher and the registry
# ---------------------------------------------------------------------------

def test_launcher_trains_whisper_on_cpu(tmp_path, capsys):
    """``launch.train --arch whisper-small --smoke``: frames in every batch
    (0.1 × normal draws keyed (seed, step, 7)), finite loss, a checkpoint."""
    final = ttrain.main(["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "16",
                         "--device", "cpu", "--preset", "offchip_bpd", "--backend", "cuda",
                         "--steps", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[step 2/2]" in out and "[final]" in out and np.isfinite(final["ce_loss"])
    assert list(tmp_path.glob("ckpt_*.pt"))
    cfg = tconfigs.get(ARCH).make_smoke(device="meta").cfg
    b = ttrain.lm_batches(ARCH, cfg, 16, 2, 5)(3)
    expect = np.random.default_rng((5, 3, 7)).normal(size=(2, 32, 48)).astype("float32") * 0.1
    np.testing.assert_array_equal(b["frames"], expect)
    assert sorted(b) == ["frames", "labels", "tokens"]


def test_registry_matches_reference():
    """The port registers the reference's ten assigned architectures, in
    its order, and its MLP."""
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED
    assert len(tconfigs.ASSIGNED) == 10
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert {tconfigs.get(n).family for n in tconfigs.ASSIGNED} == {
        jconfigs.get(n).family for n in jconfigs.ASSIGNED}
    assert tconfigs.get("qwen3-1.7b").input_extras(2, "train") == {}
