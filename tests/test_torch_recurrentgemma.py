"""The recurrentgemma family: the port against the reference on the CPU.

The RG-LRU (``rglru_scan`` against ``lax.associative_scan``, the block's
forward and its decode), sliding-window attention and ``logit_softcap``
(``reference_attention``, ``flash_attention``, ``decode_attention``, the
ring-buffer cache past its window), the gated GELU MLP, and the smoke
recurrentgemma (5 layers: one (rec, rec, attn) group and a 2-layer tail,
d 64, window 16, vocab 128) with the reference's parameters and feedback
carried across by ``convert``: the forward's parts, ``decode_step``, the
masked decode-scan prefill and its repeated noise keys, the engine's
greedy tokens past the window, 8 / 7 bank products a layer, dfa /
dfa-layerwise / bp gradients and a quiet emulated step, and both
launchers.  Inputs come from a seeded numpy generator.  The full-width
layout (recurrentgemma-9b, 10.44 B parameters) is checked on the meta
device."""

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
from repro.data import tokens as jtokens  # noqa: E402
from repro.hardware import drift as jdrift  # noqa: E402
from repro.hardware import mrr as jmrr  # noqa: E402
from repro.nn import attention as jatt  # noqa: E402
from repro.nn import linear as jlinear  # noqa: E402
from repro.nn import rglru as jrglru  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import decode as jdecode  # noqa: E402
from repro_torch import algos as talgos  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.algos import dfa as tdfa  # noqa: E402
from repro_torch.configs import recurrentgemma_9b as trg  # noqa: E402
from repro_torch.core import dfa as tcore_dfa  # noqa: E402
from repro_torch.core import photonics as tph  # noqa: E402
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.hardware import drift as tdrift  # noqa: E402
from repro_torch.hardware import mrr as tmrr  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.transformer import TransformerConfig, TransformerLM  # noqa: E402
from repro_torch.nn import attention as tatt  # noqa: E402
from repro_torch.nn import linear as tlinear  # noqa: E402
from repro_torch.nn import rglru as trglru  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import Request as TRequest  # noqa: E402
from repro_torch.serve import decode as tdecode  # noqa: E402

ARCH = "recurrentgemma-9b"
VOCAB, SEQ, BATCH = 128, 24, 4  # SEQ above the smoke window of 16
TOL = 1e-5  # of each tensor's max |value|: loss and gradients (ROADMAP)
LOGIT_TOL = 1e-4  # serving logits (ROADMAP)
ATT_TOL = 2e-5  # the reference's flash-vs-oracle bound (tests/test_layers.py)
PROMPTS = [[5, 17, 99, 3, 42, 8, 1], [7, 8], [120, 4, 4]]
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


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


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


# ---------------------------------------------------------------------------
# the RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [1, 40, 64])
def test_rglru_scan_matches_associative_scan(seq):
    """The doubling scan against ``lax.associative_scan`` (f32, (2, S,
    64)), within 1e-5 of max|h|."""
    x = _rand((2, seq, 64), 0)
    r = 1 / (1 + np.exp(-_rand((2, seq, 64), 1)))
    i = 1 / (1 + np.exp(-_rand((2, seq, 64), 2)))
    u = np.random.default_rng(3).uniform(0.9, 0.999, 64)
    lam = np.log(u ** (1 / 8) / (1 - u ** (1 / 8))).astype(np.float32)
    expect = jax.jit(jrglru.rglru_scan)(jnp.asarray(x), jnp.asarray(r), jnp.asarray(i),
                                        {"lambda": jnp.asarray(lam)})
    got = trglru.rglru_scan(_t(x), _t(r), _t(i), _t(lam))
    _close(got, expect, what=seq)


def _block_pair(d_model=32, d_rnn=48):
    jb = jrglru.RGLRUBlock(d_model, d_rnn)
    jp = jb.init(jax.random.PRNGKey(0))
    tb = trglru.RGLRUBlock(d_model, d_rnn, device="cpu")
    sd = convert.state_dict_from_reference(_to_np(jp))
    assert sorted(sd) == sorted(k for k, _ in tb.named_parameters())
    tb.load_state_dict(sd)
    return jb, jp, tb


def test_rglru_block_forward_and_decode_match_reference():
    """tests/test_layers.py's decode-parity case (d 32, d_rnn 48, T 12):
    the forward within 1e-5 of the reference's, every decode step within
    1e-5 of the reference's decode, and decode = forward within the
    reference's bound; the caches carried back."""
    jb, jp, tb = _block_pair()
    x = _rand((2, 12, 32), 4)
    with torch.no_grad():
        full = tb(_t(x))
    _close(full, jax.jit(jb.__call__)(jp, jnp.asarray(x)), what="forward")
    cache, jcache = tb.init_cache(2, 12), jb.init_cache(2, 12)
    assert cache["h"].dtype == torch.float32 and tuple(cache["conv"].shape) == (2, 3, 48)
    jdec = jax.jit(jb.decode)
    outs = []
    with torch.no_grad():
        for t in range(12):
            o, cache = tb.decode(_t(x[:, t:t + 1]), cache, torch.full((2,), t))
            jo, jcache = jdec(jp, jnp.asarray(x[:, t:t + 1]), jcache, jnp.full((2,), t))
            _close(o, jo, what=t)
            outs.append(o)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(full), rtol=1e-4, atol=2e-5)
    for name in ("h", "conv"):
        _close(cache[name], jcache[name], what=name)


def test_rglru_init_spans_griffins_range():
    """The port's own init: a^c = σ(Λ)^8 in (0.9, 0.999), the conv bias
    zero."""
    tb = trglru.RGLRUBlock(32, 48, device="cpu").init(5)
    a_c = torch.sigmoid(tb.lam.detach()) ** 8
    assert float(a_c.min()) >= 0.9 - 1e-6 and float(a_c.max()) <= 0.999 + 1e-6
    assert float(tb.conv_b.detach().abs().max()) == 0.0
    assert dict(tb.named_parameters())["lambda"] is tb.lam


def test_gelu_gated_mlp_matches_reference():
    jl = jlinear.GatedMLP(32, 64, "gelu")
    jp = jl.init(jax.random.PRNGKey(2))
    tl = tlinear.GatedMLP(32, 64, "gelu", device="cpu")
    tl.load_state_dict(convert.state_dict_from_reference(_to_np(jp)))
    x = _rand((3, 5, 32), 6)
    with torch.no_grad():
        _close(tl(_t(x)), jl(jp, jnp.asarray(x)))
        silu = tlinear.GatedMLP(32, 64, device="cpu")
        silu.load_state_dict(tl.state_dict())
        assert not torch.allclose(silu(_t(x)), tl(_t(x)))


# ---------------------------------------------------------------------------
# sliding windows, soft-capping and the ring buffer
# ---------------------------------------------------------------------------

def _pos(b, s):
    return np.broadcast_to(np.arange(s)[None], (b, s)).copy()


@pytest.mark.parametrize("window,softcap", [(64, None), (64, 5.0), (None, 5.0), (40, None)])
def test_windowed_attention_matches_reference(window, softcap):
    """tests/test_layers.py's local-window case (1 × 256, 2 heads, d 16,
    window 64, q_chunk 64, k_chunk 32), with soft-capping and a window
    that does not divide the chunks: the port's oracle and flash against
    the reference's, and flash against the port's oracle, within 2e-5."""
    q, k, v = (_rand((1, 256, 2, 16), s) for s in (7, 8, 9))
    p = _pos(1, 256)
    kw = dict(causal=True, window=window, logit_softcap=softcap)
    jref = jatt.reference_attention(*(jnp.asarray(a) for a in (q, k, v)), q_pos=jnp.asarray(p),
                                    kv_pos=jnp.asarray(p), **kw)
    tq, tk, tv, tp = (_t(a) for a in (q, k, v, p))
    ref = tatt.reference_attention(tq, tk, tv, q_pos=tp, kv_pos=tp, **kw)
    flash = tatt.flash_attention(tq, tk, tv, q_pos=tp, kv_pos=tp, q_chunk=64, k_chunk=32, **kw)
    jflash = jatt.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), q_pos=jnp.asarray(p),
                                  kv_pos=jnp.asarray(p), q_chunk=64, k_chunk=32, **kw)
    np.testing.assert_allclose(_np(ref), np.asarray(jref), rtol=ATT_TOL, atol=ATT_TOL)
    np.testing.assert_allclose(_np(flash), np.asarray(jflash), rtol=ATT_TOL, atol=ATT_TOL)
    np.testing.assert_allclose(_np(flash), _np(ref), rtol=ATT_TOL, atol=ATT_TOL)


@pytest.mark.parametrize("window,softcap", [(5, None), (5, 2.0), (None, 2.0)])
def test_windowed_decode_attention_matches_reference(window, softcap):
    q = _rand((3, 1, 4, 8), 10)
    kc, vc = _rand((3, 12, 2, 8), 11), _rand((3, 12, 2, 8), 12)
    clen = np.array([12, 7, 1])
    kw = dict(window=window, logit_softcap=softcap)
    expect = jatt.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                   cache_len=jnp.asarray(clen), **kw)
    got = tatt.decode_attention(_t(q), _t(kc), _t(vc), cache_len=_t(clen), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(expect), rtol=ATT_TOL, atol=ATT_TOL)


def _attn_pair(window, **kw):
    ja = jnn.Attention(d_model=16, n_heads=2, n_kv_heads=1, window=window, **kw)
    jp = ja.init(jax.random.PRNGKey(1))
    ta = tatt.Attention(16, 2, 1, window=window, device="cpu", **kw)
    ta.load_state_dict(convert.state_dict_from_reference(_to_np(jp)))
    return ja, jp, ta


@pytest.mark.parametrize("slots", [8, 40], ids=["ring", "longer_cache"])
@pytest.mark.parametrize("softcap", [None, 3.0])
def test_ring_buffer_decode_past_the_window(slots, softcap):
    """tests/test_layers.py's ring-buffer case (T 32, window 8): 32 decode
    steps into a cache of window slots (a ring that wraps four times) or
    of 40 (absolute slots, the window masked) equal the windowed full
    forward, and each step the reference's decode."""
    ja, jp, ta = _attn_pair(8, logit_softcap=softcap)
    x = _rand((1, 32, 16), 13)
    with torch.no_grad():
        full = ta(_t(x))
    _close(full, ja(jp, jnp.asarray(x)), tol=LOGIT_TOL, what="forward")
    cache, jcache = ta.init_cache(1, slots), ja.init_cache(1, slots)
    assert cache["k"].shape[1] == min(slots, 8) == jcache["k"].shape[1]
    jdec = jax.jit(ja.decode)
    outs = []
    with torch.no_grad():
        for t in range(32):
            o, cache = ta.decode(_t(x[:, t:t + 1]), cache, torch.full((1,), t))
            jo, jcache = jdec(jp, jnp.asarray(x[:, t:t + 1]), jcache, jnp.full((1,), t))
            _close(o, jo, tol=LOGIT_TOL, what=t)
            outs.append(o)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(full), rtol=1e-4, atol=2e-5)
    for name in ("k", "v"):
        _close(cache[name], jcache[name], what=name)


def test_windowed_layers_prefill_by_decode_scan():
    """A windowed ``Attention`` refuses the parallel prefill, and a windowed
    transformer takes the engine's decode-scan, as the reference's
    ``supports_parallel_prefill``."""
    _, _, ta = _attn_pair(8)
    cache = ta.init_cache(1, 8)
    with pytest.raises(ValueError, match="decode-scan"):
        ta.prefill(torch.zeros((1, 2, 16)), cache, torch.zeros(1, dtype=torch.long),
                   torch.ones(1, dtype=torch.long))
    cfg = dict(name="t", n_layers=1, d_model=16, n_heads=2, n_kv_heads=1, d_ff=32,
               vocab_size=32)
    assert TransformerLM(TransformerConfig(**cfg), device="meta").supports_parallel_prefill
    assert not TransformerLM(TransformerConfig(window=8, **cfg),
                             device="meta").supports_parallel_prefill


# ---------------------------------------------------------------------------
# the model and its layout
# ---------------------------------------------------------------------------

def test_full_width_layout_matches_reference_without_allocation():
    """recurrentgemma-9b at full width on the meta device: the reference's
    names, shapes and count (10.44 B), its four stacked segments (12, 12,
    12, 2 layers), and 293 bank products a token."""
    jm = jconfigs.get(ARCH).make_model(jnp.bfloat16)
    tm = trg.full(torch.bfloat16, device="meta")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == convert.torch_shapes(jm.param_shapes())
    assert all(p.is_meta and p.dtype == torch.bfloat16 for p in tm.parameters())
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(jm.param_shapes()))
    assert n == 10_444_771_328
    assert [(s.name, s.n_layers) for s in tm.segment_specs()] == [
        (s.name, s.n_layers) for s in jm.segment_specs()] == [
        ("grp_rec1", 12), ("grp_rec2", 12), ("grp_attn", 12), ("tail_rec", 2)]
    assert tm.forward_gemm_specs() == jm.forward_gemm_specs()
    assert len(tm.forward_gemm_specs()) == 26 * 8 + 12 * 7 + 1 == 293
    assert tm.cfg.v_padded == 256000 and not tm.supports_parallel_prefill


def test_forward_parts_match_reference(pair):
    """Embedding, every segment's tape, the final hidden state, the logits
    and the loss at seq 24 (past the window of 16)."""
    (jm, jp, _), (tm, tp, _) = pair
    jbatch, tbatch = _batch()
    assert tm.d_tap == jm.d_tap == 64 and tm.error_tap == "hidden"
    jx0 = jax.jit(jm.embed)(jp, jbatch)
    jxf, jtapes, jaux = jax.jit(lambda p, x: (lambda r: (
        r[0], {n: sv.inputs for n, sv in r[1].items()}, r[2]))(jm.run_segments(p, x)))(jp, jx0)
    x0 = tm.embed(tp, tbatch)
    with torch.no_grad():
        xf, saved, auxes = tm.run_segments(tp, x0)
    np.testing.assert_array_equal(_np(x0), np.asarray(jx0))
    assert sorted(saved) == sorted(jtapes) and auxes == {} and jaux == {}
    for name in saved:
        _close(saved[name].inputs, jtapes[name], what=name)
    _close(xf, jxf, what="x_final")
    with torch.no_grad():
        logits = tm.head_logits(tp, xf, tbatch)
    _close(logits, jax.jit(jm.head_logits)(jp, jxf, jbatch), what="logits")
    (jl, _), (tl, _) = jax.jit(jm.loss)(jp, jbatch), tm.loss(tp, tbatch)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)


def test_decode_step_matches_reference(pair):
    """20 decode steps of 3 slots from zero state (past the ring of 16):
    logits within 1e-4 of max|logit| of the reference's and of the
    training forward at each position; the nested caches carried back."""
    (jm, jp, _), (tm, tp, _) = pair
    toks = np.random.default_rng(5).integers(0, VOCAB, (3, 20))
    with torch.no_grad():
        full = tm.head_logits(tp, tm.run_segments(tp, tm.embed(tp, {"tokens": _t(toks)}))[0],
                              None)
    jcache, tcache = jm.init_caches(3, 32), tm.init_caches(3, 32)
    assert tuple(tcache["grp_attn.k"].shape) == (1, 3, 16, 1, 16)
    assert tcache["grp_rec1.h"].dtype == torch.float32
    assert convert.caches_to_reference(tcache).keys() == jcache.keys()
    jstep = jax.jit(jm.decode_step)
    for t in range(20):
        clen = np.full((3,), t)
        jl, jcache = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jcache, jnp.asarray(clen))
        with torch.no_grad():
            tl, tcache = tm.decode_step(_t(toks[:, t:t + 1]), tcache, _t(clen))
        _close(tl, jl, tol=LOGIT_TOL, what=t)
        _close(tl[:, 0], full[:, t], tol=LOGIT_TOL, what=("forward", t))
    back = convert.caches_to_reference(tcache)
    for seg, leaves in _to_np(jcache).items():
        for name, ref in leaves.items():
            _close(back[seg][name], ref, what=(seg, name))
    again = convert.caches_from_reference(back, tcache)
    assert all(torch.equal(again[n], tcache[n]) for n in tcache)


def test_masked_decode_scan_prefill_matches_reference(pair):
    """One prefill step over a chunk of 4 with n_valid (4, 2, 0) on carried
    state: the last valid logits, the new caches (the slot with nothing
    valid untouched) and the advanced lengths."""
    (jm, jp, _), (tm, _, _) = pair
    rng = np.random.default_rng(6)
    toks = rng.integers(0, VOCAB, (3, 4))
    n_valid = np.array([4, 2, 0])
    jcache = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.1),
        jm.init_caches(3, 32))
    tcache = convert.caches_from_reference(_to_np(jcache), tm.init_caches(3, 32))
    clen = np.array([17, 3, 2])  # the first slot's ring has wrapped
    jlast, jnew, jlen = jax.jit(jdecode.make_prefill_step(jm))(
        jp, jnp.asarray(toks), jnp.asarray(n_valid), jcache, jnp.asarray(clen))
    with torch.no_grad():
        tlast, tnew, tlen = tdecode.make_prefill_step(tm)(_t(toks), _t(n_valid), tcache,
                                                          _t(clen))
    assert tlast.dtype == torch.float32 and tuple(tlast.shape) == (3, VOCAB)
    _close(tlast, jlast, tol=LOGIT_TOL, what="last")
    assert float(tlast[2].abs().max()) == 0.0
    np.testing.assert_array_equal(_np(tlen), np.asarray(jlen))
    back = convert.caches_to_reference(tnew)
    for seg, leaves in _to_np(jnew).items():
        for name, ref in leaves.items():
            _close(back[seg][name], ref, what=(seg, name))
    assert all(torch.equal(tnew[n][:, 2], tcache[n][:, 2]) for n in tnew)


def _recording(seen, what):
    @dataclasses.dataclass(frozen=True)
    class Recording(tph.PhotonicBackend):
        name: str = "recording"

        def matmul(self, a, b, cfg, key=None, *, mask=None):
            seen.append(key if what == "key" else (tuple(b.shape), a.is_contiguous()))
            return tph.photonic_matmul(a, b, cfg, key=key, mask=mask)

    return Recording()


def test_prefill_scan_repeats_the_noise_keys(pair):
    """The reference scans one body over each (rec, rec, attn) group and
    another over the tail, tracing each once, and traces the prefill's
    decode-scan once: every group draws keys 1-23, every tail layer 24-31,
    the head 32, at every token position."""
    _, (tm, _, _) = pair
    seen = []
    toks = torch.tensor([[1, 2, 3], [4, 5, 6]])
    with torch.no_grad(), tph.forward_execution(tph.PRESETS["offchip_bpd"],
                                                _recording(seen, "key"), 7):
        tdecode.make_prefill_step(tm)(toks, torch.tensor([3, 2]), tm.init_caches(2, 32),
                                      torch.zeros(2, dtype=torch.long))
    c = tm.cfg
    one = ([tph.prng.fold(7, i) for i in range(1, 24)] * c.n_groups
           + [tph.prng.fold(7, i) for i in range(24, 32)] * c.n_tail + [tph.prng.fold(7, 32)])
    assert seen == one * 3


def test_serving_counts_the_bank_products(pair):
    """Each forward routes 8 products a recurrent layer (in_x, w_a, w_i,
    in_gate, out and the MLP's three), 7 an attention layer and the head
    through the bank: the shapes of ``forward_gemm_specs``, a forward at
    a time, in decode and in the decode-scan prefill, each with a
    contiguous input (the bank kernel takes no other)."""
    _, (tm, _, _) = pair
    seen, forwards = [], []
    step = tm.decode_step

    def counting_step(*a):
        forwards.append(1)
        return step(*a)

    eng = TEngine(tm, batch_slots=2, max_len=32, prefill_chunk=4,
                  backend=_recording(seen, "shape"), photonics=tph.PRESETS["ideal"])
    tm.decode_step = counting_step
    try:
        eng.run([TRequest(prompt=list(p), max_new=3) for p in PROMPTS])
    finally:
        del tm.decode_step
    specs = sorted(((m, k), True) for _, m, k in tm.forward_gemm_specs())
    assert len(specs) == 4 * 8 + 7 + 1
    assert len(seen) == len(specs) * len(forwards)
    for f in range(len(forwards)):
        assert sorted(seen[f * len(specs):(f + 1) * len(specs)]) == specs


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _serve_pair(jm, jp, tm, chunk, prompts=PROMPTS, max_new=12):
    jeng = JEngine(jm, jp, batch_slots=2, max_len=32, prefill_chunk=chunk, backend="ref",
                   photonics=jph.PRESETS["ideal"])
    teng = TEngine(tm, batch_slots=2, max_len=32, prefill_chunk=chunk, backend="cuda",
                   photonics=tph.PRESETS["ideal"])
    jreqs = [JRequest(prompt=list(p), max_new=max_new) for p in prompts]
    treqs = [TRequest(prompt=list(p), max_new=max_new) for p in prompts]
    jeng.run(jreqs)
    teng.run(treqs)
    return jeng, jreqs, teng, treqs


@pytest.mark.parametrize("chunk", [3, 1])
def test_engine_matches_reference(pair, chunk):
    """tests/test_serving.py's windowed case on the port: greedy tokens and
    engine stats equal to the reference's engine on the ideal bank, prompts
    of up to 7 tokens and 12 new ones (past the window of 16), 2 slots for
    3 requests; chunk 3 and chunk 1 give the same tokens."""
    (jm, jp, _), (tm, _, _) = pair
    jeng, jreqs, teng, treqs = _serve_pair(jm, jp, tm, chunk)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done and len(r.out) == 12 for r in treqs)
    assert len(PROMPTS[0]) + 12 > tm.cfg.window
    assert teng.stats == jeng.stats
    if chunk == 3:
        _, _, _, one = _serve_pair(jm, jp, tm, 1)
        assert [r.out for r in one] == [r.out for r in treqs]
    back = convert.caches_to_reference(teng.caches)
    for seg, leaves in _to_np(jeng.caches).items():
        for name, ref in leaves.items():
            _close(back[seg][name], ref, tol=LOGIT_TOL, what=(seg, name))


# ---------------------------------------------------------------------------
# one training step against the reference
# ---------------------------------------------------------------------------

def _assert_tree_close(tgrads, jgrads):
    expect = convert.state_dict_from_reference(_to_np(jgrads))
    assert sorted(tgrads) == sorted(expect)
    for k in expect:
        _close(tgrads[k], expect[k], what=k)


@pytest.mark.parametrize("algo,hardware,backend", [
    ("dfa", "ideal", "cuda"), ("dfa", "quant", "ref"), ("dfa-layerwise", "ideal", "cuda"),
    ("bp", "ideal", "ref")])
def test_value_and_grad_matches_reference(pair, algo, hardware, backend):
    """Loss and every gradient (the RG-LRU's Λ, the convolutions and the
    embedding table's included) within 1e-5 of their max."""
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
    assert "aux_loss" not in tmet
    _assert_tree_close(tg, jg)
    assert float(torch.abs(tg["embed.tok.table"]).max()) > 0
    assert all(float(tg[k].abs().max()) > 0 for k in tg if k.endswith(".lambda"))


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


def test_core_dfa_reexports_the_algos_objects():
    """``core/dfa.py`` is the reference's shim: its names are the
    ``algos`` objects themselves, and ``freeze_norm_leaves`` detaches only
    the norm scales."""
    from repro.core import dfa as jcore_dfa

    assert tcore_dfa.__all__ == jcore_dfa.__all__
    assert tcore_dfa.DFAConfig is tdfa.DFAConfig
    assert tcore_dfa.value_and_grad is tdfa.value_and_grad
    assert tcore_dfa.init_feedback is tdfa.init_feedback
    assert tcore_dfa.make_fused_train_step is tdfa.make_fused_train_step
    assert tcore_dfa.compress_error is tdfa.compress_error
    assert tcore_dfa.grad_alignment is tdfa.grad_alignment
    assert tcore_dfa.freeze_norm_leaves is tdfa.freeze_norm_leaves
    assert tcore_dfa.bp_value_and_grad is talgos.bp.bp_value_and_grad
    p = {"grp_rec1.0.norm1.scale": torch.ones(2, requires_grad=True),
         "grp_rec1.0.mlp.up.weight": torch.ones(2, requires_grad=True)}
    frozen = tcore_dfa.freeze_norm_leaves(p)
    assert not frozen["grp_rec1.0.norm1.scale"].requires_grad
    assert frozen["grp_rec1.0.mlp.up.weight"] is p["grp_rec1.0.mlp.up.weight"]


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_launchers_run_recurrentgemma_on_cpu(tmp_path, capsys):
    final = ttrain.main(["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "24",
                         "--device", "cpu", "--preset", "offchip_bpd", "--backend", "cuda",
                         "--steps", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[step 2/2]" in out and "[final]" in out and np.isfinite(final["ce_loss"])
    assert list(tmp_path.glob("ckpt_*.pt"))
    tserve.main(["--arch", ARCH, "--backend", "cuda", "--hardware", "offchip_bpd",
                 "--device", "cpu", "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 9 tokens" in out
    assert ARCH in tconfigs.ASSIGNED
    assert tconfigs.list_archs().index(ARCH) == tconfigs.list_archs().index("internvl2-2b") + 1
