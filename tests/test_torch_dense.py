"""The dense attention families: the port against the reference on the CPU.

qk-norm attention (qwen3), multi-head latent attention (minicpm3: the
latent cache, absorbed decode and prefill), ``flash_attention`` and the
smoke qwen3-1.7b, minicpm3-4b and granite-8b models, with the
reference's parameters and feedback carried across by ``convert`` and
inputs from a seeded numpy generator: logits, ``decode_step``,
``prefill_step``, the engine's greedy tokens, dfa / dfa-layerwise / bp
gradients, a quiet emulated step, both launchers, the padded vocabulary
and ``step_cost``.  The full-width layouts are checked on the meta
device."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import algos as jalgos  # noqa: E402
from repro import api as japi  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import nn as jnn  # noqa: E402
from repro.algos import dfa as jdfa  # noqa: E402
from repro.core import photonics as jph  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.hardware import drift as jdrift  # noqa: E402
from repro.hardware import mrr as jmrr  # noqa: E402
from repro.models.transformer import TransformerConfig as JTransformerConfig  # noqa: E402
from repro.models.transformer import TransformerLM as JTransformerLM  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn.norms import rms_normalize as j_rms_normalize  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import decode as jdecode  # noqa: E402
from repro_torch import algos as talgos  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.algos import dfa as tdfa  # noqa: E402
from repro_torch.configs import minicpm3_4b as tminicpm3  # noqa: E402
from repro_torch.core import photonics as tph  # noqa: E402
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.hardware import drift as tdrift  # noqa: E402
from repro_torch.hardware import mrr as tmrr  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.transformer import TransformerConfig, TransformerLM  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.nn.norms import rms_normalize  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import Request as TRequest  # noqa: E402

ARCHS = ["qwen3-1.7b", "minicpm3-4b", "granite-8b"]
VOCAB, SEQ, BATCH = 128, 16, 4
TOL = 1e-5  # of each tensor's max |value|: logits, outputs and gradients (ROADMAP)
FLASH_TOL = 2e-5  # the reference's own flash-vs-reference bound (tests/test_layers.py)
PROMPTS = [[5, 17, 99, 3, 42], [7, 8], [120]]
QUANT = dict(noise_std=0.0, weight_bits=8, input_bits=8)
MLA = dict(d_model=32, n_heads=2, q_lora_rank=16, kv_lora_rank=8, qk_nope_dim=8,
           qk_rope_dim=4, v_head_dim=8)


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


def _pos(b, s):
    return np.broadcast_to(np.arange(s)[None], (b, s)).copy()


@pytest.fixture(scope="module", params=ARCHS)
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


def _batch(step=0, seq=SEQ, batch=BATCH):
    b = jtokens.MarkovTokens(VOCAB, seq, batch, seed=0).batch(step)
    return {k: jnp.asarray(v) for k, v in b.items()}, to_device(b, "cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jdt,tdt,tol", [(jnp.float32, torch.float32, 1e-6),
                                         (jnp.bfloat16, torch.bfloat16, 1e-2)])
def test_rms_normalize_matches_reference(jdt, tdt, tol):
    x = np.random.default_rng(1).standard_normal((3, 4, 5, 16)).astype(np.float32) * 3
    expect = j_rms_normalize(jnp.asarray(x, jdt))
    got = rms_normalize(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), np.asarray(expect, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("sq,skv,h,kvh,d,causal,q_chunk,k_chunk", [
    *[(*shape, causal, 64, 32) for shape in [(128, 128, 4, 4, 32),
                                              (256, 256, 4, 2, 16),  # GQA
                                              (64, 192, 2, 2, 8)]  # cross-length
      for causal in (True, False)],
    (100, 100, 2, 1, 8, True, 64, 32),  # ragged: the single-tile fallback
    (96, 96, 2, 2, 8, True, 64, 32),  # q_chunk does not divide sq: one tile too
], ids=lambda v: str(v))
def test_flash_attention_matches_reference(sq, skv, h, kvh, d, causal, q_chunk, k_chunk):
    """``flash_attention`` against the reference's ``flash_attention``
    and the port's ``reference_attention``: tests/test_layers.py's cases
    (q_chunk 64, k_chunk 32) and the ragged fallback."""
    rng = np.random.default_rng(sq + skv + h + kvh + d)
    q = rng.standard_normal((2, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((2, skv, kvh, d)).astype(np.float32)
    v = rng.standard_normal((2, skv, kvh, d)).astype(np.float32)
    qp, kp = _pos(2, sq), _pos(2, skv)
    kw = dict(causal=causal)
    expect = jax.jit(lambda *a: jattn.flash_attention(
        *a[:3], q_pos=a[3], kv_pos=a[4], q_chunk=q_chunk, k_chunk=k_chunk, **kw))(
        *map(jnp.asarray, (q, k, v, qp, kp)))
    got = tattn.flash_attention(_t(q), _t(k), _t(v), q_pos=_t(qp), kv_pos=_t(kp),
                                q_chunk=q_chunk, k_chunk=k_chunk, **kw)
    oracle = tattn.reference_attention(_t(q), _t(k), _t(v), q_pos=_t(qp), kv_pos=_t(kp), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(expect), rtol=FLASH_TOL, atol=FLASH_TOL)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=FLASH_TOL, atol=FLASH_TOL)


def test_flash_attention_fully_masked_rows_stay_finite():
    """Queries that see no key (positions before every key) give zeros,
    not NaN, in value and in gradient."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((1, 64, 2, 8)).astype(np.float32))
    q.requires_grad_(True)
    k = torch.from_numpy(rng.standard_normal((1, 64, 2, 8)).astype(np.float32))
    qp = torch.arange(64)[None]
    out = tattn.flash_attention(q, k, k, q_pos=qp, kv_pos=qp + 32, q_chunk=32, k_chunk=16)
    assert float(out[:, :32].detach().abs().max()) == 0.0 and bool(torch.isfinite(out).all())
    out.square().sum().backward()
    assert bool(torch.isfinite(q.grad).all())


def _attn_pair(qk_norm):
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, rope_theta=1e6)
    jl = jnn.Attention(qk_norm=qk_norm, **kw)
    jp = jl.init(jax.random.PRNGKey(3))
    tl = tattn.Attention(qk_norm=qk_norm, device="cpu", **kw)
    tl.load_state_dict(convert.state_dict_from_reference(_to_np(jp)))
    return jl, jp, tl


def _mla_pair():
    jl = jnn.MLAttention(**MLA)
    jp = jl.init(jax.random.PRNGKey(4))
    # scales away from 1, so that a missed scale shows
    r = np.random.default_rng(5)
    jp = dict(jp, q_norm_scale=jnp.asarray(r.uniform(0.5, 1.5, 16).astype(np.float32)),
              kv_norm_scale=jnp.asarray(r.uniform(0.5, 1.5, 8).astype(np.float32)))
    tl = tattn.MLAttention(device="cpu", **MLA)
    tl.load_state_dict(convert.state_dict_from_reference(_to_np(jp)))
    return jl, jp, tl


@pytest.mark.parametrize("layer", ["qk_norm", "mla"])
def test_layer_forward_decode_prefill_match_reference(layer):
    """Forward, token-by-token decode and a chunked prefill (n_valid (4,
    2, 0) on a carried cache) against the reference's layer; the decode
    reproduces the forward (tests/test_layers.py's decode parity)."""
    jl, jp, tl = _mla_pair() if layer == "mla" else _attn_pair(True)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 12, 32)).astype(np.float32)
    with torch.no_grad():
        full = tl(_t(x))
        _close(full, jax.jit(jl.__call__)(jp, jnp.asarray(x)), what="forward")
        cache, jcache = tl.init_cache(3, 12), jl.init_cache(3, 12)
        jdecode_, jprefill = jax.jit(jl.decode), jax.jit(jl.prefill)
        assert {n: tuple(c.shape) for n, c in cache.items()} == {
            n: tuple(c.shape) for n, c in jcache.items()}
        outs = []
        for t in range(12):
            clen = np.full((3,), t)
            o, cache = tl.decode(_t(x[:, t:t + 1]), cache, _t(clen))
            jo, jcache = jdecode_(jp, jnp.asarray(x[:, t:t + 1]), jcache, jnp.asarray(clen))
            _close(o, jo, what=("decode", t))
            outs.append(o)
        np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(full), rtol=1e-4, atol=2e-5)
        for name in jcache:
            _close(cache[name], jcache[name], what=name)
        clen, n_valid = np.array([3, 1, 2]), np.array([4, 2, 0])
        y, new = tl.prefill(_t(x[:, :4]), cache, _t(clen), _t(n_valid))
        jy, jnew = jprefill(jp, jnp.asarray(x[:, :4]), jcache, jnp.asarray(clen),
                            jnp.asarray(n_valid))
    _close(y, jy, what="prefill")
    for name in jnew:
        _close(new[name], jnew[name], what=name)
        assert torch.equal(new[name][2], cache[name][2])


def test_qk_norm_normalises_q_and_k():
    """With qk-norm, scaling the q and k weights changes nothing (the
    reference's parameter-free norm); without it, it does."""
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 6, 32)).astype(np.float32))
    outs = {}
    for qk_norm in (True, False):
        _, _, tl = _attn_pair(qk_norm)
        with torch.no_grad():
            y0 = tl(x)
            tl.q.weight.mul_(3.0)
            tl.k.weight.mul_(0.25)
            outs[qk_norm] = (y0, tl(x))
    _close(outs[True][1], outs[True][0], tol=1e-4, what="qk-norm")  # eps keeps it from exact
    assert not torch.allclose(*outs[False], rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("layer", ["gqa", "mla"])
def test_forward_crosses_into_flash_above_two_k_chunks(layer):
    """s > 2·k_chunk takes ``flash_attention`` (q_chunk 16, k_chunk 8 at s
    = 32), in both packages; the outputs and the input gradient agree with
    the reference and with the O(S²) path."""
    jl, jp, tl = _mla_pair() if layer == "mla" else _attn_pair(True)
    x = np.random.default_rng(8).standard_normal((2, 32, 32)).astype(np.float32)
    calls = []
    flash = tattn.flash_attention

    def counted(*a, **kw):
        calls.append((kw["q_chunk"], kw["k_chunk"]))
        return flash(*a, **kw)

    tattn.flash_attention = counted
    try:
        xt = _t(x).requires_grad_(True)
        got = tl(xt, q_chunk=16, k_chunk=8)
    finally:
        tattn.flash_attention = flash
    assert calls == [(16, 8)]
    jfwd = jax.jit(lambda v: jl(jp, v, q_chunk=16, k_chunk=8))
    _close(got, jfwd(jnp.asarray(x)), tol=FLASH_TOL, what="flash forward")
    with torch.no_grad():
        _close(got, tl(_t(x)), tol=FLASH_TOL, what="flash vs O(S²)")
    got.square().sum().backward()
    jg = jax.jit(jax.grad(lambda v: jnp.sum(jnp.square(jfwd(v)))))(jnp.asarray(x))
    _close(xt.grad, jg, tol=FLASH_TOL, what="input gradient")


def test_lm_forward_crosses_into_flash():
    """A smoke qwen3 with k_chunk 4 and q_chunk 8 at seq 16: the loss and
    every dfa gradient (each block's forward and recompute through
    ``flash_attention``) against the reference's at the same chunking."""
    kw = dict(name="qwen3-flash", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab_size=VOCAB, head_dim=16, qk_norm=True, rope_theta=1e6, q_chunk=8,
              k_chunk=4)
    jm = JTransformerLM(JTransformerConfig(**kw))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    jf = jalgos.get("dfa").init_extra_state(jm, jax.random.PRNGKey(1), jdfa.DFAConfig())
    tm = TransformerLM(TransformerConfig(**kw), device="cpu")
    tp = convert.state_dict_from_reference(_to_np(jp))
    tm.load_state_dict(tp)
    tf = convert.feedback_from_reference(_to_np(jf))
    jbatch, tbatch = _batch()
    (jl, _), jg = jax.jit(jalgos.get("dfa").value_and_grad(jm, jdfa.DFAConfig()))(
        jp, jf, jbatch, jax.random.PRNGKey(1))
    (tl, _), tg = talgos.get("dfa").value_and_grad(tm, tdfa.DFAConfig(backend="cuda"))(
        tp, tf, tbatch, 1)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)
    _assert_tree_close(tg, jg)


# ---------------------------------------------------------------------------
# the models and their layouts
# ---------------------------------------------------------------------------

FULL = {  # (n_layers, bank products a token, parameters in billions, 3 decimals)
    "qwen3-1.7b": (28, 197, 2.032),
    "minicpm3-4b": (62, 435, 4.262),
    "granite-8b": (36, 253, 8.255),
}


@pytest.mark.parametrize("arch", ARCHS + ["minicpm3-4b-opt"])
def test_full_width_layout_matches_reference_without_allocation(arch):
    """Each full() (and minicpm3's opt()) on the meta device: the
    reference's names, shapes and count after ``convert.torch_shapes``,
    and its bank products a token (``forward_gemm_specs``)."""
    name, opt = arch.removesuffix("-opt"), arch.endswith("-opt")
    jarch = jconfigs.get(name)
    jm = (jarch.make_opt if opt else jarch.make_model)(jnp.bfloat16)
    make = tminicpm3.opt if opt else tconfigs.get(name).make_model
    tm = make(torch.bfloat16, device="meta")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == convert.torch_shapes(jm.param_shapes())
    assert all(p.is_meta and p.dtype == torch.bfloat16 for p in tm.parameters())
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(jm.param_shapes()))
    layers, products, billions = FULL[name]
    assert tm.cfg.n_layers == layers and len(tm.forward_gemm_specs()) == products
    assert tm.forward_gemm_specs() == jm.forward_gemm_specs()
    if opt:
        assert tm.cfg.v_padded == 73728 and tuple(got["head.out.weight"]) == (73728, 2560)
    else:
        assert round(n / 1e9, 3) == billions
    if name == "minicpm3-4b":
        assert got["blocks.61.attn.q_norm_scale"] == (768,)
        assert got["blocks.0.attn.kv_norm_scale"] == (256,)


def test_forward_parts_match_reference(pair):
    arch, (jm, jp, _), (tm, tp, _) = pair
    jbatch, tbatch = _batch()
    assert tm.d_tap == jm.d_tap == 64 and tm.error_tap == "hidden"
    @jax.jit
    def parts(p, b):
        xf, saved, _ = jm.run_segments(p, jm.embed(p, b))
        return (saved["blocks"].inputs, xf, jm.head_logits(p, xf, b), jm.loss(p, b)[0],
                jdecode.make_prefill(jm)(p, b))

    jtape, jxf, jlogits, jl, jserve = parts(jp, jbatch)
    xf, saved, _ = tm.run_segments(tp, tm.embed(tp, tbatch))
    _close(saved["blocks"].inputs, jtape, what="tape")
    _close(xf, jxf, what="x_final")
    _close(tm.head_logits(tp, xf, tbatch), jlogits, what="logits")
    assert float(tm.loss(tp, tbatch)[0]) == pytest.approx(float(jl), abs=TOL)
    with torch.no_grad():
        _close(tm(tbatch["tokens"]), jserve, what=(arch, "serving forward"))


def test_decode_and_prefill_steps_match_reference(pair):
    """Five decode steps of 3 slots from an empty cache, then a prefill
    step of a 4-token chunk with n_valid (4, 2, 0): logits and the stacked
    caches (whatever keys the attention's ``init_cache`` has) against the
    reference's, carried back by ``convert``."""
    arch, (jm, jp, _), (tm, _, _) = pair
    rng = np.random.default_rng(5)
    toks = rng.integers(0, VOCAB, (3, 5))
    jcache, tcache = jm.init_caches(3, 12), tm.init_caches(3, 12)
    want = {"c_kv", "k_rope"} if arch == "minicpm3-4b" else {"k", "v"}
    assert set(tcache) == set(jcache) == want
    assert {n: tuple(t.shape) for n, t in tcache.items()} == {
        n: tuple(t.shape) for n, t in jcache.items()}
    jstep = jax.jit(jm.decode_step)
    for t in range(5):
        clen = np.full((3,), t)
        jl, jcache = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jcache, jnp.asarray(clen))
        with torch.no_grad():
            tl, tcache = tm.decode_step(_t(toks[:, t:t + 1]), tcache, _t(clen))
        _close(tl, jl, what=(arch, "decode", t))
    chunk = rng.integers(0, VOCAB, (3, 4))
    clen, n_valid = np.array([5, 5, 5]), np.array([4, 2, 0])
    jl, jnew = jax.jit(jm.prefill_step)(jp, jnp.asarray(chunk), jcache, jnp.asarray(clen),
                                        jnp.asarray(n_valid))
    with torch.no_grad():
        tl, tnew = tm.prefill_step(_t(chunk), tcache, _t(clen), _t(n_valid))
    _close(tl, jl, what=(arch, "prefill"))
    back = convert.caches_to_reference(tnew)
    for name, ref in _to_np(jnew).items():
        _close(back[name], ref, what=name)
    again = convert.caches_from_reference(back, tnew)
    assert all(torch.equal(again[n], tnew[n]) for n in tnew)


def _serve_pair(jm, jp, tm, chunk):
    jeng = JEngine(jm, jp, batch_slots=2, max_len=32, prefill_chunk=chunk, backend="ref",
                   photonics=jph.PRESETS["ideal"])
    teng = TEngine(tm, batch_slots=2, max_len=32, prefill_chunk=chunk, backend="cuda",
                   photonics=tph.PRESETS["ideal"])
    jreqs = [JRequest(prompt=list(p), max_new=6) for p in PROMPTS]
    treqs = [TRequest(prompt=list(p), max_new=6) for p in PROMPTS]
    jeng.run(jreqs)
    teng.run(treqs)
    return jeng, jreqs, teng, treqs


@pytest.mark.parametrize("chunk", [4, 1])
def test_engine_matches_reference(pair, chunk):
    """Greedy tokens and engine stats equal to the reference's engine on
    the ideal bank (the port's ``cuda`` backend runs its kernel's plain
    version on CPU tensors), 2 slots for 3 requests."""
    arch, (jm, jp, _), (tm, _, _) = pair
    jeng, jreqs, teng, treqs = _serve_pair(jm, jp, tm, chunk)
    assert [r.out for r in treqs] == [r.out for r in jreqs], arch
    assert all(r.done and len(r.out) == 6 for r in treqs)
    assert teng.stats == jeng.stats
    for name, ref in _to_np(jeng.caches).items():
        _close(teng.caches[name], ref, tol=1e-4, what=name)


def test_serving_counts_the_bank_products(pair):
    """Every forward of the engine routes ``forward_gemm_specs`` products
    through the bank: 7 a layer and the head (MLA's absorbed k_up / v_up
    stay digital), in decode and in the chunked prefill alike."""
    arch, _, (tm, _, _) = pair
    seen = []

    @dataclasses.dataclass(frozen=True)
    class Counting(tph.PhotonicBackend):
        name: str = "counting"

        def matmul(self, a, b, cfg, key=None, *, mask=None):
            seen.append(tuple(b.shape))
            return tph.photonic_matmul(a, b, cfg, key=key, mask=mask)

    eng = TEngine(tm, batch_slots=2, max_len=32, prefill_chunk=4, backend=Counting(),
                  photonics=tph.PRESETS["ideal"])
    eng.run([TRequest(prompt=list(p), max_new=3) for p in PROMPTS])
    forwards = eng.stats["prefill_steps"] + eng.stats["decode_steps"]
    specs = [(m, k) for _, m, k in tm.forward_gemm_specs()]
    assert len(specs) == tm.cfg.n_layers * 7 + 1
    assert seen == specs * forwards, arch


def test_minicpm3_opt_never_emits_a_padding_id():
    """opt()'s padded vocabulary on a smoke-sized model (vocab 100 padded
    to 128): pad logits are masked in training and serving, the loss
    ignores the pad rows and greedy tokens stay below the vocabulary."""
    smoke = tconfigs.get("minicpm3-4b").make_smoke(device="meta").cfg
    cfg = dataclasses.replace(smoke, vocab_size=100, pad_vocab_to=128)
    jcfg = dataclasses.replace(jconfigs.get("minicpm3-4b").make_smoke().cfg, vocab_size=100,
                               pad_vocab_to=128)
    jm = JTransformerLM(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = TransformerLM(cfg, device="cpu")
    tp = convert.state_dict_from_reference(_to_np(jp))
    # make the pad rows win every argmax if they were not masked
    tp["head.out.weight"][100:] = 50.0 * tp["head.out.weight"][:28].abs()
    tm.load_state_dict(tp)
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.long),
             "labels": torch.ones((2, 8), dtype=torch.long)}
    logits = tm.head_logits(tp, tm.run_segments(tp, tm.embed(tp, batch))[0], batch)
    assert logits.shape[-1] == 128 and float(logits[..., 100:].max()) < -1e29
    tp2 = dict(tp, **{"head.out.weight": tp["head.out.weight"].clone()})
    tp2["head.out.weight"][100:] += 7.0
    assert float(tm.loss(tp, batch)[0]) == pytest.approx(float(tm.loss(tp2, batch)[0]), rel=1e-6)
    jl, _ = jax.jit(jm.loss)(dict(jp, head={**jp["head"], "out": {"w": jnp.asarray(
        tp["head.out.weight"].numpy().T)}}), {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    assert float(tm.loss(tp, batch)[0]) == pytest.approx(float(jl), abs=TOL)
    eng = TEngine(tm, batch_slots=2, max_len=32, prefill_chunk=4)
    reqs = [TRequest(prompt=list(p), max_new=8) for p in ([5, 17, 99, 3], [7, 8])]
    eng.run(reqs)
    assert all(r.done and max(r.out) < 100 for r in reqs)


# ---------------------------------------------------------------------------
# one training step against the reference
# ---------------------------------------------------------------------------

def _assert_tree_close(tgrads, jgrads):
    expect = convert.state_dict_from_reference(_to_np(jgrads))
    assert sorted(tgrads) == sorted(expect)
    for k in expect:
        _close(tgrads[k], expect[k], what=k)


@pytest.mark.parametrize("algo,hardware,backend", [
    ("dfa", "quant", "cuda"), ("dfa-layerwise", "ideal", "cuda"), ("bp", "ideal", "ref")])
def test_value_and_grad_matches_reference(pair, algo, hardware, backend):
    """Loss and every gradient, the embedding table's and MLA's norm
    scales included; dfa through a noise-off quantising bank."""
    arch, (jm, jp, jf), (tm, tp, tf) = pair
    jbatch, tbatch = _batch()
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
    assert float(torch.abs(tg["embed.tok.table"]).max()) > 0
    if arch == "minicpm3-4b":
        assert float(tg["blocks.0.attn.q_norm_scale"].abs().max()) > 0


def test_emu_step_matches_reference(pair):
    """One dfa step through the emulated banks on a quiet device
    (crosstalk on, a carried drift residual, no read / shot / drift noise,
    no heater DAC or ADC), the port's kernel path (plain version on the
    CPU) against the reference's unfused chain."""
    _, (jm, jp, jf), (tm, tp, tf) = pair
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


# ---------------------------------------------------------------------------
# the launchers and step_cost
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_on_cpu(arch, tmp_path, capsys):
    final = ttrain.main(["--arch", arch, "--batch", "2", "--seq", "8", "--device", "cpu",
                         "--preset", "offchip_bpd", "--backend", "cuda", "--steps", "2",
                         "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[step 2/2]" in out and "[final]" in out and np.isfinite(final["ce_loss"])
    assert list(tmp_path.glob("ckpt_*.pt"))
    tserve.main(["--arch", arch, "--backend", "cuda", "--hardware", "offchip_bpd",
                 "--device", "cpu", "--requests", "3", "--max-new", "3"])
    assert "[serve] 3 requests, 9 tokens" in capsys.readouterr().out
    assert arch in tconfigs.ASSIGNED


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "minicpm3-4b"])
def test_step_cost_matches_reference(arch):
    """Matrix-product FLOPs of one dfa step at batch 4 × seq 16 against the
    reference's HLO count.  As for qwen1.5, the port counts each block's
    last product once more: the FFN's down projection, which the
    recompute runs and whose value the gradient never reads, and which
    XLA drops as dead code (n_layers · 2·T·d_ff·d).  Every other product
    (MLA's absorbed-free training path included) is counted alike."""
    batch = jtokens.MarkovTokens(VOCAB, SEQ, BATCH, 0).batch(0)
    js = japi.build_session(arch=arch, smoke=True, algo="dfa", hardware="ideal",
                            backend="ref", data_parallel=False)
    expect = js.step_cost(js.init_state(), {k: jnp.asarray(v) for k, v in batch.items()}).flops
    ts = api.build_session(arch=arch, smoke=True, algo="dfa", hardware="ideal", backend="ref",
                           device="cpu")
    cost = ts.step_cost(ts.init_state(), batch)
    cfg = ts.model.cfg
    extra = cfg.n_layers * 2 * BATCH * SEQ * cfg.d_ff * cfg.d_model
    assert cost.kernel_launches == 0
    assert cost.flops == expect + extra, (cost.flops, expect, extra)
