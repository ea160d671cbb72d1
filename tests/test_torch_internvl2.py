"""internvl2-2b: the port against the reference on the CPU.

The smoke internvl2 (2 layers, d 64, GQA 4:2, vocab 128, a vision prefix
of 8 patches × 32) with the reference's parameters and feedback carried
across by ``convert``: logits with and without the patch prefix, the loss
over the text region, the engine's greedy text-only tokens at prefill
chunks 3 and 1, 7 bank products a layer and the head's (the vision
projection digital), dfa / dfa-fused / dfa-layerwise / bp gradients with
the prefix (the vision stub's included) and without it,
a quiet emu step, both launchers and the full-width layout on the meta
device.  Inputs come from seeded numpy generators."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import algos as jalgos  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.algos import dfa as jdfa  # noqa: E402
from repro.core import photonics as jph  # noqa: E402
from repro.hardware import drift as jdrift  # noqa: E402
from repro.hardware import mrr as jmrr  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.train import SGDM as JSGDM  # noqa: E402
from repro_torch import algos as talgos  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.algos import dfa as tdfa  # noqa: E402
from repro_torch.configs import internvl2_2b as tvl  # noqa: E402
from repro_torch.core import photonics as tph  # noqa: E402
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.hardware import drift as tdrift  # noqa: E402
from repro_torch.hardware import mrr as tmrr  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.transformer import (TransformerConfig, TransformerLM,  # noqa: E402
                                            VisionSettings)
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import Request as TRequest  # noqa: E402
from repro_torch.train import SGDM  # noqa: E402

ARCH = "internvl2-2b"
VOCAB, SEQ, BATCH = 128, 16, 4
TOL = 1e-5  # of each tensor's max |value|: loss and gradients (ROADMAP)
LOGIT_TOL = 1e-4  # logits (ROADMAP)
PROMPTS = [[5, 17, 99, 3, 42, 8, 1], [7, 8], [120, 4, 4]]
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
    # a non-zero vision bias and norm shift, so that every parameter's path shows
    rng = np.random.default_rng(3)
    jp = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + (rng.standard_normal(x.shape) * 0.05).astype(
            np.float32)) if x.ndim == 1 else x, jp)
    jf = jax.jit(lambda k: jalgos.get("dfa").init_extra_state(jm, k, jdfa.DFAConfig()))(
        jax.random.fold_in(key, 1))
    tm = tconfigs.get(ARCH).make_smoke(device="cpu")
    tp = convert.state_dict_from_reference(_to_np(jp))
    assert sorted(tp) == sorted(tm.param_dict())
    tm.load_state_dict(tp)
    return (jm, jp, jf), (tm, tp, convert.feedback_from_reference(_to_np(jf)))


def _batch(tm, step=0, prefix=True):
    b = ttrain.lm_batches(ARCH, tm.cfg, SEQ, BATCH, 0)(step)
    if not prefix:
        del b["patch_embeds"]
    return {k: jnp.asarray(v) for k, v in b.items()}, to_device(b, "cpu")


def test_vision_settings_build_the_stub():
    """``TransformerConfig(vision=...)`` builds (it raised before the
    vision prefix was ported): the stub's LayerNorm over d_vision and the
    projection in torch layout, under ``embed.vision``."""
    cfg = TransformerConfig(name="t", n_layers=1, d_model=16, n_heads=2, n_kv_heads=1, d_ff=32,
                            vocab_size=32, vision=VisionSettings(d_vision=12, n_patches=3))
    m = TransformerLM(cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in m.named_parameters() if n.startswith("embed.")}
    assert shapes == {"embed.tok.table": (32, 16), "embed.vision.proj.weight": (16, 12),
                      "embed.vision.proj.bias": (16,), "embed.vision.ln.scale": (12,),
                      "embed.vision.ln.bias": (12,)}
    assert TransformerLM(dataclasses.replace(cfg, vision=None), device="meta").cfg.vision is None


def test_full_width_layout_matches_reference_without_allocation():
    """internvl2-2b at full width on the meta device: the reference's names,
    shapes and count (1.891 B), 169 bank products a token (the head's M =
    92553 odd), the patch embeddings' input extras for training only, and
    the opt() vocabulary padding."""
    jm = jconfigs.get(ARCH).make_model(jnp.bfloat16)
    tm = tvl.full(torch.bfloat16, device="meta")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == convert.torch_shapes(jm.param_shapes())
    assert all(p.is_meta and p.dtype == torch.bfloat16 for p in tm.parameters())
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(jm.param_shapes()))
    assert n == 1_891_248_128
    assert got["embed.vision.proj.weight"] == (2048, 1024)
    assert tm.forward_gemm_specs() == jm.forward_gemm_specs()
    assert len(tm.forward_gemm_specs()) == 24 * 7 + 1 == 169
    assert tm.forward_gemm_specs()[-1] == ("head.unembed", 92553, 2048)
    assert tm.supports_parallel_prefill
    arch, jarch = tconfigs.get(ARCH), jconfigs.get(ARCH)
    for kind in ("train", "prefill", "decode"):
        got = {k: tuple(v.shape) for k, v in arch.input_extras(4, kind).items()}
        assert got == {k: tuple(v.shape) for k, v in jarch.input_extras(4, kind).items()}
        assert all(v.is_meta for v in arch.input_extras(4, kind).values())
    assert got == {} and arch.input_extras(4, "train")["patch_embeds"].shape == (4, 256, 1024)
    assert tvl.opt(device="meta").cfg.v_padded == jarch.make_opt().cfg.v_padded == 92672


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "text_only"])
def test_forward_parts_match_reference(pair, prefix):
    """The embedding (the projected patches before the tokens, or the
    tokens alone), the tape, the logits over prefix and text within 1e-4,
    and the loss over the text region."""
    (jm, jp, _), (tm, tp, _) = pair
    jbatch, tbatch = _batch(tm, prefix=prefix)
    jx0 = jax.jit(jm.embed)(jp, jbatch)
    jxf, jtape = jax.jit(lambda p, x: (lambda r: (r[0], r[1]["blocks"].inputs))(
        jm.run_segments(p, x)))(jp, jx0)
    with torch.no_grad():
        x0 = tm.embed(tp, tbatch)
        xf, saved, _ = tm.run_segments(tp, x0)
        logits = tm.head_logits(tp, xf, tbatch)
    rows = SEQ + (8 if prefix else 0)
    assert tuple(x0.shape) == (BATCH, rows, 64)
    _close(x0, jx0, tol=1e-6, what="x0")
    _close(saved["blocks"].inputs, jtape, what="tape")
    assert tuple(saved["blocks"].extras.shape) == (BATCH, rows)
    _close(logits, jax.jit(jm.head_logits)(jp, jxf, jbatch), tol=LOGIT_TOL, what="logits")
    (jl, jmet), (tl, tmet) = jax.jit(jm.loss)(jp, jbatch), tm.loss(tp, tbatch)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)
    assert float(tmet["accuracy"]) == pytest.approx(float(jmet["accuracy"]), abs=1e-6)


def _recording(seen):
    @dataclasses.dataclass(frozen=True)
    class Recording(tph.PhotonicBackend):
        name: str = "recording"

        def matmul(self, a, b, cfg, key=None, *, mask=None):
            seen.append((tuple(a.shape), tuple(b.shape)))
            return tph.photonic_matmul(a, b, cfg, key=key, mask=mask)

    return Recording()


def test_bank_products_serving_and_training(pair):
    """Decode routes 7 products a layer and the head through the bank;
    a dfa step with the prefix projects 2 blocks and the embedding over
    every prefix and text row; the vision projection never reaches it."""
    _, (tm, tp, tf) = pair
    seen = []
    with torch.no_grad(), tph.forward_execution(tph.PRESETS["ideal"], _recording(seen)):
        tm.decode_step(torch.zeros((2, 1), dtype=torch.long), tm.init_caches(2, 8),
                       torch.zeros(2, dtype=torch.long))
    assert sorted(b for _, b in seen) == sorted((m, k) for _, m, k in tm.forward_gemm_specs())
    assert len(seen) == 2 * 7 + 1
    seen.clear()
    _, tbatch = _batch(tm)
    talgos.get("dfa").value_and_grad(tm, tdfa.DFAConfig(backend=_recording(seen)))(
        tp, tf, tbatch, 1)
    assert seen == [((BATCH * (8 + SEQ), 64), (64, 64))] * 3


@pytest.mark.parametrize("chunk", [3, 1])
def test_engine_matches_reference(pair, chunk):
    """Text-only serving: greedy tokens and engine stats equal to the
    reference's engine on the ideal bank, 2 slots for 3 requests; chunk 3
    and chunk 1 give the same tokens."""
    (jm, jp, _), (tm, _, _) = pair

    def serve(c):
        jeng = JEngine(jm, jp, batch_slots=2, max_len=32, prefill_chunk=c, backend="ref",
                       photonics=jph.PRESETS["ideal"])
        teng = TEngine(tm, batch_slots=2, max_len=32, prefill_chunk=c, backend="cuda",
                       photonics=tph.PRESETS["ideal"])
        jreqs = [JRequest(prompt=list(p), max_new=8) for p in PROMPTS]
        treqs = [TRequest(prompt=list(p), max_new=8) for p in PROMPTS]
        jeng.run(jreqs)
        teng.run(treqs)
        assert teng.stats == jeng.stats
        return [r.out for r in treqs], [r.out for r in jreqs]

    tout, jout = serve(chunk)
    assert tout == jout and all(len(o) == 8 for o in tout)
    if chunk == 3:
        assert serve(1)[0] == tout


def _assert_tree_close(tgrads, jgrads):
    expect = convert.state_dict_from_reference(_to_np(jgrads))
    assert sorted(tgrads) == sorted(expect)
    for k in expect:
        _close(tgrads[k], expect[k], what=k)


@pytest.mark.parametrize("algo,hardware,backend,prefix", [
    ("dfa", "ideal", "cuda", True), ("dfa", "quant", "ref", True),
    ("dfa-layerwise", "ideal", "cuda", True), ("bp", "ideal", "ref", True),
    ("dfa", "ideal", "cuda", False)])
def test_value_and_grad_matches_reference(pair, algo, hardware, backend, prefix):
    """Loss and every gradient within 1e-5 of their max, the vision stub's
    (``embed.vision.*``) included.  The loss reads only the text region, so
    the tapped error is zero on the prefix rows: DFA's per-row projections
    carry none of it to the stub, whose DFA gradient is exactly zero, as
    the reference's; bp trains it through the blocks' attention.
    Text-only, every algorithm gives the stub zeros."""
    (jm, jp, jf), (tm, tp, tf) = pair
    jbatch, tbatch = _batch(tm, prefix=prefix)
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
    vision = [k for k in tg if k.startswith("embed.vision.")]
    assert len(vision) == 4
    for k in vision:
        assert (float(tg[k].abs().max()) > 0) == (prefix and algo == "bp"), k
    assert float(tg["embed.tok.table"].abs().max()) > 0


def test_fused_step_matches_reference(pair):
    """dfa-fused with the prefix: the parameters and momentum after one
    SGDM step, the vision stub's included."""
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
    _assert_tree_close(tp2, jp2)
    _assert_tree_close(ts2["mom"], js2["mom"])


def test_emu_step_matches_reference(pair):
    """One dfa step with the prefix through the emulated banks on a quiet
    device (crosstalk on, a carried drift residual, no read / shot / drift
    noise, no heater DAC or ADC)."""
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


def test_launchers_run_internvl2_on_cpu(tmp_path, capsys):
    """``launch.train --arch internvl2-2b --smoke`` (patch embeddings in
    every batch, 0.1 × normal draws keyed (seed, step, 8)) and
    ``launch.serve --arch internvl2-2b`` (text-only)."""
    final = ttrain.main(["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "16",
                         "--device", "cpu", "--preset", "offchip_bpd", "--backend", "cuda",
                         "--steps", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[step 2/2]" in out and "[final]" in out and np.isfinite(final["ce_loss"])
    cfg = tconfigs.get(ARCH).make_smoke(device="meta").cfg
    b = ttrain.lm_batches(ARCH, cfg, 16, 2, 5)(3)
    expect = np.random.default_rng((5, 3, 8)).normal(size=(2, 8, 32)).astype("float32") * 0.1
    np.testing.assert_array_equal(b["patch_embeds"], expect)
    tserve.main(["--arch", ARCH, "--backend", "cuda", "--hardware", "offchip_bpd",
                 "--device", "cpu", "--requests", "3", "--max-new", "3"])
    assert "[serve] 3 requests, 9 tokens" in capsys.readouterr().out
