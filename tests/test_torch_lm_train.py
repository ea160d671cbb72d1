"""DFA training of the decoder LM: the port against the reference on the
CPU.  The smoke qwen1.5 LM (2 layers, d 64, vocab 128) with the
reference's parameters and feedback carried across by ``convert``, on
``MarkovTokens(128, seq 16, batch 4)``: one step's loss and every gradient
(the embedding table's DFA gradient included) for dfa, dfa-fused,
dfa-layerwise and bp, the emu backend on a quiet device, the projection
noise, the token stream, the launcher's LM branch and session."""

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
from repro.data import tokens as jtokens  # noqa: E402
from repro.hardware import drift as jdrift  # noqa: E402
from repro.hardware import mrr as jmrr  # noqa: E402
from repro.train import SGDM as JSGDM  # noqa: E402
from repro_torch import algos as talgos  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.algos import dfa as tdfa  # noqa: E402
from repro_torch.core import photonics as tph  # noqa: E402
from repro_torch.data import tokens as ttokens  # noqa: E402
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.hardware import drift as tdrift  # noqa: E402
from repro_torch.hardware import mrr as tmrr  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.train import SGDM, Trainer, TrainerConfig  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402

ARCH = "qwen1.5-0.5b"
VOCAB, SEQ, BATCH = 128, 16, 4
TOL = 1e-5  # of each tensor's max |value|: loss and gradients of a step (ROADMAP)
# a noise-off quantising bank: the DAC and the weight inscription round
QUANT = dict(noise_std=0.0, weight_bits=8, input_bits=8)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def lm_pair():
    """(reference model, params, feedback), (port model, params, feedback)
    with the same numbers."""
    jm = jconfigs.get(ARCH).make_smoke()
    key = jax.random.PRNGKey(0)
    jp = jm.init(key)
    jf = jalgos.get("dfa").init_extra_state(jm, jax.random.fold_in(key, 1), jdfa.DFAConfig())
    tm = tconfigs.get(ARCH).make_smoke(device="cpu")
    tp = convert.state_dict_from_reference(_to_np(jp))
    assert sorted(tp) == sorted(tm.param_dict())
    return (jm, jp, jf), (tm, tp, convert.feedback_from_reference(_to_np(jf)))


def _batch(step=0, seq=SEQ, batch=BATCH):
    b = jtokens.MarkovTokens(VOCAB, seq, batch, seed=0).batch(step)
    return {k: jnp.asarray(v) for k, v in b.items()}, to_device(b, "cpu")


def _assert_tree_close(tgrads, jgrads):
    """Every tensor within TOL of its max |value| (the reference's tree
    mapped onto the port's names)."""
    expect = convert.state_dict_from_reference(_to_np(jgrads))
    assert sorted(tgrads) == sorted(expect)
    for k in expect:
        e, g = _np(expect[k]), _np(tgrads[k])
        scale = max(np.abs(e).max(), 1e-30)
        assert np.abs(g - e).max() <= TOL * scale, (k, np.abs(g - e).max(), scale)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed,step", [
    (128, 16, 4, 0, 0), (128, 32, 8, 0, 99), (151936, 64, 2, 3, 7)])
def test_markov_tokens_equal_the_reference(vocab, seq, batch, seed, step):
    jb = jtokens.MarkovTokens(vocab, seq, batch, seed).batch(step)
    tb = ttokens.MarkovTokens(vocab, seq, batch, seed).batch(step)
    for k in ("tokens", "labels"):
        assert jb[k].dtype == tb[k].dtype == np.int32
        assert np.array_equal(jb[k], tb[k])
    assert np.array_equal(tb["tokens"][:, 1:], tb["labels"][:, :-1])


# ---------------------------------------------------------------------------
# the model's DFA hooks
# ---------------------------------------------------------------------------

def test_lm_forward_parts_match_reference(lm_pair):
    (jm, jp, _), (tm, tp, _) = lm_pair
    jbatch, tbatch = _batch()
    assert tm.d_tap == jm.d_tap == 64 and tm.error_tap == "hidden"
    (spec,) = tm.segment_specs()
    (jspec,) = jm.segment_specs()
    assert (spec.name, spec.n_layers, spec.d_inject) == (jspec.name, jspec.n_layers,
                                                         jspec.d_inject)
    jx0 = jm.embed(jp, jbatch)
    jxf, jsaved, _ = jm.run_segments(jp, jx0)
    x0 = tm.embed(tp, tbatch)
    xf, saved, auxes = tm.run_segments(tp, x0)
    np.testing.assert_allclose(_np(x0), np.asarray(jx0), rtol=0, atol=0)
    np.testing.assert_allclose(_np(saved["blocks"].inputs),
                               np.asarray(jsaved["blocks"].inputs), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(saved["blocks"].extras),
                                  np.asarray(jsaved["blocks"].extras))
    np.testing.assert_allclose(_np(xf), np.asarray(jxf), rtol=1e-5, atol=1e-5)
    assert set(auxes) == {"blocks"} and float(auxes["blocks"]) == 0.0
    jlogits = jm.head_logits(jp, jxf, jbatch)
    logits = tm.head_logits(tp, xf, tbatch)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), rtol=1e-5, atol=1e-5)
    (jl, _), (tl, _) = jm.loss(jp, jbatch), tm.loss(tp, tbatch)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)
    # the full serving forward is the training forward's logits
    tm.load_state_dict(tp)
    with torch.no_grad():
        np.testing.assert_allclose(_np(tm(tbatch["tokens"])), _np(logits), rtol=1e-5,
                                   atol=1e-5)


def test_lm_masked_loss_matches_reference(lm_pair):
    (jm, jp, _), (tm, tp, _) = lm_pair
    jbatch, tbatch = _batch()
    mask = (np.random.default_rng(3).random((BATCH, SEQ)) > 0.4).astype(np.float32)
    jbatch["mask"], tbatch["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    (jl, jmet), (tl, tmet) = jm.loss(jp, jbatch), tm.loss(tp, tbatch)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)
    assert float(tmet["accuracy"]) == pytest.approx(float(jmet["accuracy"]), abs=1e-6)


def test_single_layer_segment_names_its_layer():
    """A one-layer stack still keys its block ``blocks.0.``."""
    cfg = dataclasses.replace(tconfigs.get(ARCH).make_smoke(device="meta").cfg, n_layers=1)
    model = TransformerLM(cfg, device="cpu").init(0)
    (spec,) = model.segment_specs()
    params = model.param_dict()
    assert spec.layer_prefix(0) == "blocks.0."
    assert sorted(spec.layer_params(params, 0)) == sorted(
        k[len("blocks.0."):] for k in params if k.startswith("blocks.0."))


# ---------------------------------------------------------------------------
# one training step against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo,hardware,backend,compress", [
    ("dfa", "ideal", "cuda", "none"), ("dfa", "quant", "cuda", "none"),
    ("dfa", "ideal", "ref", "none"), ("dfa", "quant", "ref", "int8"),
    ("dfa-fused", "ideal", "cuda", "none"), ("dfa-layerwise", "ideal", "cuda", "none"),
    ("dfa-layerwise", "quant", "ref", "none")])
def test_lm_value_and_grad_matches_reference(lm_pair, algo, hardware, backend, compress):
    """Loss and every gradient, the embedding table's included; the port's
    ``cuda`` backend runs its kernel's plain version on the CPU, the
    reference its ``ref`` backend."""
    (jm, jp, jf), (tm, tp, tf) = lm_pair
    jbatch, tbatch = _batch()
    if hardware == "quant":
        jhw, thw = jph.PhotonicConfig(**QUANT), tph.PhotonicConfig(**QUANT)
    else:
        jhw, thw = jph.PRESETS["ideal"], tph.PRESETS["ideal"]
    jcfg = jdfa.DFAConfig(photonics=jhw, backend="ref", error_compress=compress)
    tcfg = tdfa.DFAConfig(photonics=thw, backend=backend, error_compress=compress)
    (jl, jmet), jg = jalgos.get(algo).value_and_grad(jm, jcfg)(
        jp, jf, jbatch, jax.random.PRNGKey(1))
    (tl, tmet), tg = talgos.get(algo).value_and_grad(tm, tcfg)(tp, tf, tbatch, 1)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)
    assert set(tmet) == set(jmet)
    assert float(tmet["accuracy"]) == pytest.approx(float(jmet["accuracy"]), abs=1e-6)
    _assert_tree_close(tg, jg)
    assert float(torch.abs(tg["embed.tok.table"]).max()) > 0  # the table trains


def test_lm_bp_gradients_match_jax_grad(lm_pair):
    (jm, jp, jf), (tm, tp, tf) = lm_pair
    jbatch, tbatch = _batch()
    jl, jg = jax.value_and_grad(lambda p: jm.loss(p, jbatch)[0])(jp)
    (tl, _), tg = talgos.get("bp").value_and_grad(tm, tdfa.DFAConfig())(tp, tf, tbatch, 1)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)
    _assert_tree_close(tg, jg)


def test_lm_fused_step_matches_reference(lm_pair):
    """dfa-fused: the parameters and momentum after one SGDM step."""
    (jm, jp, jf), (tm, tp, tf) = lm_pair
    jbatch, tbatch = _batch()
    jopt, topt = JSGDM(lr=0.05, momentum=0.9), SGDM(lr=0.05, momentum=0.9)
    jmom = jax.tree_util.tree_map(lambda x: x + 0.01, jopt.init(jp)["mom"])
    js = {"mom": jmom, "step": jnp.int32(3)}
    ts = {"mom": convert.state_dict_from_reference(_to_np(jmom)), "step": 3}
    jp2, js2, jl = jdfa.make_fused_train_step(jm, jdfa.DFAConfig(), jopt)(
        jp, jf, js, jbatch, jax.random.PRNGKey(2))
    tp2, ts2, tl = talgos.get("dfa-fused").fused_step(tm, tdfa.DFAConfig(backend="cuda"),
                                                      topt)(tp, tf, ts, tbatch, 2)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)
    assert ts2["step"] == int(js2["step"]) == 4
    _assert_tree_close(tp2, jp2)
    _assert_tree_close(ts2["mom"], js2["mom"])
    # and it equals dfa followed by SGDM.update, the embedding included
    (_, _), g = talgos.get("dfa").value_and_grad(tm, tdfa.DFAConfig(backend="cuda"))(
        tp, tf, tbatch, 2)
    tp3, ts3, _ = topt.update(g, ts, tp)
    for k in tp3:
        torch.testing.assert_close(tp2[k], tp3[k], rtol=0, atol=0)
        torch.testing.assert_close(ts2["mom"][k], ts3["mom"][k], rtol=0, atol=0)


def test_lm_emu_step_matches_reference(lm_pair):
    """One dfa step through the emulated banks on a quiet device (no read,
    shot or drift noise, no heater DAC or ADC; crosstalk on, a carried
    drift residual), the port's kernel path (plain version on the CPU)
    against the reference's unfused chain."""
    (jm, jp, jf), (tm, tp, tf) = lm_pair
    jbatch, tbatch = _batch()
    mkw = dict(drift_sigma=0.0, heater_bits=None, crosstalk=0.01)
    jc = jph.PhotonicConfig(noise_std=0.0, mrr=jmrr.MRRConfig(**mkw))
    tc = tph.PhotonicConfig(noise_std=0.0, mrr=tmrr.MRRConfig(**mkw))
    r = np.random.default_rng(50).uniform(-0.1, 0.1, (1, 50, 20)).astype(np.float32)
    jhw = {"drift": jnp.asarray(r), "cal": jnp.zeros((1, 50, 20), jnp.float32)}
    thw = convert.hw_state_from_reference(_to_np(jhw))
    jcfg = jdfa.DFAConfig(photonics=jc, backend=jph.EmulatedMRRBackend(emu_kernel="ref"))
    tcfg = tdfa.DFAConfig(photonics=tc, backend=tph.EmulatedMRRBackend(emu_kernel="cuda"))
    with jdrift.use_state(jhw):
        (jl, _), jg = jalgos.get("dfa").value_and_grad(jm, jcfg)(
            jp, jf, jbatch, jax.random.PRNGKey(1))
    with tdrift.use_state(thw):
        (tl, _), tg = talgos.get("dfa").value_and_grad(tm, tcfg)(tp, tf, tbatch, 1)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)
    _assert_tree_close(tg, jg)


def test_lm_projection_noise_matches_model(lm_pair):
    """On offchip_bpd the δ of every DFA projection of an LM step (both
    blocks and the embedding: 3 × 4096 samples) deviates from the exact
    projection with σ = noise_sigma_total(d_tap, max|e|, max|B|) within 5%."""
    _, (tm, tp, tf) = lm_pair
    _, tbatch = _batch(seq=64, batch=16)
    cfg = tph.PRESETS["offchip_bpd"]
    fwd = tdfa.forward_with_error(tm, tp, tdfa.DFAConfig(), tbatch)
    e = fwd["e_tap"].reshape(-1, tm.d_tap)
    z = []
    for i, bmat in enumerate([tf["blocks"][0], tf["blocks"][1], tf["embed"]]):
        exact = tph.photonic_project(e, bmat, tph.PRESETS["ideal"], backend="cuda")
        noisy = tph.photonic_project(e, bmat, cfg, 40 + i, backend="cuda")
        sigma = tph.noise_sigma_total(tm.d_tap, float(e.abs().max()), float(bmat.abs().max()),
                                      cfg)
        z.append(_np(noisy - exact).ravel() / sigma)
    z = np.concatenate(z)
    assert z.size == 3 * 16 * 64 * 64
    assert abs(z.std() - 1) < 0.05


# ---------------------------------------------------------------------------
# training, the launcher and the session
# ---------------------------------------------------------------------------

def test_lm_dfa_reduces_loss_on_markov_stream():
    """The port's copy of tests/test_system.py's test: the smoke LM learns
    the successor structure with DFA in 30 steps."""
    model = tconfigs.get(ARCH).make_smoke(device="cpu")
    gen = ttokens.MarkovTokens(vocab_size=128, seq_len=32, batch_size=8, seed=0)
    tr = Trainer(model, TrainerConfig(algo="dfa", optimizer=SGDM(lr=0.1, momentum=0.9),
                                      log_every=10**9), device="cpu")
    state = tr.init_state()
    _, m0 = tr.step(state, gen.batch(0))
    state, _ = tr.fit(gen.batch, total_steps=30, verbose=False)
    _, m1 = tr.step(state, gen.batch(99))
    assert float(m1["ce_loss"]) < float(m0["ce_loss"])


@pytest.mark.parametrize("algo", ["dfa", "dfa-layerwise", "bp"])
def test_lm_session_trains_on_cpu(algo):
    s = api.build_session(arch=ARCH, smoke=True, algo=algo, hardware="offchip_bpd",
                          backend="cuda", device="cpu")
    assert isinstance(s.trainer, Trainer)
    gen = ttokens.MarkovTokens(VOCAB, SEQ, BATCH, seed=1)
    state, metrics = s.fit(gen.batch, total_steps=3, verbose=False)
    assert state["step"] == 3 and state["opt"]["step"] == 3
    assert np.isfinite(float(metrics["loss"]))
    assert all(bool(torch.isfinite(p).all()) for p in state["params"].values())
    ev = s.evaluate(state, [gen.batch(100)])
    assert set(ev) == {"ce_loss", "accuracy", "aux_loss"}


def test_launcher_trains_the_lm_and_resumes(tmp_path, capsys):
    argv = ["--arch", ARCH, "--batch", "4", "--seq", "16", "--device", "cpu",
            "--preset", "offchip_bpd", "--backend", "cuda"]
    final = tlaunch.main(argv + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "[step 2/2]" in out and "[final]" in out and np.isfinite(final["ce_loss"])
    # interrupted at 2 and resumed to 4 from --ckpt-dir, against 4 straight
    tlaunch.main(argv + ["--steps", "4", "--ckpt-dir", str(tmp_path / "a")])
    tlaunch.main(argv + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    tlaunch.main(argv + ["--steps", "4", "--ckpt-dir", str(tmp_path / "b")])
    snaps = {}
    for run in ("a", "b"):
        mgr = tckpt.CheckpointManager(str(tmp_path / run))
        assert mgr.latest_step() == 4
        snaps[run], _ = tckpt.load(mgr._path(4))
    assert sorted(snaps["a"]) == sorted(snaps["b"])
    for k, v in snaps["a"].items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, snaps["b"][k]), k
        else:
            assert v == snaps["b"][k], k
