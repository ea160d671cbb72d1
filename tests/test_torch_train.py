"""The port's DFA training path against the reference on the CPU: data,
feedback, activations and loss, the dfa / dfa-fused / bp gradients with
the reference's parameters and feedback carried across by ``convert``,
the optimizers and schedules, the trainer and its entry points."""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import algos as jalgos  # noqa: E402
from repro.algos import dfa as jdfa  # noqa: E402
from repro.core import feedback as jfb  # noqa: E402
from repro.data import mnist as jmnist  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import base as jbase  # noqa: E402
from repro.models.mlp import MLPClassifier as JMLP  # noqa: E402
from repro.nn import activations as jact  # noqa: E402
from repro.train import SGDM as JSGDM  # noqa: E402
from repro.train import schedule as jschedule  # noqa: E402
from repro_torch import algos as talgos  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.algos import dfa as tdfa  # noqa: E402
from repro_torch.core import feedback as tfb  # noqa: E402
from repro_torch.core import photonics as tph  # noqa: E402
from repro_torch.data import mnist as tmnist  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import base as tbase  # noqa: E402
from repro_torch.models.mlp import MLPClassifier as TMLP  # noqa: E402
from repro_torch.nn import activations as tact  # noqa: E402
from repro_torch.train import SGDM, AdamW, Trainer, TrainerConfig, schedule  # noqa: E402
from repro_torch.train.optimizer import clip_by_global_norm  # noqa: E402
from repro_torch.utils import prng as tprng  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# (in_dim, hidden): the smoke MLP and a wider one
MLPS = {"smoke": (64, (32, 32)), "wide": (64, (128, 128))}
TOL = 1e-5  # loss and gradients of a training step (ROADMAP)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(name):
    """The reference's MLP with its params and feedback, and the port's with
    the same numbers carried across."""
    in_dim, hidden = MLPS[name]
    jm = JMLP(in_dim=in_dim, hidden=hidden)
    key = jax.random.PRNGKey(0)
    params = jm.init(key)
    fb = jalgos.get("dfa").init_extra_state(jm, jax.random.fold_in(key, 1), jdfa.DFAConfig())
    tm = TMLP(in_dim=in_dim, hidden=hidden, device="cpu")
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return (jm, params, fb), (tm, convert.state_dict_from_reference(to_np(params)),
                              convert.feedback_from_reference(to_np(fb)))


def _batch(in_dim, n=32, seed=0):
    x, y = jmnist.procedural_digits(n, seed=seed)
    x = x[:, :in_dim]
    return ({"x": jnp.asarray(x), "y": jnp.asarray(y)},
            {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()})


def _assert_tree_close(tgrads, jgrads, tol=TOL):
    expect = convert.state_dict_from_reference(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(tgrads) == sorted(expect)
    for k in expect:
        np.testing.assert_allclose(_np(tgrads[k]), _np(expect[k]), rtol=tol, atol=tol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,seed", [(64, 0), (300, 10_000)])
def test_procedural_digits_equal_byte_for_byte(n, seed):
    jx, jy = jmnist.procedural_digits(n, seed=seed)
    tx, ty = tmnist.procedural_digits(n, seed=seed)
    assert jx.dtype == tx.dtype and jy.dtype == ty.dtype
    assert jx.tobytes() == tx.tobytes() and jy.tobytes() == ty.tobytes()


def test_array_classification_batches_equal():
    x, y = tmnist.procedural_digits(200, seed=1)
    jp = jpipeline.ArrayClassification(x, y, batch_size=32, seed=4)
    tp = tpipeline.ArrayClassification(x, y, batch_size=32, seed=4)
    for step in (0, 5, 6, 13):  # crosses an epoch boundary (6 steps per epoch)
        jb, tb = jp.batch(step), tp.batch(step)
        assert np.array_equal(jb["x"], tb["x"]) and np.array_equal(jb["y"], tb["y"])
    assert [b["y"].tolist() for b in jp.eval_batches(x, y, 64)] == \
        [b["y"].tolist() for b in tp.eval_batches(x, y, 64)]


def test_prefetcher_puts_batches_on_the_device_in_order():
    pipe = tpipeline.ArrayClassification(*tmnist.procedural_digits(128, 0), batch_size=16)
    put = lambda b: tpipeline.to_device(b, "cpu")  # noqa: E731
    feed = tpipeline.DevicePrefetcher(pipe.batch, put, depth=2, limit=8)
    for step in range(8):
        got = feed(step)
        assert got["y"].dtype == torch.int64 and got["x"].dtype == torch.float32
        assert np.array_equal(got["y"].numpy(), pipe.batch(step)["y"])
    assert not feed._buf


# ---------------------------------------------------------------------------
# activations, loss, feedback, prng
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(jact.ACTIVATIONS))
def test_activations_and_derivatives_match(name):
    # f32 rounding: the two frameworks evaluate tanh-gelu in other orders
    tol = dict(rtol=1e-5, atol=1e-5)
    x = np.linspace(-4, 4, 101).astype(np.float32)  # includes 0.0
    jg, jd = jact.get(name)
    tg, td = tact.get(name)
    np.testing.assert_allclose(_np(tg(torch.from_numpy(x))), np.asarray(jg(jnp.asarray(x))),
                               **tol)
    np.testing.assert_allclose(_np(td(torch.from_numpy(x))), np.asarray(jd(jnp.asarray(x))),
                               **tol)
    # autograd of g equals the reference's jax.grad, ties included
    xt = torch.from_numpy(x).requires_grad_()
    (gx,) = torch.autograd.grad(tg(xt).sum(), xt)
    expect = jax.grad(lambda v: jg(v).sum())(jnp.asarray(x))
    np.testing.assert_allclose(_np(gx), np.asarray(expect), **tol)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches(smoothing, masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (4, 6)).astype(np.int32)
    mask = (rng.random((4, 6)) > 0.3).astype(np.float32) if masked else None
    jl, jm = jbase.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                      mask=None if mask is None else jnp.asarray(mask),
                                      label_smoothing=smoothing)
    tl, tm = tbase.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                      mask=None if mask is None else torch.from_numpy(mask),
                                      label_smoothing=smoothing)
    assert float(tl) == pytest.approx(float(jl), abs=1e-6)
    assert float(tm["accuracy"]) == pytest.approx(float(jm["accuracy"]), abs=1e-6)


@pytest.mark.parametrize("init", ["gaussian", "uniform", "orthogonal"])
@pytest.mark.parametrize("ternary", [False, True])
def test_feedback_statistics_match_reference(init, ternary):
    """Same distribution as the reference's feedback (other streams)."""
    jc = jfb.FeedbackConfig(init=init, ternary=ternary)
    tc = tfb.FeedbackConfig(init=init, ternary=ternary)
    jb = np.asarray(jfb.make_feedback(jax.random.PRNGKey(0), 3, 200, 10, jc))
    tb = _np(tfb.make_feedback(5, 3, 200, 10, tc, "cpu"))
    assert tb.shape == jb.shape == (3, 200, 10)
    if ternary:
        # {-c, 0, +c} with c set per layer
        assert all(len(np.unique(layer)) == 3 for layer in tb)
    if ternary and init == "orthogonal":
        # the threshold keeps only a few entries of either package's draw:
        # too few for the moments below
        return
    assert abs(tb.std() / jb.std() - 1) < 0.1
    assert abs(tb.mean()) < 4 * tb.std() / np.sqrt(tb.size)
    if ternary:
        assert abs((tb == 0).mean() - (jb == 0).mean()) < 0.05
    if init == "orthogonal" and not ternary:
        cols = tb[0] / np.linalg.norm(tb[0], axis=0)
        np.testing.assert_allclose(cols.T @ cols, np.eye(10), atol=1e-5)


def test_feedback_shared_and_selection():
    tc = tfb.FeedbackConfig(shared=True)
    b = tfb.make_feedback(5, 4, 16, 10, tc, "cpu")
    assert b.shape == (1, 16, 10)
    assert torch.equal(tfb.feedback_for(b, 3), b[0])
    assert torch.equal(tfb.make_feedback(5, 4, 16, 10, tc, "cpu"), b)  # deterministic


def test_init_feedback_layout_matches_reference():
    (jm, _, fb), (tm, _, _) = _pair("smoke")
    tfbk = tdfa.init_feedback(tm, 3, tdfa.DFAConfig())
    assert {k: tuple(v.shape) for k, v in tfbk.items()} == \
        {k: tuple(v.shape) for k, v in fb.items()}


def test_step_key_is_a_pure_function_of_seed_and_step():
    assert tprng.step_key(0, 5, "noise") == tprng.step_key(0, 5, "noise")
    keys = {tprng.step_key(0, s, "noise") for s in range(100)}
    assert len(keys) == 100
    assert tprng.step_key(0, 5, "noise") != tprng.step_key(0, 5)
    assert tprng.step_key(0, 5, "noise") != tprng.step_key(1, 5, "noise")


# ---------------------------------------------------------------------------
# gradients against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mlp", list(MLPS))
@pytest.mark.parametrize("algo,compress,backend", [
    ("dfa", "none", "ref"), ("dfa", "none", "cuda"), ("dfa", "ternary", "ref"),
    ("dfa", "int8", "cuda"), ("dfa-fused", "none", "cuda"), ("bp", "none", "ref")])
def test_value_and_grad_matches_reference(mlp, algo, compress, backend):
    (jm, jp, jf), (tm, tp, tf) = _pair(mlp)
    jbatch, tbatch = _batch(tm.in_dim)
    jcfg = jdfa.DFAConfig(error_compress=compress, backend="ref")
    tcfg = tdfa.DFAConfig(error_compress=compress, backend=backend)
    (jl, jmet), jg = jalgos.get(algo).value_and_grad(jm, jcfg)(
        jp, jf, jbatch, jax.random.PRNGKey(1))
    (tl, tmet), tg = talgos.get(algo).value_and_grad(tm, tcfg)(tp, tf, tbatch, 1)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)
    assert float(tmet["accuracy"]) == pytest.approx(float(jmet["accuracy"]), abs=1e-6)
    _assert_tree_close(tg, jg)


def test_grad_alignment_matches_reference():
    (jm, jp, jf), (tm, tp, tf) = _pair("wide")
    jbatch, tbatch = _batch(tm.in_dim)
    (_, _), jd = jalgos.get("dfa").value_and_grad(jm, jdfa.DFAConfig())(
        jp, jf, jbatch, jax.random.PRNGKey(1))
    (_, _), jb = jalgos.get("bp").value_and_grad(jm, jdfa.DFAConfig())(
        jp, jf, jbatch, jax.random.PRNGKey(1))
    (_, _), td = talgos.get("dfa").value_and_grad(tm, tdfa.DFAConfig())(tp, tf, tbatch, 1)
    (_, _), tb = talgos.get("bp").value_and_grad(tm, tdfa.DFAConfig())(tp, tf, tbatch, 1)
    expect = jdfa.grad_alignment(jd, jb)
    got = tdfa.grad_alignment(td, tb)
    assert set(got) == {"h0", "h1", "head"}
    for name in got:
        assert float(got[name]) == pytest.approx(float(expect[name]), abs=1e-5)
    assert float(got["head"]) == pytest.approx(1.0, abs=1e-6)  # the head is exact


def test_sgdm_steps_and_fused_step_match_reference():
    """Five SGDM steps of dfa on the ideal preset, then one dfa-fused step."""
    (jm, jp, jf), (tm, tp, tf) = _pair("wide")
    jopt, topt = JSGDM(lr=0.05, momentum=0.9), SGDM(lr=0.05, momentum=0.9)
    jvg = jalgos.get("dfa").value_and_grad(jm, jdfa.DFAConfig())
    tvg = talgos.get("dfa").value_and_grad(tm, tdfa.DFAConfig())
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        jbatch, tbatch = _batch(tm.in_dim, seed=step)
        (_, _), jg = jvg(jp, jf, jbatch, jax.random.PRNGKey(step))
        (_, _), tg = tvg(tp, tf, tbatch, step)
        jp, js, _ = jopt.update(jg, js, jp)
        tp, ts, _ = topt.update(tg, ts, tp)
    assert ts["step"] == int(js["step"]) == 5
    _assert_tree_close(tp, jp)
    _assert_tree_close(ts["mom"], js["mom"])
    jbatch, tbatch = _batch(tm.in_dim, seed=9)
    jp2, js2, jl = jdfa.make_fused_train_step(jm, jdfa.DFAConfig(), jopt)(
        jp, jf, js, jbatch, jax.random.PRNGKey(9))
    tp2, ts2, tl = talgos.get("dfa-fused").fused_step(tm, tdfa.DFAConfig(), topt)(
        tp, tf, ts, tbatch, 9)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)
    _assert_tree_close(tp2, jp2)
    _assert_tree_close(ts2["mom"], js2["mom"])


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_offchip_projection_noise_matches_model(backend):
    """σ of (noisy − exact) DFA projection is noise_sigma_total·s_e·s_B
    within 5% (64·800·4 samples at K = 10: one bank panel)."""
    rng = np.random.default_rng(6)
    e = torch.from_numpy(rng.standard_normal((256, 10)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((800, 10)).astype(np.float32))
    cfg = tph.PRESETS["offchip_bpd"]
    exact = tph.photonic_project(e, b, tph.PRESETS["ideal"], backend=backend)
    noisy = tph.photonic_project(e, b, cfg, 17, backend=backend)
    err = _np(noisy - exact).ravel()
    expect = tph.noise_sigma_total(10, e.abs().max().item(), b.abs().max().item(), cfg)
    assert abs(err.std() / expect - 1) < 0.05
    again = tph.photonic_project(e, b, cfg, 17, backend=backend)
    assert torch.equal(noisy, again)


# ---------------------------------------------------------------------------
# optimizers and schedules: tests/test_train.py's hand values
# ---------------------------------------------------------------------------

def test_sgdm_matches_manual():
    opt = SGDM(lr=0.1, momentum=0.9)
    p = {"w": torch.tensor([1.0, 2.0])}
    g = {"w": torch.tensor([0.5, -1.0])}
    s = opt.init(p)
    p1, s1, _ = opt.update(g, s, p)
    np.testing.assert_allclose(_np(p1["w"]), [1 - 0.05, 2 + 0.1], rtol=1e-6)
    p2, s2, _ = opt.update(g, s1, p1)
    m2 = 0.9 * np.array([0.5, -1.0]) + np.array([0.5, -1.0])
    np.testing.assert_allclose(_np(p2["w"]), _np(p1["w"]) - 0.1 * m2, rtol=1e-6)
    assert torch.equal(p["w"], torch.tensor([1.0, 2.0]))  # inputs left as they were


def test_sgdm_options_match_reference():
    rng = np.random.default_rng(2)
    p = {"w": rng.standard_normal(5).astype(np.float32)}
    g = {"w": (3 * rng.standard_normal(5)).astype(np.float32)}
    kw = dict(lr=0.1, momentum=0.9, weight_decay=0.01, nesterov=True, clip_norm=1.0)
    jo, to = JSGDM(**kw), SGDM(**kw)
    jpp, js = {"w": jnp.asarray(p["w"])}, None
    tpp = {"w": torch.from_numpy(p["w"])}
    js, ts = jo.init(jpp), to.init(tpp)
    for _ in range(2):
        jpp, js, jinfo = jo.update({"w": jnp.asarray(g["w"])}, js, jpp)
        tpp, ts, tinfo = to.update({"w": torch.from_numpy(g["w"])}, ts, tpp)
    np.testing.assert_allclose(_np(tpp["w"]), np.asarray(jpp["w"]), rtol=1e-6, atol=1e-6)
    assert float(tinfo["grad_norm"]) == pytest.approx(float(jinfo["grad_norm"]), rel=1e-6)


def test_adamw_first_step_is_lr_sized():
    opt = AdamW(lr=1e-3, weight_decay=0.0, clip_norm=None)
    p = {"w": torch.tensor([0.0])}
    g = {"w": torch.tensor([10.0])}
    p1, _, _ = opt.update(g, opt.init(p), p)
    np.testing.assert_allclose(_np(p1["w"]), [-1e-3], rtol=1e-3)


def test_adamw_matches_reference():
    from repro.train import AdamW as JAdamW

    rng = np.random.default_rng(3)
    p = rng.standard_normal(7).astype(np.float32)
    jo, to = JAdamW(lr=1e-2), AdamW(lr=1e-2)
    jpp, tpp = {"w": jnp.asarray(p)}, {"w": torch.from_numpy(p)}
    js, ts = jo.init(jpp), to.init(tpp)
    for i in range(3):
        g = rng.standard_normal(7).astype(np.float32)
        jpp, js, _ = jo.update({"w": jnp.asarray(g)}, js, jpp)
        tpp, ts, _ = to.update({"w": torch.from_numpy(g)}, ts, tpp)
    np.testing.assert_allclose(_np(tpp["w"]), np.asarray(jpp["w"]), rtol=1e-5, atol=1e-6)


def test_clip_by_global_norm():
    g = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert float(torch.sqrt(clipped["a"] ** 2 + clipped["b"] ** 2)[0]) == pytest.approx(1.0)


def test_schedules():
    s = schedule.warmup_cosine(1.0, 10, 110, final_frac=0.1)
    assert s(0) == 0.0
    assert s(10) == pytest.approx(1.0)
    assert s(110) == pytest.approx(0.1, abs=1e-3)
    assert schedule.linear_decay(2.0, 100)(50) == pytest.approx(1.0)
    assert schedule.constant(0.3)(7) == pytest.approx(0.3)
    js = jschedule.warmup_cosine(1.0, 10, 110, final_frac=0.1)
    for step in (0, 3, 10, 47, 110, 200):
        assert s(step) == pytest.approx(float(js(jnp.int32(step))), abs=1e-6)


# ---------------------------------------------------------------------------
# trainer, session, launcher
# ---------------------------------------------------------------------------

def test_session_defaults_equal_the_reference():
    from repro import api as japi

    tsig = dict(_defaults(api.build_session))
    jsig = dict(_defaults(japi.build_session))
    for name in ("arch", "algo", "hardware", "backend", "seed", "smoke", "error_compress",
                 "freeze_norms", "microbatches", "prefetch", "log_every", "log_path",
                 "step_deadline_s"):
        assert tsig[name] == jsig[name], name
    s = api.build_session(device="cpu")
    js = japi.build_session(data_parallel=False)
    assert s.config.optimizer == SGDM(lr=0.01, momentum=0.9)
    assert dataclasses.asdict(s.config.optimizer) == dataclasses.asdict(js.config.optimizer)
    assert isinstance(s.model, TMLP) and s.model.hidden == (800, 800)
    assert s.config.algo == "dfa" and s.photonics == tph.PRESETS["ideal"]


def _defaults(fn):
    import inspect

    return [(n, p.default) for n, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty]


def test_microbatch_accumulation_matches_full_batch():
    model = TMLP(in_dim=8, hidden=(16,), n_classes=4, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32)),
             "y": torch.from_numpy(rng.integers(0, 4, 32))}
    t1 = Trainer(model, TrainerConfig(optimizer=SGDM(lr=0.0), microbatches=1, seed=3),
                 device="cpu")
    t4 = Trainer(model, TrainerConfig(optimizer=SGDM(lr=0.0), microbatches=4, seed=3),
                 device="cpu")
    _, m1 = t1.step(t1.init_state(), batch)
    _, m4 = t4.step(t4.init_state(), batch)
    assert abs(float(m1["ce_loss"]) - float(m4["ce_loss"])) < 1e-5
    with pytest.raises(ValueError, match="microbatches"):
        Trainer(model, TrainerConfig(microbatches=5), device="cpu").step(
            t1.init_state(), batch)


def test_straggler_deadline_raises():
    model = TMLP(in_dim=8, hidden=(16,), n_classes=4, device="cpu")
    tr = Trainer(model, TrainerConfig(step_deadline_s=0.0), device="cpu")
    with pytest.raises(TimeoutError):
        tr.step(tr.init_state(), {"x": np.zeros((4, 8), np.float32),
                                  "y": np.zeros((4,), np.int32)})


def test_fit_logs_csv_and_is_a_pure_function_of_seed(tmp_path):
    x, y = tmnist.procedural_digits(256, seed=0)
    pipe = tpipeline.ArrayClassification(x[:, :64], y, 32, seed=0)
    runs = []
    for i in range(2):
        s = api.build_session(smoke=True, hardware="offchip_bpd", backend="cuda", seed=2,
                              log_every=4, log_path=str(tmp_path / f"log{i}.csv"),
                              device="cpu")
        state, metrics = s.fit(pipe.batch, 8, verbose=False)
        assert state["step"] == 8 and state["opt"]["step"] == 8
        runs.append(state["params"])
        ev = s.evaluate(state, pipe.eval_batches(x[:, :64], y, 64))
        assert set(ev) == {"ce_loss", "accuracy"} and np.isfinite(ev["ce_loss"])
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k])
    lines = (tmp_path / "log0.csv").read_text().splitlines()
    assert lines[0] == "step,accuracy,ce_loss,loss,lr" and len(lines) == 3
    assert lines[1].startswith("4,") and lines[2].startswith("8,")


def test_noisy_training_moves_with_the_key():
    """offchip_bpd noise is drawn per (seed, step): another seed trains to
    other parameters; ideal hardware draws none."""
    x, y = tmnist.procedural_digits(128, seed=0)
    pipe = tpipeline.ArrayClassification(x[:, :64], y, 32, seed=0)

    def params(hardware, seed):
        s = api.build_session(smoke=True, hardware=hardware, backend="cuda", seed=0,
                              device="cpu")
        tr = Trainer(s.model, dataclasses.replace(s.config, seed=seed), device="cpu")
        state = tr.init_state(seed=0)
        for step in range(3):
            state, _ = tr.step(state, pipe.batch(step))
        return state["params"]["h0.weight"]

    assert not torch.equal(params("offchip_bpd", 1), params("offchip_bpd", 2))
    assert torch.equal(params("ideal", 1), params("ideal", 2))


def test_launcher_trains_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(tmnist, "load", lambda seed=0: {
        "train": tmnist.procedural_digits(512, seed), "test": tmnist.procedural_digits(256, 1),
        "source": "procedural"})
    ev = tlaunch.main(["--arch", "mnist_mlp", "--smoke", "--steps", "4", "--device", "cpu",
                       "--backend", "cuda", "--preset", "offchip_bpd"])
    out = capsys.readouterr().out
    assert "[data] source=procedural" in out and "[step 4/4]" in out and "[eval]" in out
    assert 0.0 <= ev["accuracy"] <= 1.0


def test_language_models_do_not_train_yet():
    """The language models train now (a trainer for every DFAModel); a
    model that is only a ServingModel still refuses every training call."""
    from repro_torch.models.base import ServingModel

    s = api.build_session(arch="qwen1.5-0.5b", smoke=True, device="cpu")
    assert isinstance(s.trainer, Trainer) and s.config.algo == "dfa"
    assert s.init_state()["step"] == 0
    serving_only = ServingModel()
    with pytest.raises(TypeError, match="not a DFAModel"):
        api.build_session(arch=serving_only, device="cpu")
    s = api.build_session(arch=serving_only, algo="bp", device="cpu")
    assert s.trainer is None
    with pytest.raises(TypeError, match="serves only"):
        s.init_state()


def test_convert_maps_the_full_mlp_layout():
    jm = JMLP()
    shapes = convert.torch_shapes(jm.param_shapes() if hasattr(jm, "param_shapes") else
                                  jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    tm = TMLP(device="meta")
    assert shapes == {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert shapes["h0.weight"] == (800, 784) and shapes["head.weight"] == (10, 800)


def test_training_entry_points_never_move_to_cpu_on_their_own():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.build_session(arch="mnist_mlp")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.build_session()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tconfigs.get("mnist_mlp").make_smoke()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TMLP(in_dim=8, hidden=(4,), device="cpu"), TrainerConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", "mnist_mlp", "--smoke"])


def test_chip_smoke_imports_neither_jax_nor_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "repro_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots
