"""The port's data parallelism on four gloo ranks on the CPU, against the
reference and the port's own one-process step.

Each scenario group is one spawn of four ranks (``tests/_dist_ranks.py``)
that runs every check of the group and returns its numbers; the tests
below read them.  Noise off, the four-rank loss and gradients equal the
reference's single-device ``value_and_grad`` (mnist_mlp smoke, dfa and bp)
and its ``fit`` within 1e-5.  Noise on (offchip_bpd in input mode, and
emu_offchip through the unfused chain and the emu kernel's plain version)
and for the smoke qwen1.5's dfa step, the four-rank step equals the port's
one-process step within 1e-5, and a rank that takes s_a or its noise from
its own rows fails that check.  Microbatches compose as the global batch's, an
indivisible batch is replicated (the report's multiplier 1), the emu
hardware state agrees on every rank."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _dist_ranks as ranks  # noqa: E402
from repro import algos as jalgos  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.algos import dfa as jdfa  # noqa: E402
from repro.data import mnist as jmnist  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.models.mlp import MLPClassifier as JMLP  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

WORLD = 4
TOL = 1e-5  # loss and gradients of a step (ROADMAP)
FIT_STEPS = 4
LM_VOCAB, LM_SEQ, LM_BATCH = 128, 16, 8
LM_HARDWARE = ["ideal", "offchip_bpd"]


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _np_sd(tree):
    return {k: v.numpy() for k, v in convert.state_dict_from_reference(_to_np(tree)).items()}


def _np_fb(tree):
    return {k: v.numpy() for k, v in convert.feedback_from_reference(_to_np(tree)).items()}


def _close(got: dict, expect: dict, tol=TOL):
    """Every tensor within ``tol`` of its max |value|."""
    assert sorted(got) == sorted(expect)
    for k in expect:
        e, g = np.asarray(expect[k]), np.asarray(got[k])
        scale = max(np.abs(e).max(), 1e-30)
        assert np.abs(g - e).max() <= tol * scale, (k, np.abs(g - e).max(), scale)


def _worst(got: dict, expect: dict) -> float:
    return max(np.abs(np.asarray(got[k]) - expect[k]).max() / max(np.abs(expect[k]).max(), 1e-30)
               for k in expect)


def _same_on_every_rank(results, key):
    loss0, _, g0 = results[0][key]
    for r in results[1:]:
        loss, _, g = r[key]
        assert loss == loss0
        for k in g0:
            np.testing.assert_array_equal(g[k], g0[k], err_msg=k)


# ---------------------------------------------------------------------------
# the MLP group
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mlp(tmp_path_factory):
    """The reference's smoke MLP, its numbers carried to the port, the
    reference's and the port's one-process results, and the four ranks'."""
    jm = JMLP(in_dim=64, hidden=(32, 32))
    key = jax.random.PRNGKey(0)
    jp = jm.init(key)
    jf = jalgos.get("dfa").init_extra_state(jm, jax.random.fold_in(key, 1), jdfa.DFAConfig())
    params, fb = _np_sd(jp), _np_fb(jf)
    x, y = jmnist.procedural_digits(64, seed=0)
    batch = {"x": x[:32, :64], "y": y[:32]}
    odd = {"x": x[32:62, :64], "y": y[32:62]}
    ref = {}
    for algo in ("dfa", "bp"):
        (loss, _), g = jalgos.get(algo).value_and_grad(jm, jdfa.DFAConfig(backend="ref"))(
            jp, jf, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
        ref[algo] = (float(loss), _np_sd(g))
    # fit: the reference from its own initial state; the port from that
    # state, written as its step-0 snapshot
    js = japi.build_session(arch="mnist_mlp", smoke=True, data_parallel=False,
                            log_every=10**9)
    j0 = js.init_state()
    xs, ys = jmnist.procedural_digits(256, seed=0)
    jpipe = jpipeline.ArrayClassification(xs[:, :64], ys, 32, seed=0)
    jstate, _ = js.fit(jpipe.batch, FIT_STEPS, verbose=False)
    ref["fit"] = _np_sd(jstate["params"])
    fit_dir = tmp_path_factory.mktemp("fit")
    one = ranks.session(False, arch="mnist_mlp", smoke=True)
    start = ranks.load_state(one, _np_sd(j0["params"]), _np_fb(j0["fb"]))
    tckpt.CheckpointManager(str(fit_dir)).save(0, start)
    # the port's one-process results with the noise on
    port = {}
    s = ranks.session(False, arch="mnist_mlp", smoke=True, hardware="offchip_bpd",
                      backend="cuda")
    st = ranks.load_state(s, params, fb)
    port["offchip"] = ranks.grads_of(s, st, batch)
    port["odd"] = ranks.grads_of(s, st, odd)
    s = ranks.session(False, arch="mnist_mlp", smoke=True, hardware="offchip_bpd",
                      backend="cuda", microbatches=2)
    port["micro"] = ranks.grads_of(s, ranks.load_state(s, params, fb), batch)
    s = ranks.session(False, arch="mnist_mlp", smoke=True, hardware="offchip_bpd",
                      backend="cuda", algo="dfa-fused")
    st = ranks.load_state(s, params, fb)
    p, _, loss = s.fused_step()(st["params"], st["fb"], st["opt"], s.trainer.put(batch), 7)
    port["fused"] = (float(loss), ranks.np_tree(p))
    emu, port["emu"] = _emu_inputs()
    out = ranks.spawn("mlp", WORLD, params=params, fb=fb, batch=batch, odd=odd,
                      fit_dir=str(fit_dir), fit_steps=FIT_STEPS, emu=emu)
    return {"ref": ref, "port": port, "ranks": out}


@pytest.mark.parametrize("algo", ["dfa", "bp"])
def test_four_ranks_equal_the_reference_noise_off(mlp, algo):
    loss, _, grads = mlp["ranks"][0][f"ideal_{algo}"]
    ref_loss, ref_grads = mlp["ref"][algo]
    assert loss == pytest.approx(ref_loss, abs=TOL)
    for k in ref_grads:
        np.testing.assert_allclose(grads[k], ref_grads[k], rtol=TOL, atol=TOL, err_msg=k)
    _same_on_every_rank(mlp["ranks"], f"ideal_{algo}")


def test_fit_on_four_ranks_equals_the_reference_fit(mlp):
    got = mlp["ranks"][0]["fit"]
    for k, v in mlp["ref"]["fit"].items():
        np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL, err_msg=k)
    for r in mlp["ranks"][1:]:
        for k in got:
            np.testing.assert_array_equal(r["fit"][k], got[k])


def test_noisy_step_equals_one_process(mlp):
    loss, _, grads = mlp["ranks"][0]["offchip_global"]
    ref_loss, _, ref_grads = mlp["port"]["offchip"]
    assert loss == pytest.approx(ref_loss, abs=TOL)
    _close(grads, ref_grads)
    _same_on_every_rank(mlp["ranks"], "offchip_global")


@pytest.mark.parametrize("local", ["local_scale", "local_noise"])
def test_rank_local_scale_or_noise_fails_the_check(mlp, local):
    """A rank that takes s_a, or its noise, from its own rows misses the
    one-process step by far more than the tolerance."""
    _, _, grads = mlp["ranks"][0][f"offchip_{local}"]
    assert _worst(grads, mlp["port"]["offchip"][2]) > 100 * TOL


def test_microbatches_compose_as_the_global_batch(mlp):
    loss, _, grads = mlp["ranks"][0]["micro"]
    ref_loss, _, ref_grads = mlp["port"]["micro"]
    assert loss == pytest.approx(ref_loss, abs=TOL)
    _close(grads, ref_grads)


def test_indivisible_batch_is_replicated(mlp):
    """30 rows on 4 ranks: every rank runs the whole batch (no window, no
    all-reduce), bit for bit the one-process step; the report counts 1
    device for it and 4 for the 32-row batch."""
    r0 = mlp["ranks"][0]
    assert r0["odd_rows"] is None and r0["rows"] == (0, 8, 32)
    assert [r["rows"][0] for r in mlp["ranks"]] == [0, 8, 16, 24]
    assert r0["multiplier"] == (WORLD, 1)
    loss, _, grads = r0["offchip_odd"]
    ref_loss, _, ref_grads = mlp["port"]["odd"]
    assert loss == ref_loss
    for k in ref_grads:
        np.testing.assert_array_equal(grads[k], ref_grads[k], err_msg=k)


def test_fused_step_reduces_each_block(mlp):
    loss, params = mlp["ranks"][0]["fused"]
    ref_loss, ref_params = mlp["port"]["fused"]
    assert loss == pytest.approx(ref_loss, abs=TOL)
    for k in ref_params:
        np.testing.assert_allclose(params[k], ref_params[k], rtol=TOL, atol=TOL, err_msg=k)


def test_mean_all_reduce_in_buckets(mlp):
    for r in mlp["ranks"]:
        f3, f4, f7, d = r["mean"]
        ranks_mean = (WORLD - 1) / 2
        np.testing.assert_array_equal(f3, np.full(3, ranks_mean + 3, np.float32))
        np.testing.assert_array_equal(f4, np.full(4, ranks_mean + 4, np.float32))
        np.testing.assert_array_equal(f7, np.full(7, ranks_mean + 7, np.float32))
        np.testing.assert_array_equal(d, np.full(2, ranks_mean))


# ---------------------------------------------------------------------------
# the emulated bank
# ---------------------------------------------------------------------------

EMU_KERNELS = ["ref", "cuda"]


def _emu_inputs():
    """The emu group's inputs (the scenario's keyword arguments) and the
    port's one-process results on them."""
    jm = JMLP(in_dim=64, hidden=(32, 32))
    key = jax.random.PRNGKey(2)
    jp = jm.init(key)
    jf = jalgos.get("dfa").init_extra_state(jm, jax.random.fold_in(key, 1), jdfa.DFAConfig())
    params, fb = _np_sd(jp), _np_fb(jf)
    x, y = jmnist.procedural_digits(32, seed=3)
    batch = {"x": x[:, :64], "y": y}
    port = {}
    for kernel in EMU_KERNELS:
        s = ranks.session(False, arch="mnist_mlp", smoke=True, hardware="emu_offchip",
                          backend="emu", emu_kernel=kernel)
        st = ranks.load_state(s, params, fb)
        port[kernel] = ranks.grads_of(s, st, batch)
        new, _ = s.step(st, batch)
        port[f"{kernel}_hw"] = ranks.np_tree(new["hw"])
    return {"params": params, "fb": fb, "batch": batch}, port


@pytest.fixture(scope="module")
def emu(mlp):
    """The emu group's results: it runs in the MLP group's spawn."""
    return {"port": mlp["port"]["emu"], "ranks": [r["emu"] for r in mlp["ranks"]]}


@pytest.mark.parametrize("kernel", EMU_KERNELS)
def test_emu_step_equals_one_process(emu, kernel):
    loss, _, grads = emu["ranks"][0][f"{kernel}_global"]
    ref_loss, _, ref_grads = emu["port"][kernel]
    assert loss == pytest.approx(ref_loss, abs=TOL)
    _close(grads, ref_grads)
    assert _worst(emu["ranks"][0][f"{kernel}_local_noise"][2], ref_grads) > 100 * TOL


@pytest.mark.parametrize("kernel", EMU_KERNELS)
def test_emu_hardware_state_agrees_on_every_rank(emu, kernel):
    hw0 = emu["ranks"][0][f"{kernel}_hw"]
    for r in emu["ranks"]:
        for k, v in hw0.items():
            np.testing.assert_array_equal(r[f"{kernel}_hw"][k], v, err_msg=k)
    for k, v in emu["port"][f"{kernel}_hw"].items():
        np.testing.assert_array_equal(hw0[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# the language model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    one = ranks.session(False, arch="qwen1.5-0.5b", smoke=True)
    state = one.init_state()
    params, fb = ranks.np_tree(state["params"]), ranks.np_tree(state["fb"])
    batch = jtokens.MarkovTokens(LM_VOCAB, LM_SEQ, LM_BATCH, seed=0).batch(0)
    port = {}
    for hardware in LM_HARDWARE:
        s = ranks.session(False, arch="qwen1.5-0.5b", smoke=True, hardware=hardware,
                          backend="cuda")
        port[hardware] = ranks.grads_of(s, ranks.load_state(s, params, fb), batch)
    args = ["--arch", "qwen1.5-0.5b", "--device", "cpu", "--steps", "2", "--batch", "8",
            "--seq", "16", "--backend", "cuda", "--preset", "offchip_bpd",
            "--data-parallel", "on"]
    out = ranks.spawn("lm", WORLD, params=params, fb=fb, batch=batch, launcher_args=args)
    return {"port": port, "ranks": out}


@pytest.mark.parametrize("hardware", LM_HARDWARE)
def test_lm_dfa_step_on_four_ranks_equals_one_process(lm, hardware):
    """The smoke qwen1.5's dfa step (the embedding's DFA gradient included;
    the one-process step is held to the reference by test_torch_lm_train)."""
    loss, _, grads = lm["ranks"][0][f"{hardware}_global"]
    assert loss == pytest.approx(lm["port"][hardware][0], abs=TOL)
    _close(grads, lm["port"][hardware][2])
    _same_on_every_rank(lm["ranks"], f"{hardware}_global")


def test_lm_rank_local_noise_fails_the_check(lm):
    local = lm["ranks"][0]["offchip_bpd_local_noise"][2]
    assert _worst(local, lm["port"]["offchip_bpd"][2]) > 100 * TOL


def test_launcher_runs_data_parallel(lm):
    finals = [r["launcher"] for r in lm["ranks"]]
    assert all(np.isfinite(v) for v in finals[0].values())
    assert all(f == finals[0] for f in finals)


# ---------------------------------------------------------------------------
# resolving the flag
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flag", ["bogus", "yes", ""])
def test_bogus_flag_raises_the_reference_error(flag):
    with pytest.raises(ValueError) as expect:
        jtrainer._resolve_data_parallel(flag)
    with pytest.raises(ValueError) as got:
        ttrainer._resolve_data_parallel(flag)
    assert str(got.value) == str(expect.value)
    with pytest.raises(ValueError, match="data_parallel must be"):
        api.build_session(arch="mnist_mlp", smoke=True, data_parallel=flag, device="cpu")


def test_auto_means_more_than_one_launched_rank(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not ttrainer._resolve_data_parallel("auto")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not ttrainer._resolve_data_parallel("auto")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert ttrainer._resolve_data_parallel("auto")
    for flag, on in (("on", True), ("true", True), ("off", False), ("false", False),
                     (True, True), (False, False), (1, True), (0, False)):
        assert ttrainer._resolve_data_parallel(flag) is on
    monkeypatch.delenv("WORLD_SIZE")
    s = api.build_session(arch="mnist_mlp", smoke=True, device="cpu")
    assert s.mesh is None and s.trainer.is_chief
