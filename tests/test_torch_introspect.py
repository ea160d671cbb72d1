"""The alignment probe and the noise-budget attribution of the port
against the reference on the CPU: the probe's rows on the ideal ``ref``
backend with the reference's parameters and feedback carried across by
``convert``, the unit-alignment anchor, probe-on = probe-off training
states bit for bit, the probe's cadence in ``fit``, and ``noise_budget``
on emu_onchip with the reference's hardware state and dead-ring mask."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.core import photonics as jph  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.hardware import drift as jdrift  # noqa: E402
from repro.hardware import mrr as jmrr  # noqa: E402
from repro.obs.attribution import noise_budget as jnoise_budget  # noqa: E402
from repro.obs.introspect import AlignmentProbe as JProbe  # noqa: E402
from repro_torch import api, convert, obs  # noqa: E402
from repro_torch.core import photonics as tph  # noqa: E402
from repro_torch.hardware import channel as tch  # noqa: E402
from repro_torch.hardware import mrr as tmrr  # noqa: E402
from repro_torch.obs.attribution import noise_budget  # noqa: E402
from repro_torch.obs.introspect import AlignmentProbe  # noqa: E402

ARCH = "qwen1.5-0.5b"


def _batch(arch, in_dim=64, n=32, seed=0):
    if arch == ARCH:
        return jtokens.MarkovTokens(128, 16, 4, seed).batch(0)
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(n, in_dim)).astype(np.float32),
            "y": rng.integers(0, 10, n).astype(np.int32)}


def _pair(arch):
    """(reference session, its state), (port session, the same state)."""
    js = japi.build_session(arch=arch, smoke=True, algo="dfa", hardware="ideal",
                            backend="ref", data_parallel=False)
    jstate = js.init_state()
    ts = api.build_session(arch=arch, smoke=True, algo="dfa", hardware="ideal",
                           backend="ref", device="cpu")
    tstate = ts.init_state()
    tstate["params"] = convert.state_dict_from_reference(jax.device_get(jstate["params"]))
    tstate["fb"] = convert.feedback_from_reference(jax.device_get(jstate["fb"]))
    return (js, jstate), (ts, tstate)


# norms: the LM's gradients agree within 1e-5 of each tensor's max |value|
# (test_torch_lm_train), which leaves their sums of squares 1.1e-5 apart
NORM_RTOL = {"mnist_mlp": 1e-5, ARCH: 5e-5}


@pytest.mark.parametrize("arch", ["mnist_mlp", ARCH])
def test_probe_rows_match_reference(arch):
    (js, jstate), (ts, tstate) = _pair(arch)
    batch = _batch(arch)
    want = jax.device_get(JProbe(js.trainer).probe(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = {k: float(v) for k, v in AlignmentProbe(ts.trainer).probe(
        tstate, ts.trainer.put(batch)).items()}
    assert sorted(got) == sorted(want)
    subtrees = {spec.name for spec in ts.model.segment_specs()} | {"head"}
    if arch == ARCH:
        subtrees.add("embed")
    assert {k[len("align_"):] for k in got if k.startswith("align_")} == subtrees | {"global"}
    for k, v in got.items():
        if k.startswith("align_"):
            assert abs(v - float(want[k])) <= 1e-5, k
            assert abs(v) <= 1.0 + 1e-6
        else:
            assert v == pytest.approx(float(want[k]), rel=NORM_RTOL[arch]), k
    # DFA's head gradient is BP's: alignment 1 by construction
    assert got["align_head"] == pytest.approx(1.0, abs=1e-5)


def test_feedback_equal_to_head_weights_gives_unit_alignment():
    s = api.build_session(arch="mnist_mlp", smoke=True, hardware="ideal", backend="ref",
                          device="cpu")
    state = s.init_state()
    last = s.model.segment_specs()[-1].name
    state["fb"] = dict(state["fb"], **{last: state["params"]["head.weight"].T[None]})
    m = AlignmentProbe(s.trainer).probe(state, s.trainer.put(_batch("mnist_mlp")))
    assert float(m[f"align_{last}"]) == pytest.approx(1.0, abs=1e-5)
    assert abs(float(m["align_h0"])) < 0.5  # random feedback: a small cosine


@pytest.mark.parametrize("hardware,backend", [("emu_offchip", "emu"),
                                              ("offchip_bpd", "cuda")])
def test_probe_on_and_off_training_states_are_bitwise_identical(hardware, backend):
    batch = _batch("mnist_mlp", n=16)

    def final_state(probe_every):
        s = api.build_session(arch="mnist_mlp", smoke=True, hardware=hardware,
                              backend=backend, recalibrate_every=3, log_every=10**9,
                              probe_every=probe_every, device="cpu")
        state, _ = s.fit(lambda i: batch, total_steps=6, verbose=False)
        return state

    plain, probed = final_state(None), final_state(2)
    flat = lambda st: {f"{g}.{k}": v for g in ("params", "hw")  # noqa: E731
                       for k, v in st.get(g, {}).items()}
    a, b = flat(plain), flat(probed)
    assert a.keys() == b.keys() and plain["step"] == probed["step"] == 6
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k in plain["opt"]["mom"]:
        assert torch.equal(plain["opt"]["mom"][k], probed["opt"]["mom"][k])
    assert all(v.grad is None for v in probed["params"].values())


def test_fit_probe_rows_land_at_cadence_with_the_noise_budget():
    s = api.build_session(arch="mnist_mlp", smoke=True, hardware="emu_onchip", backend="emu",
                          probe_every=2, recalibrate_every=4, log_every=10**9, device="cpu")
    ob = obs.Observer()
    batch = _batch("mnist_mlp", n=16)
    s.fit(lambda i: batch, total_steps=5, verbose=False, observer=ob)
    rows = [r for r in ob.metrics.sinks[0].rows if "align_global" in r["metrics"]]
    assert [r["step"] for r in rows] == [0, 2, 4]
    m = rows[-1]["metrics"]
    for src in tch.NOISE_SOURCES:
        assert f"nb_{src}_var" in m
    assert m["nb_closure"] == pytest.approx(1.0, abs=0.1)
    # without an observer the fit makes an in-memory one and still runs
    s2 = api.build_session(arch="mnist_mlp", smoke=True, hardware="ideal", backend="ref",
                           probe_every=2, device="cpu")
    _, metrics = s2.fit(lambda i: batch, total_steps=3, verbose=False)
    assert np.isfinite(float(metrics["loss"]))


# ---------------------------------------------------------------------------
# noise-budget attribution
# ---------------------------------------------------------------------------

DETERMINISTIC = ("quantization", "drift", "dead_rings", "adc")
STOCHASTIC = ("thermal", "shot")


def _device(cfg, **kw):
    return dataclasses.replace(cfg, mrr=dataclasses.replace(cfg.mrr, **kw))


@pytest.mark.parametrize("case", ["emu_onchip", "shot_dead_rings", "uncompensated"])
def test_noise_budget_matches_reference(case, monkeypatch):
    """emu_onchip as the preset stands; with shot noise and dead rings (the
    reference's mask carried across); and with crosstalk left uncompensated.
    Deterministic sources within 1e-5 relative, stochastic ones within 5%
    (65536 samples: the variance estimate's own spread is 0.6%), closure
    within 0.1 of 1.  On emu_onchip the compensated crosstalk leaves an
    error power of ≈ 1e-10, at the f32 rounding floor of the products (the
    port's ring weights differ from the reference's by one ulp in 0.2% of
    the rings), so it is held within 1e-5 of the total error power there,
    and within 1e-5 relative where crosstalk is uncompensated."""
    kw = {"emu_onchip": {}, "shot_dead_rings": dict(shot_noise=0.05, dead_ring_rate=0.05),
          "uncompensated": dict(compensate_crosstalk=False, crosstalk=0.02)}[case]
    jcfg, tcfg = _device(jph.PRESETS["emu_onchip"], **kw), _device(tph.PRESETS["emu_onchip"], **kw)
    if jcfg.mrr.dead_ring_rate > 0:
        jmask = np.asarray(jmrr.dead_ring_mask(jcfg.mrr, (1, jcfg.bank_rows, jcfg.bank_cols)))
        monkeypatch.setattr(tmrr, "dead_ring_mask", lambda cfg, shape, device="cpu":
                            convert.dead_ring_mask_from_reference(jmask, device))
    rng = np.random.default_rng(3)
    e = (0.3 * rng.normal(size=(256, 10))).astype(np.float32)
    b = (rng.normal(size=(256, 10)) / np.sqrt(10)).astype(np.float32)
    d = (0.02 * rng.normal(size=(1, jcfg.bank_rows, jcfg.bank_cols))).astype(np.float32)
    hw = {"drift": d, "cal": np.zeros_like(d)}
    want = jax.device_get(jnoise_budget(
        jnp.asarray(e), jnp.asarray(b), jcfg, jax.random.PRNGKey(5),
        residual=jdrift.residual({k: jnp.asarray(v) for k, v in hw.items()})))
    th = convert.hw_state_from_reference(hw)
    got = {k: float(v) for k, v in noise_budget(
        torch.from_numpy(e), torch.from_numpy(b), tcfg, 5,
        residual=th["drift"] - th["cal"]).items()}
    assert sorted(got) == sorted(want)
    want = {k: float(v) for k, v in want.items()}
    for src in DETERMINISTIC:
        assert got[f"nb_{src}_var"] == pytest.approx(want[f"nb_{src}_var"], rel=1e-5), src
    for src in STOCHASTIC:
        assert got[f"nb_{src}_var"] == pytest.approx(want[f"nb_{src}_var"], rel=0.05), src
    xt = got["nb_crosstalk_var"] - want["nb_crosstalk_var"]
    if case == "uncompensated":
        assert abs(xt) <= 1e-5 * want["nb_crosstalk_var"]
    else:
        assert abs(xt) <= 1e-5 * want["nb_total_var"]
    assert got["nb_total_var"] == pytest.approx(want["nb_total_var"], rel=0.05)
    assert got["nb_closure"] == pytest.approx(1.0, abs=0.1)
    assert got["nb_thermal_vs_analytic"] == pytest.approx(1.0, abs=0.15)
    assert got["nb_thermal_var"] > got["nb_adc_var"] > 0
    if case == "shot_dead_rings":
        assert got["nb_shot_var"] > 0 and got["nb_dead_rings_var"] > 0
    else:
        assert got["nb_shot_var"] == got["nb_dead_rings_var"] == 0.0
