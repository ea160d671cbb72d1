"""The port's device emulation (the ``emu`` backend) against the reference
on the CPU: ring physics, inscription and crosstalk, the bus tiling, the
fused panel loop's plain version against ``emu_bank_product_xla`` (noise
bit for bit), ``emulated_matmul``, drift and calibration, training steps
with the reference's parameters, feedback and hardware state carried
across, the trainer's hardware state, the session rules, and serving."""

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
from repro.data import mnist as jmnist  # noqa: E402
from repro.hardware import calibrate as jcal  # noqa: E402
from repro.hardware import channel as jch  # noqa: E402
from repro.hardware import drift as jdrift  # noqa: E402
from repro.hardware import mrr as jmrr  # noqa: E402
from repro.kernels import emu_matmul as jem  # noqa: E402
from repro.models.mlp import MLPClassifier as JMLP  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.train import SGDM as JSGDM  # noqa: E402
from repro_torch import algos as talgos  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.algos import dfa as tdfa  # noqa: E402
from repro_torch.core import photonics as tph  # noqa: E402
from repro_torch.hardware import calibrate as tcal  # noqa: E402
from repro_torch.hardware import channel as tch  # noqa: E402
from repro_torch.hardware import drift as tdrift  # noqa: E402
from repro_torch.hardware import mrr as tmrr  # noqa: E402
from repro_torch.kernels import emu_matmul as tem  # noqa: E402
from repro_torch.kernels import photonic_matmul as tpm  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.mlp import MLPClassifier as TMLP  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import Request as TRequest  # noqa: E402
from repro_torch.train import SGDM  # noqa: E402

TOL = 1e-5  # of max|out| for the panel loop; loss and gradients of a step
SEED = (0x1234ABCD, 0x0BADF00D)  # the kernel's two seed words, in both packages
# tests/test_emu_kernel.py's shapes (T, M, K, n_buses)
KERNEL_SHAPES = [(4, 50, 20, 1), (7, 61, 83, 2), (5, 61, 83, 5), (16, 130, 260, 4)]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _configs(**kw):
    """The same PhotonicConfig in both packages (an MRRConfig from the
    ``mrr_`` keywords)."""
    mkw = {k[4:]: v for k, v in kw.items() if k.startswith("mrr_")}
    pkw = {k: v for k, v in kw.items() if not k.startswith("mrr_")}
    return (jph.PhotonicConfig(mrr=jmrr.MRRConfig(**mkw), **pkw),
            tph.PhotonicConfig(mrr=tmrr.MRRConfig(**mkw), **pkw))


def _uniform(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _adc_flips(got, expect, adc_bits, amax=20.0):
    """Elements that differ by at least half an ADC step: a rounding that
    went the other way."""
    if adc_bits is None:
        return 0
    step = amax / max(2 ** (adc_bits - 1) - 1, 1)
    return int((np.abs(got - expect) >= step / 2).sum())


# ---------------------------------------------------------------------------
# ring physics, inscription, crosstalk
# ---------------------------------------------------------------------------

def test_device_configs_equal_field_for_field():
    assert dataclasses.asdict(tmrr.MRRConfig()) == dataclasses.asdict(jmrr.MRRConfig())
    assert dataclasses.asdict(tmrr.MRRConfig.ideal()) == dataclasses.asdict(jmrr.MRRConfig.ideal())
    for cfg in (tmrr.MRRConfig(), tmrr.MRRConfig.ideal(), tmrr.MRRConfig(delta_max=3.0)):
        jcfg = jmrr.MRRConfig(**dataclasses.asdict(cfg))
        assert tmrr.w_ceiling(cfg) == jmrr.w_ceiling(jcfg)


def test_ring_weight_and_inscribe_match():
    w = np.concatenate([_uniform((997,), 1), [-1.0, 0.0, 0.9999999, 1.0, 1.5, -2.0]])
    w = w.astype(np.float32)
    for gamma, cfg in ((1.0, tmrr.MRRConfig()), (1.3, tmrr.MRRConfig(gamma=1.3)),
                       (1.0, tmrr.MRRConfig.ideal())):
        jcfg = jmrr.MRRConfig(**dataclasses.asdict(cfg))
        d_t = tmrr.inscribe(_t(w), cfg)
        d_j = jmrr.inscribe(jnp.asarray(w), jcfg)
        np.testing.assert_allclose(_np(d_t), np.asarray(d_j), rtol=1e-6, atol=0)
        np.testing.assert_allclose(_np(tmrr.ring_weight(d_t, gamma)),
                                   np.asarray(jmrr.ring_weight(d_j, gamma)), rtol=0, atol=1e-6)


def test_bf16_inscription_stays_finite():
    """A normalised bf16 bank holds a weight of exactly 1; the reference
    inscribes in bf16, where the ceiling rounds to 1, and its detunings
    turn NaN after the crosstalk sums.  The port inscribes in f32."""
    w = np.array([[1.0, -1.0, 0.5, 0.99], [0.0, -0.3, 1.0, 0.25]], np.float32)
    cfg = tmrr.MRRConfig()
    jcfg = jmrr.MRRConfig()
    wb = _t(w).to(torch.bfloat16)
    got = tcal.command_deltas(wb, cfg)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    # the f32 inscription of the same (bf16-rounded) weights
    np.testing.assert_array_equal(_np(got), np.asarray(jcal.command_deltas(
        jnp.asarray(_np(wb)), jcfg)))
    expect = jcal.command_deltas(jnp.asarray(w, jnp.bfloat16), jcfg)
    assert not np.isfinite(np.asarray(expect, np.float32)).all()  # the reference's bf16 fault


@pytest.mark.parametrize("shape,axes", [
    ((50, 20), {}),                                   # bare grid
    ((3, 50, 4, 20), {}),                             # tiled panel stack
    ((2, 3, 50, 4, 20), {}),                          # bus-tiled
    ((3, 50, 20), {"row_axis": -2, "col_axis": -1, "bus_axis": 0}),  # state grid
])
def test_crosstalk_leak_matches(shape, axes):
    x = _uniform(shape, 2, 0.0, 50.0)
    cfg = tmrr.MRRConfig(crosstalk=0.01, bus_crosstalk=0.004)
    jcfg = jmrr.MRRConfig(**dataclasses.asdict(cfg))
    got = tmrr.crosstalk_leak(_t(x), cfg, **axes)
    expect = jmrr.crosstalk_leak(jnp.asarray(x), jcfg, **axes)
    np.testing.assert_array_equal(_np(got), np.asarray(expect))
    np.testing.assert_array_equal(_np(tmrr.neighbor_sum(_t(x))),
                                  np.asarray(jmrr.neighbor_sum(jnp.asarray(x))))


@pytest.mark.parametrize("shape", [(50, 20), (3, 50, 4, 20), (2, 3, 50, 4, 20)])
@pytest.mark.parametrize("device", [
    dict(), dict(bus_crosstalk=0.01), dict(heater_bits=6, delta_max=10.0),
    dict(heater_bits=1), dict(compensate_crosstalk=False, crosstalk=0.02)])
def test_command_deltas_exact_after_the_heater_dac(shape, device):
    w = _uniform(shape, 3, -0.95, 0.95)
    cfg = tmrr.MRRConfig(**device)
    jcfg = jmrr.MRRConfig(**device)
    got = _np(tcal.command_deltas(_t(w), cfg))
    expect = np.asarray(jcal.command_deltas(jnp.asarray(w), jcfg))
    np.testing.assert_array_equal(got, expect)
    if cfg.heater_bits is not None:  # on the DAC grid
        levels = 2**cfg.heater_bits - 1
        grid = got / cfg.delta_max * max(levels, 1)
        np.testing.assert_allclose(grid, np.round(grid), atol=1e-3)


@pytest.mark.parametrize("t,m,k,n_buses,failed", [
    (4, 50, 20, 1, ()), (7, 61, 83, 2, ()), (5, 61, 83, 5, ()), (16, 130, 260, 4, ()),
    (9, 120, 130, 3, (1,)), (6, 77, 95, 4, (0, 2))])
def test_tile_operands_match(t, m, k, n_buses, failed):
    jc, tc = _configs(n_buses=n_buses, failed_buses=failed)
    a, b = _uniform((t, k), 4), _uniform((m, k), 5)
    ja, jb, jn = jch.tile_operands(jnp.asarray(a), jnp.asarray(b), jc)
    ta, tb, tn = tch.tile_operands(_t(a), _t(b), tc)
    assert tn == jn
    np.testing.assert_array_equal(_np(ta), np.asarray(ja))
    np.testing.assert_array_equal(_np(tb), np.asarray(jb))


@pytest.mark.parametrize("n_buses,failed,bus_ct,resid", [
    (4, (), 0.01, True), (3, (1,), 0.01, False), (4, (0, 2), 0.02, True)])
def test_effective_deltas_match(n_buses, failed, bus_ct, resid):
    """Failed buses with inter-bus crosstalk take the physical-bus path."""
    jc, tc = _configs(n_buses=n_buses, failed_buses=failed, mrr_bus_crosstalk=bus_ct)
    b = _uniform((130, 150), 6)
    _, jb, _ = jch.tile_operands(jnp.zeros((2, 150)), jnp.asarray(b), jc)
    _, tb, _ = tch.tile_operands(torch.zeros(2, 150), _t(b), tc)
    r = 0.05 * np.random.default_rng(7).standard_normal((n_buses, 50, 20)).astype(np.float32)
    jr = jch.alive_residual(jnp.asarray(r), jc) if resid else None
    tr = tch.alive_residual(_t(r), tc) if resid else None
    if resid:
        np.testing.assert_array_equal(_np(tr), np.asarray(jr))
    expect = np.asarray(jch.effective_deltas(jb, jc, jr))
    got = _np(tch.effective_deltas(tb, tc, tr))
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tch.realized_weights(tb, tc, tr)),
                               np.asarray(jch.realized_weights(jb, jc, jr)), atol=1e-6)


def test_dead_ring_mask_rate_and_determinism():
    """The port draws its own dead set (not jax.random.bernoulli's stream):
    the dead fraction sits within 3σ of its binomial, and the set is a
    pure function of yield_seed."""
    shape = (4, 50, 20)
    n = int(np.prod(shape))
    for rate, seed in ((0.05, 0), (0.2, 3)):
        cfg = tmrr.MRRConfig(dead_ring_rate=rate, yield_seed=seed)
        mask = tmrr.dead_ring_mask(cfg, shape)
        dead = n - int(mask.sum())
        assert abs(dead - rate * n) < 3 * np.sqrt(n * rate * (1 - rate))
        assert torch.equal(mask, tmrr.dead_ring_mask(cfg, shape))
        assert set(np.unique(_np(mask))) <= {0.0, 1.0}
    other = tmrr.dead_ring_mask(tmrr.MRRConfig(dead_ring_rate=0.05, yield_seed=1), shape)
    assert not torch.equal(other, tmrr.dead_ring_mask(tmrr.MRRConfig(dead_ring_rate=0.05),
                                                      shape))
    assert bool((tmrr.dead_ring_mask(tmrr.MRRConfig(), shape) == 1).all())
    jc, tc = _configs(n_buses=3, failed_buses=(1,), mrr_dead_ring_rate=0.1)
    alive = tch.alive_dead_ring_mask(tc)
    assert alive.shape == (2, 50, 20)
    full = tmrr.dead_ring_mask(tc.mrr, (3, 50, 20))
    assert torch.equal(alive, full[[0, 2]])
    assert jch.alive_dead_ring_mask(jc).shape == alive.shape


# ---------------------------------------------------------------------------
# the fused panel loop: plain version against the reference's twin
# ---------------------------------------------------------------------------

def test_counter_gaussian_matches_reference_bit_for_bit():
    c0 = np.arange(0, 4096, 7, dtype=np.uint32)
    c1 = np.arange(50, dtype=np.uint32)
    for k0, k1 in ((0, 0), SEED, (0xFFFFFFFF, 1)):
        for x0 in (c0, c0 ^ np.uint32(tem._SHOT_STREAM)):
            expect = np.asarray(jem.counter_gaussian(
                jnp.uint32(k0), jnp.uint32(k1), jnp.asarray(x0)[:, None],
                jnp.asarray(c1)[None, :]))
            got = tem.counter_gaussian(k0, k1, _t(x0.astype(np.int64))[:, None],
                                       _t(c1.astype(np.int64))[None, :])
            np.testing.assert_array_equal(_np(got), expect)


def _panel_inputs(t, m, k, tc, resid=False, seed=0):
    """Tiled operands, effective detunings and the dead-ring mask from the
    port (held to the reference above), for both packages."""
    a, b = _uniform((t, k), 10 + seed), _uniform((m, k), 20 + seed)
    ta, tb, n_panels = tch.tile_operands(_t(a), _t(b), tc)
    r = None
    if resid:
        r = 0.08 * np.random.default_rng(30 + seed).standard_normal(
            (max(tc.n_buses, 1), tc.bank_rows, tc.bank_cols)).astype(np.float32)
        r = tch.alive_residual(_t(r), tc)
    td = tch.effective_deltas(tb, tc, r)
    tmask = tch.alive_dead_ring_mask(tc)
    jmask = None if tmask is None else jnp.asarray(_np(tmask))
    return (jnp.asarray(_np(ta)), jnp.asarray(_np(td)), jmask), (ta, td, tmask), n_panels


NOISE = {"off": (0.0, 0.0), "sigma": (0.098, 0.0), "sigma+shot": (0.202, 0.05)}


# noise off at every shape; on at the shapes with idle slots and several tiles
TWIN_CASES = ([(*shape, "off", adc) for shape in KERNEL_SHAPES for adc in (None, 8)]
              + [(*shape, noise, adc) for shape in KERNEL_SHAPES[2:]
                 for noise in ("sigma", "sigma+shot") for adc in (None, 8)])


@pytest.mark.parametrize("t,m,k,n_buses,noise,adc_bits", TWIN_CASES)
def test_plain_matches_reference_twin(t, m, k, n_buses, noise, adc_bits):
    """emu_bank_product_plain against emu_bank_product_xla (the reference's
    bit-identical twin of its TPU kernel) with the same seed words."""
    _, tc = _configs(n_buses=n_buses)
    (ja, jd, _), (ta, td, _), n_panels = _panel_inputs(t, m, k, tc)
    sigma, shot = NOISE[noise]
    kw = dict(n_panels=n_panels, gamma=1.0, sigma=sigma, shot=shot, adc_bits=adc_bits,
              amax=20.0)
    noisy = sigma > 0 or shot > 0
    expect = np.asarray(jem.emu_bank_product_xla(
        ja, jd, None, seed=jnp.asarray(SEED, jnp.uint32) if noisy else None, **kw))
    got = _np(tem.emu_bank_product_plain(ta, td, None, seed=SEED if noisy else None, **kw))
    assert got.shape == expect.shape
    assert _adc_flips(got, expect, adc_bits) == 0
    np.testing.assert_allclose(got, expect, rtol=0, atol=TOL * np.abs(expect).max())


@pytest.mark.parametrize("case", ["failed_bus_dead_rings", "drift_residual",
                                  "bus_crosstalk_failed"])
@pytest.mark.parametrize("noise", ["off", "sigma+shot"])
def test_plain_matches_reference_twin_on_device_faults(case, noise):
    kw_cfg = {"failed_bus_dead_rings": dict(n_buses=3, failed_buses=(1,),
                                            mrr_dead_ring_rate=0.05),
              "drift_residual": dict(n_buses=2),
              "bus_crosstalk_failed": dict(n_buses=4, failed_buses=(2,),
                                           mrr_bus_crosstalk=0.01)}[case]
    _, tc = _configs(mrr_adc_bits=8, **kw_cfg)
    (ja, jd, jmask), (ta, td, tmask), n_panels = _panel_inputs(
        9, 120, 130, tc, resid=case == "drift_residual")
    sigma, shot = NOISE[noise]
    kw = dict(n_panels=n_panels, gamma=1.0, sigma=sigma, shot=shot, adc_bits=8, amax=20.0)
    noisy = sigma > 0
    expect = np.asarray(jem.emu_bank_product_xla(
        ja, jd, jmask, seed=jnp.asarray(SEED, jnp.uint32) if noisy else None, **kw))
    got = _np(tem.emu_bank_product_plain(ta, td, tmask, seed=SEED if noisy else None, **kw))
    assert _adc_flips(got, expect, 8) == 0
    np.testing.assert_allclose(got, expect, rtol=0, atol=TOL * np.abs(expect).max())


def test_plain_matches_the_interpreted_tpu_kernel():
    """One noisy shape through the reference's Pallas kernel in interpret
    mode, as its own tests run it, with bf16 inputs and f32 detunings, as
    the port's bf16 serving path hands them over (both kernels upcast the
    inputs inside, as the plain version does)."""
    _, tc = _configs(n_buses=2, mrr_dead_ring_rate=0.05)
    (ja, jd, jmask), _, n_panels = _panel_inputs(6, 61, 83, tc)
    ja = ja.astype(jnp.bfloat16)
    kw = dict(n_panels=n_panels, gamma=1.0, sigma=0.1, shot=0.05, adc_bits=8, amax=20.0)
    expect = np.asarray(jem.emu_bank_product_pallas(
        ja, jd, jmask, seed=jnp.asarray(SEED, jnp.uint32), interpret=True, **kw))
    got = _np(tem.emu_bank_product_cuda(
        _t(np.asarray(ja.astype(jnp.float32))).to(torch.bfloat16), _t(jd), _t(jmask),
        seed=SEED, **kw))
    assert _adc_flips(got, expect, 8) == 0
    np.testing.assert_allclose(got, expect, rtol=0, atol=TOL * np.abs(expect).max())


def test_wrapper_runs_plain_on_cpu_and_validates():
    _, tc = _configs(n_buses=2)
    _, (ta, td, _), n_panels = _panel_inputs(5, 61, 83, tc)
    kw = dict(n_panels=n_panels, gamma=1.0, sigma=0.1, shot=0.0, adc_bits=None, amax=20.0)
    before = tem.launches
    got = tem.emu_bank_product_cuda(ta, td, None, seed=SEED, **kw)
    assert torch.equal(got, tem.emu_bank_product_plain(ta, td, None, seed=SEED, **kw))
    assert tem.launches == before  # the CPU path launches nothing
    assert not torch.equal(got, tem.emu_bank_product_cuda(ta, td, None, seed=(1, 2), **kw))
    with pytest.raises(ValueError, match="seed"):
        tem.emu_bank_product_cuda(ta, td, None, **kw)
    with pytest.raises(ValueError, match="disagree"):
        tem.emu_bank_product_cuda(ta[:, :1], td, None, seed=SEED, **kw)
    with pytest.raises(TypeError):
        tem.emu_bank_product_cuda(ta.half(), td, None, seed=SEED, **kw)
    with pytest.raises(TypeError, match="delta_eff f32"):
        tem.emu_bank_product_cuda(ta, td.bfloat16(), None, seed=SEED, **kw)
    with pytest.raises(ValueError, match="dead_mask"):
        tem.emu_bank_product_cuda(ta, td, torch.ones(3, 50, 20), seed=SEED, **kw)
    with pytest.raises(ValueError, match="n_panels"):
        tem.emu_bank_product_cuda(ta, td, None, seed=SEED, **{**kw, "n_panels": 99})
    with pytest.raises(ValueError, match="device"):
        tem.launch_kernel(ta, td, None, seed=SEED, **kw)
    assert tem.seed_words((0xAB << 32) | 0xCD) == (0xAB, 0xCD)
    assert tem.counter_gaussian is not tpm.counter_gaussian


# ---------------------------------------------------------------------------
# emulated_matmul and the backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,m,k,n_buses,preset", [
    (8, 96, 70, 1, "emu_ideal"), (8, 96, 70, 1, "emu_offchip"), (5, 61, 83, 5, "emu_offchip")])
@pytest.mark.parametrize("kernel", ["ref", "cuda"])
def test_emulated_matmul_matches_reference(preset, kernel, t, m, k, n_buses):
    """Noise off (σ = 0) on the preset's device; ``cuda`` on CPU tensors is
    the kernel's plain version, held to the reference's fused twin."""
    jc = dataclasses.replace(jph.PRESETS[preset], noise_std=0.0, n_buses=n_buses)
    tc = dataclasses.replace(tph.PRESETS[preset], noise_std=0.0, n_buses=n_buses)
    rng = np.random.default_rng(t + m)
    a = rng.standard_normal((t, k)).astype(np.float32)
    b = rng.standard_normal((m, k)).astype(np.float32)
    expect = np.asarray(jch.emulated_matmul(jnp.asarray(a), jnp.asarray(b), jc,
                                            kernel="ref" if kernel == "ref" else "xla"))
    got = _np(tch.emulated_matmul(_t(a), _t(b), tc, kernel=kernel))
    scale = np.abs(expect).max()
    adc = tc.mrr.adc_bits
    amax = 20.0 * np.abs(a).max() * np.abs(b).max()  # an ADC step in output units
    assert _adc_flips(got, expect, adc, amax) == 0
    np.testing.assert_allclose(got, expect, rtol=0, atol=TOL * scale)
    exact = a @ b.T
    if preset == "emu_ideal":
        np.testing.assert_allclose(got, exact, rtol=0, atol=1e-4 * np.abs(exact).max())


@pytest.mark.parametrize("kernel", ["ref", "cuda"])
def test_emu_noise_statistics_match_the_model(kernel):
    """σ of (noisy − clean) is noise_sigma_total within 5% (no ADC, 5 real
    panels over 2 buses), and a key gives the same draw twice."""
    cfg = tph.PhotonicConfig(noise_std=0.098, n_buses=2, mrr=tmrr.MRRConfig.ideal())
    rng = np.random.default_rng(11)
    a = _t(rng.standard_normal((64, 97)).astype(np.float32))
    b = _t(rng.standard_normal((300, 97)).astype(np.float32))
    clean = tch.emulated_matmul(a, b, dataclasses.replace(cfg, noise_std=0.0), kernel=kernel)
    noisy = tch.emulated_matmul(a, b, cfg, key=17, kernel=kernel)
    err = _np(noisy - clean).ravel()
    expect = tph.noise_sigma_total(97, a.abs().max().item(), b.abs().max().item(), cfg)
    assert abs(err.std() / expect - 1) < 0.05
    assert abs(err.mean()) < 4 * expect / np.sqrt(err.size)
    assert torch.equal(noisy, tch.emulated_matmul(a, b, cfg, key=17, kernel=kernel))
    with pytest.raises(ValueError, match="key"):
        tch.emulated_matmul(a, b, cfg, kernel=kernel)


def test_emu_backend_and_kernel_resolution(monkeypatch):
    backend = tph.get_backend("emu")
    assert isinstance(backend, tph.EmulatedMRRBackend)
    assert backend.stateful_hardware and backend.emu_kernel == "auto"
    assert not tph.get_backend("cuda").stateful_hardware
    monkeypatch.delenv("REPRO_EMU_KERNEL", raising=False)
    assert tch.resolve_emu_kernel() == "ref"
    assert tch.resolve_emu_kernel("auto", "cpu") == "ref"
    assert tch.resolve_emu_kernel("auto", torch.device("cuda")) == "cuda"
    assert tch.resolve_emu_kernel("ref", "cuda") == "ref"
    monkeypatch.setenv("REPRO_EMU_KERNEL", "cuda")
    assert tch.resolve_emu_kernel(None, "cpu") == "cuda"
    for bad in ("pallas", "xla", "nope"):
        with pytest.raises(ValueError, match="cuda"):
            tch.resolve_emu_kernel(bad)
    # the mask epilogue and the disabled bank, as the reference
    cfg = tph.PRESETS["emu_ideal"]
    a, b = torch.randn(4, 30), torch.randn(60, 30)
    mask = (torch.randn(4, 60) > 0).float()
    out = tph.photonic_project(a, b, cfg, mask=mask, backend="emu")
    assert bool((out[mask == 0] == 0).all())
    off = tch.emulated_matmul(a, b, dataclasses.replace(cfg, enabled=False))
    torch.testing.assert_close(off, a @ b.T)


def test_isolate_source_matches_reference():
    jc = dataclasses.replace(jph.PRESETS["emu_onchip"], n_buses=3, failed_buses=(1,),
                             input_bits=6, mrr=dataclasses.replace(
                                 jph.PRESETS["emu_onchip"].mrr, shot_noise=0.02,
                                 dead_ring_rate=0.05, bus_crosstalk=0.01))
    tc = tph.PhotonicConfig(**{**dataclasses.asdict(jc), "mrr": tmrr.MRRConfig(
        **dataclasses.asdict(jc.mrr))})
    assert tch.NOISE_SOURCES == jch.NOISE_SOURCES
    for src in (None, *tch.NOISE_SOURCES):
        got = tch.ideal_twin(tc) if src is None else tch.isolate_source(tc, src)
        expect = jch.ideal_twin(jc) if src is None else jch.isolate_source(jc, src)
        assert dataclasses.asdict(got) == dataclasses.asdict(expect), src
    with pytest.raises(ValueError):
        tch.isolate_source(tc, "nope")


# ---------------------------------------------------------------------------
# drift and calibration
# ---------------------------------------------------------------------------

def test_ou_step_is_stationary():
    """From the stationary law, σ stays σ within 5% after 50 OU steps."""
    sigma, tau = 0.5, 20.0
    x = sigma * torch.randn((4, 50, 20), generator=torch.Generator().manual_seed(0))
    for step in range(50):
        x = tdrift.ou_step(x, 1000 + step, sigma, tau)
    assert abs(x.std().item() / sigma - 1) < 0.05
    assert torch.equal(tdrift.ou_step(x, 3, sigma, tau), tdrift.ou_step(x, 3, sigma, tau))
    # one step of the update rule from zero: σ·sqrt(1 − a²) noise
    a = np.exp(-1 / tau)
    z = tdrift.ou_step(torch.zeros(200, 200), 9, sigma, tau)
    assert abs(z.std().item() / (sigma * np.sqrt(1 - a * a)) - 1) < 0.05


def test_advance_cadence_matches_reference():
    """Recalibration exactly at step % every == 0 and step > 0; in between
    the estimate is frozen and the drift moves; both packages agree on
    which steps recalibrate."""
    jc, tc = _configs(n_buses=2, mrr_drift_sigma=0.3, mrr_drift_tau=10.0,
                      mrr_cal_noise=0.0)
    every = 3
    tstate = tdrift.init_state(tc)
    jstate = jdrift.init_state(jc)
    assert tstate["drift"].shape == tuple(jstate["drift"].shape) == (2, 50, 20)
    t_recal, j_recal = [], []
    for step in range(10):
        tnew = tcal.advance(tstate, tc, step, 100 + step, recalibrate_every=every)
        jnew = jcal.advance(jstate, jc, step, jax.random.PRNGKey(step), recalibrate_every=every)
        assert not torch.equal(tnew["drift"], tstate["drift"])
        if not torch.equal(tnew["cal"], tstate["cal"]):
            t_recal.append(step)
            assert torch.equal(tnew["cal"], tnew["drift"])  # cal_noise = 0: exact sweep
        if not np.array_equal(np.asarray(jnew["cal"]), np.asarray(jstate["cal"])):
            j_recal.append(step)
        tstate, jstate = tnew, jnew
    assert t_recal == j_recal == [3, 6, 9]
    never = tcal.advance(tstate, tc, 6, 1, recalibrate_every=0)
    assert torch.equal(never["cal"], tstate["cal"])
    # measurement noise: a sweep reads drift + cal_noise·ε
    noisy = dataclasses.replace(tc, mrr=dataclasses.replace(tc.mrr, cal_noise=0.01))
    swept = tcal.advance(tstate, noisy, 3, 5, recalibrate_every=3)
    resid = (swept["cal"] - swept["drift"]).std().item()
    assert abs(resid / 0.01 - 1) < 0.1


def test_use_state_scopes_the_drift():
    assert tdrift.active_state() is None
    s1 = {"drift": torch.ones(1, 2, 2), "cal": torch.zeros(1, 2, 2)}
    s2 = {"drift": torch.zeros(1, 2, 2), "cal": torch.ones(1, 2, 2)}
    with tdrift.use_state(s1):
        assert tdrift.active_state() is s1
        with tdrift.use_state(s2):
            assert tdrift.active_state() is s2
        assert tdrift.active_state() is s1
    assert tdrift.active_state() is None
    with pytest.raises(RuntimeError), tdrift.use_state(s1):
        raise RuntimeError("boom")
    assert tdrift.active_state() is None
    # the channel reads the active state: the residual moves the product
    cfg = dataclasses.replace(tph.PRESETS["emu_ideal"], mrr=dataclasses.replace(
        tph.PRESETS["emu_ideal"].mrr, delta_max=100.0))
    a, b = torch.randn(3, 20), torch.randn(50, 20)
    clean = tch.emulated_matmul(a, b, cfg)
    state = {"drift": 0.3 * torch.ones(1, 50, 20), "cal": torch.zeros(1, 50, 20)}
    with tdrift.use_state(state):
        drifted = tch.emulated_matmul(a, b, cfg)
    assert not torch.allclose(clean, drifted)
    torch.testing.assert_close(drifted, tch.emulated_matmul(a, b, cfg, state=state))


def test_convert_carries_hardware_state_both_ways():
    assert jdrift.init_state(jph.PhotonicConfig(n_buses=3))["drift"].shape == (3, 50, 20)
    jstate = {"drift": jnp.asarray(_uniform((3, 50, 20), 40)),
              "cal": jnp.asarray(_uniform((3, 50, 20), 41))}
    tstate = convert.hw_state_from_reference(jax.tree_util.tree_map(np.asarray, jstate))
    assert tstate["drift"].dtype == torch.float32 and tstate["cal"].shape == (3, 50, 20)
    back = convert.hw_state_to_reference(tstate)
    for name in ("drift", "cal"):
        np.testing.assert_array_equal(back[name], np.asarray(jstate[name]))
    mask = np.asarray(jmrr.dead_ring_mask(jmrr.MRRConfig(dead_ring_rate=0.1), (2, 50, 20)))
    tmask = convert.dead_ring_mask_from_reference(mask)
    np.testing.assert_array_equal(convert.dead_ring_mask_to_reference(tmask), mask)


# ---------------------------------------------------------------------------
# training on the emu backend
# ---------------------------------------------------------------------------

def _quiet_pair():
    """A quiet device (no read or shot noise, no drift steps, no heater DAC
    or ADC: the reference traces its projections, and XLA then multiplies
    by reciprocals where the port divides) with crosstalk on, and a carried
    nonzero drift residual."""
    jc, tc = _configs(noise_std=0.0, mrr_drift_sigma=0.0, mrr_heater_bits=None,
                      mrr_crosstalk=0.01)
    r = _uniform((1, 50, 20), 50, -0.1, 0.1)
    jhw = {"drift": jnp.asarray(r), "cal": jnp.zeros((1, 50, 20), jnp.float32)}
    thw = convert.hw_state_from_reference(jax.tree_util.tree_map(np.asarray, jhw))
    return (jc, jhw), (tc, thw)


def _mlp_pair(hidden=(32, 32), in_dim=64):
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


def _assert_tree_close(tgrads, jgrads):
    expect = convert.state_dict_from_reference(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(tgrads) == sorted(expect)
    for k in expect:
        np.testing.assert_allclose(_np(tgrads[k]), _np(expect[k]), rtol=TOL, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("algo,kernel", [("dfa", "cuda"), ("dfa-fused", "ref"), ("bp", "cuda")])
def test_emu_training_step_matches_reference(algo, kernel):
    (jc, jhw), (tc, thw) = _quiet_pair()
    (jm, jp, jf), (tm, tp, tf) = _mlp_pair()
    jbatch, tbatch = _batch(tm.in_dim)
    jcfg = jdfa.DFAConfig(photonics=jc, backend=jph.EmulatedMRRBackend(emu_kernel="ref"))
    tcfg = tdfa.DFAConfig(photonics=tc, backend=tph.EmulatedMRRBackend(emu_kernel=kernel))
    with jdrift.use_state(jhw):
        (jl, _), jg = jalgos.get(algo).value_and_grad(jm, jcfg)(
            jp, jf, jbatch, jax.random.PRNGKey(1))
    with tdrift.use_state(thw):
        (tl, _), tg = talgos.get(algo).value_and_grad(tm, tcfg)(tp, tf, tbatch, 1)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)
    _assert_tree_close(tg, jg)
    if algo == "dfa-fused":
        jopt, topt = JSGDM(lr=0.05, momentum=0.9), SGDM(lr=0.05, momentum=0.9)
        with jdrift.use_state(jhw):
            jp2, _, jl2 = jdfa.make_fused_train_step(jm, jcfg, jopt)(
                jp, jf, jopt.init(jp), jbatch, jax.random.PRNGKey(1))
        with tdrift.use_state(thw):
            tp2, _, tl2 = talgos.get("dfa-fused").fused_step(tm, tcfg, topt)(
                tp, tf, topt.init(tp), tbatch, 1)
        assert float(tl2) == pytest.approx(float(jl2), abs=TOL)
        _assert_tree_close(tp2, jp2)


def test_trainer_carries_hardware_state_only_for_stateful_backends():
    x, y = jmnist.procedural_digits(64, seed=0)
    batch = {"x": x[:, :64], "y": y}
    for backend, preset, has_hw, gauges in (
            ("emu", "emu_onchip", True, True), ("emu", "emu_ideal", True, False),
            ("ref", "offchip_bpd", False, False), ("cuda", "emu_onchip", False, False)):
        s = api.build_session(smoke=True, hardware=preset, backend=backend, device="cpu",
                              recalibrate_every=2)
        state = s.init_state()
        assert ("hw" in state) == has_hw, (backend, preset)
        for _ in range(3):
            state, metrics = s.step(state, batch)
        assert ("hw" in state) == has_hw
        assert {"hw_drift_rms", "hw_residual_rms", "hw_dead_rings"} <= set(metrics) \
            if gauges else not any(k.startswith("hw_") for k in metrics), (backend, preset)
    # without recalibration the residual is the drift; a sweep at step 2
    # leaves step 3's drift increment plus the sweep's measurement noise
    gauges = {}
    for every in (0, 2):
        s = api.build_session(smoke=True, hardware="emu_onchip", backend="emu", device="cpu",
                              recalibrate_every=every)
        state = s.init_state()
        for _ in range(3):
            state, metrics = s.step(state, batch)
        assert state["step"] == 3 and state["hw"]["drift"].shape == (1, 50, 20)
        gauges[every] = (float(metrics["hw_drift_rms"]), float(metrics["hw_residual_rms"]))
    assert gauges[0][0] == gauges[0][1] > 0
    assert gauges[2][0] == gauges[0][0] and gauges[2][1] != gauges[2][0]
    assert gauges[2][1] < 2 * tmrr.MRRConfig().cal_noise


def test_build_session_emu_rules():
    s = api.build_session(smoke=True, hardware="emu_onchip", backend="emu", device="cpu")
    assert s.config.recalibrate_every == 500  # the device drifts
    s = api.build_session(smoke=True, hardware="emu_ideal", backend="emu", device="cpu")
    assert s.config.recalibrate_every == 0
    s = api.build_session(smoke=True, hardware="offchip_bpd", backend="emu", device="cpu")
    assert s.photonics.mrr == tmrr.MRRConfig() and s.config.recalibrate_every == 500
    s = api.build_session(smoke=True, hardware="offchip_bpd", backend="ref", device="cpu")
    assert s.photonics.mrr is None and s.config.recalibrate_every == 0
    s = api.build_session(smoke=True, hardware="emu_onchip", backend="emu",
                          emu_kernel="cuda", recalibrate_every=7, device="cpu")
    assert s.backend == tph.EmulatedMRRBackend(emu_kernel="cuda")
    assert s.config.recalibrate_every == 7
    with pytest.raises(ValueError, match="requires backend='emu'"):
        api.build_session(smoke=True, backend="cuda", emu_kernel="cuda", device="cpu")
    with pytest.raises(ValueError, match="cuda"):
        api.build_session(smoke=True, backend="emu", emu_kernel="pallas", device="cpu")
    # the reference's rules agree
    from repro import api as japi

    js = japi.build_session(arch=JMLP(in_dim=64, hidden=(32, 32)), hardware="offchip_bpd",
                            backend="emu", data_parallel=False)
    assert js.config.recalibrate_every == 500
    assert dataclasses.asdict(js.config.dfa.photonics.mrr) == \
        dataclasses.asdict(tmrr.MRRConfig())


def test_emu_launchers_on_cpu(capsys, monkeypatch):
    from repro_torch.data import mnist as tmnist

    monkeypatch.setattr(tmnist, "load", lambda seed=0: {
        "train": tmnist.procedural_digits(256, seed), "test": tmnist.procedural_digits(256, 1),
        "source": "procedural"})
    ev = tlaunch.main(["--arch", "mnist_mlp", "--smoke", "--steps", "2", "--device", "cpu",
                       "--backend", "emu", "--preset", "emu_onchip", "--recal-every", "1"])
    out = capsys.readouterr().out
    assert "hw_residual_rms" in out and "[eval]" in out
    assert 0.0 <= ev["accuracy"] <= 1.0
    tserve.main(["--arch", "qwen1.5-0.5b", "--backend", "emu", "--hardware", "emu_offchip",
                 "--device", "cpu", "--requests", "2", "--max-new", "2"])
    assert "[serve] 2 requests, 4 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# serving through emulated banks
# ---------------------------------------------------------------------------

def _record(engine, name, rec, idx):
    fn = getattr(engine, name)

    def wrapped(*args):
        out = fn(*args)
        rec.append(np.array(_np(out[idx]), np.float32))
        return out

    setattr(engine, name, wrapped)


def test_emu_engine_matches_reference():
    """The qwen1.5 smoke engine on emu_ideal (a drift-free device) on both
    emu kernels: logits within 1e-4 of max|logit| of the reference's, with
    its parameters, and the same tokens."""
    jmodel = jconfigs.get("qwen1.5-0.5b").make_smoke()
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = tconfigs.get("qwen1.5-0.5b").make_smoke(device="cpu")
    tmodel.load_state_dict(convert.state_dict_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams)))
    kw = dict(batch_slots=2, max_len=8, prefill_chunk=4)
    prompts = [[5, 17, 99, 3], [7, 8]]
    jeng = JEngine(jmodel, jparams, backend="emu", photonics=jph.PRESETS["emu_ideal"], **kw)
    jlog = []
    _record(jeng, "_decode", jlog, 1)
    jreqs = [JRequest(prompt=list(p), max_new=3) for p in prompts]
    jeng.run(jreqs)
    for kernel in ("ref", "cuda"):
        teng = TEngine(tmodel, backend=tph.EmulatedMRRBackend(emu_kernel=kernel),
                       photonics=tph.PRESETS["emu_ideal"], **kw)
        assert teng.hw_state is None  # emu_ideal does not drift
        tlog = []
        _record(teng, "_decode", tlog, 1)
        treqs = [TRequest(prompt=list(p), max_new=3) for p in prompts]
        teng.run(treqs)
        assert [r.out for r in treqs] == [r.out for r in jreqs], kernel
        assert len(tlog) == len(jlog) >= 2
        for got, expect in zip(tlog, jlog):
            np.testing.assert_allclose(got, expect, rtol=0,
                                       atol=1e-4 * np.abs(expect).max(), err_msg=kernel)


def test_engine_attaches_a_device_and_carries_drift_state():
    tmodel = tconfigs.get("qwen1.5-0.5b").make_smoke(device="cpu")
    tmodel.init(0)
    eng = TEngine(tmodel, batch_slots=1, max_len=8, backend="emu",
                  photonics=tph.PRESETS["offchip_bpd"])
    assert eng.photonics.mrr == tmrr.MRRConfig()
    assert eng.hw_state is not None and float(eng.hw_state["drift"].abs().sum()) == 0
    state = {"drift": 0.2 * torch.ones(1, 50, 20), "cal": torch.zeros(1, 50, 20)}
    eng2 = TEngine(tmodel, batch_slots=1, max_len=8, backend="emu",
                   photonics=tph.PRESETS["emu_onchip"], hw_state=state)
    assert eng2.hw_state is state
    seen = []
    orig = tch.emulated_matmul

    def spy(*args, **kw):
        seen.append(tdrift.active_state())
        return orig(*args, **kw)

    import unittest.mock

    with unittest.mock.patch.object(tch, "emulated_matmul", spy):
        eng2.run([TRequest(prompt=[1, 2, 3], max_new=2)])
    assert seen and all(s is state for s in seen)
    assert tdrift.active_state() is None
    s = api.build_session(arch="qwen1.5-0.5b", algo="bp", smoke=True, hardware="emu_onchip",
                          backend="emu", device="cpu")
    eng3 = s.engine(batch_slots=1, max_len=8, hw_state=state)
    assert eng3._backend.name == "emu" and eng3.hw_state is state
