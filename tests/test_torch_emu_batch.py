"""The emu kernel's batch axis on the CPU: a stack of E products (a mixture
of experts' weights) through ``emu_bank_product_plain``, the planner,
``fused_bank_product``, ``channel.emulated_matmul`` and the ``emu``
backend.  The batched plain version must equal its E stacked 2-D calls bit
for bit (one noise realisation and one dead-ring mask for every product),
and agree with the reference's ``jax.vmap`` of its emu kernel's twin."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import emu_matmul as jem  # noqa: E402
from repro_torch.core import photonics as tph  # noqa: E402
from repro_torch.hardware import channel as tch  # noqa: E402
from repro_torch.hardware import mrr as tmrr  # noqa: E402
from repro_torch.kernels import emu_matmul as tem  # noqa: E402

SEED = (0x1234ABCD, 0x0BADF00D)
TOL = 1e-5  # of max|out|: the reference's jitted twin rounds its divisions otherwise
# the bus layouts: one bus, two, and three with bus 1 dead (and dead rings)
LAYOUTS = {"q1": dict(), "q2": dict(n_buses=2),
           "q3_failed": dict(n_buses=3, failed_buses=(1,))}


def _cfg(layout, **mkw):
    dead = {"dead_ring_rate": 0.05} if layout == "q3_failed" else {}
    return tph.PhotonicConfig(mrr=tmrr.MRRConfig(**dead, **mkw), **LAYOUTS[layout])


def _stack(e, t, m, k, cfg, dtype, seed=0):
    """A stack of E tiled operand sets, detunings with a drift residual and
    the chip's dead-ring mask, as ``fused_bank_product`` hands them over."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(-1, 1, (e, t, k)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-1, 1, (e, m, k)).astype(np.float32))
    a_t, b_t, n_panels = tch.tile_operands(a, b, cfg)
    r = torch.from_numpy(0.08 * rng.standard_normal(
        (max(cfg.n_buses, 1), cfg.bank_rows, cfg.bank_cols)).astype(np.float32))
    delta = tch.effective_deltas(b_t, cfg, tch.alive_residual(r, cfg)).contiguous()
    return a_t.to(dtype), delta, tch.alive_dead_ring_mask(cfg), n_panels


def _kw(n_panels, noisy=True, adc_bits=8):
    return dict(n_panels=n_panels, gamma=1.0, sigma=0.202 if noisy else 0.0,
                shot=0.05 if noisy else 0.0, adc_bits=adc_bits, amax=20.0,
                seed=SEED if noisy else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("e,t,m,k", [(1, 5, 61, 83), (3, 7, 73, 61), (60, 3, 51, 41)])
def test_batched_plain_equals_stacked_2d_calls(e, t, m, k, layout, dtype):
    """Ragged T and M, E in {1, 3, 60}, q in {1, 2, 3 with a failed bus},
    σ + shot noise and an 8-bit ADC: index i of the batched plain version
    is the 2-D plain version of product i, bit for bit."""
    cfg = _cfg(layout)
    a_t, delta, mask, n_panels = _stack(e, t, m, k, cfg, dtype)
    kw = _kw(n_panels)
    got = tem.emu_bank_product_plain(a_t, delta, mask, **kw)
    assert got.shape == (e, t, delta.shape[1] * delta.shape[3])
    for i in range(e):
        assert torch.equal(got[i], tem.emu_bank_product_plain(a_t[i], delta[i], mask, **kw)), i
    # the wrapper runs the plain version for CPU tensors, batched as well
    assert torch.equal(tem.emu_bank_product_cuda(a_t, delta, mask, **kw), got)


def test_every_product_draws_the_same_noise():
    """The counters do not read the product index: two products with the
    same operands give the same noisy output, and the noise is there."""
    cfg = _cfg("q2")
    a_t, delta, mask, n_panels = _stack(1, 6, 61, 83, cfg, torch.float32)
    a2, d2 = torch.cat([a_t, a_t]), torch.cat([delta, delta])
    noisy = tem.emu_bank_product_plain(a2, d2, mask, **_kw(n_panels, adc_bits=None))
    quiet = tem.emu_bank_product_plain(a2, d2, mask, **_kw(n_panels, False, None))
    assert torch.equal(noisy[0], noisy[1])
    assert (noisy - quiet).abs().max() > 1e-3 * quiet.abs().max()


@pytest.mark.parametrize("layout", ["q2", "q3_failed"])
def test_batched_plain_matches_the_vmapped_reference_twin(layout):
    """``jax.vmap`` of the reference's ``emu_bank_product_xla`` over (a_t,
    δ) with the mask and seed unbatched, as its MoE runs experts, against
    the port's batched plain version: within TOL of max|out| with no ADC
    flip."""
    cfg = _cfg(layout)
    a_t, delta, mask, n_panels = _stack(3, 7, 73, 61, cfg, torch.float32, seed=4)
    kw = _kw(n_panels)
    jkw = dict(kw, seed=jnp.asarray(SEED, jnp.uint32))
    jmask = None if mask is None else jnp.asarray(mask.numpy())
    expect = np.asarray(jax.vmap(lambda a, d: jem.emu_bank_product_xla(a, d, jmask, **jkw))(
        jnp.asarray(a_t.numpy()), jnp.asarray(delta.numpy())))
    got = tem.emu_bank_product_plain(a_t, delta, mask, **kw).numpy()
    assert got.shape == expect.shape
    step = 20.0 / 127
    assert int((np.abs(got - expect) >= step / 2).sum()) == 0
    np.testing.assert_allclose(got, expect, rtol=0, atol=TOL * np.abs(expect).max())


@pytest.mark.parametrize("kernel", ["ref", "cuda"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_emulated_matmul_stack_equals_per_product_calls(kernel, layout):
    """``emulated_matmul`` on a stack (each product by its own scales, a
    (E, T, M) mask, one key, the drift residual of an active state) is the
    2-D call of each product, bit for bit, on the unfused chain (a loop)
    and on the kernel's path (one batched call of the plain version)."""
    from repro_torch.hardware import drift as tdrift

    cfg = dataclasses.replace(_cfg(layout, adc_bits=8, shot_noise=0.05), noise_std=0.098)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 5, 47)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 29, 47)).astype(np.float32))
    w = w * torch.tensor([1.0, 2.0, 4.0])[:, None, None]
    mask = torch.from_numpy((rng.uniform(size=(3, 5, 29)) > 0.3).astype(np.float32))
    state = {"drift": torch.from_numpy(0.05 * rng.standard_normal(
        (max(cfg.n_buses, 1), cfg.bank_rows, cfg.bank_cols)).astype(np.float32))}
    state["cal"] = torch.zeros_like(state["drift"])
    with tdrift.use_state(state):
        got = tph.EmulatedMRRBackend(emu_kernel=kernel).matmul(x, w, cfg, key=99, mask=mask)
        for i in range(3):
            one = tch.emulated_matmul(x[i], w[i], cfg, key=99, mask=mask[i], kernel=kernel)
            assert torch.equal(got[i], one), i
    off = dataclasses.replace(cfg, enabled=False)
    assert torch.equal(tch.emulated_matmul(x, w, off), torch.einsum("etk,emk->etm", x, w))


def test_fused_bank_product_tiles_the_stack_in_one_call(monkeypatch):
    """The kernel path hands the whole stack to the kernel's wrapper once."""
    cfg = _cfg("q2", adc_bits=8)
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(-1, 1, (4, 6, 57)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-1, 1, (4, 33, 57)).astype(np.float32))
    calls = []
    inner = tem.emu_bank_product_cuda

    def counted(a_t, delta, mask, **kw):
        calls.append((tuple(a_t.shape), tuple(delta.shape)))
        return inner(a_t, delta, mask, **kw)

    monkeypatch.setattr(tem, "emu_bank_product_cuda", counted)
    got = tem.fused_bank_product(a, b, cfg, key=5)
    assert calls == [((4, 6, 2, 2, 20), (4, 1, 2, 50, 2, 20))]
    for i in range(4):
        assert torch.equal(got[i], tem.fused_bank_product(a[i], b[i], cfg, key=5))


def test_plan_counts_the_stack():
    """The planner sizes row groups and T tiles over E times the blocks:
    the qwen2-moe expert shapes at E = 60 get a plan for 60 x their blocks
    (at least one wave), and E = 1 is the 2-D plan."""
    aligned = (0, None)
    for t, m, k in ((4, 1408, 2048), (4, 2048, 1408), (64, 1408, 2048)):
        nm, nj = -(-m // 50), -(-k // 20)
        one = tem._plan(t, nm, 50, 1, nj, 20, aligned)
        assert tem._plan(t, nm, 50, 1, nj, 20, aligned, e=1) == one
        stacked = tem._plan(t, nm, 50, 1, nj, 20, aligned, e=60)
        assert tem.grid_blocks(stacked, t, nm, 50, 60) == 60 * tem.grid_blocks(stacked, t, nm,
                                                                               50)
        assert tem.grid_blocks(stacked, t, nm, 50, 60) >= tem.CARD_SMS
        plans = tem.candidate_plans(t, nm, 50, 1, nj, 20, aligned, e=60)
        assert plans[0] == stacked and len(set(plans)) == len(plans)


def test_stack_operands_are_checked():
    cfg = _cfg("q2")
    a_t, delta, mask, n_panels = _stack(2, 3, 51, 41, cfg, torch.float32)
    kw = _kw(n_panels)
    with pytest.raises(ValueError, match="need a_t"):
        tem.emu_bank_product_cuda(a_t, delta[0], mask, **kw)
    with pytest.raises(ValueError, match="need a_t"):
        tem.emu_bank_product_cuda(a_t, torch.cat([delta, delta]), mask, **kw)
    # the vector variant loads every product's detunings 16 bytes at a time
    pointers = tem._pointers(delta, mask)
    assert len(pointers) == 3 and pointers[2] - pointers[0] == delta[0].numel() * 4
    assert len(tem._pointers(delta[:1], mask)) == 2
    with pytest.raises(ValueError, match="16-byte"):
        tem._check_plan(tem.Plan(tem.VECTOR, 4, 3), 3, 2, 2, 20, (0, None, 8))
