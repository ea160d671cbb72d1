"""The ``emu_bank_product`` kernel's batch axis on the card: a stack of E
products in one launch against its plain version and against E 2-D
launches under the same plan, bit for bit, under every plan
``candidate_plans`` returns.  It covers qwen2-moe's expert products (60
experts, 2048 -> 1408 and 1408 -> 2048, bf16 inputs and f32 detunings, as
its emu serve hands them over) and the tuned LM session's bus counts q = 2
and q = 8 at (4096, 1024, 1024).  Marked ``gpu``: skipped where there is no
CUDA device; on the card run

    python -m pytest -m gpu tests/test_torch_emu_batch_gpu.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import photonics as ph  # noqa: E402
from repro_torch.hardware import channel, mrr  # noqa: E402
from repro_torch.kernels import emu_matmul as em  # noqa: E402

pytestmark = pytest.mark.gpu

SEED = (0x1234ABCD, 0x0BADF00D)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _operands(e, t, k, m, cfg, dtype, device, seed=0):
    """Tiled operands of e products (e = 0: one 2-D product), f32 detunings
    with a drift residual, and the chip's dead-ring mask."""
    g = torch.Generator(device=device).manual_seed(seed)
    lead = (e,) if e else ()
    a = (torch.rand((*lead, t, k), generator=g, device=device) * 2 - 1).to(dtype)
    b = (torch.rand((*lead, m, k), generator=g, device=device) * 2 - 1).to(dtype)
    a_t, b_t, n_panels = channel.tile_operands(a, b, cfg)
    r = 0.08 * torch.randn((cfg.n_buses, cfg.bank_rows, cfg.bank_cols), generator=g,
                           device=device)
    delta = channel.effective_deltas(b_t, cfg, channel.alive_residual(r, cfg)).contiguous()
    return a_t, delta.float(), channel.alive_dead_ring_mask(cfg, device), n_panels


def _plans(a_t, delta, mask):
    t, q, nj, cols = a_t.shape[-4:]
    nm, _q, rows, _nj, _c = delta.shape[-5:]
    e = a_t.shape[0] if a_t.ndim == 5 else 1
    return em.candidate_plans(t, nm, rows, q, nj, cols, em._pointers(delta, mask),
                              em._sm_count(a_t.device.index), e)


@pytest.mark.parametrize("t", [2, 5])
@pytest.mark.parametrize("k,m", [(2048, 1408), (1408, 2048)])
def test_expert_stack_equals_plain_and_2d_launches(cuda, k, m, t):
    """qwen2-moe's experts on emu_offchip (σ 0.098, 10-bit ADC, dead rings):
    the batched launch = the batched plain version, and index e = the 2-D
    launch of expert e, bit for bit under every plan."""
    cfg = ph.PhotonicConfig(noise_std=0.098, mrr=mrr.MRRConfig(adc_bits=10,
                                                               dead_ring_rate=0.01))
    a_t, delta, mask, n_panels = _operands(60, t, k, m, cfg, torch.bfloat16, cuda)
    kw = dict(n_panels=n_panels, gamma=1.0, sigma=0.098, shot=0.0, adc_bits=10, amax=20.0,
              seed=SEED)
    expect = em.emu_bank_product_plain(a_t, delta, mask, **kw)
    for plan in _plans(a_t, delta, mask):
        got = em.launch_kernel(a_t, delta, mask, plan=plan, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, expect), plan.name
        for i in (0, 1, 31, 59):
            one = em.launch_kernel(a_t[i], delta[i], mask, plan=plan, **kw)
            assert torch.equal(got[i], one), (plan.name, i)


@pytest.mark.parametrize("n_buses", [2, 8])
def test_tuned_bus_counts_equal_plain(cuda, n_buses):
    """The tuned session's q = 2 and q = 8 (nj = 7: four padded slots) at
    the LM's (4096, 1024, 1024) on emu_onchip (σ 0.202, 8-bit ADC), f32:
    every plan = the plain version, and a stack of one = the 2-D launch."""
    cfg = ph.PhotonicConfig(n_buses=n_buses, noise_std=0.202, mrr=mrr.MRRConfig(adc_bits=8))
    a_t, delta, mask, n_panels = _operands(0, 4096, 1024, 1024, cfg, torch.float32, cuda)
    assert a_t.shape[1:3] == (n_buses, -(-52 // n_buses))
    kw = dict(n_panels=n_panels, gamma=1.0, sigma=0.202, shot=0.0, adc_bits=8, amax=20.0,
              seed=SEED)
    expect = em.emu_bank_product_plain(a_t, delta, mask, **kw)
    for plan in _plans(a_t, delta, mask):
        got = em.launch_kernel(a_t, delta, mask, plan=plan, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, expect), plan.name
    one = em.launch_kernel(a_t[None], delta[None], mask, **kw)
    assert one.shape == (1, *expect.shape) and torch.equal(one[0], expect)


def test_stack_rejects_what_it_cannot_run(cuda):
    cfg = ph.PhotonicConfig(n_buses=2)
    a_t, delta, mask, n_panels = _operands(3, 4, 60, 50, cfg, torch.float32, cuda)
    kw = dict(n_panels=n_panels, gamma=1.0, sigma=0.0, shot=0.0, adc_bits=None, amax=20.0)
    with pytest.raises(ValueError, match="need a_t"):
        em.emu_bank_product_cuda(a_t, delta[:2], mask, **kw)
    # a view whose second product sits off a 16-byte boundary takes no vector plan
    flat = torch.empty(delta.numel() + 1, device=cuda)[1:].view_as(delta)
    flat.copy_(delta)
    with pytest.raises(ValueError, match="16-byte"):
        em.launch_kernel(a_t, flat, mask, plan=em.Plan(em.VECTOR, 4, 4), **kw)
    assert torch.equal(em.emu_bank_product_cuda(a_t, flat, mask, **kw),
                       em.emu_bank_product_plain(a_t, delta, mask, **kw))
