"""The Mamba-2 path's kernels on the card: the bank kernel at mamba2-130m's
decode shapes, the emu kernel at its widths (K = 768 and 1536 leave a
ragged last slot of the 20-column bank) and the masked decode-scan
prefill against token-by-token prefill.  Marked ``gpu``: skipped where
there is no CUDA device; on the card run

    python -m pytest -m gpu tests/test_torch_mamba_gpu.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.core import photonics as ph  # noqa: E402
from repro_torch.hardware import channel  # noqa: E402
from repro_torch.kernels import emu_matmul as em  # noqa: E402
from repro_torch.kernels import photonic_matmul as pm  # noqa: E402
from repro_torch.serve.decode import make_prefill_step  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # the reference's kernel-test bounds
# (T, K, M) of every bank product of one mamba2-130m token: in_proj, out_proj, head
DECODE_SHAPES = [(4, 768, 3352), (4, 1536, 768), (4, 768, 50280)]
SEED = (0x1234ABCD, 0x0BADF00D)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("t,k,m", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bank_kernel_matches_plain_at_mamba_shapes(cuda, t, k, m, dtype):
    g = torch.Generator(device=cuda).manual_seed(t + k + m)
    a = torch.randn((t, k), generator=g, device=cuda).to(dtype)
    b = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    before = pm.launches
    got = pm.photonic_matmul_cuda(a, b)
    assert pm.launches == before + 1
    expect = pm.photonic_matmul_plain(a, b)
    tol = TOL[dtype] * expect.abs().max().item()
    assert (got - expect).abs().max().item() <= tol


@pytest.mark.parametrize("k", [768, 1536])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emu_kernel_bit_for_bit_with_a_ragged_last_slot(cuda, k, dtype):
    """emu_offchip (σ 0.098, 10-bit ADC), a drift residual, every plan the
    planner may pick or a caller may force, equal to the plain version."""
    cfg = ph.PRESETS["emu_offchip"]
    assert k % cfg.bank_cols != 0
    g = torch.Generator(device=cuda).manual_seed(k)
    a = (torch.rand((16, k), generator=g, device=cuda) * 2 - 1).to(dtype)
    b = (torch.rand((768, k), generator=g, device=cuda) * 2 - 1).to(dtype)
    a_t, b_t, n_panels = channel.tile_operands(a, b, cfg)
    assert n_panels == -(-k // cfg.bank_cols)  # 39 and 77 slots, the last one part-filled
    r = 0.08 * torch.randn((cfg.n_buses, cfg.bank_rows, cfg.bank_cols), generator=g,
                           device=cuda)
    delta = channel.effective_deltas(b_t, cfg, channel.alive_residual(r, cfg)).contiguous()
    mask = channel.alive_dead_ring_mask(cfg, cuda)
    kw = dict(n_panels=n_panels, gamma=1.0, sigma=channel._per_pass_sigma(cfg),
              shot=cfg.mrr.shot_noise, adc_bits=cfg.mrr.adc_bits,
              amax=float(cfg.bank_cols), seed=SEED)
    expect = em.emu_bank_product_plain(a_t, delta, mask, **kw)
    assert torch.equal(em.emu_bank_product_cuda(a_t, delta, mask, **kw), expect)
    t, q, nj, cols = a_t.shape
    nm, _, rows, _, _ = delta.shape
    for plan in em.candidate_plans(t, nm, rows, q, nj, cols, em._pointers(delta, mask),
                                   em._sm_count(cuda.index)):
        assert torch.equal(em.launch_kernel(a_t, delta, mask, plan=plan, **kw), expect), \
            plan.name


def test_decode_scan_prefill_equals_token_by_token(cuda):
    """The smoke mamba2 on the ``cuda`` backend (ideal bank): one prefill
    step over a chunk of 6 (n_valid 6, 3, 0) gives the logits and states
    of six one-token steps, every bank product through the kernel."""
    model = api.build_model("mamba2-130m", smoke=True, device=cuda, seed=0)
    step = make_prefill_step(model)
    toks = torch.randint(0, 128, (3, 6), generator=torch.Generator().manual_seed(1)).to(cuda)
    n_valid = torch.tensor([6, 3, 0], device=cuda)
    zero = torch.zeros(3, dtype=torch.long, device=cuda)
    with torch.no_grad(), ph.forward_execution(ph.PRESETS["ideal"], "cuda"):
        before = pm.launches
        last, caches, clen = step(toks, n_valid, model.init_caches(3), zero)
        assert pm.launches - before == 6 * (2 * model.cfg.n_layers + 1)
        one_last, one_caches, one_len = None, model.init_caches(3), zero
        for t in range(6):
            out, one_caches, one_len = step(toks[:, t:t + 1],
                                            (n_valid > t).long(), one_caches, one_len)
            keep = (n_valid > t)[:, None]
            one_last = out if one_last is None else torch.where(keep, out, one_last)
    assert torch.equal(clen, one_len)
    torch.testing.assert_close(last[:2], one_last[:2], rtol=1e-6, atol=1e-6)
    assert float(last[2].abs().max()) == 0.0
    for name in ("ssm", "conv"):
        torch.testing.assert_close(caches[name], one_caches[name], rtol=1e-6, atol=1e-6)
