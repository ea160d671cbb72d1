"""The dense families' kernels on the card: the bank kernel at every decode
shape qwen3-1.7b, minicpm3-4b and granite-8b give it (T = 4), the
skinny variants at granite's K = 14336 (f32 stages A in 229,376 B of
shared memory), the emu kernel at the two DFA training shapes, and
``flash_attention`` against ``reference_attention``.  Marked ``gpu``:
skipped where there is no CUDA device; on the card run

    python -m pytest -m gpu tests/test_torch_dense_gpu.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import photonics as ph  # noqa: E402
from repro_torch.hardware import channel  # noqa: E402
from repro_torch.kernels import emu_matmul as em  # noqa: E402
from repro_torch.kernels import photonic_matmul as pm  # noqa: E402
from repro_torch.nn import attention  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # the reference's kernel-test bounds
# (T, K, M) of every bank product of one decode token
DECODE_SHAPES = {
    "qwen3-1.7b": [(4, 2048, 2048), (4, 2048, 1024), (4, 2048, 6144), (4, 6144, 2048),
                   (4, 2048, 151936)],
    "minicpm3-4b": [(4, 2560, 768), (4, 768, 3840), (4, 2560, 288), (4, 2560, 2560),
                    (4, 2560, 6400), (4, 6400, 2560), (4, 2560, 73448)],
    "granite-8b": [(4, 4096, 4096), (4, 4096, 1024), (4, 4096, 14336), (4, 14336, 4096),
                   (4, 4096, 49152)],
}
CASES = [(arch, *shape) for arch, shapes in DECODE_SHAPES.items() for shape in shapes]
SEED = (0x1234ABCD, 0x0BADF00D)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(cuda, t, k, m, dtype):
    g = torch.Generator(device=cuda).manual_seed(t + k + m)
    a = torch.randn((t, k), generator=g, device=cuda).to(dtype)
    b = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    return a, b


@pytest.mark.parametrize("arch,t,k,m", CASES, ids=[f"{a}-{t}x{k}x{m}" for a, t, k, m in CASES])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bank_kernel_matches_plain_at_dense_decode_shapes(cuda, arch, t, k, m, dtype):
    a, b = _operands(cuda, t, k, m, dtype)
    noise = 0.01 * torch.randn((t, m), device=cuda)
    for kw in ({}, {"noise": noise}):
        before = pm.launches
        got = pm.photonic_matmul_cuda(a, b, **kw)
        assert pm.launches == before + 1
        expect = pm.photonic_matmul_plain(a, b, **kw)
        assert (got - expect).abs().max().item() <= TOL[dtype] * expect.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [4096, 100])
def test_both_skinny_variants_at_k_14336(cuda, dtype, m):
    """granite's down projection: T = 4 rows of K = 14336 staged whole in
    shared memory (229,376 B in f32, 3,072 B under the opt-in limit), by
    the 16-byte-load variant and its scalar-load twin."""
    t, k = 4, 14336
    itemsize = 4 if dtype == torch.float32 else 2
    assert pm._skinny_rows(t) * k * itemsize <= pm.SMEM_MAX
    a, b = _operands(cuda, t, k, m, dtype)
    assert pm._plan(t, m, k, dtype, (a.data_ptr(), b.data_ptr())).variant == pm.SKINNY
    expect = pm.photonic_matmul_plain(a, b)
    for plan in (pm.Plan(pm.SKINNY), pm.Plan(pm.SKINNY_SCALAR)):
        got = pm.launch_kernel(a, b, plan=plan)
        assert (got - expect).abs().max().item() <= TOL[dtype] * expect.abs().max().item(), \
            plan.name


@pytest.mark.parametrize("d", [2048, 2560])
def test_emu_kernel_bit_for_bit_at_dense_training_shapes(cuda, d):
    """emu_offchip (σ 0.098, 10-bit ADC) at (4096, d, d), the shape of
    every DFA projection of qwen3-1.7b (d 2048) and minicpm3-4b (d 2560):
    a drift residual, the planner's plan and every plan of the forced grid
    equal to the plain version bit for bit."""
    cfg = ph.PRESETS["emu_offchip"]
    g = torch.Generator(device=cuda).manual_seed(d)
    a = torch.rand((4096, d), generator=g, device=cuda) * 2 - 1
    b = torch.rand((d, d), generator=g, device=cuda) * 2 - 1
    a_t, b_t, n_panels = channel.tile_operands(a, b, cfg)
    assert n_panels == -(-d // cfg.bank_cols)
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


@pytest.mark.parametrize("sq,kvh,causal", [(4096, 8, True), (1024, 16, False)])
def test_flash_attention_matches_reference_on_the_card(cuda, sq, kvh, causal):
    """f32 on the card, TF32 off: the chunked online softmax against the
    O(S²) oracle within the reference's 2e-5 (qwen3's head_dim 128, GQA
    16:8 at seq 4096 with q_chunk 2048 and k_chunk 1024)."""
    g = torch.Generator(device=cuda).manual_seed(sq)
    q = torch.randn((2, sq, 16, 128), generator=g, device=cuda)
    k = torch.randn((2, sq, kvh, 128), generator=g, device=cuda)
    v = torch.randn((2, sq, kvh, 128), generator=g, device=cuda)
    pos = torch.arange(sq, device=cuda)[None].expand(2, sq)
    got = attention.flash_attention(q, k, v, q_pos=pos, kv_pos=pos, causal=causal,
                                    q_chunk=2048, k_chunk=1024)
    expect = attention.reference_attention(q, k, v, q_pos=pos, kv_pos=pos, causal=causal)
    torch.testing.assert_close(got, expect, rtol=2e-5, atol=2e-5)
