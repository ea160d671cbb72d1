"""The bank kernel on the card against its plain version: every variant
and every seam between them.  Marked ``gpu``: skipped where there is no
CUDA device; on the card run

    python -m pytest -m gpu tests/test_torch_kernel_gpu.py -q
"""

import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import photonic_matmul as pm  # noqa: E402

pytestmark = pytest.mark.gpu

DTYPES = [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)]
# both sides of the planner's seam, prefill and beyond one mma tile
TS = [1, 4, pm.SEAM, pm.SEAM + 1, 64, 200]
KS = [10, 257, 1024, 2816]  # unaligned (scalar loads) and aligned (16-byte loads)
MS = [1, 63, 800, 1024]
HEAD = (4, 1024, 151936)  # the qwen1.5-0.5b head at decode


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("t,k,m", [(4, 1024, 1024), (64, 2816, 1024), (200, 300, 257),
                                   (64, 10, 800)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("mode", ["none", "input", "prng"])
def test_kernel_matches_plain(cuda, t, k, m, dtype, tol, mode):
    g = torch.Generator(device=cuda).manual_seed(t + k + m)
    a = (torch.rand((t, k), generator=g, device=cuda) * 2 - 1).to(dtype)
    b = (torch.rand((m, k), generator=g, device=cuda) * 2 - 1).to(dtype)
    kw = {"none": {}, "input": {"noise": torch.randn((t, m), generator=g, device=cuda)},
          "prng": {"seed": 5, "sigma_step": 0.1}}[mode]
    before = pm.launches
    got = pm.photonic_matmul_cuda(a, b, **kw)
    torch.cuda.synchronize()
    assert pm.launches == before + 1
    expect = pm.photonic_matmul_plain(a, b, **kw)
    torch.testing.assert_close(got, expect, rtol=tol, atol=tol * expect.abs().max().item() + 1e-6)


def _operands(cuda, t, k, m, dtype, misaligned=False):
    g = torch.Generator(device=cuda).manual_seed(t * 7 + k * 3 + m)

    def make(rows):
        x = (torch.rand((rows, k), generator=g, device=cuda) * 2 - 1).to(dtype)
        if misaligned:  # contiguous, one element past a 16-byte boundary
            x = torch.empty(rows * k + 1, device=cuda, dtype=dtype)[1:].view(rows, k).copy_(x)
        return x

    a, b = make(t), make(m)
    modes = {"none": {}, "input": {"noise": torch.randn((t, m), generator=g, device=cuda)},
             "prng": {"seed": 5, "sigma_step": 0.1}}
    return a, b, modes


def _check_all_modes(a, b, modes, tol, plan=None):
    for mode, kw in modes.items():
        got = pm.launch_kernel(a, b, plan=plan, **kw)
        torch.cuda.synchronize()
        expect = pm.photonic_matmul_plain(a, b, **kw)
        assert got.shape == expect.shape and got.dtype == torch.float32
        torch.testing.assert_close(got, expect, rtol=tol,
                                   atol=tol * expect.abs().max().item() + 1e-6,
                                   msg=lambda msg, mode=mode: f"{mode}: {msg}")


def _plans(t, k, dtype, aligned):
    """Every plan the kernel takes for these operands."""
    plans = []
    if t <= 16:
        plans.append(pm.Plan(pm.SKINNY_SCALAR))
        if aligned:
            plans.append(pm.Plan(pm.SKINNY))
    if dtype == torch.bfloat16:
        for split in (1, 2, 4, 8):
            plans.append(pm.Plan(pm.MMA_SCALAR, split))
            if aligned:
                plans.append(pm.Plan(pm.MMA, split))
    else:
        plans.append(pm.Plan(pm.FFMA))
    return plans


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_planned_variant_matches_plain(cuda, t, k, m, dtype, tol):
    """The planner's variant for each shape across the seams, noise modes
    none / input / prng."""
    a, b, modes = _operands(cuda, t, k, m, dtype)
    before = pm.launches
    pm.photonic_matmul_cuda(a, b)
    assert pm.launches == before + 1
    _check_all_modes(a, b, modes, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_head_at_decode_matches_plain(cuda, dtype, tol):
    t, k, m = HEAD
    a, b, modes = _operands(cuda, t, k, m, dtype)
    assert pm._plan(t, m, k, dtype, (a.data_ptr(), b.data_ptr())).variant == pm.SKINNY
    _check_all_modes(a, b, modes, tol)


@pytest.mark.parametrize("t,k,m", [(4, 1024, 1024), (pm.SEAM, 257, 800), (pm.SEAM + 1, 1024, 63),
                                   (16, 2816, 800)])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_every_variant_matches_plain(cuda, t, k, m, dtype, tol):
    """Each variant (and each cluster split of the mma variant) the kernel
    can run these operands with, not only the planner's."""
    a, b, modes = _operands(cuda, t, k, m, dtype)
    aligned = pm._aligned(k, a.element_size(), (a.data_ptr(), b.data_ptr()))
    for plan in _plans(t, k, dtype, aligned):
        _check_all_modes(a, b, modes, tol, plan=plan)


@pytest.mark.parametrize("t", [4, 64])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_misaligned_view_takes_the_scalar_path(cuda, t, dtype, tol):
    k = m = 1024
    a, b, modes = _operands(cuda, t, k, m, dtype, misaligned=True)
    assert a.data_ptr() % 16 != 0 and b.data_ptr() % 16 != 0
    plan = pm._plan(t, m, k, dtype, (a.data_ptr(), b.data_ptr()))
    assert plan.variant not in pm.VECTOR_VARIANTS
    for variant in pm.VECTOR_VARIANTS:
        with pytest.raises(ValueError, match="16-byte"):
            pm.launch_kernel(a, b, plan=pm.Plan(variant))
    _check_all_modes(a, b, modes, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_variant_is_deterministic(cuda, dtype):
    t, k, m = pm.SEAM, 1024, 800
    a, b, modes = _operands(cuda, t, k, m, dtype)
    for plan in _plans(t, k, dtype, aligned=True):
        for kw in modes.values():
            first = pm.launch_kernel(a, b, plan=plan, **kw)
            again = pm.launch_kernel(a, b, plan=plan, **kw)
            assert torch.equal(first, again), plan.name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prng_sigma_of_skinny_and_tiled_at_the_seam(cuda, dtype):
    """σ of the prng noise is σ_step·√nk within 5% on both sides of the
    seam (T·M = 32768 samples: 5% is > 9 standard errors)."""
    t, k, m = pm.SEAM, 1024, 4096
    a, b, _ = _operands(cuda, t, k, m, dtype)
    step = 0.5 / math.sqrt(math.ceil(k / pm.BLOCK_K))
    tiled = pm.Plan(pm.MMA, 1) if dtype == torch.bfloat16 else pm.Plan(pm.FFMA)
    for plan in (pm.Plan(pm.SKINNY), tiled):
        exact = pm.launch_kernel(a, b, plan=plan)
        noisy = pm.launch_kernel(a, b, plan=plan, seed=21, sigma_step=step)
        z = (noisy - exact).double() / 0.5
        assert abs(z.std().item() - 1) < 0.05, plan.name
        assert abs(z.mean().item()) < 4 / math.sqrt(z.numel()), plan.name


def test_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.randn(8, 16, device=cuda)
    b = torch.randn(4, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        pm.photonic_matmul_cuda(a.T.contiguous().T, b)
    with pytest.raises(TypeError):
        pm.photonic_matmul_cuda(a.half(), b.half())
    with pytest.raises(ValueError):
        pm.photonic_matmul_cuda(a, b.cpu())
    with pytest.raises(ValueError, match="mma"):
        pm.launch_kernel(a, b, plan=pm.Plan(pm.MMA))
    with pytest.raises(ValueError, match="skinny"):
        pm.launch_kernel(torch.randn(17, 16, device=cuda), b, plan=pm.Plan(pm.SKINNY))
