"""The fused dfa_gradient kernel on the card against its plain version.
Marked ``gpu``: skipped where there is no CUDA device; on the card run

    python -m pytest -m gpu tests/test_torch_dfa_gradient_gpu.py -q
"""

import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import photonics as ph  # noqa: E402
from repro_torch.kernels import dfa_gradient as dg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import photonic_matmul as pm  # noqa: E402

pytestmark = pytest.mark.gpu

# tests/test_kernels.py's shapes and the paper MLP's projection at batch 256
SHAPES = [(4, 8, 16), (64, 10, 800), (128, 128, 128), (200, 300, 257), (256, 512, 384),
          (256, 10, 800)]
# the bank kernel's variants and seams (tests/test_torch_kernel_gpu.py's grid)
TS = [1, 4, pm.SEAM, pm.SEAM + 1, 64, 200]
KS = [10, 257, 1024, 2816]
MS = [1, 63, 800, 1024]
DTYPES = [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, t, k, m, dtype, binary):
    g = torch.Generator(device=cuda).manual_seed(t + k + m)
    a = (torch.rand((t, k), generator=g, device=cuda) * 2 - 1).to(dtype)
    b = (torch.rand((m, k), generator=g, device=cuda) * 2 - 1).to(dtype)
    pre = torch.randn((t, m), generator=g, device=cuda)
    mask = (pre > 0).float() if binary else 1 - torch.tanh(pre) ** 2
    return a, b, mask, torch.randn((t, m), generator=g, device=cuda)


@pytest.mark.parametrize("t,k,m", SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("mode", ["none", "input", "prng"])
@pytest.mark.parametrize("binary", [True, False], ids=["relu'", "tanh'"])
def test_kernel_matches_plain(cuda, t, k, m, dtype, tol, mode, binary):
    a, b, mask, noise = _inputs(cuda, t, k, m, dtype, binary)
    kw = {"none": {}, "input": {"noise": noise}, "prng": {"seed": 5, "sigma_step": 0.1}}[mode]
    before = dg.launches
    got = dg.dfa_gradient_cuda(a, b, mask, **kw)
    torch.cuda.synchronize()
    assert dg.launches == before + 1
    expect = dg.dfa_gradient_plain(a, b, mask, **kw)
    assert got.dtype == torch.float32 and got.shape == (t, m)
    torch.testing.assert_close(got, expect, rtol=0,
                               atol=tol * expect.abs().max().item() + 1e-6)
    assert bool((got[mask == 0] == 0).all())


def _check_all(cuda, t, k, m, dtype, tol):
    for binary in (True, False):
        a, b, mask, noise = _inputs(cuda, t, k, m, dtype, binary)
        for mode, kw in (("none", {}), ("input", {"noise": noise}),
                         ("prng", {"seed": 5, "sigma_step": 0.1})):
            got = dg.dfa_gradient_cuda(a, b, mask, **kw)
            torch.cuda.synchronize()
            expect = dg.dfa_gradient_plain(a, b, mask, **kw)
            assert got.dtype == torch.float32 and got.shape == (t, m)
            torch.testing.assert_close(got, expect, rtol=0,
                                       atol=tol * expect.abs().max().item() + 1e-6,
                                       msg=lambda msg, mode=mode: f"{mode} {binary}: {msg}")
            assert bool((got[mask == 0] == 0).all())


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_every_variant_and_seam_matches_plain(cuda, t, k, m, dtype, tol):
    """The planner's variant for each shape across the seams x relu' /
    tanh' masks x none / input / prng."""
    _check_all(cuda, t, k, m, dtype, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_head_at_decode_matches_plain(cuda, dtype, tol):
    _check_all(cuda, 4, 1024, 151936, dtype, tol)


def test_prng_sigma_on_kept_entries(cuda):
    t, k, m = 256, 10, 800
    a, b, mask, _ = _inputs(cuda, t, k, m, torch.float32, binary=True)
    sigma = 0.5 / math.sqrt(math.ceil(k / pm.BLOCK_K))
    exact = dg.dfa_gradient_cuda(a, b, mask)
    noisy = dg.dfa_gradient_cuda(a, b, mask, seed=9, sigma_step=sigma)
    z = (noisy - exact)[mask != 0].double() / 0.5
    assert abs(z.std().item() - 1) < 0.05


def test_masked_projection_is_the_bank_product_times_the_mask(cuda):
    t, k, m = 64, 10, 800
    a, b, mask, _ = _inputs(cuda, t, k, m, torch.float32, binary=True)
    cfg = ph.PRESETS["offchip_bpd"]
    before_b, before_a = dg.launches, pm.launches
    fused = ph.photonic_project(a, b, cfg, 11, mask=mask, backend="cuda")
    assert dg.launches == before_b + 1 and pm.launches == before_a
    unfused = ph.photonic_project(a, b, cfg, 11, backend="cuda") * mask
    torch.testing.assert_close(fused, unfused, rtol=0,
                               atol=2e-5 * unfused.abs().max().item())
    exact = ops.dfa_gradient(a, b, mask, ph.PRESETS["digital"])
    torch.testing.assert_close(exact, (a @ b.T) * mask, rtol=1e-5, atol=1e-5)


def test_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.randn(8, 16, device=cuda)
    b = torch.randn(4, 16, device=cuda)
    mask = torch.ones(8, 4, device=cuda)
    with pytest.raises(TypeError):
        dg.dfa_gradient_cuda(a, b, mask.half())
    with pytest.raises(ValueError):
        dg.dfa_gradient_cuda(a, b, torch.ones(8, 5, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        dg.dfa_gradient_cuda(a, b, torch.ones(4, 8, device=cuda).T)
    with pytest.raises(ValueError):
        dg.dfa_gradient_cuda(a, b, mask.cpu())
