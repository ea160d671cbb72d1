"""The bank kernel on the card against its plain version.  Marked ``gpu``:
skipped where there is no CUDA device; on the card run

    python -m pytest -m gpu tests/test_torch_kernel_gpu.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import photonic_matmul as pm  # noqa: E402

pytestmark = pytest.mark.gpu


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


def test_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.randn(8, 16, device=cuda)
    b = torch.randn(4, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        pm.photonic_matmul_cuda(a.T.contiguous().T, b)
    with pytest.raises(TypeError):
        pm.photonic_matmul_cuda(a.half(), b.half())
    with pytest.raises(ValueError):
        pm.photonic_matmul_cuda(a, b.cpu())
