"""whisper-small's and internvl2-2b's new bank-kernel shapes on the card:
whisper's encoder at T = 4 × 1500 = 6000 rows (93 full 64-row tiles and a
48-row partial one) in bf16 (the mma variant) and f32 (ffma), and
internvl2's head (4, 2048 → 92553), the first odd M of a head, in bf16
(skinny) and at T = 64 (the prefill's mma).  Marked ``gpu``: skipped where
there is no CUDA device; on the card run

    python -m pytest -m gpu tests/test_torch_whisper_gpu.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import photonic_matmul as pm  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # the reference's kernel-test bounds
# (T, K, M) of whisper's encoder products at 4 clips of 1500 frames: q / k / v
# / o, fc1, fc2
ENCODE_SHAPES = [(6000, 768, 768), (6000, 768, 3072), (6000, 3072, 768)]
HEAD_SHAPES = [(4, 2048, 92553), (64, 2048, 92553)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(cuda, t, k, m, dtype, variant):
    g = torch.Generator(device=cuda).manual_seed(t + k + m)
    a = torch.randn((t, k), generator=g, device=cuda).to(dtype)
    b = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    assert pm._plan(t, m, k, dtype, (a.data_ptr(), b.data_ptr())).variant == variant
    noise = 0.01 * torch.randn((t, m), generator=g, device=cuda)
    for kw in ({}, {"noise": noise}):
        before = pm.launches
        got = pm.photonic_matmul_cuda(a, b, **kw)
        assert pm.launches == before + 1
        expect = pm.photonic_matmul_plain(a, b, **kw)
        err = (got - expect).abs().max().item()
        assert err <= TOL[dtype] * expect.abs().max().item(), (t, k, m, dtype, sorted(kw))
        # the partial last tile and the odd last column are written too
        assert torch.isfinite(got[-1]).all() and torch.isfinite(got[:, -1]).all()


@pytest.mark.parametrize("t,k,m", ENCODE_SHAPES, ids=[f"{t}x{k}x{m}" for t, k, m in ENCODE_SHAPES])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bank_kernel_matches_plain_at_whisper_encode_shapes(cuda, t, k, m, dtype):
    assert t % 64 == 48
    _check(cuda, t, k, m, dtype, pm.MMA if dtype == torch.bfloat16 else pm.FFMA)


@pytest.mark.parametrize("t,k,m", HEAD_SHAPES, ids=[f"{t}x{k}x{m}" for t, k, m in HEAD_SHAPES])
def test_bank_kernel_matches_plain_at_internvl2_head(cuda, t, k, m):
    assert m % 2 == 1
    _check(cuda, t, k, m, torch.bfloat16, pm.SKINNY if t <= pm.SEAM else pm.MMA)
