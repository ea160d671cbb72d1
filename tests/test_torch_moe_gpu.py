"""The bank kernel's batch axis on the card: A (E, T, K) and B (E, M, K) in
one launch, as the mixture of experts' stacked products run it.  Under
every variant and scalar-load twin the planner can pick (skinny, mma with
cluster splits 1/2/4/8, ffma), with E ∈ {1, 3, 60}, T across the seam
between the skinny and the tiled variants and noise modes none / input /
prng: the batched launch against its plain version within the reference's
kernel-test bound, and index e against a 2-D launch of ``a[e]``, ``b[e]``
under the same plan, bit for bit.  Marked ``gpu``: skipped where there is
no CUDA device; on the card run

    python -m pytest -m gpu tests/test_torch_moe_gpu.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import photonic_matmul as pm  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # the reference's kernel-test bounds
TS = [1, 4, pm.SEAM, pm.SEAM + 1, 64, 100]
KS = [256, 250]  # 16-byte rows, and rows that only the scalar-load twins take


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _plans(t, k, dtype, pointers):
    """Every plan the kernel takes on these operands."""
    itemsize = 2 if dtype == torch.bfloat16 else 4
    vec = pm._aligned(k, itemsize, pointers)
    plans = []
    if t <= 16:
        plans += [pm.Plan(pm.SKINNY)] * vec + [pm.Plan(pm.SKINNY_SCALAR)]
    if dtype == torch.bfloat16:
        plans += [pm.Plan(pm.MMA, s) for s in (1, 2, 4, 8)] * vec
        plans += [pm.Plan(pm.MMA_SCALAR, s) for s in (1, 2)]
    else:
        plans.append(pm.Plan(pm.FFMA))
    return plans


def _noise(cuda, mode, t, m):
    if mode == "input":
        g = torch.Generator(device=cuda).manual_seed(t * 7 + m)
        return {"noise": 0.05 * torch.randn((t, m), generator=g, device=cuda)}
    if mode == "prng":
        return {"seed": 0x5EED, "sigma_step": 0.01}
    return {}


@pytest.mark.parametrize("mode", ["none", "input", "prng"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("e", [1, 3, 60])
def test_batched_launch_equals_single_launches(cuda, e, t, k, dtype, mode):
    m = 96
    g = torch.Generator(device=cuda).manual_seed(e * 1000 + t * 10 + k)
    a = (torch.rand((e, t, k), generator=g, device=cuda) * 2 - 1).to(dtype)
    b = (torch.rand((e, m, k), generator=g, device=cuda) * 2 - 1).to(dtype)
    kw = _noise(cuda, mode, t, m)
    expect = pm.photonic_matmul_plain(a, b, **kw)
    scale = expect.abs().max().item()
    for plan in _plans(t, k, dtype, (a.data_ptr(), b.data_ptr())):
        got = pm.launch_kernel(a, b, plan=plan, **kw)
        assert got.shape == (e, t, m)
        err = (got - expect).abs().max().item()
        assert err <= TOL[dtype] * scale, (plan.name, err, scale)
        for i in range(e):
            one = pm.launch_kernel(a[i], b[i], plan=plan, **kw)
            assert torch.equal(got[i], one), (plan.name, i)


@pytest.mark.parametrize("e,t,k,m", [(60, 1, 2048, 1408), (60, 1, 1408, 2048),
                                     (60, 5, 2048, 1408), (60, 5, 1408, 2048)])
def test_qwen2_moe_expert_shapes(cuda, e, t, k, m):
    """The planner's plan at qwen2-moe's expert shapes (decode cap 1,
    prefill cap 5) in bf16: one launch counted, the plain version's bound,
    and every index equal to its 2-D launch."""
    g = torch.Generator(device=cuda).manual_seed(e + t + k + m)
    a = (torch.rand((e, t, k), generator=g, device=cuda) * 2 - 1).to(torch.bfloat16)
    b = (torch.rand((e, m, k), generator=g, device=cuda) * 2 - 1).to(torch.bfloat16)
    noise = 0.05 * torch.randn((t, m), generator=g, device=cuda)
    before = pm.launches
    got = pm.photonic_matmul_cuda(a, b, noise=noise)
    assert pm.launches == before + 1
    expect = pm.photonic_matmul_plain(a, b, noise=noise)
    assert (got - expect).abs().max().item() <= TOL[torch.bfloat16] * expect.abs().max().item()
    plan = pm._plan(t, m, k, a.dtype, (a.data_ptr(), b.data_ptr()), e=e)
    for i in range(e):
        assert torch.equal(got[i], pm.launch_kernel(a[i], b[i], noise=noise, plan=plan)), i


def test_batched_launch_is_deterministic_and_masks(cuda):
    """The same launch twice gives the same bits; the masked entry (the
    fused DFA gradient) takes a batch with an (E, T, M) mask."""
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.rand((3, 64, 256), generator=g, device=cuda) * 2 - 1
    b = torch.rand((3, 96, 256), generator=g, device=cuda) * 2 - 1
    mask = (torch.rand((3, 64, 96), generator=g, device=cuda) > 0.5).float()
    kw = {"seed": 11, "sigma_step": 0.02}
    first = pm.launch_kernel(a, b, **kw)
    assert torch.equal(first, pm.launch_kernel(a, b, **kw))
    got = pm.launch_kernel(a, b, mask=mask, **kw)
    expect = pm.photonic_matmul_plain(a, b, **kw) * mask
    assert (got - expect).abs().max().item() <= TOL[torch.float32] * expect.abs().max().item()
