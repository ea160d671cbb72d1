"""The recurrentgemma family on the card: the bank kernel at every decode
shape recurrentgemma-9b gives it (T = 4, the K = 12288 down projection
and the 256000-row head among them), both skinny variants at K = 12288
(f32 stages A in 196,608 B of shared memory), a full-width local
attention layer decoding past its 2048-slot ring buffer against its
windowed forward, and the windowed ``flash_attention`` against its
oracle.  Marked ``gpu``: skipped where there is no CUDA device; on the
card run

    python -m pytest -m gpu tests/test_torch_recurrentgemma_gpu.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import photonic_matmul as pm  # noqa: E402
from repro_torch.nn import attention  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # the reference's kernel-test bounds
# (T, K, M) of every bank product of one decode token: in_x / in_gate / w_a /
# w_i / out / q / o, the MLP's gate / up and down, k / v, the head
DECODE_SHAPES = [(4, 4096, 4096), (4, 4096, 12288), (4, 12288, 4096), (4, 4096, 256),
                 (4, 4096, 256000)]


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


@pytest.mark.parametrize("t,k,m", DECODE_SHAPES, ids=[f"{t}x{k}x{m}" for t, k, m in DECODE_SHAPES])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bank_kernel_matches_plain_at_recurrentgemma_decode_shapes(cuda, t, k, m, dtype):
    a, b = _operands(cuda, t, k, m, dtype)
    noise = 0.01 * torch.randn((t, m), device=cuda)
    for kw in ({}, {"noise": noise}):
        before = pm.launches
        got = pm.photonic_matmul_cuda(a, b, **kw)
        assert pm.launches == before + 1
        expect = pm.photonic_matmul_plain(a, b, **kw)
        assert (got - expect).abs().max().item() <= TOL[dtype] * expect.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_both_skinny_variants_at_k_12288(cuda, dtype):
    """The down projection: T = 4 rows of K = 12288 staged whole in shared
    memory (196,608 B in f32), by the 16-byte-load variant and its
    scalar-load twin."""
    t, k, m = 4, 12288, 4096
    itemsize = 4 if dtype == torch.float32 else 2
    assert pm._skinny_rows(t) * k * itemsize <= pm.SMEM_MAX
    a, b = _operands(cuda, t, k, m, dtype)
    assert pm._plan(t, m, k, dtype, (a.data_ptr(), b.data_ptr())).variant == pm.SKINNY
    expect = pm.photonic_matmul_plain(a, b)
    for plan in (pm.Plan(pm.SKINNY), pm.Plan(pm.SKINNY_SCALAR)):
        got = pm.launch_kernel(a, b, plan=plan)
        assert (got - expect).abs().max().item() <= TOL[dtype] * expect.abs().max().item(), \
            plan.name


def test_ring_buffer_at_the_configs_window(cuda):
    """One local attention layer at recurrentgemma-9b's width (d 4096, 16
    heads, kv 1, head dim 256, window 2048) in f32: 2100 decode steps
    through its 2048-slot ring equal its windowed full forward
    (tests/test_layers.py's bound)."""
    layer = attention.Attention(4096, 16, 1, window=2048, device=cuda).init(3)
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((1, 2100, 4096), generator=g, device=cuda)
    with torch.no_grad():
        full = layer(x)
        cache = layer.init_cache(1, 4096)
        assert cache["k"].shape[1] == 2048
        outs = []
        for t in range(x.shape[1]):
            y, cache = layer.decode(x[:, t:t + 1], cache,
                                    torch.full((1,), t, dtype=torch.long, device=cuda))
            outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=1e-4, atol=2e-5)


def test_windowed_flash_attention_matches_reference_on_the_card(cuda):
    """Batch 2 x seq 4096, 16 heads of 256, kv 1, window 2048, q_chunk 2048
    and k_chunk 1024: the chunked online softmax against the windowed
    O(S²) oracle within the reference's 2e-5."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((2, 4096, 16, 256), generator=g, device=cuda)
    k = torch.randn((2, 4096, 1, 256), generator=g, device=cuda)
    v = torch.randn((2, 4096, 1, 256), generator=g, device=cuda)
    pos = torch.arange(4096, device=cuda)[None].expand(2, 4096)
    kw = dict(q_pos=pos, kv_pos=pos, causal=True, window=2048)
    got = attention.flash_attention(q, k, v, q_chunk=2048, k_chunk=1024, **kw)
    expect = attention.reference_attention(q, k, v, **kw)
    torch.testing.assert_close(got, expect, rtol=2e-5, atol=2e-5)
