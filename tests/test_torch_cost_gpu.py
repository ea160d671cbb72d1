"""The kernels' bytes on the card: each wrapper, run under
``utils.flop_cost.measure``, reports one launch whose bytes are its
kernel's helper's for the shape (``photonic_matmul.launch_bytes``,
``dfa_gradient.launch_bytes``, ``emu_matmul.launch_bytes``), 2-D and
batched, and a step's ``mem_bytes`` holds its kernels' bytes.  Marked
``gpu``: skipped where there is no CUDA device; on the card run

    python -m pytest -m gpu tests/test_torch_cost_gpu.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import photonics as ph  # noqa: E402
from repro_torch.hardware import channel, mrr  # noqa: E402
from repro_torch.kernels import dfa_gradient as dg  # noqa: E402
from repro_torch.kernels import emu_matmul as em  # noqa: E402
from repro_torch.kernels import photonic_matmul as pm  # noqa: E402
from repro_torch.utils import flop_cost  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _one_launch(fn):
    _, cost = flop_cost.measure(fn)
    torch.cuda.synchronize()
    assert cost.kernel_launches == 1
    assert cost.mem_bytes >= cost.kernel_bytes
    return cost


@pytest.mark.parametrize("e", [0, 60])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,k,m", [(4, 1024, 2816), (64, 768, 800)])
def test_bank_and_dfa_gradient_report_their_helpers_bytes(cuda, e, dtype, t, k, m):
    g = torch.Generator(device=cuda).manual_seed(0)
    lead = (e,) if e else ()
    a = torch.randn((*lead, t, k), generator=g, device=cuda).to(dtype)
    b = torch.randn((*lead, m, k), generator=g, device=cuda).to(dtype)
    noise = torch.randn((t, m), generator=g, device=cuda)
    mask = torch.rand((*lead, t, m), generator=g, device=cuda)
    size = a.element_size()
    for kw, has_noise in (({}, False), ({"noise": noise}, True), ({"seed": 7}, False)):
        cost = _one_launch(lambda: pm.photonic_matmul_cuda(a, b, **kw))
        assert cost.kernel_bytes == pm.launch_bytes(t, m, k, size, e=max(e, 1),
                                                    noise=has_noise)
        assert cost.kernel_flops == 2 * max(e, 1) * t * k * m
        cost = _one_launch(lambda: dg.dfa_gradient_cuda(a, b, mask, **kw))
        assert cost.kernel_bytes == dg.launch_bytes(t, m, k, size, e=max(e, 1),
                                                    noise=has_noise)


@pytest.mark.parametrize("e", [0, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emu_reports_its_helpers_bytes(cuda, e, dtype):
    cfg = ph.PhotonicConfig(noise_std=0.098, mrr=mrr.MRRConfig(adc_bits=10,
                                                               dead_ring_rate=0.01))
    g = torch.Generator(device=cuda).manual_seed(1)
    lead = (e,) if e else ()
    a = (torch.rand((*lead, 8, 300), generator=g, device=cuda) * 2 - 1).to(dtype)
    b = torch.rand((*lead, 120, 300), generator=g, device=cuda) * 2 - 1
    a_t, b_t, n_panels = channel.tile_operands(a, b, cfg)
    delta = channel.effective_deltas(b_t, cfg, None).contiguous().float()
    mask = channel.alive_dead_ring_mask(cfg, cuda)
    for dead in (mask, None):
        cost = _one_launch(lambda: em.emu_bank_product_cuda(
            a_t.contiguous(), delta, dead, n_panels=n_panels, gamma=1.0, sigma=0.098,
            shot=0.0, adc_bits=10, amax=20.0, seed=(1, 2)))
        assert cost.kernel_bytes == em.launch_bytes(tuple(a_t.shape), a_t.element_size(),
                                                    tuple(delta.shape), dead is not None)
