"""Data parallelism's pieces on the card: the ``emu_bank_product`` kernel's
``row_base`` (a launch on rows [r, r + n) with ``row_base = r`` equals its
plain version and rows [r, r + n) of a ``row_base = 0`` launch over the
whole batch, bit for bit, under every plan ``candidate_plans`` returns; a
``row_base`` past the 32-bit counters raises), and a world of one NCCL rank
training bit for bit as the single-device path.  Marked ``gpu``: skipped
where there is no CUDA device; on the card run

    python -m pytest -m gpu tests/test_torch_data_parallel_gpu.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
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


def _case(t, k, m, n_buses, dtype, device):
    cfg = ph.PhotonicConfig(noise_std=0.202, n_buses=n_buses,
                            mrr=mrr.MRRConfig(adc_bits=8, shot_noise=0.05))
    g = torch.Generator(device=device).manual_seed(t + k)
    a = (torch.rand((t, k), generator=g, device=device) * 2 - 1).to(dtype)
    b = torch.rand((m, k), generator=g, device=device) * 2 - 1
    a_t, b_t, n_panels = channel.tile_operands(a, b, cfg)
    delta = channel.effective_deltas(b_t, cfg).contiguous()
    kw = dict(n_panels=n_panels, gamma=float(cfg.mrr.gamma), sigma=0.202, shot=0.05,
              adc_bits=8, amax=float(cfg.bank_cols), seed=SEED)
    return a_t, delta, channel.alive_dead_ring_mask(cfg, device), kw


@pytest.mark.parametrize("t,k,m,n_buses,dtype", [
    (64, 800, 10, 1, torch.float32), (96, 1024, 1024, 2, torch.bfloat16),
    (12, 257, 300, 3, torch.float32)])
@pytest.mark.parametrize("r,n", [(0, 8), (5, 7), (32, 4)])
def test_row_base_launch_equals_plain_and_the_whole_batch(cuda, t, k, m, n_buses, dtype, r, n):
    a_t, delta, mask, kw = _case(t, k, m, n_buses, dtype, cuda)
    r, n = min(r, t - 1), min(n, t - min(r, t - 1))
    part = a_t[r:r + n].contiguous()
    whole_t, q, nj, cols = a_t.shape
    nm, _q, rows, _nj, _c = delta.shape
    ptrs = em._pointers(delta, mask)
    sms = em._sm_count(cuda.index or 0)
    plain = em.emu_bank_product_plain(part, delta, mask, row_base=r, **kw)
    for plan in em.candidate_plans(n, nm, rows, q, nj, cols, ptrs, sms):
        got = em.launch_kernel(part, delta, mask, plan=plan, row_base=r, **kw)
        assert torch.equal(got, plain), plan.name
    for plan in em.candidate_plans(whole_t, nm, rows, q, nj, cols, ptrs, sms):
        whole = em.launch_kernel(a_t, delta, mask, plan=plan, **kw)
        assert torch.equal(whole[r:r + n], plain), plan.name
    torch.cuda.synchronize()


def test_row_base_past_the_counters_raises(cuda):
    a_t, delta, mask, kw = _case(8, 64, 50, 1, torch.float32, cuda)
    rows = delta.shape[-3]
    with pytest.raises(ValueError, match="row_base"):
        em.emu_bank_product_cuda(a_t, delta, mask, row_base=(1 << 32) // rows, **kw)
    # the C entry point refuses it too, without a launch
    with pytest.raises(RuntimeError, match="launch failed"):
        em.launch_kernel(a_t, delta, mask, row_base=(1 << 32) // rows, **kw)
    top = (1 << 32) // rows - a_t.shape[0]  # the last base whose counters fit
    got = em.emu_bank_product_cuda(a_t, delta, mask, row_base=top, **kw)
    assert torch.equal(got, em.emu_bank_product_plain(a_t, delta, mask, row_base=top, **kw))


def test_world_of_one_nccl_trains_bit_for_bit(cuda):
    """data_parallel=True without a launcher: a world of one NCCL rank; two
    noisy steps of the MLP equal the single-device path's bit for bit."""
    import torch.distributed as dist

    from repro_torch.data import mnist

    x, y = mnist.procedural_digits(64, seed=1)
    batch = {"x": x, "y": y}
    out = {}
    try:
        for dp in (False, True):
            s = api.build_session(arch="mnist_mlp", hardware="offchip_bpd", backend="cuda",
                                  data_parallel=dp, device=cuda)
            state = s.init_state()
            for _ in range(2):
                state, metrics = s.step(state, batch)
            out[dp] = (state["params"], float(metrics["loss"]))
        assert dist.get_backend() == "nccl" and s.mesh is not None
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert out[True][1] == out[False][1]
    for k, v in out[False][0].items():
        assert torch.equal(out[True][0][k], v), k
