"""Tensor parallelism on the card: ``launch/dryrun.build_train``'s sharded
step of qwen1.5-0.5b at full width (24 layers, d 1024, 16 / 16 heads, d_ff
2816, V 151936) in f32 on a (1, 2) (data, model) mesh, its weights, its
vocabulary and its feedback rows split over two ranks on one card (gloo:
NCCL takes one rank a device), the dense blocks' products column-parallel,
offchip_bpd through the bank kernel, 64 x 64 rows.  Step 1's loss and gradients and the parameters after 2 steps within
1e-5 of each leaf's max of the one process's; 25 bank launches a rank a
step; each piece the rule's slice of an independent init; the resident
parameters and momentum about half the replicated state; ``step_cost``'s
collective bytes = what ``torch.distributed`` was handed.  The emu kernel's
``col_base`` (a rank's first global output column, whole bank panels): a
launch on panels [p, nm) with ``col_base = p·rows`` equals its plain version
and those columns of a ``col_base = 0`` launch over the whole product, bit
for bit, under every plan ``candidate_plans`` returns; a column base inside
a panel or past the slot counters raises.  The bank kernel in a column
window at the sharded serving's shapes (a rank's half of qwen1.5's q / o,
gate / up, down and head rows on (1, 2), T = 4 and 128, f32 and bf16,
offchip_bpd in input mode) equal to the plain version in the same window
and to the whole product's columns.  Marked ``gpu``: skipped where
there is no CUDA device; on the card run

    python -m pytest -m gpu tests/test_torch_tensor_parallel_gpu.py -q
"""

import pytest

torch = pytest.importorskip("torch")

import _dist_ranks as ranks  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = 1e-5  # of each leaf's max |value| (ROADMAP)
LAUNCHES = 25  # a dfa step's bank products: 24 blocks + the embedding


@pytest.fixture(scope="module")
def two_ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    from repro_torch.kernels import photonic_matmul as pm

    pm.build()  # once, before the ranks load it
    return ranks.spawn("tp_card", 2, timeout=600.0, seed=0, seq=64, batch=64)


def test_step_equals_one_process(two_ranks):
    r0, r1 = two_ranks
    assert r0["loss1"] == r1["loss1"] and r0["loss2"] == r1["loss2"]
    assert r0["loss1"] == pytest.approx(r0["one_loss"], abs=TOL * abs(r0["one_loss"]))
    assert r0["grad_err"] <= TOL
    assert r0["params2_err"] <= TOL


def test_launches_pieces_and_resident_bytes(two_ranks):
    for r in two_ranks:
        assert r["launches"] == [LAUNCHES, LAUNCHES]
        assert r["pieces"]
        assert 0.5 <= r["share"] < 0.51


def test_step_cost_counts_the_collectives_handed_to_torch_distributed(two_ranks):
    for r in two_ranks:
        assert r["counted"] == r["seen"]
        assert r["counted"]["all-gather"] > 0 and r["counted"]["all-reduce"] > 0


SEED = (0x1234ABCD, 0x0BADF00D)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _emu_case(t, k, m, n_buses, dtype, device):
    from repro_torch.core import photonics as ph
    from repro_torch.hardware import channel, mrr

    cfg = ph.PhotonicConfig(noise_std=0.202, n_buses=n_buses,
                            mrr=mrr.MRRConfig(adc_bits=8, shot_noise=0.05))
    g = torch.Generator(device=device).manual_seed(t + k + m)
    a = (torch.rand((t, k), generator=g, device=device) * 2 - 1).to(dtype)
    b = torch.rand((m, k), generator=g, device=device) * 2 - 1
    a_t, b_t, n_panels = channel.tile_operands(a, b, cfg)
    delta = channel.effective_deltas(b_t, cfg).contiguous()
    kw = dict(n_panels=n_panels, gamma=float(cfg.mrr.gamma), sigma=0.202, shot=0.05,
              adc_bits=8, amax=float(cfg.bank_cols), seed=SEED)
    return a_t, delta, channel.alive_dead_ring_mask(cfg, device), kw


@pytest.mark.parametrize("t,k,m,n_buses,dtype,panel,r", [
    (64, 800, 10, 1, torch.float32, 0, 0), (96, 1024, 1024, 2, torch.bfloat16, 10, 5),
    (12, 257, 300, 3, torch.float32, 3, 0), (8, 40, 130, 1, torch.float32, 1, 2)])
def test_col_base_launch_equals_plain_and_the_whole_product(cuda, t, k, m, n_buses, dtype,
                                                            panel, r):
    from repro_torch.kernels import emu_matmul as em

    a_t, delta, mask, kw = _emu_case(t, k, m, n_buses, dtype, cuda)
    whole_t, q, nj, cols = a_t.shape
    nm, _q, rows, _nj, _c = delta.shape
    panel = min(panel, nm - 1)
    a_part, d_part = a_t[r:].contiguous(), delta[panel:].contiguous()
    c0 = panel * rows
    sms = em._sm_count(cuda.index or 0)
    plain = em.emu_bank_product_plain(a_part, d_part, mask, row_base=r, col_base=c0, **kw)
    for plan in em.candidate_plans(whole_t - r, nm - panel, rows, q, nj, cols,
                                   em._pointers(d_part, mask), sms):
        got = em.launch_kernel(a_part, d_part, mask, plan=plan, row_base=r, col_base=c0, **kw)
        assert torch.equal(got, plain), plan.name
    for plan in em.candidate_plans(whole_t, nm, rows, q, nj, cols, em._pointers(delta, mask),
                                   sms):
        whole = em.launch_kernel(a_t, delta, mask, plan=plan, **kw)
        assert torch.equal(whole[r:, c0:], plain), plan.name
    torch.cuda.synchronize()


def test_col_base_inside_a_panel_or_past_the_counters_raises(cuda):
    from repro_torch.kernels import emu_matmul as em

    a_t, delta, mask, kw = _emu_case(8, 1024, 100, 1, torch.float32, cuda)
    nm, q, rows, nj, _c = delta.shape
    with pytest.raises(ValueError, match="whole number of panels"):
        em.emu_bank_product_cuda(a_t, delta, mask, col_base=rows // 2, **kw)
    # the C entry point refuses both without a launch
    with pytest.raises(RuntimeError, match="launch failed"):
        em.launch_kernel(a_t, delta, mask, col_base=rows // 2, **kw)
    top = (em.COUNTER_SLOTS // (q * nj) - nm) * rows  # the last base whose counters fit
    with pytest.raises(RuntimeError, match="launch failed"):
        em.launch_kernel(a_t, delta, mask, col_base=top + rows, **kw)
    got = em.emu_bank_product_cuda(a_t, delta, mask, col_base=top, **kw)
    assert torch.equal(got, em.emu_bank_product_plain(a_t, delta, mask, col_base=top, **kw))


KERNEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # the reference's kernel-test bounds
# (K, M) of qwen1.5's serving products: q / k / v / o, gate / up, down, the head
SERVE_PRODUCTS = ((1024, 1024), (1024, 2816), (2816, 1024), (1024, 151936))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [4, 128])
@pytest.mark.parametrize("k,m", SERVE_PRODUCTS)
def test_bank_kernel_in_a_column_window_equals_plain(cuda, k, m, t, dtype):
    """Rank 1's rows [M/2, M) of a serving product in its column window
    (s_b from its rows, where the whole weight's max lies; the noise its
    columns of the global draw): the kernel = the plain version in the same
    window = the whole product's columns."""
    from repro_torch.core import photonics as ph
    from repro_torch.kernels import ops

    cfg = ph.preset("offchip_bpd")
    gen = torch.Generator(device=cuda).manual_seed(t + k + m)
    a = torch.randn(t, k, generator=gen, device=cuda).to(dtype)
    b = torch.randn(m, k, generator=gen, device=cuda) * 0.02
    n = m // 2
    b[n + 1, 3] = 1.0  # the whole weight's max, in the window's rows
    b = b.to(dtype)
    with ph.column_window(ph.ColumnWindow(n, m - n, m)):
        got = ops.photonic_matmul(a, b[n:], cfg, key=9).float()
        plain = ph.photonic_matmul(a, b[n:], cfg, key=9).float()
    whole = ph.photonic_matmul(a, b, cfg, key=9)[:, n:].float()
    torch.cuda.synchronize()
    for expect in (plain, whole):
        assert ((got - expect).abs().max() / expect.abs().max()).item() <= KERNEL_TOL[dtype]
