"""Tensor parallelism on the card: ``launch/dryrun.build_train``'s sharded
step of qwen1.5-0.5b at full width (24 layers, d 1024, 16 / 16 heads, d_ff
2816, V 151936) in f32 on a (1, 2) (data, model) mesh, its weights, its
vocabulary and its feedback rows split over two ranks on one card (gloo:
NCCL takes one rank a device), offchip_bpd through the bank kernel, 64 x 64
rows.  Step 1's loss and gradients and the parameters after 2 steps within
1e-5 of each leaf's max of the one process's; 25 bank launches a rank a
step; each piece the rule's slice of an independent init; the resident
parameters and momentum about half the replicated state; ``step_cost``'s
collective bytes = what ``torch.distributed`` was handed.  Marked ``gpu``:
skipped where there is no CUDA device; on the card run

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
