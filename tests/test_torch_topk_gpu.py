"""The mixture of experts' top-k with ties on the card.

``nn.moe.top_k`` and the routing prelude on CUDA tensors against a numpy
oracle that breaks ties toward the lower index, as ``jax.lax.top_k`` does
(the card has no JAX; ``tests/test_torch_topk.py`` holds the port to
``jax.lax.top_k`` itself on the CPU).  The router is the identity, so the
logits are the input rows exactly.  Marked ``gpu``: skipped where there is
no CUDA device; on the card run

    python -m pytest -m gpu tests/test_torch_topk_gpu.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.nn import moe as tmoe  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _oracle_route(logits, k, cap):
    """(topi, keep, pos) of the reference's routing, ties toward the lower
    index (a stable descending sort of the logits, in the softmax's
    order)."""
    t, e = logits.shape
    topi = np.argsort(-logits, axis=-1, kind="stable")[:, :k]
    assign = np.eye(e, dtype=np.float32)[topi]  # (T, K, E)
    flat = assign.reshape(t * k, e)
    pos_in = (np.cumsum(flat, 0) - flat).reshape(t, k, e)
    keep = (pos_in < cap).astype(np.float32) * assign
    pos = np.einsum("tke,tke->tk", pos_in, keep).astype(np.int64)
    return topi, keep, pos


def _bf16_logits(t, e, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((t, e), generator=g).to(torch.bfloat16).float().numpy()


def test_top_k_breaks_ties_by_index_on_cuda(cuda):
    x = np.random.default_rng(0).integers(0, 5, (4096, 60)).astype(np.float32)
    for k in (1, 2, 4, 8):
        vals, idx = tmoe.top_k(torch.from_numpy(x).to(cuda), k)
        want = np.argsort(-x, axis=-1, kind="stable")[:, :k]
        np.testing.assert_array_equal(idx.cpu().numpy(), want)
        np.testing.assert_array_equal(vals.cpu().numpy(), np.take_along_axis(x, want, -1))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["cap1.25", "drops"])
def test_routing_with_bf16_logits_on_cuda(cuda, capacity_factor):
    """qwen2-moe's width (60 experts, top 4), 4096 tokens of bf16-rounded
    logits: ties across the top-4 boundary occur, and the chosen experts,
    ``keep`` and ``pos`` equal the oracle's."""
    e, k, t = 60, 4, 4096
    layer = tmoe.MoE(e, 8, e, k, capacity_factor=capacity_factor, device=cuda)
    with torch.no_grad():
        layer.router.weight.copy_(torch.eye(e, device=cuda))
    x = _bf16_logits(t, e, 1)
    s = -np.sort(-x, axis=-1)
    assert int(np.sum(s[:, k - 1] == s[:, k])) >= 10
    with torch.no_grad():
        _, topi, keep, pos, cap, _ = layer._route_topk(torch.from_numpy(x).to(cuda),
                                                       with_aux=False)
    want_i, want_keep, want_pos = _oracle_route(x, k, cap)
    np.testing.assert_array_equal(topi.cpu().numpy(), want_i)
    np.testing.assert_array_equal(keep.cpu().numpy(), want_keep)
    np.testing.assert_array_equal(pos.cpu().numpy(), want_pos)
