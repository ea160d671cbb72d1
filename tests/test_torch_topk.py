"""The mixture of experts' top-k with ties: the port against
``jax.lax.top_k`` on the CPU.

``jax.lax.top_k`` puts the lower index first among equal values; the
port's ``nn.moe.top_k`` must choose the same experts, or a tied token is
routed elsewhere and every later position in those experts' queues
moves.  Ties are made exact in both frameworks: router logits in quarter
steps (f32 ties) and random logits rounded to bf16 at qwen2-moe's expert
count (60 experts, top 4), each fed through an identity router so that
both sides see the same f32 logits.  The card's
counterpart is ``tests/test_torch_topk_gpu.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.nn.moe import MoE as JMoE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("row,k", [
    ([0.1, 0.3, 0.3, 0.2, 0.3, 0.05], 2),
    ([0.1, 0.3, 0.3, 0.2, 0.3, 0.05], 3),
    ([0.5, 0.5, 0.5, 0.5], 2),
    ([0.0, 1.0, 0.0, 1.0, 0.0, 1.0, 0.5], 4),
])
def test_top_k_orders_ties_as_jax(row, k):
    x = np.asarray(row, np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = tmoe.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_top_k_matches_jax_on_tied_rows():
    """Rows of small integers (many ties) in a batch."""
    x = np.random.default_rng(0).integers(0, 5, (256, 16)).astype(np.float32)
    for k in (1, 2, 4, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tmoe.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _identity_router_pair(n_experts, top_k, capacity_factor):
    """The reference's MoE layer with d_model = E and an identity router,
    and the port's layer carrying its parameters: the router's logits are
    the input rows, exactly, in either framework."""
    kw = dict(d_model=n_experts, d_ff_expert=8, n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor)
    jl = JMoE(**kw)
    jp = jl.init(jax.random.PRNGKey(0))
    jp["router"]["w"] = jnp.eye(n_experts, dtype=jnp.float32)
    tl = tmoe.MoE(**kw, device="cpu")
    tl.load_state_dict(convert.state_dict_from_reference(_to_np(jp)))
    return jl, jp, tl


def _ties_across_the_boundary(logits, k):
    """Tokens whose k-th and (k+1)-th largest logits are equal."""
    s = -np.sort(-logits, axis=-1)
    return int(np.sum(s[:, k - 1] == s[:, k]))


def _assert_routing_equal(jl, jp, tl, x):
    jv, ji, jkeep, jpos, jcap, _ = jax.jit(jl._route_topk)(jp, jnp.asarray(x))
    with torch.no_grad():
        tv, ti, tkeep, tpos, tcap, _ = tl._route_topk(torch.from_numpy(np.array(x)))
    assert tcap == jcap
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["cap1.25", "drops"])
def test_routing_with_tied_f32_logits_matches_reference(capacity_factor):
    """Logits in quarter steps over 8 experts, top 2: the chosen experts,
    ``keep`` and ``pos`` equal the reference's."""
    jl, jp, tl = _identity_router_pair(8, 2, capacity_factor)
    x = (np.random.default_rng(1).integers(-4, 5, (128, 8)) / 4).astype(np.float32)
    assert _ties_across_the_boundary(x, 2) >= 10
    _assert_routing_equal(jl, jp, tl, x)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["cap1.25", "drops"])
def test_routing_with_bf16_logits_matches_reference(capacity_factor):
    """Random logits rounded to bf16 at qwen2-moe's width (60 experts, top
    4, 1024 tokens): ties across the top-4 boundary occur, and the routing
    equals the reference's."""
    jl, jp, tl = _identity_router_pair(60, 4, capacity_factor)
    x = np.random.default_rng(2).standard_normal((1024, 60)).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    assert _ties_across_the_boundary(x, 4) >= 10
    _assert_routing_equal(jl, jp, tl, x)
