"""Elastic scaling of the port's checkpoints: a snapshot holds logical
tensors, so one taken on one mesh restores on a mesh of another size.

The smoke qwen3-1.7b's parameters (the reference's, carried by
``convert``) placed by ``PARAM_RULES`` on a (2, 2) mesh of four gloo ranks
are saved, then restored on two ranks: every local shard is its rule's
slice on both meshes, the logical tensors come back bit for bit, and the
loss equals the reference's on the same parameters.  A property test
round-trips trees of ``DTensor`` leaves in a world of one."""

import hypothesis
import hypothesis.strategies as st
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _dist_ranks as ranks  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402

BATCH = {"tokens": np.zeros((4, 16), np.int32), "labels": np.ones((4, 16), np.int32)}


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    jm = jconfigs.get("qwen3-1.7b").make_smoke()
    jp = jm.init(jax.random.PRNGKey(0))
    loss, _ = jm.loss(jp, {k: jnp.asarray(v) for k, v in BATCH.items()})
    params = {k: v.numpy() for k, v in convert.state_dict_from_reference(
        jax.tree_util.tree_map(np.asarray, jp)).items()}
    path = str(tmp_path_factory.mktemp("elastic") / "elastic.pt")
    saved = ranks.spawn("elastic_save", 4, params=params, path=path, data=2, model=2)
    loaded = ranks.spawn("elastic_load", 2, params=params, path=path, batch=BATCH)
    return {"loss": float(loss), "saved": saved, "loaded": loaded, "path": path,
            "params": params}


def test_shards_are_the_rules_on_both_meshes(elastic):
    # most leaves split on the (2, 2) mesh; the norm scales stay whole
    assert all(r["split"] == elastic["saved"][0]["split"] > 0 for r in elastic["saved"])
    assert all(r["split"] > 0 for r in elastic["loaded"])


def test_snapshot_holds_the_logical_tensors(elastic):
    flat, step = tckpt.load(elastic["path"])
    assert step == 7
    for k, v in elastic["params"].items():
        assert torch.equal(flat[f"params/{k}"], torch.from_numpy(v)), k


def test_restore_on_two_ranks_is_bit_for_bit_and_gives_the_references_loss(elastic):
    for r in elastic["loaded"]:
        assert r["step"] == 7 and r["exact"]
        assert r["loss"] == pytest.approx(elastic["loss"], rel=1e-5)


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo group of one rank in this process, torn down after."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield tmesh.make_host_mesh(1, device_type="cpu")
    finally:
        dist.destroy_process_group()


@hypothesis.given(
    shapes=st.lists(st.tuples(st.integers(1, 8), st.integers(1, 8)), min_size=1, max_size=5),
    dtype=st.sampled_from(["float32", "int32", "bfloat16"]),
    step=st.integers(0, 10**9),
)
@hypothesis.settings(max_examples=10, deadline=None)
def test_dtensor_tree_roundtrip_property(world_of_one, tmp_path_factory, shapes, dtype, step):
    from torch.distributed.tensor import DTensor, distribute_tensor

    mesh = world_of_one
    rng = np.random.default_rng(0)
    tree = {f"blocks.{i}.attn.q.weight": torch.from_numpy(
        rng.normal(size=s).astype("float32")).to(getattr(torch, dtype))
        for i, s in enumerate(shapes)}
    sh = tsh.make_param_shardings(mesh, tree)
    placed = {k: distribute_tensor(v, mesh, sh[k].placements) for k, v in tree.items()}
    path = str(tmp_path_factory.mktemp("dt") / "c.pt")
    tckpt.save(path, {"params": placed, "step": step}, step=step)
    template = {"params": {k: torch.zeros_like(v) for k, v in tree.items()}, "step": 0}
    loaded, got_step = tckpt.load(path, template, shardings={"params": sh})
    assert got_step == step and loaded["step"] == step
    for k, v in tree.items():
        got = loaded["params"][k]
        assert isinstance(got, DTensor) and got.placements == sh[k].placements
        assert got.dtype == v.dtype and torch.equal(got.full_tensor(), v)
    plain, _ = tckpt.load(path, template)  # the same snapshot without a mesh
    for k, v in tree.items():
        assert type(plain["params"][k]) is torch.Tensor and torch.equal(plain["params"][k], v)
