"""FSDP on the card: ``launch/dryrun.build_train``'s sharded step on a
(1, 1) mesh of a world of one NCCL rank equals the trainer's single-device
steps bit for bit (losses, parameters and momentum after two noisy steps
of the smoke LM through the bank kernel, one launch a block plus one a
step), and ``sharding.full_tensor`` gives a ``DTensor``'s whole tensor.
Marked ``gpu``: skipped where there is no CUDA device; on the card run

    python -m pytest -m gpu tests/test_torch_fsdp_gpu.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.kernels import photonic_matmul as pm  # noqa: E402

pytestmark = pytest.mark.gpu

ARCH, SEED, SEQ, BATCH = "qwen1.5-0.5b", 3, 16, 8


@pytest.fixture
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    mesh_lib.init_process_group("cuda")
    try:
        yield mesh_lib.make_host_mesh(1, device_type="cuda")
    finally:
        dist.destroy_process_group()


def test_world_of_one_sharded_step_is_the_trainers_bit_for_bit(nccl_mesh):
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import lm_batches
    from repro_torch.utils import prng

    s = api.build_session(arch=ARCH, smoke=True, hardware="offchip_bpd", backend="cuda",
                          seed=SEED, data_parallel=False, log_every=10**9)
    data = lm_batches(ARCH, s.model.cfg, SEQ, BATCH, 0)
    host = {k: torch.as_tensor(v) for k, v in data(0).items()}
    fn, (p, fb, o, _, _), extra = dryrun.build_train(ARCH, nccl_mesh, smoke=True,
                                                     dfa=s.config.dfa, seed=SEED, batch=host)
    state = s.init_state()
    b_sh = extra["in_shardings"][3]
    for step in range(2):
        batch = sharding.place({k: torch.as_tensor(v) for k, v in data(step).items()}, b_sh)
        pm.launches = 0
        p, o, loss = fn(p, fb, o, batch, prng.step_key(SEED, step, "noise"))
        assert pm.launches == s.model.cfg.n_layers + 1
        state, metrics = s.step(state, data(step))
        assert loss.to_local().item() == metrics["loss"].item()
    for k, v in state["params"].items():
        assert torch.equal(p[k].to_local(), v), k
        assert torch.equal(o["mom"][k].to_local(), state["opt"]["mom"][k]), k
    assert all(x.is_meta for x in extra["model"].parameters())


def test_full_tensor_on_the_card(nccl_mesh):
    x = torch.randn(6, 4, device="cuda")
    placed = sharding.place_leaf(x, sharding.named(nccl_mesh, sharding.P("data", None)))
    assert torch.equal(sharding.full_tensor(placed), x)
