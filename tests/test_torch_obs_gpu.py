"""The observability plane on the card: the alignment probe on a small LM
with the bank kernel's launches counted, ``StepTimer`` synchronising the
device, ``step_cost`` counting the kernel's launches from their shapes,
and ``bench.report.environment()`` naming the card.  Marked ``gpu``:
skipped where there is no CUDA device; on the card run

    python -m pytest -m gpu tests/test_torch_obs_gpu.py -q
"""

import math
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, bench, obs  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.kernels import photonic_matmul as pm  # noqa: E402
from repro_torch.obs.introspect import AlignmentProbe  # noqa: E402

pytestmark = pytest.mark.gpu

ARCH = "qwen1.5-0.5b"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bank kernel has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _session(cuda, **kw):
    return api.build_session(arch=ARCH, smoke=True, algo="dfa", hardware="offchip_bpd",
                             backend="cuda", log_every=10**9, device=cuda, **kw)


def test_probe_on_the_card_launches_the_bank_kernel(cuda):
    """The smoke LM (2 layers): the probe's DFA side makes 3 projections
    (2 blocks and the embedding), each one bank-kernel launch."""
    session = _session(cuda)
    state = session.init_state()
    batch = session.trainer.put(tokens.MarkovTokens(128, 16, 4, 0).batch(0))
    pm.launches = 0
    rows = AlignmentProbe(session.trainer).probe(state, batch)
    assert pm.launches == 3
    host = obs.Registry.drain(rows)
    assert {"align_blocks", "align_embed", "align_head", "align_global"} <= set(host)
    assert all(math.isfinite(v) for v in host.values())
    assert all(abs(v) <= 1 + 1e-6 for k, v in host.items() if k.startswith("align_"))
    cost = session.step_cost(state, tokens.MarkovTokens(128, 16, 4, 0).batch(0))
    assert cost.kernel_launches == 3 and cost.kernel_flops == 3 * 2 * 64 * 64 * 64


def test_probed_fit_equals_unprobed_fit_on_the_card(cuda):
    gen = tokens.MarkovTokens(128, 16, 4, 0)
    plain, _ = _session(cuda).fit(gen.batch, total_steps=4, verbose=False)
    pm.launches = 0
    probed, _ = _session(cuda, probe_every=2).fit(gen.batch, total_steps=4, verbose=False)
    assert pm.launches == 4 * 3 + 2 * 3  # 4 steps and 2 probes
    for k in plain["params"]:
        assert torch.equal(plain["params"][k], probed["params"][k]), k


def test_step_timer_synchronises_the_device(cuda):
    a = torch.randn(2048, 2048, device=cuda)
    timer = bench.StepTimer(warmup=0)
    timer.start()
    for _ in range(8):  # a queue of matmuls the host does not wait for
        a = a @ a / a.norm()
    timer.tick(cuda)
    assert torch.cuda.current_stream(cuda).query()  # nothing left queued
    t0 = time.perf_counter()
    torch.cuda.synchronize(cuda)
    assert time.perf_counter() - t0 < 1e-3
    assert timer.summary()["steps_measured"] == 1


def test_environment_names_the_card(cuda):
    env = bench.report.environment()
    assert env["backend"] == "cuda" and "jax" not in env
    assert env["device"] == torch.cuda.get_device_name(0)
    assert env["device_count"] == torch.cuda.device_count()
    assert env["power_limit"] is None or env["power_limit"].endswith("W")
