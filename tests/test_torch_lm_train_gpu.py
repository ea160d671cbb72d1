"""One DFA training step of the qwen1.5-0.5b LM on the card: the full
width (d 1024, d_ff 2816, vocab 151936) cut to 2 layers, batch 64 × seq
64, so every DFA projection is a bank product at (T, K, M) = (4096, 1024,
1024).  Marked ``gpu``: skipped where there is no CUDA device; on the card
run

    python -m pytest -m gpu tests/test_torch_lm_train_gpu.py -q
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, configs  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import photonic_matmul as pm  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = 2e-5  # the f32 bank tolerance, of max |δ|


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_full_width_lm_step_through_the_bank_kernel(cuda, monkeypatch):
    cfg = dataclasses.replace(configs.get("qwen1.5-0.5b").make_model(device="meta").cfg,
                              n_layers=2, dtype=torch.float32)
    model = TransformerLM(cfg, device=cuda).init(0)
    session = api.build_session(arch=model, algo="dfa", hardware="offchip_bpd",
                                backend="cuda", log_every=10**9, device=cuda)
    captured = []
    kernel = kops.photonic_matmul_cuda

    def capture(a, b, **kw):
        out = kernel(a, b, **kw)
        captured.append((a, b, kw, out))
        return out

    monkeypatch.setattr(kops, "photonic_matmul_cuda", capture)
    batch = tokens.MarkovTokens(cfg.vocab_size, 64, 64, seed=0).batch(0)
    state = session.init_state()
    before = pm.launches
    new, metrics = session.step(state, batch)
    torch.cuda.synchronize()
    assert pm.launches - before == 3  # 2 blocks + the embedding
    assert torch.isfinite(metrics["loss"]) and all(
        bool(torch.isfinite(p).all()) for p in new["params"].values())
    assert not torch.equal(new["params"]["embed.tok.table"], state["params"]["embed.tok.table"])
    for a, b, kw, out in captured:
        assert a.shape == (4096, 1024) and b.shape == (1024, 1024) and "noise" in kw
        expect = pm.photonic_matmul_plain(a, b, **kw)
        torch.testing.assert_close(out, expect, rtol=TOL,
                                   atol=TOL * expect.abs().max().item())
