"""Sharded serving and the dry-run on the card, at smoke width.

* The smoke qwen1.5 (kv heads split on (1, 2)), minicpm3 (its latent
  caches at 1024 slots: the sequence rule) and qwen2-moe (30 of 60 experts
  a rank on (1, 2)) served through ``serve.decode``'s params-taking steps on
  two ranks over gloo on one card, on (2, 1) and (1, 2), offchip_bpd
  through the bank kernel: the prefill's last logits and three greedy
  decode steps within 1e-4 of one process, the tokens equal, the caches
  the one process's, every rank the same bank launches as one process.
* ``run_cell``'s fake world of one against a real NCCL world of one
  (``tests/_dryrun_card.py``, its own process) for the smoke qwen1.5's train
  and decode cells: FLOPs, bytes and collectives equal, the fake peak at
  most ``torch.cuda.max_memory_allocated`` and within cuBLAS's workspace of
  it.

Imports no JAX.  Marked ``gpu``: skipped where there is no CUDA device; on
the card run

    python -m pytest -m gpu tests/test_torch_shard_serve_gpu.py -q
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _dist_ranks as ranks  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = 1e-4  # serving logits (ROADMAP)
WORKSPACE = 64 << 20  # cuBLAS's workspaces a process allocates on the card, at most
HERE = os.path.dirname(os.path.abspath(__file__))


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")


def _case(arch, seed):
    from repro_torch import configs

    model = configs.get(arch).make_smoke(device="cpu").init(seed)
    rng = np.random.default_rng(seed)
    return {"params": {k: v.detach().numpy() for k, v in model.named_parameters()},
            "tokens": rng.integers(0, model.cfg.vocab_size, size=(4, 5)).astype(np.int64),
            "n_valid": np.array([5, 4, 5, 2], np.int64), "max_len": ranks.CARD_SERVE[arch]}


@pytest.fixture(scope="module")
def served():
    _needs_card()
    from repro_torch.kernels import photonic_matmul as pm

    pm.build()  # once, before the ranks load it
    cases = {arch: _case(arch, 40 + i) for i, arch in enumerate(ranks.CARD_SERVE)}
    return ranks.spawn("shard_serve_card", 2, timeout=600.0, cases=cases)


@pytest.mark.parametrize("m", [1, 2], ids=["data", "model"])
@pytest.mark.parametrize("arch", list(ranks.CARD_SERVE))
def test_sharded_serving_on_the_card(served, arch, m):
    r0, r1 = served
    got = r0[arch, m]
    assert got["prefill"] <= TOL and got["decode"] <= TOL, got
    assert got["tokens"], got
    assert got["caches"] <= TOL, got
    assert r0[arch, m]["launches"] == r1[arch, m]["launches"] > 0


def test_rules_on_the_card(served):
    r0, _ = served
    assert set(r0["qwen1.5-0.5b", 2]["split"].values()) == {3}  # kv heads
    assert set(r0["minicpm3-4b", 2]["split"].values()) == {2}  # latent caches' slots
    assert set(r0["qwen1.5-0.5b", 1]["split"].values()) == {3}  # on a model axis of 1


def test_dryrun_fake_world_equals_the_card(tmp_path):
    _needs_card()
    out = str(tmp_path / "cells.json")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE, os.path.join(HERE, "..", "src"), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, os.path.join(HERE, "_dryrun_card.py"), out], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(out) as f:
        cells = json.load(f)
    for kind, pair in cells.items():
        fake, real = pair["fake"], pair["real"]
        assert fake["status"] == real["status"] == "ok", (fake.get("traceback"),
                                                          real.get("traceback"))
        assert fake["cost"] == real["cost"], kind
        assert fake["collectives"] == real["collectives"], kind
        assert fake["collectives_agree"] and real["collectives_agree"], kind
        # at smoke width the allocator's peak is mostly cuBLAS's workspace,
        # which the fake world does not allocate: the fake peak stays under
        # it by at most that (chip_smoke.py's [dryrun] holds the ratio within
        # 10% at full width)
        fake_peak, real_peak = (r["memory"]["total_hbm_bytes"] for r in (fake, real))
        assert 0 < fake_peak <= real_peak <= fake_peak + WORKSPACE, (kind, fake_peak, real_peak)
