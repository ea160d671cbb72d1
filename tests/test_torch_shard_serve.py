"""Sharded serving on four gloo ranks on the CPU: ``serve.decode``'s
params-taking prefill and decode steps on parameters placed by
``make_param_shardings`` (each block gathered a layer at a time, the
reference's serving gathers), caches placed by ``cache_shardings`` and
tokens split over the data axes, against the port's one process and the
reference's jitted steps under the same shardings.

One spawn of four ranks (``tests/_dist_ranks.py``, scenario "shard_serve")
serves every family's smoke model (qwen1.5 and qwen2-moe: kv heads split;
qwen3: head_dim at m = 4; minicpm3 at 1024 slots: its latent caches'
sequence; mamba2: the SSM state's d_state; recurrentgemma: its window's
head_dim; whisper against its encoder output) on (4, 1), (2, 2) and (1, 4),
noise off and on (offchip_bpd through the bank kernel's plain version:
each rank's rows of the one global draw).  The prefill's last logits and
three greedy decode steps' logits within 1e-4 of one process, the tokens
equal and the caches the one process's; with the kv heads split and no
rows split, the same bits.  The sequence rule at one layer (a kv head of 6
dims on a model axis of 4).  The reference's sharded steps run at the same
time in their own process on four forced host devices
(``tests/_serve_reference.py``), on the (2, 2) mesh, noise off, with the
weights carried across by ``repro_torch.convert``."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _dist_ranks as ranks  # noqa: E402
from test_torch_fsdp import _flatten  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402

WORLD = 4
TOL = 1e-4  # serving logits (ROADMAP)
# arch -> cache slots (minicpm3's latent caches split by sequence at 1024)
ARCHS = {"qwen1.5-0.5b": 16, "qwen3-1.7b": 16, "minicpm3-4b": 1024, "qwen2-moe-a2.7b": 16,
         "mamba2-130m": 16, "recurrentgemma-9b": 32, "whisper-small": 16}
MESHES = list(ranks.SERVE_MESHES)
HARDWARE = (None, "offchip_bpd")
HERE = os.path.dirname(os.path.abspath(__file__))
B, C = 4, 5


def _case(arch, seed):
    """The reference's smoke parameters of ``arch`` (the port's through
    ``convert``), a (B, C) prompt batch with ragged valid lengths, and
    whisper's encoder output (the reference's, of random frames)."""
    jm = jconfigs.get(arch).make_smoke()
    jp = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    case = {"params": {k: v.numpy() for k, v in convert.state_dict_from_reference(jp).items()},
            "tokens": rng.integers(0, jm.cfg.vocab_size, size=(B, C)).astype(np.int64),
            "n_valid": np.array([C, C - 1, C, 2], np.int64), "max_len": ARCHS[arch]}
    if arch == "whisper-small":
        frames = rng.normal(size=(B, jm.cfg.n_frames, jm.cfg.d_model)).astype(np.float32) * 0.1
        case["enc"] = np.asarray(jm.encode(jp, frames), np.float32)
    return jp, case


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    ref_in, ref_out = str(tmp / "ref_in.npz"), str(tmp / "ref_out.npz")
    cases, data = {}, {}
    for i, arch in enumerate(ARCHS):
        jp, cases[arch] = _case(arch, 20 + i)
        data.update({f"{arch}|params|{k}": v for k, v in _flatten(jp).items()})
        for k in ("tokens", "n_valid", "max_len", "enc"):
            if k in cases[arch]:
                data[f"{arch}|{k}"] = np.asarray(cases[arch][k])
    np.savez(ref_in, **data)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE, os.path.join(HERE, "..", "src"), os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen([sys.executable, os.path.join(HERE, "_serve_reference.py"), ref_in,
                            ref_out], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        (out, *_) = ranks.spawn("shard_serve", WORLD, timeout=300, cases=cases)
    finally:
        log = ref.communicate(timeout=300)[0].decode()
    assert ref.returncode == 0, log[-3000:]
    return out, dict(np.load(ref_out))


@pytest.mark.parametrize("hardware", HARDWARE, ids=["digital", "offchip_bpd"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_serving_matches_one_process(served, arch, mesh, hardware):
    got = served[0]["compare"][arch, mesh, hardware]
    assert got.get("prefill", 0.0) <= TOL, got
    assert got["decode"] <= TOL, got
    assert got["tokens"], got
    assert got["caches"] <= 1e-5, got


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-moe-a2.7b", "whisper-small"])
def test_heads_rule_is_the_one_process_bits(served, arch):
    """kv heads split over ``model`` with the batch whole: each rank attends
    its heads as the one process does, every output the same bits."""
    for hardware in HARDWARE:
        got = served[0]["compare"][arch, "serve14", hardware]
        assert set(got["split"].values()) == {3}, got["split"]  # (L, B, S, KVH, D): heads
        assert got.get("prefill", 0.0) == 0.0 and got["decode"] == 0.0, got
        assert got["caches"] == 0.0, got


def test_each_cache_rule_is_met(served):
    """head_dim (qwen3's 2 kv heads, recurrentgemma's 1, at m = 4), the
    latent caches' sequence (minicpm3 at 1024 slots) and the SSM state's
    d_state (mamba2) on (1, 4); heads at m = 2."""
    split = {arch: served[0]["compare"][arch, "serve14", None]["split"] for arch in ARCHS}
    assert set(split["qwen3-1.7b"].values()) == {4}
    assert split["recurrentgemma-9b"]["grp_attn.k"] == 4
    assert split["recurrentgemma-9b"]["grp_rec1.h"] is None
    assert set(split["minicpm3-4b"].values()) == {2}
    assert split["mamba2-130m"] == {"ssm": 3, "conv": None}
    assert set(served[0]["compare"]["qwen3-1.7b", "serve22", None]["split"].values()) == {3}


def test_sequence_rule_at_one_layer(served):
    got = served[0]["seq_attention"]
    assert got["dims"] == {"k": 1, "v": 1}  # the per-layer (B, S, KVH, D) cache's slots
    assert got["y"] <= 1e-5, got
    assert got["cache"] == 0.0, got


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_serving_matches_reference(served, arch):
    """On (2, 2), noise off: the port's prefill and decode logits within
    1e-4 of ``repro``'s jitted steps under the same shardings."""
    out, ref = served
    got = out["logits"][arch]
    for what in got:
        assert ranks.rel(got[what], ref[f"{arch}|{what}"]) <= TOL, (what, arch)
