"""The port's serving slice against the reference: layers, the qwen1.5
model, and the continuous-batching engine on the photonic bank, with
parameters carried across by ``repro_torch.convert``."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import photonics as jph  # noqa: E402
from repro.nn import embeddings as jemb  # noqa: E402
from repro.nn.attention import decode_attention as j_decode_attention  # noqa: E402
from repro.nn.norms import RMSNorm as JRMSNorm  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve.decode import make_prefill  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import photonics as tph  # noqa: E402
from repro_torch.kernels import photonic_matmul as tpm  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.nn import embeddings as temb  # noqa: E402
from repro_torch.nn.attention import decode_attention as t_decode_attention  # noqa: E402
from repro_torch.nn.attention import write_positions  # noqa: E402
from repro_torch.nn.norms import RMSNorm as TRMSNorm  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import Request as TRequest  # noqa: E402
from repro_torch.serve.decode import select_slots  # noqa: E402

ARCH = "qwen1.5-0.5b"
PROMPTS = [[5, 17, 99, 3, 42], [7, 8], [120]]


@pytest.fixture(scope="module")
def smoke_pair():
    """(reference model, reference params, port model with those params)."""
    jmodel = jconfigs.get(ARCH).make_smoke()
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = tconfigs.get(ARCH).make_smoke(device="cpu")
    tmodel.load_state_dict(convert.state_dict_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams)))
    return jmodel, jparams, tmodel


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rotary_matches_reference():
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 4096, (2, 5))
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    jc, js = jemb.rotary_angles(jnp.asarray(pos), 16, 1e6)
    tc, ts = temb.rotary_angles(torch.from_numpy(pos), 16, 1e6)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ts), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(temb.apply_rotary(torch.from_numpy(x), tc, ts)),
        np.asarray(jemb.apply_rotary(jnp.asarray(x), jc, js)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32),
                                     (jnp.bfloat16, torch.bfloat16)])
def test_rmsnorm_matches_reference(jdt, tdt):
    x = np.random.default_rng(1).standard_normal((3, 4, 32)).astype(np.float32)
    jout = JRMSNorm(32, 1e-6, jdt)({"scale": jnp.ones((32,), jdt)}, jnp.asarray(x, jdt))
    tout = TRMSNorm(32, 1e-6, tdt, "cpu").init(0)(torch.from_numpy(x).to(tdt))
    assert tout.dtype == tdt
    tol = 1e-6 if tdt == torch.float32 else 1e-2
    np.testing.assert_allclose(_np(tout), np.asarray(jout, np.float32), rtol=tol, atol=tol)


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    k = rng.standard_normal((3, 6, 2, 8)).astype(np.float32)  # GQA: 2 kv heads
    v = rng.standard_normal((3, 6, 2, 8)).astype(np.float32)
    cl = np.array([1, 4, 6])
    expect = j_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                cache_len=jnp.asarray(cl))
    got = t_decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             cache_len=torch.from_numpy(cl))
    np.testing.assert_allclose(_np(got), np.asarray(expect), rtol=1e-5, atol=1e-6)


def test_write_positions_drops_out_of_range():
    """The reference's ``mode="drop"`` scatter: positions at or past the
    end are dropped and slots with nothing valid keep their cache."""
    cache = torch.arange(2 * 4, dtype=torch.float32).reshape(2, 4, 1, 1)
    new = -torch.arange(1, 7, dtype=torch.float32).reshape(2, 3, 1, 1)
    out = write_positions(cache, new, torch.tensor([2, 1]), torch.tensor([3, 0]))
    np.testing.assert_array_equal(out[:, :, 0, 0].numpy(),
                                  [[0, 1, -1, -2], [4, 5, 6, 7]])
    assert torch.equal(cache, torch.arange(8, dtype=torch.float32).reshape(2, 4, 1, 1))
    full = write_positions(cache, new[:, :1], torch.tensor([4, 3]), torch.ones(2, dtype=torch.long))
    np.testing.assert_array_equal(full[:, :, 0, 0].numpy(), [[0, 1, 2, 3], [4, 5, 6, -4]])


def test_select_slots_keeps_inactive():
    old = {"k": torch.zeros(2, 3, 1), "v": torch.zeros(2, 3, 1)}
    new = {"k": torch.ones(2, 3, 1), "v": torch.ones(2, 3, 1)}
    out = select_slots(torch.tensor([True, False, True]), new, old)
    np.testing.assert_array_equal(out["k"][:, :, 0].numpy(), [[1, 0, 1], [1, 0, 1]])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_matches_reference(smoke_pair):
    jmodel, jparams, tmodel = smoke_pair
    toks = np.random.default_rng(3).integers(0, 128, (2, 9))
    expect = make_prefill(jmodel)(jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = tmodel(torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), np.asarray(expect), rtol=1e-4, atol=1e-4)


def test_decode_matches_forward(smoke_pair):
    """Greedy decode over a teacher-forced prompt reproduces the full
    forward's logits at every position (the reference's own 2e-4 bound)."""
    _, _, tmodel = smoke_pair
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 128, (2, 8)))
    with torch.no_grad():
        full = tmodel(toks)
        caches = tmodel.init_caches(2, 16)
        outs = []
        for t in range(8):
            logits, caches = tmodel.decode_step(toks[:, t:t + 1], caches,
                                                torch.full((2,), t))
            outs.append(logits)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(full), rtol=2e-4, atol=2e-4)


def test_full_width_layout_matches_reference_without_allocation():
    """qwen1.5-0.5b at full width on the meta device: the same parameter
    names, shapes and count as the reference after the layout map."""
    jmodel = jconfigs.get(ARCH).make_model(jnp.bfloat16)
    expect = convert.torch_shapes(jmodel.param_shapes())
    tmodel = api.build_model(ARCH, dtype=torch.bfloat16, device="meta")
    got = {n: tuple(p.shape) for n, p in tmodel.named_parameters()}
    assert got == expect
    assert all(p.is_meta and p.dtype == torch.bfloat16 for p in tmodel.parameters())
    n_ref = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(jmodel.param_shapes()))
    assert sum(p.numel() for p in tmodel.parameters()) == n_ref
    assert tmodel.forward_gemm_specs() == jmodel.forward_gemm_specs()
    assert len(tmodel.forward_gemm_specs()) == 24 * 7 + 1 == 169


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _record(engine, name, rec, idx):
    fn = getattr(engine, name)

    def wrapped(*args):
        out = fn(*args)
        rec.append(np.array(_np(out[idx]), np.float32))
        return out

    setattr(engine, name, wrapped)


def test_engine_matches_reference_on_the_bank(smoke_pair):
    """The qwen1.5 smoke engine on the ideal bank: the reference runs its
    TPU kernel in interpret mode, the port its cuda backend on CPU tensors.
    2 slots, 3 requests, chunked prefill, and a slot that ends at max_len
    (an inactive slot then sits at cache_len == max_len)."""
    jmodel, jparams, tmodel = smoke_pair
    kw = dict(batch_slots=2, max_len=8, prefill_chunk=4)
    jeng = JEngine(jmodel, jparams, backend=jph.PallasBackend(interpret=True),
                   photonics=jph.PRESETS["ideal"], **kw)
    teng = TEngine(tmodel, backend="cuda", photonics=tph.PRESETS["ideal"], **kw)
    jlog = {"prefill": [], "decode": []}
    tlog = {"prefill": [], "decode": []}
    _record(jeng, "_prefill", jlog["prefill"], 0)
    _record(jeng, "_decode", jlog["decode"], 1)
    _record(teng, "_prefill", tlog["prefill"], 0)
    _record(teng, "_decode", tlog["decode"], 1)
    jreqs = [JRequest(prompt=list(p), max_new=6) for p in PROMPTS]
    treqs = [TRequest(prompt=list(p), max_new=6) for p in PROMPTS]
    jeng.run(jreqs)
    teng.run(treqs)

    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done for r in treqs)
    assert teng.stats == jeng.stats
    assert teng.stats["prefill_steps"] >= 2 and teng.stats["decode_steps"] >= 5
    for phase in ("prefill", "decode"):
        assert len(tlog[phase]) == len(jlog[phase])
        for got, expect in zip(tlog[phase], jlog[phase]):
            np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)
    jcaches = jax.tree_util.tree_map(np.asarray, jeng.caches)
    tcaches = convert.caches_to_reference(teng.caches)
    assert set(tcaches) == set(jcaches)
    for name in jcaches:
        assert tcaches[name].shape == jcaches[name].shape
        np.testing.assert_allclose(tcaches[name], jcaches[name], rtol=1e-4, atol=1e-5)


def test_noisy_engine_is_seeded(smoke_pair):
    """Bank noise on: the same seed serves the same tokens, and the kernel
    wrapper's CPU path counts no launches."""
    _, _, tmodel = smoke_pair
    outs = []
    before = tpm.launches
    for seed in (0, 0):
        eng = TEngine(tmodel, batch_slots=2, max_len=16, prefill_chunk=4, backend="cuda",
                      photonics=tph.PRESETS["onchip_bpd"], seed=seed)
        reqs = [TRequest(prompt=list(p), max_new=4) for p in PROMPTS]
        eng.run(reqs)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    assert tpm.launches == before


def test_session_engine_backend_rules():
    s = api.build_session(arch=ARCH, algo="bp", smoke=True, hardware="ideal",
                          backend="auto", device="cpu")
    assert s.engine(batch_slots=1, max_len=8)._backend.name == "ref"
    s = api.build_session(arch=ARCH, algo="bp", smoke=True, hardware="digital",
                          backend="cuda", device="cpu")
    assert not s.engine(batch_slots=1, max_len=8)._photonic
    # the reference serves any backend instance as "ref" (kept as is)
    s = api.build_session(arch=ARCH, algo="bp", smoke=True, hardware="ideal",
                          backend=tph.BACKENDS["cuda"], device="cpu")
    assert s.engine(batch_slots=1, max_len=8)._backend.name == "ref"
    # the LM trains as well now: a dfa session has a trainer and serves by
    # the same rules
    s = api.build_session(arch=ARCH, smoke=True, algo="dfa", device="cpu")
    assert s.trainer is not None
    assert s.engine(batch_slots=1, max_len=8)._backend.name == "ref"


def test_launcher_serves_on_cpu(capsys):
    tlaunch.main(["--arch", ARCH, "--backend", "cuda", "--hardware", "offchip_bpd",
                  "--device", "cpu", "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 9 tokens" in out
    assert "[serve] engine stats:" in out


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

def test_port_imports_no_jax():
    """Every module of the port imports, the simulator and the energy model
    among them, and neither jax nor repro is then loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "want = ['repro_torch.core.energy'] + ['repro_torch.sim.' + m for m in\n"
        "        ('components', 'pipeline', 'serving', 'autotune')]\n"
        "assert all(n in sys.modules for n in want), want\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    src = str(pathlib.Path(repro_torch.__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_never_move_to_cpu_on_their_own():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.build_session(arch=ARCH, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.build_model(ARCH, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tconfigs.get(ARCH).make_smoke()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", ARCH])
