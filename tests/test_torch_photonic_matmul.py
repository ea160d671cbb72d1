"""The port's bank product against the reference: the photonic core, the
kernel's plain version, and the ``cuda`` backend's wrapper on CPU tensors,
each held to ``repro`` in interpret mode on the same numpy inputs."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax._src.prng import threefry_2x32  # noqa: E402

from repro.core import photonics as jph  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.photonic_matmul import photonic_matmul_pallas  # noqa: E402
from repro.utils import prng as jprng  # noqa: E402
from repro_torch.core import photonics as tph  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import photonic_matmul as tpm  # noqa: E402
from repro_torch.utils import prng as tprng  # noqa: E402

# (t, k, m) — tests/test_kernels.py's shape set
SHAPES = [
    (4, 8, 16),
    (64, 10, 800),   # the paper's MLP projection
    (128, 128, 128),
    (200, 300, 257),  # ragged
    (256, 512, 384),
]
# name, jax dtype, torch dtype, tolerance (tests/test_kernels.py's bound)
DTYPES = [("f32", jnp.float32, torch.float32, 2e-5),
          ("bf16", jnp.bfloat16, torch.bfloat16, 2e-2)]
IDEAL = "ideal"
NOISY = "offchip_bpd"


def _operands(t, k, m, seed, jdt, tdt):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((t, k)).astype(np.float32)
    b = rng.standard_normal((m, k)).astype(np.float32)
    # both frameworks round f32 -> bf16 to nearest even: identical operands
    return (jnp.asarray(a, jdt), jnp.asarray(b, jdt),
            torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))


def _close(got, expect, tol):
    got = np.asarray(got, np.float32)
    expect = np.asarray(expect, np.float32)
    np.testing.assert_allclose(got, expect, rtol=tol,
                               atol=tol * np.abs(expect).max() + 1e-6)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# photonic core
# ---------------------------------------------------------------------------

def test_presets_equal_field_for_field():
    assert list(tph.PRESETS) == list(jph.PRESETS)
    for name in jph.PRESETS:
        t, j = tph.PRESETS[name], jph.PRESETS[name]
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        assert t.effective_bits == j.effective_bits
    assert dataclasses.asdict(tph.PhotonicConfig()) == dataclasses.asdict(jph.PhotonicConfig())


@pytest.mark.parametrize("k", [1, 10, 20, 21, 800, 1024, 2816])
@pytest.mark.parametrize("buses,failed", [(1, ()), (4, (1,)), (3, (0, 2))])
def test_schedule_helpers_match(k, buses, failed):
    jc = jph.PhotonicConfig(n_buses=buses, failed_buses=failed, noise_std=0.098)
    tc = tph.PhotonicConfig(n_buses=buses, failed_buses=failed, noise_std=0.098)
    assert tph.n_contraction_panels(k, tc) == jph.n_contraction_panels(k, jc)
    assert tph.active_buses(tc) == jph.active_buses(jc)
    assert tph.n_bank_passes(k, tc) == jph.n_bank_passes(k, jc)
    assert tph.gemm_cycles(151936, k, tc) == jph.gemm_cycles(151936, k, jc)
    for conv in ("absolute", "fullscale"):
        jc2 = dataclasses.replace(jc, noise_convention=conv)
        tc2 = dataclasses.replace(tc, noise_convention=conv)
        assert tph.noise_sigma_total(k, 0.5, 3.0, tc2) == pytest.approx(
            jph.noise_sigma_total(k, 0.5, 3.0, jc2), rel=1e-12)


@pytest.mark.parametrize("bits", [None, 1, 2, 6, 8])
def test_fake_quant_matches(bits):
    x = np.random.default_rng(0).standard_normal((64, 33)).astype(np.float32)
    for amax in (None, 1.0):
        got = tph.fake_quant(torch.from_numpy(x), bits, amax)
        expect = jph.fake_quant(jnp.asarray(x), bits, amax)
        np.testing.assert_allclose(_np(got), np.asarray(expect), rtol=1e-6, atol=1e-6)
        assert np.isfinite(_np(got)).all()


@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES)
def test_normalise_operands_matches(name, jdt, tdt, tol):
    ja, jb, ta, tb = _operands(32, 24, 48, 1, jdt, tdt)
    cfg_kw = dict(input_bits=6, weight_bits=4)
    jout = jph.normalise_operands(ja, jb, jph.PhotonicConfig(**cfg_kw))
    tout = tph.normalise_operands(ta, tb, tph.PhotonicConfig(**cfg_kw))
    for j, t in zip(jout, tout):
        assert t.dtype == tdt  # the division stays in the operand dtype
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32))


def test_get_backend_rules():
    assert tph.get_backend("ref").name == "ref"
    assert tph.get_backend("cuda").name == "cuda"
    assert tph.get_backend(tph.BACKENDS["ref"]) is tph.BACKENDS["ref"]
    emu = tph.get_backend("emu")  # device emulation, ported in slice 3
    assert isinstance(emu, tph.EmulatedMRRBackend) and emu.stateful_hardware
    with pytest.raises(KeyError):
        tph.get_backend("pallas")
    # auto: the kernel for CUDA tensors, the plain path for CPU tensors
    a = torch.ones(2, 3)
    b = torch.ones(4, 3)
    cfg = tph.PRESETS[IDEAL]
    np.testing.assert_array_equal(
        _np(tph.get_backend("auto").matmul(a, b, cfg)), np.full((2, 4), 3.0, np.float32))


def test_ref_backend_mask_matches_reference():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((16, 24)).astype(np.float32)
    b = rng.standard_normal((32, 24)).astype(np.float32)
    mask = (rng.standard_normal((16, 32)) > 0).astype(np.float32)
    got = tph.photonic_project(torch.from_numpy(a), torch.from_numpy(b), tph.PRESETS[IDEAL],
                               mask=torch.from_numpy(mask), backend="ref")
    expect = jph.photonic_project(jnp.asarray(a), jnp.asarray(b), jph.PRESETS[IDEAL],
                                  mask=jnp.asarray(mask), backend="ref")
    _close(_np(got), expect, 2e-5)
    # the cuda backend takes mask= too: the dfa_gradient kernel's wrapper
    got = tph.photonic_project(torch.from_numpy(a), torch.from_numpy(b), tph.PRESETS[IDEAL],
                               mask=torch.from_numpy(mask), backend="cuda")
    _close(_np(got), expect, 2e-5)


def test_prng_name_hash_matches_reference():
    for name in ("tok", "blocks", "w", "attn"):
        assert tprng._name_to_int(name) == jprng._name_to_int(name)
    assert tprng.fold(3, "a", 1) == tprng.fold(3, "a", 1)
    assert len({tprng.fold(3, "a", i) for i in range(100)}) == 100
    assert tprng.fold(3, "a") != tprng.fold(4, "a")


# ---------------------------------------------------------------------------
# the kernel's plain version against the TPU kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,k,m", SHAPES)
@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES)
@pytest.mark.parametrize("mode", ["none", "input"])
def test_plain_matches_pallas_kernel(t, k, m, name, jdt, tdt, tol, mode):
    ja, jb, ta, tb = _operands(t, k, m, t * 7 + k, jdt, tdt)
    noise = None
    if mode == "input":
        noise = np.random.default_rng(5).standard_normal((t, m)).astype(np.float32)
    # one block per operand: the interpreter needs shapes that divide the
    # blocks, and the ragged ones only divide themselves
    expect = photonic_matmul_pallas(
        ja, jb, noise=None if noise is None else jnp.asarray(noise),
        block_t=t, block_m=m, block_k=k, out_dtype=jnp.float32, interpret=True)
    got = tpm.photonic_matmul_plain(ta, tb, noise=None if noise is None
                                    else torch.from_numpy(noise))
    assert got.dtype == torch.float32 and got.shape == (t, m)
    _close(_np(got), expect, tol)


def test_cuda_wrapper_runs_plain_on_cpu_and_validates():
    a = torch.randn(8, 16)
    b = torch.randn(4, 16)
    before = tpm.launches
    np.testing.assert_allclose(_np(tpm.photonic_matmul_cuda(a, b)), _np(a @ b.T),
                               rtol=1e-5, atol=1e-5)
    assert tpm.launches == before  # the plain version is no launch
    with pytest.raises(TypeError):
        tpm.photonic_matmul_cuda(a.half(), b.half())
    with pytest.raises(ValueError):
        tpm.photonic_matmul_cuda(a, torch.randn(4, 15))
    with pytest.raises(ValueError):
        tpm.photonic_matmul_cuda(a, b, noise=torch.zeros(8, 5))
    with pytest.raises(ValueError):
        tpm.photonic_matmul_cuda(a, b, noise=torch.zeros(8, 4), seed=1)
    with pytest.raises(ValueError, match="no photonic_matmul kernel"):
        tpm.photonic_matmul_cuda(a.to("meta"), b.to("meta"))


# ---------------------------------------------------------------------------
# ops.photonic_matmul (the cuda backend's wrapper) against the reference's
# ---------------------------------------------------------------------------

def _padded(n, block=128):
    return -(-n // block) * block


@pytest.mark.parametrize("t,k,m", SHAPES)
@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES)
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_ops_noiseless_matches_reference(t, k, m, name, jdt, tdt, tol, backend):
    ja, jb, ta, tb = _operands(t, k, m, t * 7 + k, jdt, tdt)
    expect = jops.photonic_matmul(ja, jb, jph.PRESETS[IDEAL], interpret=True)
    got = tph.get_backend(backend).matmul(ta, tb, tph.PRESETS[IDEAL])
    assert got.dtype == tdt
    _close(_np(got), expect, tol)


@pytest.mark.parametrize("t,k,m", SHAPES)
@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES)
def test_ops_input_noise_matches_reference(t, k, m, name, jdt, tdt, tol, monkeypatch):
    """Input mode with the reference's own noise draw handed to the port."""
    ja, jb, ta, tb = _operands(t, k, m, t * 7 + k, jdt, tdt)
    key = jax.random.PRNGKey(t + m)
    cfg_j, cfg_t = jph.PRESETS[NOISY], tph.PRESETS[NOISY]
    expect = jops.photonic_matmul(ja, jb, cfg_j, key=key, interpret=True)
    noise = np.array(jref.total_noise(key, (_padded(t), _padded(m)), k, cfg_j))[:t, :m].copy()

    def shared_noise(seed, shape, k_dim, cfg, device):
        assert tuple(shape) == (t, m) and k_dim == k and cfg == cfg_t
        return torch.from_numpy(noise)

    monkeypatch.setattr(tops, "total_noise", shared_noise)
    got = tops.photonic_matmul(ta, tb, cfg_t, key=7)
    _close(_np(got), expect, tol)


def test_ops_disabled_is_exact_product():
    a = torch.randn(5, 7)
    b = torch.randn(3, 7)
    got = tops.photonic_matmul(a, b, tph.PRESETS["digital"])
    np.testing.assert_allclose(_np(got), _np(a @ b.T), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# noise statistics and the counter-based generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["input", "prng"])
def test_noise_statistics_match_model(mode):
    """σ of (output − exact product) is noise_sigma_total·s_a·s_b within 5%
    over T·M = 65536 samples (40 columns = 2 bank passes)."""
    rng = np.random.default_rng(3)
    t, k, m = 256, 40, 256
    a = torch.from_numpy(rng.standard_normal((t, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    cfg = tph.PRESETS[NOISY]
    out = tops.photonic_matmul(a, b, cfg, key=11, noise_mode=mode)
    err = _np(out - a @ b.T).ravel()
    expect_std = tph.noise_sigma_total(k, a.abs().max().item(), b.abs().max().item(), cfg)
    assert abs(err.std() / expect_std - 1.0) < 0.05
    assert abs(err.mean()) < 3 * expect_std / np.sqrt(err.size)
    again = tops.photonic_matmul(a, b, cfg, key=11, noise_mode=mode)
    other = tops.photonic_matmul(a, b, cfg, key=12, noise_mode=mode)
    np.testing.assert_array_equal(_np(out), _np(again))
    assert np.abs(_np(out - other)).max() > 0


def test_threefry_matches_jax_bit_for_bit():
    rng = np.random.default_rng(9)
    k0, k1 = 0x12345678, 0x9ABCDEF0
    c0 = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    c1 = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    expect = np.asarray(threefry_2x32((jnp.uint32(k0), jnp.uint32(k1)),
                                      jnp.concatenate([jnp.asarray(c0), jnp.asarray(c1)])))
    x0, x1 = tpm.threefry2x32(k0, k1, torch.from_numpy(c0.astype(np.int64)),
                              torch.from_numpy(c1.astype(np.int64)))
    got = np.concatenate([x0.numpy(), x1.numpy()]).astype(np.uint32)
    np.testing.assert_array_equal(got, expect)


def test_prng_tiles_uncorrelated():
    z = [tpm.counter_gaussian(5, kt, torch.arange(256)[:, None].expand(256, 256),
                              torch.arange(256)[None, :].expand(256, 256)).ravel().numpy()
         for kt in range(3)]
    for i in range(3):
        assert abs(z[i].std() - 1.0) < 0.02
        for j in range(i):
            assert abs(np.corrcoef(z[i], z[j])[0, 1]) < 0.02


# ---------------------------------------------------------------------------
# the planner: which of the kernel's variants runs each call
# ---------------------------------------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32
# (T, M, K, dtype) of the main paths -> the variant the kernel runs
MAIN_PATH_PLANS = {
    # qwen1.5-0.5b decode, 4 slots: q/k/v/o, gate/up, down, the head
    (4, 1024, 1024, BF16): "skinny",
    (4, 2816, 1024, BF16): "skinny",
    (4, 1024, 2816, BF16): "skinny",
    (4, 151936, 1024, BF16): "skinny",
    # prefill, 4 slots x chunk 16: the narrow layers split K over a cluster
    (64, 1024, 1024, BF16): "mma/split8",
    (64, 2816, 1024, BF16): "mma/split4",
    (64, 1024, 2816, BF16): "mma/split8",
    (64, 151936, 1024, BF16): "mma",
    # DFA projection of the paper's MLP (K = 10: no 16-byte rows)
    (64, 800, 10, F32): "ffma",
    (64, 800, 10, BF16): "mma_scalar",
    # the f32 parity runs of the serving path
    (4, 1024, 1024, F32): "skinny",
    (64, 151936, 1024, F32): "ffma",
    # the ragged kernel-test shape
    (200, 257, 300, BF16): "mma_scalar/split2",
}


@pytest.mark.parametrize("shape,name", list(MAIN_PATH_PLANS.items()),
                         ids=[f"{t}x{m}x{k}-{str(d)[6:]}" for t, m, k, d in MAIN_PATH_PLANS])
def test_plan_of_main_path_shapes(shape, name):
    t, m, k, dtype = shape
    plan = tpm._plan(t, m, k, dtype, (0x7F00_0000_0000, 0x7F00_0100_0000))
    assert plan.name == name
    tpm._check_plan(plan, t, k, dtype, (0x7F00_0000_0000, 0x7F00_0100_0000))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_plan_never_gives_misaligned_operands_the_vector_path(dtype):
    itemsize = 2 if dtype == BF16 else 4
    rng = np.random.default_rng(17)
    seen = set()
    for _ in range(3000):
        t = int(rng.integers(1, 300))
        m = int(rng.integers(1, 200_000))
        k = int(rng.choice([1, 7, 8, 10, 16, 255, 257, 512, 1000, 1024, 2816, 4096]))
        pointers = tuple(int(0x7F00_0000_0000 + itemsize * rng.choice([0, 1, 3, 8, 64]))
                         for _ in range(2))
        plan = tpm._plan(t, m, k, dtype, pointers)
        seen.add(tpm.VARIANTS[plan.variant])
        tpm._check_plan(plan, t, k, dtype, pointers)  # the plan is one the kernel takes
        aligned = (k * itemsize) % 16 == 0 and all(p % 16 == 0 for p in pointers)
        assert (plan.variant in (tpm.SKINNY, tpm.SKINNY_SCALAR)) == (t <= tpm.SEAM)
        if t <= tpm.SEAM:
            assert plan.variant == (tpm.SKINNY if aligned else tpm.SKINNY_SCALAR)
        else:
            assert plan.variant == (tpm.FFMA if dtype == F32 else
                                    tpm.MMA if aligned else tpm.MMA_SCALAR)
        assert plan.split in (1, 2, 4, 8)
        if plan.split > 1:
            # a split leaves every block of the cluster at least two K tiles,
            # and happens only while the tiles alone leave SMs idle
            tiles = math.ceil(t / tpm.MMA_TILE) * math.ceil(m / tpm.MMA_TILE)
            assert 2 * plan.split <= math.ceil(k / tpm.MMA_TILE_K)
            assert tiles * plan.split // 2 < tpm.CARD_SMS
        if not aligned:
            for variant in tpm.VECTOR_VARIANTS:
                with pytest.raises(ValueError, match="16-byte"):
                    tpm._check_plan(tpm.Plan(variant), t, k, dtype, pointers)
    assert seen == ({"skinny", "skinny_scalar", "ffma"} if dtype == F32
                    else {"skinny", "skinny_scalar", "mma", "mma_scalar"})


def test_check_plan_rejects_what_the_kernel_does_not_take():
    aligned = (0, 0)
    with pytest.raises(ValueError, match="skinny"):
        tpm._check_plan(tpm.Plan(tpm.SKINNY), 17, 1024, BF16, aligned)
    with pytest.raises(ValueError, match="mma"):
        tpm._check_plan(tpm.Plan(tpm.MMA), 64, 1024, F32, aligned)
    with pytest.raises(ValueError, match="ffma"):
        tpm._check_plan(tpm.Plan(tpm.FFMA), 64, 1024, BF16, aligned)
    with pytest.raises(ValueError, match="split"):
        tpm._check_plan(tpm.Plan(tpm.MMA, 3), 64, 1024, BF16, aligned)
    with pytest.raises(ValueError, match="split"):
        tpm._check_plan(tpm.Plan(tpm.SKINNY, 2), 4, 1024, BF16, aligned)
