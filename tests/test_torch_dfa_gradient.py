"""The port's fused DFA gradient against the reference: the kernel's plain
version and the ``cuda`` backend's wrapper on CPU tensors, each held to
``repro``'s ``dfa_gradient_pallas`` in interpret mode on the same numpy
inputs, and the masked projection on both backends."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import photonics as jph  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.dfa_gradient import dfa_gradient_pallas  # noqa: E402
from repro_torch.core import photonics as tph  # noqa: E402
from repro_torch.kernels import dfa_gradient as tdg  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# tests/test_kernels.py's first three shapes (the reference's dfa_gradient
# test) plus the ragged one
SHAPES = [(4, 8, 16), (64, 10, 800), (128, 128, 128), (200, 300, 257)]
DTYPES = [("f32", jnp.float32, torch.float32, 2e-5),
          ("bf16", jnp.bfloat16, torch.bfloat16, 2e-2)]


def _inputs(t, k, m, seed, jdt, tdt, binary=True):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((t, k)).astype(np.float32)
    b = rng.standard_normal((m, k)).astype(np.float32)
    pre = rng.standard_normal((t, m)).astype(np.float32)
    mask = (pre > 0).astype(np.float32) if binary else (1 - np.tanh(pre) ** 2)
    return ((jnp.asarray(a, jdt), jnp.asarray(b, jdt), jnp.asarray(mask)),
            (torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt),
             torch.from_numpy(mask)))


def _close(got, expect, tol):
    got = np.asarray(got, np.float32)
    expect = np.asarray(expect, np.float32)
    np.testing.assert_allclose(got, expect, rtol=tol, atol=tol * np.abs(expect).max() + 1e-6)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("t,k,m", SHAPES)
@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES)
@pytest.mark.parametrize("mode", ["none", "input"])
@pytest.mark.parametrize("binary", [True, False], ids=["relu'", "tanh'"])
def test_plain_matches_pallas_kernel(t, k, m, name, jdt, tdt, tol, mode, binary):
    """The plain version against the TPU kernel, with the same numpy noise
    array handed to both in input mode."""
    (ja, jb, jmask), (ta, tb, tmask) = _inputs(t, k, m, t * 7 + k, jdt, tdt, binary)
    noise = None
    if mode == "input":
        noise = np.random.default_rng(5).standard_normal((t, m)).astype(np.float32)
    # one block per operand: the interpreter needs shapes that divide the
    # blocks, and the ragged one divides only itself
    expect = dfa_gradient_pallas(
        ja, jb, jmask, noise=None if noise is None else jnp.asarray(noise),
        block_t=t, block_m=m, block_k=k, out_dtype=jnp.float32, interpret=True)
    got = tdg.dfa_gradient_plain(ta, tb, tmask,
                                 noise=None if noise is None else torch.from_numpy(noise))
    assert got.dtype == torch.float32 and got.shape == (t, m)
    _close(_np(got), expect, tol)
    assert (_np(got)[np.asarray(jmask) == 0] == 0).all()


@pytest.mark.parametrize("t,k,m", SHAPES)
@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES)
def test_ops_dfa_gradient_matches_reference(t, k, m, name, jdt, tdt, tol):
    """ops.dfa_gradient (the cuda backend's wrapper) on CPU tensors against
    the reference's ops.dfa_gradient in interpret mode, ideal hardware."""
    (ja, jb, jmask), (ta, tb, tmask) = _inputs(t, k, m, t + k + m, jdt, tdt)
    expect = jops.dfa_gradient(ja, jb, jmask, jph.PRESETS["ideal"], interpret=True)
    got = tops.dfa_gradient(ta, tb, tmask, tph.PRESETS["ideal"])
    assert got.dtype == tdt
    _close(_np(got), expect, tol)


@pytest.mark.parametrize("t,k,m", SHAPES)
def test_ops_dfa_gradient_input_noise_matches_reference(t, k, m, monkeypatch):
    """Input mode with the reference's own noise draw handed to the port:
    the noise is added before the mask and the rescale, as on the TPU."""
    (ja, jb, jmask), (ta, tb, tmask) = _inputs(t, k, m, t + 2 * m, jnp.float32,
                                              torch.float32)
    key = jax.random.PRNGKey(t + m)
    cfg_j, cfg_t = jph.PRESETS["offchip_bpd"], tph.PRESETS["offchip_bpd"]
    expect = jops.dfa_gradient(ja, jb, jmask, cfg_j, key=key, interpret=True)
    padded = (-(-t // 128) * 128, -(-m // 128) * 128)  # the reference's padded draw
    noise = np.array(jref.total_noise(key, padded, k, cfg_j))[:t, :m].copy()

    def shared_noise(seed, shape, k_dim, cfg, device):
        assert tuple(shape) == (t, m) and k_dim == k and cfg == cfg_t
        return torch.from_numpy(noise)

    monkeypatch.setattr(tops, "total_noise", shared_noise)
    got = tops.dfa_gradient(ta, tb, tmask, cfg_t, key=7)
    _close(_np(got), expect, 2e-5)


def test_dfa_gradient_ref_matches_reference():
    (ja, jb, jmask), (ta, tb, tmask) = _inputs(32, 24, 48, 3, jnp.float32, torch.float32,
                                              binary=False)
    noise = np.random.default_rng(1).standard_normal((32, 48)).astype(np.float32)
    expect = jref.dfa_gradient_ref(ja, jb, jmask, noise=jnp.asarray(noise))
    got = tref.dfa_gradient_ref(ta, tb, tmask, noise=torch.from_numpy(noise))
    _close(_np(got), expect, 2e-5)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("preset", ["ideal", "digital"])
def test_photonic_project_mask_matches_reference(backend, preset):
    rng = np.random.default_rng(2)
    e = rng.standard_normal((2, 8, 10)).astype(np.float32)  # leading dims flatten
    b = rng.standard_normal((40, 10)).astype(np.float32)
    mask = (rng.standard_normal((2, 8, 40)) > 0).astype(np.float32)
    expect = jph.photonic_project(jnp.asarray(e), jnp.asarray(b), jph.PRESETS[preset],
                                  mask=jnp.asarray(mask), backend="ref")
    got = tph.photonic_project(torch.from_numpy(e), torch.from_numpy(b), tph.PRESETS[preset],
                               mask=torch.from_numpy(mask), backend=backend)
    assert got.shape == (2, 8, 40)
    _close(_np(got), expect, 2e-5)


def test_noisy_masked_projection_is_the_bank_product_times_the_mask():
    """With the same key, the fused path (noise, then mask, then rescale)
    equals the unfused bank product times the mask on both backends."""
    rng = np.random.default_rng(4)
    e = torch.from_numpy(rng.standard_normal((64, 10)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((800, 10)).astype(np.float32))
    mask = torch.from_numpy((rng.standard_normal((64, 800)) > 0).astype(np.float32))
    cfg = tph.PRESETS["offchip_bpd"]
    for backend in ("ref", "cuda"):
        fused = tph.photonic_project(e, b, cfg, 21, mask=mask, backend=backend)
        unfused = tph.photonic_project(e, b, cfg, 21, backend=backend) * mask
        _close(_np(fused), _np(unfused), 2e-5)
        assert (_np(fused)[_np(mask) == 0] == 0).all()


def test_cuda_wrapper_runs_plain_on_cpu_and_validates():
    a = torch.randn(8, 16)
    b = torch.randn(4, 16)
    mask = (torch.randn(8, 4) > 0).float()
    before = tdg.launches
    np.testing.assert_allclose(_np(tdg.dfa_gradient_cuda(a, b, mask)), _np((a @ b.T) * mask),
                               rtol=1e-5, atol=1e-5)
    assert tdg.launches == before  # the plain version is no launch
    with pytest.raises(TypeError, match="f32"):
        tdg.dfa_gradient_cuda(a, b, mask.bool())
    with pytest.raises(ValueError):
        tdg.dfa_gradient_cuda(a, b, torch.ones(8, 5))
    with pytest.raises(ValueError):
        tdg.dfa_gradient_cuda(a, b, mask, noise=torch.zeros(8, 4), seed=1)
    with pytest.raises(ValueError, match="no photonic_matmul kernel"):
        tdg.dfa_gradient_cuda(a.to("meta"), b.to("meta"), mask.to("meta"))
    # prng mode: the bank kernel's counters, times the mask
    noisy = tdg.dfa_gradient_cuda(a, b, mask, seed=3, sigma_step=0.5)
    kept = _np(mask) != 0
    assert (_np(noisy)[~kept] == 0).all()
    assert np.abs(_np(noisy - (a @ b.T) * mask)[kept]).max() > 0
