"""Photonic weight-bank product C = A @ Bᵀ (+ bank read noise): the CUDA
kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/photonic_matmul.py::photonic_matmul_pallas``.
The kernel is ``csrc/photonic_matmul.cu`` (see its header for the design
and what bounds it).  It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use, into
``build/repro_torch/`` at the repository root, and loaded with ``ctypes``;
importing this module builds nothing.  The same library holds the fused
DFA gradient (``dfa_gradient.py``), the kernel with its mask epilogue
(``launch_kernel`` launches either), and the emu backend's panel loop
(``emu_matmul.py``, source ``csrc/emu_matmul.cu``): one ``nvcc`` builds
both sources.

``photonic_matmul_cuda`` launches the kernel for CUDA tensors, and runs
``photonic_matmul_plain`` only because its tensors lie on the CPU.  Noise
modes follow the reference: ``noise`` (a (T, M) operand) selects "input",
``seed`` selects "prng", neither gives the exact product.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import pathlib
import shutil
import subprocess

import torch

from repro_torch.kernels.ref import photonic_matmul_ref

BLOCK_K = 32  # the kernel's K tile; prng noise is drawn once per tile

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
# every source of the one library (its file name hashes them all)
_SOURCES = (_CSRC / "photonic_matmul.cu", _CSRC / "emu_matmul.cu", _CSRC / "threefry.cuh")
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"none": 0, "input": 1, "prng": 2}

launches = 0  # kernel launches since the last reset; read by chip_smoke.py


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(cuda_home, "bin", "nvcc")


def build() -> pathlib.Path:
    """Compile the kernels (once per source revision) with one ``nvcc``
    into one library and return its path.  The file name carries a hash of
    every source, so an edited source is rebuilt and a stale library is
    never loaded."""
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.read_bytes())
    digest = h.hexdigest()[:12]
    lib = _BUILD_DIR / f"librepro_torch_kernels-{digest}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           *(str(src) for src in _SOURCES if src.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.photonic_matmul_block_k.argtypes = []
    lib.photonic_matmul_block_k.restype = ctypes.c_int
    lib.photonic_matmul_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p]
    lib.photonic_matmul_launch.restype = ctypes.c_int
    lib.dfa_gradient_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p]
    lib.dfa_gradient_launch.restype = ctypes.c_int
    lib.emu_bank_product_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]
    lib.emu_bank_product_launch.restype = ctypes.c_int
    if lib.photonic_matmul_block_k() != BLOCK_K:
        raise RuntimeError("kernel K tile differs from BLOCK_K; rebuild")
    return lib


# ---------------------------------------------------------------------------
# counter-based noise, the kernel's generator in plain torch
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)


def threefry2x32(k0: int, k1: int, x0, x1):
    """threefry2x32 (20 rounds) on int64 tensors holding uint32 values —
    torch has no uint32 arithmetic, so every step masks to 32 bits."""
    ks = (k0 & _M32, k1 & _M32, (0x1BD11BDA ^ k0 ^ k1) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for r in range(20):
        x0 = (x0 + x1) & _M32
        rot = _ROT[r % 8]
        x1 = ((x1 << rot) & _M32) | (x1 >> (32 - rot))
        x1 = x1 ^ x0
        if r % 4 == 3:
            i = r // 4 + 1
            x0 = (x0 + ks[i % 3]) & _M32
            x1 = (x1 + ks[(i + 1) % 3] + i) & _M32
    return x0, x1


def counter_gaussian(seed: int, ktile: int, rows, cols):
    """N(0, 1) per (row, col) for one K tile: Box–Muller on 24 high bits
    of each threefry word, as the kernel draws it."""
    x0, x1 = threefry2x32(seed, ktile, rows, cols)
    u1 = (x0 >> 8).float() * (1.0 / (1 << 24))
    u2 = (x1 >> 8).float() * (1.0 / (1 << 24))
    return torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos(2.0 * math.pi * u2)


def prng_noise(seed: int, shape, k_dim: int, sigma_step: float, device):
    """The kernel's "prng" noise summed over its K tiles: (T, M) f32."""
    t, m = shape
    rows = torch.arange(t, device=device, dtype=torch.int64)[:, None].expand(t, m)
    cols = torch.arange(m, device=device, dtype=torch.int64)[None, :].expand(t, m)
    total = torch.zeros((t, m), device=device, dtype=torch.float32)
    for kt in range(math.ceil(k_dim / BLOCK_K)):
        total += sigma_step * counter_gaussian(seed, kt, rows, cols)
    return total


def photonic_matmul_plain(a, b, *, noise=None, seed=None, sigma_step: float = 0.0):
    """The kernel's function in plain torch: the f32 oracle
    (``ref.photonic_matmul_ref``) plus the kernel's prng noise -> f32."""
    out = photonic_matmul_ref(a.float(), b.float(), noise=noise)
    if seed is not None and sigma_step > 0.0:
        out = out + prng_noise(int(seed) & _M32, out.shape, a.shape[1], sigma_step, out.device)
    return out


def check_operands(a, b, noise, seed):
    if noise is not None and seed is not None:
        raise ValueError("give noise or seed, not both")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"need a (T, K) and b (M, K), got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"operands must share a dtype in {list(_DTYPES)}, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if noise is not None and (noise.shape != (a.shape[0], b.shape[0])
                              or noise.dtype != torch.float32 or noise.device != a.device):
        raise ValueError("noise must be an f32 (T, M) tensor on the operands' device")


def launch_kernel(a, b, *, mask=None, noise=None, seed=None, sigma_step: float = 0.0):
    """Launch the CUDA kernel on checked CUDA operands: the bank product,
    or with ``mask`` (a (T, M) f32 tensor) the fused DFA gradient.  Returns
    the f32 (T, M) output; raises if the launch fails."""
    if a.device.type != "cuda":
        raise ValueError(f"no photonic_matmul kernel for device {a.device}")
    t, k_dim = a.shape
    m = b.shape[0]
    if min(t, m, k_dim) == 0:
        raise ValueError(f"the kernel takes no empty operands: T={t} M={m} K={k_dim}")
    if not all(x is None or x.is_contiguous() for x in (a, b, noise, mask)):
        raise ValueError("the kernel takes contiguous operands")
    mode = "input" if noise is not None else ("prng" if seed is not None else "none")
    out = torch.empty((t, m), device=a.device, dtype=torch.float32)
    noise_ptr = noise.data_ptr() if noise is not None else None
    args = (out.data_ptr(), t, m, k_dim, _DTYPES[a.dtype], _MODES[mode],
            (int(seed) & _M32) if seed is not None else 0, float(sigma_step))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        lib = _library()
        if mask is None:
            err = lib.photonic_matmul_launch(a.data_ptr(), b.data_ptr(), noise_ptr, *args,
                                             stream)
        else:
            err = lib.dfa_gradient_launch(a.data_ptr(), b.data_ptr(), mask.data_ptr(),
                                          noise_ptr, *args, stream)
    if err != 0:
        name = "photonic_matmul" if mask is None else "dfa_gradient"
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def photonic_matmul_cuda(a, b, *, noise=None, seed=None, sigma_step: float = 0.0):
    """C = A @ Bᵀ with optional bank noise.  A:(T,K) B:(M,K) -> (T,M) f32.

    ``noise`` (T, M) f32 selects "input" mode, ``seed`` (an int) "prng"
    mode with ``sigma_step`` per K tile of ``BLOCK_K``."""
    global launches
    check_operands(a, b, noise, seed)
    if a.device.type == "cpu":
        return photonic_matmul_plain(a, b, noise=noise, seed=seed, sigma_step=sigma_step)
    out = launch_kernel(a, b, noise=noise, seed=seed, sigma_step=sigma_step)
    launches += 1
    return out
