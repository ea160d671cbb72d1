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
(``emu_matmul.py``, source ``csrc/emu_matmul.cu``): one ``nvcc`` per
source, run in parallel, and one link build it.

The kernel has three variants (see the source's header): a skinny GEMV
for decode, tensor-core tiles for bf16 and FFMA tiles for f32 above the
seam.  ``_plan`` picks one per call from the shape, the dtype and the
operands' addresses, and ``launch_kernel`` hands the choice to the C entry
point, so the shape logic is plain Python that the CPU tests reach.

``photonic_matmul_cuda`` launches the kernel for CUDA tensors, and runs
``photonic_matmul_plain`` only because its tensors lie on the CPU.  Noise
modes follow the reference: ``noise`` (a (T, M) operand) selects "input",
``seed`` selects "prng", neither gives the exact product.

Every entry takes a batch axis as well: A (E, T, K) and B (E, M, K) give
(E, T, M) in one launch, the counterpart of the reference's ``jax.vmap``
over stacked experts (``nn/moe.py``).  The noise stays one (T, M) operand
and prng mode one seed for every index, as the reference's unbatched key
gives; index e of a batched launch equals a 2-D launch of ``a[e]``,
``b[e]`` under the same plan, bit for bit.
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
from typing import NamedTuple

import torch

from repro_torch.kernels.ref import photonic_matmul_ref
from repro_torch.utils import flop_cost

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
    """Compile the kernels (once per source revision) into one library and
    return its path: one ``nvcc -c`` per source, all started together, then
    one link.  The file name carries a hash of every source, so an edited
    source is rebuilt and a stale library is never loaded.  ptxas's report
    (registers, shared memory and spills per kernel) is kept beside the
    library as ``ptxas_log(lib)``."""
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.read_bytes())
    digest = h.hexdigest()[:12]
    lib = _BUILD_DIR / f"librepro_torch_kernels-{digest}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC"]
    sources = [src for src in _SOURCES if src.suffix == ".cu"]
    objs = [_BUILD_DIR / f"{src.stem}-{tag}.o" for src in sources]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        procs = [subprocess.Popen([_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for src, obj in zip(sources, objs)]
        logs = [proc.communicate()[1] for proc in procs]  # every nvcc ends before any raise
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
        link = subprocess.run([_nvcc(), *flags, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n{link.stderr}")
        ptxas_log(lib).write_text("".join(logs))
        os.replace(tmp, lib)
    finally:  # no object file or partial library stays behind, built or not
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return lib


def ptxas_log(lib: pathlib.Path) -> pathlib.Path:
    return lib.with_suffix(".ptxas.txt")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.photonic_matmul_block_k.argtypes = []
    lib.photonic_matmul_block_k.restype = ctypes.c_int
    lib.photonic_matmul_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.photonic_matmul_launch.restype = ctypes.c_int
    lib.dfa_gradient_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.dfa_gradient_launch.restype = ctypes.c_int
    lib.emu_bank_product_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int,  # the products in the stack
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]  # the plan: variant, rows, T tile
    lib.emu_bank_product_launch.restype = ctypes.c_int
    lib.emu_division_check.argtypes = [ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                       ctypes.c_void_p, ctypes.c_void_p]
    lib.emu_division_check.restype = ctypes.c_int
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
    """The kernel's "prng" noise summed over its K tiles: (T, M) f32, the
    same at every batch index."""
    t, m = shape
    rows = torch.arange(t, device=device, dtype=torch.int64)[:, None].expand(t, m)
    cols = torch.arange(m, device=device, dtype=torch.int64)[None, :].expand(t, m)
    total = torch.zeros((t, m), device=device, dtype=torch.float32)
    for kt in range(math.ceil(k_dim / BLOCK_K)):
        total += sigma_step * counter_gaussian(  # lint: disable=RL001 counter kt per K tile
            seed, kt, rows, cols)
    return total


def photonic_matmul_plain(a, b, *, noise=None, seed=None, sigma_step: float = 0.0):
    """The kernel's function in plain torch: the f32 oracle
    (``ref.photonic_matmul_ref``) plus the kernel's prng noise -> f32.
    a (T, K), b (M, K) -> (T, M), or a (E, T, K), b (E, M, K) -> (E, T, M)
    with the (T, M) noise added at every index."""
    out = photonic_matmul_ref(a.float(), b.float(), noise=noise)
    if seed is not None and sigma_step > 0.0:
        out = out + prng_noise(int(seed) & _M32, out.shape[-2:], a.shape[-1], sigma_step,
                               out.device)
    return out


def check_operands(a, b, noise, seed):
    """a (T, K) and b (M, K), or a batch of each: a (E, T, K), b (E, M, K)."""
    if noise is not None and seed is not None:
        raise ValueError("give noise or seed, not both")
    if (a.ndim not in (2, 3) or b.ndim != a.ndim or a.shape[-1] != b.shape[-1]
            or a.shape[:-2] != b.shape[:-2]):
        raise ValueError("need a (T, K) and b (M, K), or a (E, T, K) and b (E, M, K), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"operands must share a dtype in {list(_DTYPES)}, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if noise is not None and (noise.shape != (a.shape[-2], b.shape[-2])
                              or noise.dtype != torch.float32 or noise.device != a.device):
        raise ValueError("noise must be an f32 (T, M) tensor on the operands' device")


# ---------------------------------------------------------------------------
# the planner: which of the kernel's variants runs a call
# ---------------------------------------------------------------------------
# the kernel's variants, in the order of csrc/photonic_matmul.cu's Variant
VARIANTS = ("skinny", "skinny_scalar", "mma", "mma_scalar", "ffma")
SKINNY, SKINNY_SCALAR, MMA, MMA_SCALAR, FFMA = range(len(VARIANTS))
VECTOR_VARIANTS = (SKINNY, MMA)  # 16-byte loads of A and B
SEAM = 8  # T at or below: the skinny GEMV; above: the tiled variants
MMA_TILE = 64  # the mma variant's output tile edge (T and M)
MMA_TILE_K = 64  # and its K per pipeline stage
MAX_SPLIT = 8  # a portable cluster: K is split over at most 8 blocks
SMEM_MAX = 232448  # an sm_90 block's opt-in shared memory, bytes
CARD_SMS = 132  # an H100 SXM's SMs


class Plan(NamedTuple):
    variant: int
    split: int = 1  # cluster blocks sharing one mma tile's K

    @property
    def name(self) -> str:
        return VARIANTS[self.variant] + (f"/split{self.split}" if self.split > 1 else "")


def _skinny_rows(t: int) -> int:
    """T rounded up to the skinny variant's accumulator count (2, 4, 8 or
    16): the rows of A it stages."""
    return max(2, 1 << (t - 1).bit_length())


def _aligned(k: int, itemsize: int, pointers) -> bool:
    return (k * itemsize) % 16 == 0 and all(p % 16 == 0 for p in pointers)


def _plan(t: int, m: int, k: int, dtype, pointers, sms: int = CARD_SMS, e: int = 1) -> Plan:
    """The variant for one call: A (t, k), B (m, k) of ``dtype`` whose
    first elements lie at ``pointers`` (A's and B's addresses), ``e`` of
    them in a batched launch.

    T <= SEAM (decode) takes the skinny GEMV if A fits in shared memory;
    above it bf16 takes the tensor-core tiles and f32 the FFMA tiles.  The
    16-byte-load variants need K·itemsize % 16 == 0 and 16-byte-aligned
    operands; every other call takes the scalar-load twin.  The mma
    variant splits K over a cluster of 2, 4 or 8 blocks while the tiles
    alone would leave SMs idle and every block keeps at least two K tiles;
    a batch of ``e`` products has ``e`` times the tiles.
    """
    itemsize = 2 if dtype == torch.bfloat16 else 4
    vec = _aligned(k, itemsize, pointers)
    if t <= SEAM and _skinny_rows(t) * k * itemsize <= SMEM_MAX:
        return Plan(SKINNY if vec else SKINNY_SCALAR)
    if dtype != torch.bfloat16:
        return Plan(FFMA)
    tiles = e * math.ceil(t / MMA_TILE) * math.ceil(m / MMA_TILE)
    k_tiles = math.ceil(k / MMA_TILE_K)
    split = 1
    while split < MAX_SPLIT and tiles * split < sms and 4 * split <= k_tiles:
        split *= 2
    return Plan(MMA if vec else MMA_SCALAR, split)


def _check_plan(plan: Plan, t: int, k: int, dtype, pointers) -> None:
    """Raise on a plan the kernel cannot run on these operands (a plan
    handed in by a caller, as the card's tests do for every variant)."""
    itemsize = 2 if dtype == torch.bfloat16 else 4
    if plan.variant in VECTOR_VARIANTS and not _aligned(k, itemsize, pointers):
        raise ValueError(f"{VARIANTS[plan.variant]} needs 16-byte-aligned operands and rows")
    if plan.variant in (SKINNY, SKINNY_SCALAR) and (
            t > 16 or _skinny_rows(t) * k * itemsize > SMEM_MAX):
        raise ValueError(f"the skinny variant takes T <= 16 with A in shared memory, got T={t}")
    if plan.variant in (MMA, MMA_SCALAR) and dtype != torch.bfloat16:
        raise ValueError("the mma variant takes bf16 operands")
    if plan.variant == FFMA and dtype != torch.float32:
        raise ValueError("the ffma variant takes f32 operands")
    if plan.split not in (1, 2, 4, 8) or (plan.split > 1 and plan.variant not in (MMA, MMA_SCALAR)):
        raise ValueError(f"split {plan.split} is not a cluster the {VARIANTS[plan.variant]} "
                         "variant takes")


# ---------------------------------------------------------------------------
# the launch
# ---------------------------------------------------------------------------
@functools.cache
def _entry_point(masked: bool):
    """The bound ctypes entry point, looked up once."""
    lib = _library()
    return lib.dfa_gradient_launch if masked else lib.photonic_matmul_launch


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_kernel(a, b, *, mask=None, noise=None, seed=None, sigma_step: float = 0.0,
                  plan: Plan | None = None):
    """Launch the CUDA kernel on checked CUDA operands: the bank product,
    or with ``mask`` (an f32 tensor of the output's shape) the fused DFA
    gradient; a (E, T, K) and b (E, M, K) run as one batched launch.
    ``plan`` defaults to ``_plan``'s choice.  Returns the f32 (T, M) or
    (E, T, M) output; raises if the launch fails."""
    device = a.device
    if device.type != "cuda":
        raise ValueError(f"no photonic_matmul kernel for device {device}")
    n_e = a.shape[0] if a.ndim == 3 else 1
    t, k_dim = a.shape[-2:]
    m = b.shape[-2]
    if min(n_e, t, m, k_dim) == 0:
        raise ValueError(f"the kernel takes no empty operands: E={n_e} T={t} M={m} K={k_dim}")
    if not (a.is_contiguous() and b.is_contiguous()
            and (noise is None or noise.is_contiguous())
            and (mask is None or mask.is_contiguous())):
        raise ValueError("the kernel takes contiguous operands")
    pointers = (a.data_ptr(), b.data_ptr())
    index = device.index
    if plan is None:
        plan = _plan(t, m, k_dim, a.dtype, pointers, _sm_count(index), n_e)
    else:
        _check_plan(plan, t, k_dim, a.dtype, pointers)
    mode = "input" if noise is not None else ("prng" if seed is not None else "none")
    out = torch.empty((*a.shape[:-2], t, m), device=device, dtype=torch.float32)
    operands = (*pointers, mask.data_ptr()) if mask is not None else pointers
    args = (*operands, noise.data_ptr() if noise is not None else None, out.data_ptr(),
            n_e, t, m, k_dim, _DTYPES[a.dtype], _MODES[mode],
            (int(seed) & _M32) if seed is not None else 0, float(sigma_step))
    fn = _entry_point(mask is not None)
    # the raw current stream; a device switch only for operands off the current device
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index), plan.variant, plan.split)
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index), plan.variant, plan.split)
    if err != 0:
        name = "photonic_matmul" if mask is None else "dfa_gradient"
        raise RuntimeError(f"{name} kernel launch failed ({plan.name}): CUDA error {err}")
    return out


def launch_bytes(t: int, m: int, k: int, itemsize: int, *, e: int = 1,
                 noise: bool = False) -> int:
    """Bytes one bank-kernel launch must move: A (E, T, K) and B (E, M, K)
    in their dtype read once, input mode's (T, M) f32 noise read once (every
    index of a batch shares it), the f32 (E, T, M) output written once.
    The wrapper reports these to ``utils.flop_cost``; ``chip_smoke.py``'s
    bounds divide them by the card's memory rate."""
    return e * ((t * k + m * k) * itemsize + t * m * 4) + t * m * 4 * bool(noise)


def launch_cost(a, b, noise) -> tuple[int, int]:
    """(FLOPs, bytes) of the launch on these operands: 2·E·T·K·M and
    ``launch_bytes``."""
    e = a.shape[0] if a.ndim == 3 else 1
    t, k, m = a.shape[-2], a.shape[-1], b.shape[-2]
    return 2 * e * t * k * m, launch_bytes(t, m, k, a.element_size(), e=e,
                                           noise=noise is not None)


def photonic_matmul_cuda(a, b, *, noise=None, seed=None, sigma_step: float = 0.0):
    """C = A @ Bᵀ with optional bank noise.  A:(T,K) B:(M,K) -> (T,M) f32,
    or a batch in one launch: A:(E,T,K) B:(E,M,K) -> (E,T,M) f32.

    ``noise`` (T, M) f32 selects "input" mode, ``seed`` (an int) "prng"
    mode with ``sigma_step`` per K tile of ``BLOCK_K``; both are the same
    at every batch index."""
    global launches
    check_operands(a, b, noise, seed)
    if a.device.type == "cpu":
        return photonic_matmul_plain(a, b, noise=noise, seed=seed, sigma_step=sigma_step)
    out = launch_kernel(a, b, noise=noise, seed=seed, sigma_step=sigma_step)
    launches += 1
    flop_cost.count_launch(*launch_cost(a, b, noise))
    return out
