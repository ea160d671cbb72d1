"""Photonic execution model: MRR weight-bank matrix products with the
paper's measured noise, precision, and tiling semantics.

Counterpart of ``repro/core/photonics.py``; see its docstring for the
physics.  In short: an M×N MRR bank computes M inner products of length N
per operational cycle on operands normalised to [-1, 1]; every bank pass
adds Gaussian read noise σ, so a length-K product accumulates
σ·sqrt(ceil(K / bank_cols)).

The port keeps the reference's semantics and differs in idiom only:
tensors carry their device, ``stop_gradient`` is ``.detach()``, and a
"key" is a plain integer seed (``utils.prng.fold``) from which a
``torch.Generator`` is made where noise is drawn.  The ``cuda`` backend is
the counterpart of ``pallas``: it runs the bank product in the CUDA kernel
of ``kernels/photonic_matmul.py``.  The ``emu`` backend emulates the bank
at device level (``hardware.channel``), its fused panel loop in the CUDA
kernel of ``kernels/emu_matmul.py``.

A stacked weight (E, M, K), a mixture of experts' (``nn/moe.py``), makes
``forward_matmul`` the counterpart of ``jax.vmap(forward_matmul)``: one
key for all E products, each normalised by its own scales, one noise draw
in normalised units shared by all of them (the reference's key is not
batched), and every backend takes the batch: ``ref`` as one einsum,
``cuda`` as one batched kernel launch, ``emu`` with one key and drift
residual for all, its fused kernel in one batched launch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import typing

import torch

from repro_torch.hardware.mrr import MRRConfig
from repro_torch.lint.runtime import check_finite
from repro_torch.utils import prng
from repro_torch.utils.flop_cost import collective, storage_key


@dataclasses.dataclass(frozen=True)
class PhotonicConfig:
    bank_rows: int = 50  # M — rows of MRR arrays (paper headline bank 50×20)
    bank_cols: int = 20  # N — WDM channels per waveguide bus
    n_buses: int = 1  # parallel WDM buses (paper §5 scale-out)
    failed_buses: tuple = ()  # physical indices of dead buses
    noise_std: float = 0.0  # per-bank-pass Gaussian σ (0 = ideal hardware)
    noise_convention: str = "absolute"  # absolute | fullscale
    weight_bits: int | None = None  # fake-quant of inscribed MRR weights
    input_bits: int | None = None  # fake-quant of modulator amplitudes (DAC)
    f_s: float = 10e9  # operational rate (Hz), DAC-limited per the paper
    enabled: bool = True
    # device-level description for the "emu" backend; the ref and cuda
    # backends ignore it
    mrr: MRRConfig | None = None

    @property
    def effective_bits(self) -> float:
        """log2(2/σ), the effective resolution in bits."""
        return sigma_to_resolution(self.noise_std)


# Paper-measured hardware presets (Figs. 3c, 5a), as in the reference.
PRESETS: dict[str, PhotonicConfig] = {
    "ideal": PhotonicConfig(noise_std=0.0),
    "single_mrr": PhotonicConfig(noise_std=0.019),
    "offchip_bpd": PhotonicConfig(noise_std=0.098),
    "onchip_bpd": PhotonicConfig(noise_std=0.202),
    "digital": PhotonicConfig(enabled=False),
    "emu_ideal": PhotonicConfig(noise_std=0.0, mrr=MRRConfig.ideal()),
    "emu_offchip": PhotonicConfig(noise_std=0.098, mrr=MRRConfig(adc_bits=10)),
    "emu_onchip": PhotonicConfig(noise_std=0.202, mrr=MRRConfig(adc_bits=8)),
}


def preset(name: str) -> PhotonicConfig:
    return PRESETS[name]


def resolution_to_sigma(bits: float) -> float:
    """Effective resolution (bits) -> full-scale noise σ = 2^(1 - bits)."""
    return 2.0 ** (1.0 - bits)


def sigma_to_resolution(sigma: float) -> float:
    """Full-scale noise σ -> effective bits = 1 - log2(σ)."""
    return 1.0 - math.log2(sigma) if sigma > 0 else float("inf")


def bits_to_std(bits: float) -> float:
    """Alias of ``resolution_to_sigma`` (the reference's historical name)."""
    return resolution_to_sigma(bits)


def std_to_bits(std: float) -> float:
    """Alias of ``sigma_to_resolution`` (the reference's historical name)."""
    return sigma_to_resolution(std)


def fake_quant(x, bits: int | None, amax=None):
    """Symmetric fake quantisation to ``bits`` over [-amax, amax].

    ``bits=1`` clamps to the ternary grid of ``bits=2`` (the naive formula
    has zero levels at one bit).  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    if bits is None:
        return x
    if amax is None:
        amax = x.abs().amax().clamp_min(1e-12)
    levels = max(2 ** (bits - 1) - 1, 1)
    scaled = torch.clamp(x / amax, -1.0, 1.0) * levels
    return torch.round(scaled) / levels * amax


def n_contraction_panels(k_dim: int, cfg: PhotonicConfig) -> int:
    """Bank-sized panels along the contraction dim: the number of noisy
    partial products accumulated per output."""
    return max(1, math.ceil(k_dim / cfg.bank_cols))


def active_buses(cfg: PhotonicConfig) -> int:
    """Buses carrying panels: the physical count minus the failed ones."""
    n = max(cfg.n_buses, 1)
    failed = {b for b in cfg.failed_buses if 0 <= b < n}
    alive = n - len(failed)
    if alive < 1:
        raise ValueError(
            f"all {n} buses failed ({sorted(failed)}): no path through the chip")
    return alive


def alive_bus_indices(cfg: PhotonicConfig) -> tuple:
    """Physical indices of the surviving buses, in order: the panel
    scheduler's logical-bus -> physical-bank map."""
    n = max(cfg.n_buses, 1)
    failed = {b for b in cfg.failed_buses if 0 <= b < n}
    return tuple(b for b in range(n) if b not in failed)


def n_bank_passes(k_dim: int, cfg: PhotonicConfig) -> int:
    """Operational cycles along the contraction dim: ⌈panels / active_buses⌉."""
    return math.ceil(n_contraction_panels(k_dim, cfg) / active_buses(cfg))


def gemm_cycles(m: int, k: int, cfg: PhotonicConfig) -> int:
    """Total operational cycles for an (m×k)·(k,) matvec on the bank."""
    return max(1, math.ceil(m / cfg.bank_rows)) * n_bank_passes(k, cfg)


def noise_sigma_total(k_dim: int, s_a, s_b, cfg: PhotonicConfig):
    """Std of the accumulated output noise for a length-k inner product, in
    natural units.  Every panel contributes one BPD read."""
    passes = n_contraction_panels(k_dim, cfg)
    if cfg.noise_convention == "absolute":
        per_pass = cfg.noise_std * s_a * s_b
    elif cfg.noise_convention == "fullscale":
        per_pass = cfg.noise_std * cfg.bank_cols * s_a * s_b
    else:
        raise ValueError(cfg.noise_convention)
    return per_pass * math.sqrt(passes)


def normalise_operands(a, b, cfg: PhotonicConfig):
    """Encode operands into [-1, 1]: per-tensor max-abs scales, then the
    DAC/weight fake-quant -> (a_n, b_n, s_a, s_b).

    The division runs in the operand dtype (bf16 at full size) and the
    scales stay on the device, as in the reference: no host sync.  Inside
    a row window s_a is the data group's MAX, inside a column window s_b
    the model group's (the whole weight's scale).  A
    stacked b (E, M, K) with a (E, T, K) takes one scale per index, (E, 1,
    1) each, as the reference's vmap gives."""
    dims = (-2, -1) if b.ndim == 3 else None
    window, columns = active_window(), active_columns()
    if dims is not None and (window is not None or columns is not None):
        raise ValueError("a stacked bank product inside a data-parallel row window or a "
                         "model-parallel column window: the trainer's projections are 2-D")
    s_a = (_amax(a.detach().abs(), dims) if window is None else window.amax(a)).clamp_min(1e-12)
    s_b = (_amax(b.detach().abs(), dims) if columns is None else columns.bmax(b)).clamp_min(1e-12)
    a_n = fake_quant(a / s_a, cfg.input_bits, 1.0)
    b_n = fake_quant(b / s_b, cfg.weight_bits, 1.0)
    return a_n, b_n, s_a, s_b


def _amax(x, dims):
    return x.amax() if dims is None else x.amax(dim=dims, keepdim=True)


def photonic_matmul(a, b, cfg: PhotonicConfig, key=None, *, mask=None):
    """Noisy C = A @ Bᵀ (the weight-bank product), plain-torch path.

    a: (..., T, K); b: (M, K); mask: optional (..., T, M) epilogue applied
    after the noise.  ``key`` is an integer seed.  Returns (..., T, M).
    A stacked b (E, M, K) with a (E, T, K) gives (E, T, M): each index
    normalised by its own scales, one (T, M) noise draw added to all."""
    eq = "...tk,...mk->...tm" if b.ndim == 3 else "...tk,mk->...tm"
    if not cfg.enabled:
        out = torch.einsum(eq, a, b)
        return out * mask if mask is not None else out

    a_n, b_n, s_a, s_b = normalise_operands(a, b, cfg)
    out = torch.einsum(eq, a_n, b_n)
    if cfg.noise_std > 0.0:
        if key is None:
            raise ValueError("noise_std > 0 requires a PRNG key")
        sigma = noise_sigma_total(a.shape[-1], 1.0, 1.0, cfg)  # normalised units
        shape = out.shape[-2:] if b.ndim == 3 else out.shape
        noise = randn_rows(shape, prng.generator(key, out.device), out.device, out.dtype)
        out = out + sigma * noise
    out = check_finite(out * (s_a * s_b), "photonic_matmul output")
    return out * mask if mask is not None else out


# ---------------------------------------------------------------------------
# Data-parallel row window and model-parallel column window
# ---------------------------------------------------------------------------
# Under data parallelism each rank projects its own rows of the step's
# global error.  The reference runs one SPMD program over the global
# array, so two things a rank would otherwise take from its rows alone come
# from the global array: the operand's max-abs scale s_a (it sets the DAC
# grid and the noise's absolute size) is the MAX over the data group, and
# noise drawn from a key is this rank's rows of the global draw (the emu
# kernel counts its noise counters from the global row).  The trainer opens
# a window around each data-parallel gradient; outside one every result is
# the single-device one, bit for bit.
#
# Under tensor parallelism each rank projects through its rows of the
# feedback matrix B (the rule splits B's injection dim over ``model``), so
# it computes its columns of the output.  A column window gives the same
# two things from the whole weight: s_b is the MAX over the model group,
# and the noise is this rank's columns of the draw over the global
# columns (with a row window too, its window of both).  The emu backend
# computes the whole bank panels its columns touch and draws their noise
# (``hardware/channel.py``).


def _group_max(cache: dict, x, group):
    """max |x| over ``group``'s pieces of the operand ``x`` is this rank's
    share of: one MAX all-reduce per distinct operand of the window,
    cached in ``cache``; in f32 for the collective (exact)."""
    key = (storage_key(x), x.storage_offset(), tuple(x.shape), x.stride(), x._version)
    if key not in cache:
        s = x.detach().abs().amax()
        if group is not None:
            import torch.distributed as dist

            s32 = s.float()
            with collective("all-reduce", s32.numel() * s32.element_size()):
                dist.all_reduce(s32, op=dist.ReduceOp.MAX, group=group)
            s = s32.to(s.dtype)
        # the operand is held until the window closes, so its storage
        # cannot be reused under the same key
        cache[key] = (x, s)
    return cache[key][1]


@dataclasses.dataclass
class RowWindow:
    """This rank's rows of a step's global batch: ``start`` its first
    example, ``count`` its examples, ``total`` the global examples; the
    scale's MAX runs over ``group`` (a ``torch.distributed`` process group;
    None for a world of one).  A projection's operand has t rows for the
    ``count`` examples: t / count rows an example (tokens for a language
    model)."""

    start: int
    count: int
    total: int
    group: typing.Any = None
    _scales: dict = dataclasses.field(default_factory=dict, repr=False)

    def rows(self, t: int) -> tuple[int, int]:
        """(first global row, global row count) of a t-row operand."""
        if t % self.count:
            raise ValueError(f"an operand of {t} rows over {self.count} examples: the rows "
                             "of a data-parallel projection are whole examples")
        per = t // self.count
        return self.start * per, self.total * per

    def amax(self, a):
        """max |a| over the group's rows of the operand ``a`` is this rank's
        share of (every projection of a step reads the same error: one MAX
        a step)."""
        return _group_max(self._scales, a, self.group)


@dataclasses.dataclass
class ColumnWindow:
    """This rank's columns of a product whose weight's rows are split over
    the model axis: ``start`` its first output column, ``count`` its
    columns (the weight's local rows), ``total`` the global column count;
    the weight's scale s_b is the MAX over ``group`` (the model group)."""

    start: int
    count: int
    total: int
    group: typing.Any = None
    _scales: dict = dataclasses.field(default_factory=dict, repr=False)

    def bmax(self, b):
        """max |b| over the whole weight ``b`` holds this rank's rows of."""
        if b.shape[-2] != self.count:
            raise ValueError(f"a weight of {b.shape[-2]} rows in a window of {self.count} "
                             "columns")
        return _group_max(self._scales, b, self.group)


_WINDOW: list = []
_COLUMNS: list = []


@contextlib.contextmanager
def _pushed(stack: list, window):
    if window is None:
        yield None
        return
    stack.append(window)
    try:
        yield window
    finally:
        stack.pop()


def row_window(window: RowWindow | None):
    """Run the block's projections on this rank's rows of the global batch
    (None: no window, the single-device path)."""
    return _pushed(_WINDOW, window)


def column_window(window: ColumnWindow | None):
    """Run a projection on this rank's columns (its rows of the weight)
    of the global product (None: no window)."""
    return _pushed(_COLUMNS, window)


_WHOLE = object()  # a row window's suspension (``whole_rows``)


@contextlib.contextmanager
def whole_rows():
    """Suspend the row window within the block: its products run on whole
    rows every rank of the group holds alike (a mixture of experts' summed
    dispatch buffer under a photonic forward, ``nn/moe.py``)."""
    _WINDOW.append(_WHOLE)
    try:
        yield
    finally:
        _WINDOW.pop()


def active_window() -> RowWindow | None:
    window = _WINDOW[-1] if _WINDOW else None
    return None if window is _WHOLE else window


def active_columns() -> ColumnWindow | None:
    return _COLUMNS[-1] if _COLUMNS else None


def global_rows(t: int) -> tuple[int, int]:
    """(first global row, global row count) of a t-row operand: (0, t)
    outside a row window."""
    window = active_window()
    return (0, t) if window is None else window.rows(t)


def randn_rows(shape, generator, device, dtype):
    """``torch.randn(shape)`` from ``generator``, whose leading dim is the
    operand's rows and, for a product's (rows, columns) output, whose last
    dim its columns: inside a row window this rank's rows of the draw over
    the global rows, inside a column window its columns of the draw over
    the global columns (with both, its window of both)."""
    base, total = global_rows(shape[0])
    columns = active_columns()
    c0, c_total = (0, shape[-1]) if columns is None else (columns.start, columns.total)
    if columns is not None and shape[-1] != columns.count:
        raise ValueError(f"a draw of {shape[-1]} columns in a window of {columns.count}")
    if (base, total, c0, c_total) == (0, shape[0], 0, shape[-1]):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)
    full = torch.randn((total, *shape[1:-1], c_total), generator=generator, device=device,
                       dtype=dtype)
    return full[base: base + shape[0], ..., c0: c0 + shape[-1]]


# ---------------------------------------------------------------------------
# Execution backends
# ---------------------------------------------------------------------------


class PhotonicBackend:
    """Executes C = A @ Bᵀ (+ bank noise, ⊙ mask) with a:(T,K), b:(M,K)."""

    name = "base"
    stateful_hardware = False

    def matmul(self, a, b, cfg: PhotonicConfig, key=None, *, mask=None):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ReferenceBackend(PhotonicBackend):
    """Plain-torch path: total accumulated noise drawn once per output."""

    name: str = "ref"

    def matmul(self, a, b, cfg, key=None, *, mask=None):
        return photonic_matmul(a, b, cfg, key=key, mask=mask)


@dataclasses.dataclass(frozen=True)
class CudaBackend(PhotonicBackend):
    """The bank product in the hand-written CUDA kernel
    (``kernels/ops.py``), counterpart of the reference's ``PallasBackend``.
    On CPU tensors the kernel's wrapper runs its plain version."""

    name: str = "cuda"

    def matmul(self, a, b, cfg, key=None, *, mask=None):
        from repro_torch.kernels import ops as kops  # lazy: kernels import us

        return kops.photonic_matmul(a, b, cfg, key=key, mask=mask)


@dataclasses.dataclass(frozen=True)
class AutoBackend(PhotonicBackend):
    """``cuda`` for tensors on a CUDA device, ``ref`` otherwise — as the
    reference's ``auto`` picks ``pallas`` on a TPU."""

    name: str = "auto"

    def matmul(self, a, b, cfg, key=None, *, mask=None):
        return BACKENDS["cuda" if a.is_cuda else "ref"].matmul(
            a, b, cfg, key=key, mask=mask)


@dataclasses.dataclass(frozen=True)
class EmulatedMRRBackend(PhotonicBackend):
    """Device-level MRR bank emulation (``hardware.channel``): Lorentzian
    ring transfer, heater inscription and DAC, thermal crosstalk, dead
    rings, BPD read and shot noise, per-pass ADC, and under the trainer
    stateful resonance drift with in-situ recalibration.  ``cfg.mrr``
    describes the device (None: ``MRRConfig()``).

    ``emu_kernel`` picks the execution path (``channel.resolve_emu_kernel``):
    "ref" is the unfused chain, "cuda" the fused panel loop in the
    ``emu_bank_product`` kernel, "auto" the kernel for CUDA tensors and
    the unfused chain for CPU tensors."""

    name: str = "emu"
    stateful_hardware = True
    emu_kernel: str = "auto"

    def matmul(self, a, b, cfg, key=None, *, mask=None):
        from repro_torch.hardware import channel  # lazy: hardware imports us

        return channel.emulated_matmul(a, b, cfg, key=key, mask=mask,
                                       kernel=self.emu_kernel)


BACKENDS: dict[str, PhotonicBackend] = {}


def register_backend(backend: PhotonicBackend) -> PhotonicBackend:
    BACKENDS[backend.name] = backend
    return backend


register_backend(ReferenceBackend())
register_backend(CudaBackend())
register_backend(AutoBackend())
register_backend(EmulatedMRRBackend())


def get_backend(spec: str | PhotonicBackend = "auto") -> PhotonicBackend:
    """Resolve a backend: an instance passes through, a name is looked up."""
    if isinstance(spec, PhotonicBackend):
        return spec
    if spec not in BACKENDS:
        raise KeyError(
            f"unknown photonic backend {spec!r}; registered: {sorted(BACKENDS)}")
    return BACKENDS[spec]


def photonic_project(e, b, cfg: PhotonicConfig, key=None, *, mask=None,
                     backend: str | PhotonicBackend = "auto"):
    """DFA projection δ = e·Bᵀ (⊙ mask) through a registered backend.
    e: (..., d_tap), b: (d_out, d_tap)."""
    lead = e.shape[:-1]
    e2 = e.reshape(-1, e.shape[-1])
    m2 = mask.reshape(-1, mask.shape[-1]) if mask is not None else None
    out = get_backend(backend).matmul(e2, b, cfg, key=key, mask=m2)
    return out.reshape(*lead, b.shape[0])


# ---------------------------------------------------------------------------
# Forward-execution context (photonic inference)
# ---------------------------------------------------------------------------
# The serve engine pushes a ForwardExecution around each step, and
# ``forward_matmul`` is the one seam every weight-stationary projection of
# the models calls.  Outside a context it is the exact digital product.

_FORWARD: list = []


class ForwardExecution:
    """One photonic forward pass: config + backend + a seed stream that
    hands each routed matmul its own folded seed, numbered in call order."""

    def __init__(self, cfg: PhotonicConfig, backend, key=None):
        self.cfg = cfg
        self.backend = get_backend(backend)
        self.key = key
        self.calls = 0

    def next_key(self):
        if self.key is None:
            return None
        self.calls += 1
        return prng.fold(self.key, self.calls)


@contextlib.contextmanager
def forward_execution(cfg: PhotonicConfig, backend="ref", key=None):
    """Route every ``forward_matmul`` in the dynamic extent through
    ``backend`` under ``cfg``."""
    ctx = ForwardExecution(cfg, backend, key)
    _FORWARD.append(ctx)
    try:
        yield ctx
    finally:
        _FORWARD.pop()


def active_forward() -> ForwardExecution | None:
    return _FORWARD[-1] if _FORWARD else None


def scanned_layers(layers):
    """Iterate a stack of layers with the reference's key numbering.

    The reference runs its layers under ``lax.scan``, which traces the body
    once, so every layer's projections draw the same folded keys (layer i's
    q projection reuses layer 0's noise key).  The port keeps that: the
    call counter is rewound at the start of each layer."""
    ctx = active_forward()
    start = ctx.calls if ctx is not None else 0
    for layer in layers:
        if ctx is not None:
            ctx.calls = start
        yield layer


def forward_matmul(x, w):
    """THE forward projection seam: ``x @ wᵀ`` with x: (..., K) and w in
    torch layout (M, K), so the bank's B operand is ``w`` itself.

    Leading dims flatten to a (T, K) stream.  Digital (no active context /
    ``enabled=False``): the exact product.  Photonic: the bank product
    through the context's backend.

    A stacked w (E, M, K) with x (E, ..., K) is the counterpart of the
    reference's ``jax.vmap(forward_matmul)``: x flattens to (E, T, K), the
    digital product is ``x @ w.mT``, and the photonic one is one backend
    call on the batch with one key.

    Inside a column window (``nn/linear.Linear.columns``: w is this rank's
    rows of a weight split over the model axis) the photonic product is
    this rank's columns of the whole weight's: s_b the whole weight's MAX,
    the noise its columns of the one draw (``ref`` and ``cuda``; ``emu``
    through its kernel's ``col_base``); the key is the one the whole
    product takes."""
    ctx = active_forward()
    a = x.reshape(*w.shape[:-2], -1, x.shape[-1])  # (T, K), or (E, T, K) for a stack
    if ctx is None or not ctx.cfg.enabled:
        out = a @ w.mT
    else:
        out = ctx.backend.matmul(a, w, ctx.cfg, key=ctx.next_key())
    return out.reshape(*x.shape[:-1], w.shape[-2]).to(torch.result_type(x, w))
