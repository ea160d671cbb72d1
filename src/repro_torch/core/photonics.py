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
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from repro_torch.hardware.mrr import MRRConfig
from repro_torch.lint.runtime import check_finite
from repro_torch.utils import prng


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


def sigma_to_resolution(sigma: float) -> float:
    """Full-scale noise σ -> effective bits = 1 - log2(σ)."""
    return 1.0 - math.log2(sigma) if sigma > 0 else float("inf")


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
    scales stay on the device, as in the reference: no host sync."""
    s_a = a.detach().abs().amax().clamp_min(1e-12)
    s_b = b.detach().abs().amax().clamp_min(1e-12)
    a_n = fake_quant(a / s_a, cfg.input_bits, 1.0)
    b_n = fake_quant(b / s_b, cfg.weight_bits, 1.0)
    return a_n, b_n, s_a, s_b


def photonic_matmul(a, b, cfg: PhotonicConfig, key=None, *, mask=None):
    """Noisy C = A @ Bᵀ (the weight-bank product), plain-torch path.

    a: (..., T, K); b: (M, K); mask: optional (..., T, M) epilogue applied
    after the noise.  ``key`` is an integer seed.  Returns (..., T, M)."""
    if not cfg.enabled:
        out = torch.einsum("...tk,mk->...tm", a, b)
        return out * mask if mask is not None else out

    a_n, b_n, s_a, s_b = normalise_operands(a, b, cfg)
    out = torch.einsum("...tk,mk->...tm", a_n, b_n)
    if cfg.noise_std > 0.0:
        if key is None:
            raise ValueError("noise_std > 0 requires a PRNG key")
        sigma = noise_sigma_total(a.shape[-1], 1.0, 1.0, cfg)  # normalised units
        noise = torch.randn(out.shape, generator=prng.generator(key, out.device),
                            device=out.device, dtype=out.dtype)
        out = out + sigma * noise
    out = check_finite(out * (s_a * s_b), "photonic_matmul output")
    return out * mask if mask is not None else out


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

    Digital (no active context / ``enabled=False``): the exact product.
    Photonic: flatten leading dims to a (T, K) stream and run the bank
    product through the context's backend."""
    ctx = active_forward()
    if ctx is None or not ctx.cfg.enabled:
        return x @ w.T
    lead = x.shape[:-1]
    a = x.reshape(-1, x.shape[-1])
    out = ctx.backend.matmul(a, w, ctx.cfg, key=ctx.next_key())
    return out.reshape(*lead, w.shape[0]).to(torch.result_type(x, w))
