"""The emulated analog signal chain: DAC → modulator → MRR bank (with
crosstalk and drift) → balanced photodetector → ADC, tiled over bank
panels and the WDM buses.

Counterpart of ``repro/hardware/channel.py``; see its docstring for the
chain.  ``emulated_matmul`` is the ``emu`` backend's entry point and the
device-fidelity twin of ``photonics.photonic_matmul``:

1. the GeMM compiler's tiling (``tile_operands``): A (T, K) · B (M, K)ᵀ in
   ⌈M/rows⌉ × ⌈K/cols⌉ panels, the contraction panels scheduled
   round-robin over the surviving buses;
2. the controller's write path (``calibrate.command_deltas``) and the
   physical leak plus drift residual (``effective_deltas``);
3. the photonic part — Lorentzian transfer, dead rings, the MAC, per-pass
   BPD read and shot noise, the per-pass ADC, digital accumulation — either
   unfused here (``bank_product``) or fused in the ``emu_bank_product``
   kernel (``kernels/emu_matmul.py``).

Keys are integer seeds.  ``bank_product`` draws its noise from two
``torch.Generator``s folded from the key, as the reference splits its key
into a thermal and a shot half; the fused kernel draws from the
reference's own counter-based stream.

Tensor parallelism: inside a model-parallel column window
(``photonics.ColumnWindow``) a rank holds its rows of B, the output
columns [start, start + count) of the global product.  The bank tiles B
into panels of ``bank_rows`` output rows, and a panel's crosstalk, its
dead rings and its drift residual are the bank's, so a rank computes
whole global panels: where its columns start or end inside a panel, its
rows of B are widened to the panels they touch with the neighbouring
rows, all-gathered over the model group (``_panel_window``), and the
product's columns are cut back to the rank's.  Both paths then draw the
noise of those global panels (``bank_product`` the panels of the draw over
every panel, the kernel from its column base), so a rank's columns are
the one process's bit for bit.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch.core import photonics
from repro_torch.hardware import calibrate
from repro_torch.hardware import drift as drift_lib
from repro_torch.hardware import mrr
from repro_torch.lint.runtime import check_finite
from repro_torch.utils import prng


def _pad_axis(x, mult: int, axis: int):
    rem = (-x.shape[axis]) % mult
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def tile_operands(a_n, b_n, cfg):
    """Split normalised operands into bank panels scheduled over the alive
    buses: a_n (T, K) -> a_t (T, n_alive, nj, cols); b_n (M, K) -> b_t (nm,
    n_alive, rows, nj, cols); returns (a_t, b_t, n_panels) with n_panels =
    ⌈K/cols⌉ real contraction panels, panel p on cycle p // n_alive of
    alive bus p % n_alive.  Zero padding is harmless (see the reference).
    A stack (E, T, K), (E, M, K) tiles each product alike, in one pass."""
    rows, cols = cfg.bank_rows, cfg.bank_cols
    n_buses = photonics.active_buses(cfg)
    lead = tuple(a_n.shape[:-2])
    t = a_n.shape[-2]
    a_p = _pad_axis(a_n, cols, -1)
    nk = a_p.shape[-1] // cols
    a_t = _pad_axis(a_p.reshape(*lead, t, nk, cols), n_buses, -2)
    nj = a_t.shape[-2] // n_buses
    a_t = a_t.reshape(*lead, t, nj, n_buses, cols).transpose(-3, -2).contiguous()
    b_p = _pad_axis(_pad_axis(b_n, rows, -2), cols, -1)
    nm = b_p.shape[-2] // rows
    b_t = _pad_axis(b_p.reshape(*lead, nm, rows, nk, cols), n_buses, -2)
    b_t = b_t.reshape(*lead, nm, rows, nj, n_buses, cols).movedim(-2, -4).contiguous()
    return a_t, b_t, nk


def effective_deltas(w_target, cfg, residual=None):
    """Targets -> commanded heaters -> physical detunings (crosstalk leak
    plus drift residual).  ``w_target``: the bus-tiled (nm, n_alive, rows,
    nj, cols) layout, a bus-free (..., rows, nk, cols) stack or a bare
    (rows, cols) grid; ``residual``: (n_alive, rows, cols) for the tiled
    layouts (broadcast over the panel axes), (rows, cols) for a bare grid."""
    device = cfg.mrr or mrr.MRRConfig()
    if cfg.failed_buses and device.bus_crosstalk != 0.0 and w_target.ndim >= 5:
        delta_eff = _physical_bus_effective_deltas(w_target, cfg, device)
    else:
        delta_cmd = calibrate.command_deltas(w_target, device)
        delta_eff = delta_cmd + mrr.crosstalk_leak(delta_cmd, device)
    if residual is not None:
        if w_target.ndim >= 3:  # panel layout: broadcast over (nm, nj)
            delta_eff = delta_eff + residual[..., :, None, :]
        else:
            delta_eff = delta_eff + residual
    return delta_eff


def realized_weights(w_target, cfg, residual=None):
    """The full inscription path: targets -> realized Lorentzian weights."""
    device = cfg.mrr or mrr.MRRConfig()
    return mrr.ring_weight(effective_deltas(w_target, cfg, residual), device.gamma)


def _physical_bus_effective_deltas(w_target, cfg, device):
    """Effective detunings for a chip with failed buses and inter-bus
    crosstalk: the alive-layout targets sit in the physical bus stack with
    dead banks undriven at δ = 0; pre-compensation and leak act on that
    stack (dead banks pinned at 0 after every Jacobi sweep) and the alive
    slice is read back."""
    alive = torch.tensor(photonics.alive_bus_indices(cfg), device=w_target.device)
    n_buses = max(cfg.n_buses, 1)
    bus = w_target.ndim - 4

    def embed(x):
        shape = x.shape[:bus] + (n_buses,) + x.shape[bus + 1:]
        return x.new_zeros(shape).index_copy(bus, alive, x)

    delta_target = embed(mrr.inscribe(w_target, device))
    delta_phys = delta_target
    if device.compensate_crosstalk and (device.crosstalk != 0.0
                                        or device.bus_crosstalk != 0.0):
        for _ in range(device.ct_iters):
            delta_phys = delta_target - mrr.crosstalk_leak(delta_phys, device)
            delta_phys = embed(delta_phys.index_select(bus, alive))
    delta_phys = calibrate.quantize_command(
        torch.clamp(delta_phys, 0.0, device.delta_max), device)
    delta_eff = delta_phys + mrr.crosstalk_leak(delta_phys, device)
    return delta_eff.index_select(bus, alive)


def _per_pass_sigma(cfg) -> float:
    """Per-bank-pass BPD read-noise σ in normalised units (the convention
    switch of ``photonics.noise_sigma_total``)."""
    if cfg.noise_convention == "absolute":
        return cfg.noise_std
    if cfg.noise_convention == "fullscale":
        return cfg.noise_std * cfg.bank_cols
    raise ValueError(cfg.noise_convention)


def alive_residual(residual, cfg):
    """Slice a carried (n_buses, rows, cols) residual to the alive buses."""
    if residual is not None and cfg.failed_buses and residual.ndim == 3:
        idx = torch.tensor(photonics.alive_bus_indices(cfg), device=residual.device)
        residual = residual.index_select(0, idx)
    return residual


def alive_dead_ring_mask(cfg, device="cpu"):
    """The chip-fixed dead-ring mask over the physical ring grid, sliced to
    the alive buses: (n_alive, rows, cols) f32, or None without dead rings."""
    dev = cfg.mrr or mrr.MRRConfig()
    if dev.dead_ring_rate <= 0.0:
        return None
    phys = mrr.dead_ring_mask(dev, (max(cfg.n_buses, 1), cfg.bank_rows, cfg.bank_cols),
                              device=device)
    idx = torch.tensor(photonics.alive_bus_indices(cfg), device=phys.device)
    return phys.index_select(0, idx)


def _randn_panels(shape, generator, device, dtype, panels: tuple[int, int]):
    """``torch.randn(shape)`` for a (T, nm, ...) draw of T operand rows and
    nm panels: inside a row window this rank's rows of the draw over the
    global rows, and with ``panels`` = (first, total) the panels [first,
    first + nm) of the draw over ``total``."""
    base, total = photonics.global_rows(shape[0])
    first, n_panels = panels
    if (base, total, first, n_panels) == (0, shape[0], 0, shape[1]):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)
    full = torch.randn((total, n_panels, *shape[2:]), generator=generator, device=device,
                       dtype=dtype)
    return full[base: base + shape[0], first: first + shape[1]]


def bank_product(a_n, b_n, cfg, key=None, *, residual=None, col_base: int = 0,
                 m_total: int | None = None):
    """Noisy panel-accumulated product of normalised operands, unfused.

    a_n: (T, K), b_n: (M, K) in [-1, 1]  ->  (T, M) in bank output units.
    ``col_base`` (whole panels) is the global output column of b_n's first
    row in a product of ``m_total`` columns (default M): the noise is that
    product's draw's panels."""
    device = cfg.mrr or mrr.MRRConfig()
    t = a_n.shape[0]
    m = b_n.shape[0]
    a_t, b_t, n_panels = tile_operands(a_n, b_n, cfg)
    residual = alive_residual(residual, cfg)
    w_eff = realized_weights(b_t, cfg, residual)
    dead = alive_dead_ring_mask(cfg, a_n.device)
    if dead is not None:
        w_eff = w_eff * dead[..., :, None, :]
    # p[t, i, r, q, j]: partial sum of output row block i, ring row r, bus
    # q, bus-cycle j, over every panel at once (the weights are f32: the
    # port inscribes in f32)
    p = torch.einsum("tqjc,iqrjc->tirqj", a_t.to(w_eff.dtype), w_eff)
    n_buses, nj = a_t.shape[1], a_t.shape[2]
    sigma = _per_pass_sigma(cfg)
    if sigma > 0.0 or device.shot_noise > 0.0:
        if key is None:
            raise ValueError("noisy emulated bank requires a PRNG key")
        # rows of T and panels of M: inside a data-parallel row window this
        # rank's rows of the draw over the global rows, and from col_base its
        # panels of the draw over the global product's panels
        rows = cfg.bank_rows
        if col_base % rows:
            raise ValueError(f"col_base {col_base} is not a whole number of panels of {rows}")
        panels = (col_base // rows, -(-(m_total or m) // rows))
        noise = torch.zeros_like(p)
        if sigma > 0.0:
            gen = prng.generator(prng.fold(key, 0), p.device)
            noise = noise + sigma * _randn_panels(p.shape, gen, p.device, p.dtype, panels)
        if device.shot_noise > 0.0:
            gen = prng.generator(prng.fold(key, 1), p.device)
            noise = noise + (device.shot_noise * torch.sqrt(torch.abs(p))
                             * _randn_panels(p.shape, gen, p.device, p.dtype, panels))
        if n_buses * nj != n_panels:
            # idle buses of the last cycle never fire: mask their draws so
            # the accumulated noise counts the real panels only
            valid = (torch.arange(nj, device=p.device)[None, :] * n_buses
                     + torch.arange(n_buses, device=p.device)[:, None]) < n_panels
            noise = noise * valid
        p = p + noise
    if device.adc_bits is not None:
        # each pass is digitised before accumulating; full scale = bank_cols
        p = photonics.fake_quant(p, device.adc_bits, amax=float(cfg.bank_cols))
    out = p.sum(dim=(-2, -1))  # digital accumulation over buses and cycles
    return out.reshape(t, -1)[:, :m]


# ---------------------------------------------------------------------------
# Source-toggle seam (noise-budget attribution): a config twin with the same
# geometry and exactly one physical error source on.
# ---------------------------------------------------------------------------

NOISE_SOURCES: tuple[str, ...] = (
    "quantization",  # DAC/weight fake-quant + heater-DAC command quant
    "thermal",       # per-pass BPD read/thermal floor (cfg.noise_std)
    "shot",          # signal-dependent shot noise
    "adc",           # per-pass output ADC
    "drift",         # carried resonance-drift residual (needs `residual`)
    "crosstalk",     # intra-bank + inter-bus thermal crosstalk
    "dead_rings",    # fabrication-yield dead rings
)


def ideal_twin(cfg):
    """``cfg`` with the same geometry and schedule and every physical error
    source off."""
    device = cfg.mrr or mrr.MRRConfig()
    return dataclasses.replace(
        cfg, noise_std=0.0, input_bits=None, weight_bits=None,
        mrr=dataclasses.replace(mrr.MRRConfig.ideal(), gamma=device.gamma,
                                thermal_settle_s=device.thermal_settle_s))


def isolate_source(cfg, source: str):
    """``cfg`` with exactly one physical error source active (for "drift"
    the caller supplies the residual).  Unknown names raise."""
    if source not in NOISE_SOURCES:
        raise ValueError(f"unknown noise source {source!r} (one of {NOISE_SOURCES})")
    device = cfg.mrr or mrr.MRRConfig()
    base = ideal_twin(cfg)
    ideal = base.mrr
    if source == "quantization":
        return dataclasses.replace(
            base, input_bits=cfg.input_bits, weight_bits=cfg.weight_bits,
            mrr=dataclasses.replace(ideal, heater_bits=device.heater_bits,
                                    delta_max=device.delta_max))
    if source == "thermal":
        return dataclasses.replace(base, noise_std=cfg.noise_std,
                                   noise_convention=cfg.noise_convention)
    if source == "shot":
        return dataclasses.replace(base, mrr=dataclasses.replace(
            ideal, shot_noise=device.shot_noise))
    if source == "adc":
        return dataclasses.replace(base, mrr=dataclasses.replace(
            ideal, adc_bits=device.adc_bits))
    if source == "drift":
        return dataclasses.replace(base, mrr=dataclasses.replace(
            ideal, delta_max=device.delta_max))
    if source == "crosstalk":
        return dataclasses.replace(base, mrr=dataclasses.replace(
            ideal, crosstalk=device.crosstalk, bus_crosstalk=device.bus_crosstalk,
            compensate_crosstalk=device.compensate_crosstalk, ct_iters=device.ct_iters,
            delta_max=device.delta_max))
    return dataclasses.replace(base, mrr=dataclasses.replace(
        ideal, dead_ring_rate=device.dead_ring_rate, yield_seed=device.yield_seed))


EMU_KERNELS = ("ref", "cuda")


def resolve_emu_kernel(spec: str | None = None, device=None) -> str:
    """The emu execution path: "ref" (the unfused chain above) or "cuda"
    (the fused ``emu_bank_product`` kernel; its wrapper runs the kernel's
    plain version for CPU tensors).  None or "auto" reads
    ``REPRO_EMU_KERNEL``, then picks "cuda" for a CUDA ``device`` and "ref"
    otherwise, as the ``auto`` backend does."""
    if spec in (None, "auto"):
        spec = os.environ.get("REPRO_EMU_KERNEL") or None
    if spec in (None, "auto"):
        dev = torch.device(device) if device is not None else None
        spec = "cuda" if dev is not None and dev.type == "cuda" else "ref"
    if spec not in EMU_KERNELS:
        raise ValueError(f"unknown emu kernel {spec!r} (auto | ref | cuda; the "
                         "reference's pallas and xla are the port's cuda)")
    return spec


def emulated_matmul(a, b, cfg, key=None, *, mask=None, state=None,
                    kernel: str | None = None):
    """Device-emulated C = A @ Bᵀ, drop-in for ``photonics.photonic_matmul``
    (the ``emu`` backend).  a: (T, K); b: (M, K); mask: optional (T, M)
    post-detection epilogue.  A stack a (E, T, K), b (E, M, K), mask (E, T,
    M) gives (E, T, M): each product normalised by its own scales, one key,
    residual and dead-ring mask for all, as the reference's ``jax.vmap``;
    the fused kernel takes the stack in one launch, the unfused chain one
    product at a time.  ``state`` overrides the drift state, else the
    active ``drift.use_state`` context is read; with neither the bank is
    drift-free.  ``kernel``: see ``resolve_emu_kernel``."""
    if not cfg.enabled:
        out = torch.einsum("...tk,...mk->...tm" if b.ndim == 3 else "tk,mk->tm", a, b)
        return out * mask if mask is not None else out
    kernel = resolve_emu_kernel(kernel, a.device)
    a_n, b_n, s_a, s_b = photonics.normalise_operands(a, b, cfg)
    if state is None:
        state = drift_lib.active_state()
    residual = drift_lib.residual(state) if state is not None else None
    columns = photonics.active_columns()
    b_n, col_base, cut = _panel_window(b_n, cfg)
    if kernel == "ref" and b.ndim == 3:
        out = torch.stack([bank_product(a_n[i], b_n[i], cfg, key, residual=residual)
                           for i in range(b.shape[0])])
    elif kernel == "ref":
        out = bank_product(a_n, b_n, cfg, key, residual=residual, col_base=col_base,
                           m_total=None if columns is None else columns.total)
    else:
        from repro_torch.kernels import emu_matmul  # lazy: kernels import us

        out = emu_matmul.fused_bank_product(a_n, b_n, cfg, key, residual=residual,
                                            col_base=col_base)
    if cut is not None:
        out = out[..., cut: cut + b.shape[-2]]
    out = check_finite(out * (s_a * s_b), "emulated_matmul output")
    out = out * mask if mask is not None else out
    return out.to(torch.result_type(a, b))


def _panel_window(b_n, cfg):
    """-> (rows of B, col_base, cut): outside a column window b_n, 0 and
    None; inside one the rank's rows of the normalised B widened to the
    whole bank panels they touch, the global output column of the first,
    and where the rank's columns start within the widened product (None
    where nothing was widened).

    The ranks' windows are equal (rank i holds [i·count, (i+1)·count)),
    so whether any panel is shared follows from ``count`` alone and every
    rank of the model group takes the same branch.  Where ``count`` is not
    a whole number of panels, every rank all-gathers its first and last h
    rows, h = min(rows - 1, ⌈count / 2⌉): all that a neighbour's widened
    window reaches into it, and at most one row more than its own."""
    columns = photonics.active_columns()
    if columns is None:
        return b_n, 0, None
    rows, start, count = cfg.bank_rows, columns.start, columns.count
    if count % rows == 0:
        return b_n, start, None
    if columns.group is None:
        raise ValueError(f"a window of {count} columns splits a bank panel of {rows} rows "
                         "between ranks: the window needs its model group")
    import torch.distributed as dist

    from repro_torch.dist import sharding  # lazy: sharding's users import us

    size = dist.get_world_size(columns.group)
    h = min(rows - 1, -(-count // 2))
    ends = sharding._all_gather(torch.cat([b_n[:h], b_n[count - h:]]), 0, columns.group, size)
    first = start // rows * rows
    last = min(-(-(start + count) // rows) * rows, columns.total)
    near = torch.cat([torch.arange(first, start, device=b_n.device),
                      torch.arange(start + count, last, device=b_n.device)])
    rank, at = near // count, near % count  # a row's owner, its place in the owner's rows
    near = ends[rank * 2 * h + torch.where(at < h, at, at - count + 2 * h)]
    cut = start - first
    return torch.cat([near[:cut], b_n, near[cut:]]), first, cut
