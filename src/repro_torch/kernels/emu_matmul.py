"""The fused emu panel loop: the ``emu_bank_product`` CUDA kernel's wrapper,
its plain version, and ``fused_bank_product``, the ``emu`` backend's
drop-in for ``hardware.channel.bank_product``.

Counterpart of ``repro/kernels/emu_matmul.py::emu_bank_product_pallas``
(and its bit-identical twin ``emu_bank_product_xla``).  For each output
element (t, i·rows + r), over the slots s = j·Q + q of the bus-tiled
schedule:

    out = Σ_s ADC( Σ_c a_t[t,q,j,c]·w[i,q,r,j,c] + valid_s·noise )
    w   = (δ² − γ²)/(δ² + γ²) · dead_mask[q,r,c]
    noise = σ·z(c0, c1) + shot·√|p|·z(c0 ^ 0x80000000, c1)
    c0 = (col_base/rows + i)·(Q·NJ) + s,  c1 = (row_base + t)·rows + r,
    valid_s = s < n_panels

with z the reference's Irwin–Hall(4) gaussian of one threefry2x32 output
(``counter_gaussian``), so the noise is the reference's bit for bit.
``row_base`` is the global row of the first row of a_t: a data-parallel
rank that holds rows [r, r + T) of a batch passes r and draws the noise
those rows draw in one launch over the whole batch (0 on one process).
``col_base`` is the global output column of delta_eff's first row: a
tensor-parallel rank that holds output columns [c, c + nm·rows) of a
product passes c and draws those columns' noise (0 on one process).  It
must be a whole number of panels (a multiple of rows): the dead-ring mask
and a drift residual are one bank's, the same for every panel, so a
rank's whole panels are the global product's panels; a column start
inside a panel raises ValueError here, and ``fused_bank_product``'s caller
(``hardware.channel.emulated_matmul``) widens such a rank's rows of the
weight to the panels they touch first.

A stack of E products (a mixture of experts' weights) is one launch:
a_t (E, T, Q, NJ, C) and delta_eff (E, nm, Q, rows, NJ, C) give (E, T,
nm·rows), the index on the kernel's grid y, as the reference's kernel under
``jax.vmap`` gains a leading grid axis.  The counters do not read the
index, so every product draws the same noise, and the dead-ring mask is one
chip's.

The kernel is ``csrc/emu_matmul.cu`` (see its header for the design and
what bounds it), built with ``nvcc`` for ``sm_90a`` at first use into the
library of ``photonic_matmul.build`` and loaded with ``ctypes``; importing
this module builds nothing.  ``_plan`` picks, per call, the kernel's
variant (from C and the operands' addresses), the global output rows each
block owns and the T tile, so the shape logic is plain Python that the
CPU tests reach.

Each slot's inner product is a sequence of single-rounding f32
multiply-adds over c = 0..C−1 from zero, in the kernel (``__fmaf_rn``)
and in the plain version (an exact product plus the f32 accumulator,
summed in f64 and rounded once), so the two agree elementwise and the
ADC rounds the same values.  Divisions are IEEE divisions in both.

``emu_bank_product_cuda`` launches the kernel for CUDA tensors and runs
``emu_bank_product_plain`` only because its tensors lie on the CPU.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import photonic_matmul as pm
from repro_torch.lint.runtime import check_finite
from repro_torch.utils import flop_cost

# Irwin–Hall(4) scale: the sum of four 16-bit uniforms has variance
# 4·(65536² − 1)/12, and √3/65536 normalises it to 1 − 2.3e-10.
_IH4_SCALE = 3.0**0.5 / 65536.0
# counter tweak separating the shot-noise stream from the thermal stream
# (slot counters c0 stay far below 2³¹, so the top bit is free)
_SHOT_STREAM = 0x80000000
_M32 = 0xFFFFFFFF
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # of a_t; delta_eff is f32

launches = 0  # kernel launches since the last reset; read by chip_smoke.py


def counter_gaussian(k0: int, k1: int, c0, c1):
    """One standard gaussian per counter, as the reference's emu kernel
    draws it: the four 16-bit lanes of the two threefry2x32 words summed
    (Irwin–Hall n = 4) and rescaled.  Not the Box–Muller
    ``photonic_matmul.counter_gaussian`` of the bank kernel.  ``c0``, ``c1``:
    broadcastable int64 tensors holding uint32 values -> f32."""
    b0, b1 = pm.threefry2x32(k0, k1, c0, c1)
    s = (b0 & 0xFFFF) + (b0 >> 16) + (b1 & 0xFFFF) + (b1 >> 16)
    return (s.to(torch.float32) - 131070.0) * _IH4_SCALE


def _true_div(x, v: float):
    """x / v as an IEEE division (PyTorch's CUDA kernels multiply by the
    reciprocal of a Python-scalar divisor, which rounds differently)."""
    return x / torch.full((1,), v, dtype=x.dtype, device=x.device)


def _levels(adc_bits: int | None) -> int:
    """ADC levels L = 2^(bits−1) − 1, at least 1; 0 for no ADC."""
    return 0 if adc_bits is None else max(2 ** (adc_bits - 1) - 1, 1)


def _adc(part, adc_bits: int | None, amax: float):
    """Per-pass ADC: rint(clip(p / amax, −1, 1)·L) / L · amax with
    L = 2^(bits−1) − 1, rounding half to even."""
    if adc_bits is None:
        return part
    levels = _levels(adc_bits)
    scaled = torch.clamp(_true_div(part, amax), -1.0, 1.0) * levels
    return _true_div(torch.round(scaled), float(levels)) * amax


def _slot_noise(part, k0: int, k1: int, c0, c1, valid: float, sigma: float, shot: float):
    """One slot's BPD noise on its partials: the read floor plus shot noise
    from disjoint counter streams, times ``valid`` (0 on idle padded slots);
    a term whose amplitude is zero is not drawn."""
    noise = torch.zeros_like(part)
    if sigma > 0.0:
        noise = noise + sigma * counter_gaussian(k0, k1, c0, c1)
    if shot > 0.0:
        z_sh = counter_gaussian(k0, k1, c0 ^ _SHOT_STREAM, c1)
        noise = noise + shot * torch.sqrt(torch.abs(part)) * z_sh
    return part + noise * valid


def _fma_dot(a, w):
    """Σ_c a[..., c]·w[..., c] as f32 multiply-adds with one rounding each,
    in order c = 0..C−1 from zero.  a: (E, T, C), w: (E, R, C) f32 -> (E,
    T, R)."""
    acc = torch.zeros((*a.shape[:-1], w.shape[-2]), dtype=torch.float32, device=a.device)
    a64, w64 = a.double(), w.double()
    for c in range(a.shape[-1]):
        # the f32 product is exact in f64: one rounding per step, as fmaf
        acc = (acc.double() + a64[..., :, c, None] * w64[..., None, :, c]).float()
    return acc


def check_operands(a_t, delta_eff, dead_mask, n_panels: int, seed, row_base: int = 0,
                   col_base: int = 0):
    """Raise on operands the kernel does not take: a_t (T, Q, NJ, C) with
    delta_eff (nm, Q, rows, NJ, C), or a stack of E of each; a ``row_base``
    whose noise counters (row_base + T)·rows would pass 2³²; a ``col_base``
    that is not a whole number of panels, not below 2³², or whose slot
    counters (col_base/rows + nm)·Q·NJ would pass 2³¹."""
    if not ((a_t.ndim, delta_eff.ndim) in ((4, 5), (5, 6))
            and a_t.shape[:-4] == delta_eff.shape[:-5]):
        raise ValueError(f"need a_t ([E,] T, Q, NJ, C) and delta_eff ([E,] nm, Q, rows, NJ, "
                         f"C), got {tuple(a_t.shape)} and {tuple(delta_eff.shape)}")
    t, q_buses, nj, cols = a_t.shape[-4:]
    nm, q2, rows, nj2, cols2 = delta_eff.shape[-5:]
    if (q2, nj2, cols2) != (q_buses, nj, cols):
        raise ValueError(f"a_t {tuple(a_t.shape)} and delta_eff {tuple(delta_eff.shape)} "
                         "disagree on (Q, NJ, C)")
    if a_t.ndim == 5 and not 1 <= a_t.shape[0] <= MAX_STACK:
        raise ValueError(f"a stack of {a_t.shape[0]} products: the kernel takes 1 to "
                         f"{MAX_STACK}")
    if a_t.dtype not in _DTYPES or delta_eff.dtype != torch.float32:
        raise TypeError(f"a_t is f32 or bf16 and delta_eff f32 (the port inscribes in f32), "
                        f"got {a_t.dtype} and {delta_eff.dtype}")
    if a_t.device != delta_eff.device:
        raise ValueError(f"operands on {a_t.device} and {delta_eff.device}")
    if dead_mask is not None and (tuple(dead_mask.shape) != (q_buses, rows, cols)
                                  or dead_mask.dtype != torch.float32
                                  or dead_mask.device != a_t.device):
        raise ValueError(f"dead_mask must be an f32 (Q, rows, C) = {(q_buses, rows, cols)} "
                         "tensor on the operands' device")
    if not 1 <= n_panels <= q_buses * nj:
        raise ValueError(f"n_panels {n_panels} outside [1, Q·NJ = {q_buses * nj}]")
    if seed is not None and len(seed) != 2:
        raise ValueError("seed is two uint32 words")
    if row_base < 0 or (row_base + t) * rows > COUNTER_ROWS:
        raise ValueError(f"row_base {row_base}: the noise counters (row_base + T={t})·"
                         f"rows={rows} pass 2**32")
    if col_base < 0 or col_base % rows:
        raise ValueError(f"col_base {col_base} is not a whole number of panels of {rows} "
                         "rows: widen the weight's rows to the panels they touch")
    if col_base >= COUNTER_ROWS:
        raise ValueError(f"col_base {col_base}: the kernel takes a 32-bit column base")
    if (col_base // rows + nm) * q_buses * nj > COUNTER_SLOTS:
        raise ValueError(f"col_base {col_base}: the slot counters (col_base/rows + nm={nm})·"
                         f"Q·NJ={q_buses * nj} pass 2**31")


def emu_bank_product_plain(a_t, delta_eff, dead_mask, *, n_panels: int, gamma: float,
                           sigma: float, shot: float, adc_bits: int | None, amax: float,
                           seed=None, row_base: int = 0, col_base: int = 0):
    """The kernel's function in plain torch, slot by slot in the kernel's
    order, with its counters -> f32 (T, nm·rows), or (E, T, nm·rows) for a
    stack: every product with the same counters and mask."""
    batched = a_t.ndim == 5
    if not batched:
        a_t, delta_eff = a_t[None], delta_eff[None]
    n_e, t, q_buses, nj, cols = a_t.shape
    nm, _q, rows, _nj, _c = delta_eff.shape[1:]
    noisy = sigma > 0.0 or shot > 0.0
    if noisy and seed is None:
        raise ValueError("noisy fused bank requires a PRNG seed")
    dev = a_t.device
    g2 = gamma * gamma
    d2 = torch.square(delta_eff.float())
    w = (d2 - g2) / (d2 + g2)  # Lorentzian BPD transfer; tensor / tensor is IEEE
    if dead_mask is not None:
        w = w * dead_mask[:, :, None, :]
    a = a_t.float()
    n_slots = q_buses * nj
    if noisy:
        k0, k1 = (int(x) & _M32 for x in seed)
        ii = (col_base // rows
              + torch.arange(nm, device=dev, dtype=torch.int64))[None, :, None]
        c1 = ((row_base + torch.arange(t, device=dev, dtype=torch.int64))[:, None, None] * rows
              + torch.arange(rows, device=dev, dtype=torch.int64)[None, None, :])
    acc = torch.zeros((n_e, t, nm, rows), dtype=torch.float32, device=dev)
    for j in range(nj):
        for q in range(q_buses):
            s = j * q_buses + q
            part = _fma_dot(a[:, :, q, j, :],
                            w[:, :, q, :, j, :].reshape(n_e, nm * rows, cols))
            part = part.reshape(n_e, t, nm, rows)
            if noisy:
                c0 = ii * n_slots + s
                part = _slot_noise(part, k0, k1, c0, c1, float(s < n_panels), sigma, shot)
            acc = acc + _adc(part, adc_bits, amax)
    out = acc.reshape(n_e, t, nm * rows)
    return out if batched else out[0]


# ---------------------------------------------------------------------------
# the planner: which variant, row group and T tile run a call
# ---------------------------------------------------------------------------
# the kernel's variants, in the order of csrc/emu_matmul.cu's Variant
VARIANTS = ("vector", "scalar", "generic")
VECTOR, SCALAR, GENERIC = range(len(VARIANTS))
BANK_COLS = 20  # C of the vector and scalar variants (the paper's 50×20 bank)
THREADS = 256  # the most threads a block runs
TUPLES = 2048  # (row, slot) tuples a block takes at most: 8 per thread
DECODE_T = 8  # T at or below: one T tile, so every weight is formed once
T_TILES = (4, 8, 16, 32)  # the T tiles above it
SMEM_MAX = 232448  # an sm_90 block's opt-in shared memory, bytes
CARD_SMS = 132  # an H100 SXM's SMs
# what one SM holds (sm_90): the kernel's 128 registers a thread
# (__launch_bounds__(256, 2)), and 1 KB of shared memory reserved per block
SM_REGISTERS, REGISTERS, SM_SMEM, SM_THREADS, SM_BLOCKS = 65536, 128, 233472, 2048, 32
MAX_STACK = 65535  # products a launch takes (the grid's y extent)
COUNTER_ROWS = 1 << 32  # (row_base + T)·rows at most: the noise counter c1 is 32 bits
COUNTER_SLOTS = 1 << 31  # slot counters c0 below the shot stream's bit
# the planner's cost of a block, in units of one T row of one tuple (its
# FMA chain, draw and ADC): loading a tuple's detunings and forming its
# weights ≈ 4, staging a T row of inputs ≈ 1/2, the block's launch,
# barriers and sums ≈ 2 (fitted to the card's sweep: tools/emu_plan_sweep.py)
WEIGHT_COST, STAGE_COST, BLOCK_COST = 4.0, 0.5, 2.0


class Plan(NamedTuple):
    variant: int
    rows_per_block: int  # global output rows (i·rows + r) of one block
    t_tile: int  # rows of T per block

    @property
    def name(self) -> str:
        return f"{VARIANTS[self.variant]}/r{self.rows_per_block}/t{self.t_tile}"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _t_unroll(t_tile: int) -> int:
    """Rows of T each thread works on at once (the kernel's TU)."""
    return 1 if t_tile == 1 else 4


def _a_bytes(t_tile: int, n_slots: int, cols: int) -> int:
    """The block's f32 input tile, rounded up to TU rows."""
    tu = _t_unroll(t_tile)
    return 4 * _cdiv(t_tile, tu) * tu * n_slots * cols


def smem_bytes(plan: Plan, q: int, nj: int, cols: int) -> int:
    """Dynamic shared memory of one block: the input tile and the per-slot
    values of its outputs (an odd row stride)."""
    n_slots = q * nj
    return (_a_bytes(plan.t_tile, n_slots, cols)
            + 4 * plan.t_tile * plan.rows_per_block * (n_slots | 1))


def grid_blocks(plan: Plan, t: int, nm: int, rows: int, e: int = 1) -> int:
    """Blocks of one launch: row groups x T tiles, for each of ``e`` products."""
    return e * _cdiv(nm * rows, plan.rows_per_block) * _cdiv(t, plan.t_tile)


def threads_per_block(plan: Plan, q: int, nj: int) -> int:
    """The kernel's block size: the block's tuples spread evenly over at
    most THREADS threads, in whole warps."""
    tuples = plan.rows_per_block * q * nj
    return _cdiv(_cdiv(tuples, _cdiv(tuples, THREADS)), 32) * 32


def _variant(cols: int, pointers) -> int:
    """``pointers``: the addresses of delta_eff and the dead-ring mask (None
    for no mask)."""
    if cols == BANK_COLS:
        aligned = all(p is None or p % 16 == 0 for p in pointers)
        return VECTOR if aligned else SCALAR
    return GENERIC


def _resident(threads: int, smem: int) -> int:
    """Blocks of the kernel one SM holds at once."""
    return min(SM_REGISTERS // (REGISTERS * threads), SM_SMEM // (smem + 1024),
               SM_THREADS // threads, SM_BLOCKS)


@functools.cache
def _tiling(t: int, m_pad: int, n_slots: int, cols: int, sms: int,
            e: int = 1) -> tuple[int, int]:
    """(rows per block, T tile) for a shape; see ``_plan``."""
    best, best_key = (1, 1), None
    for bt in [t] if t <= DECODE_T else sorted({min(t, b) for b in T_TILES}):
        for rb in range(1, max(1, min(TUPLES // n_slots, m_pad)) + 1):
            plan = Plan(VECTOR, rb, bt)
            smem = smem_bytes(plan, 1, n_slots, cols)
            if smem > SMEM_MAX:
                break
            threads = threads_per_block(plan, 1, n_slots)
            blocks = grid_blocks(plan, t, m_pad, 1, e)
            slots = sms * _resident(threads, smem)
            waves = _cdiv(blocks, slots)
            per_thread = _cdiv(rb * n_slots, threads)
            cost = waves * (per_thread * (bt + WEIGHT_COST) + bt * STAGE_COST + BLOCK_COST)
            # the share of the waves' thread-tuple slots that hold a tuple
            used = rb * n_slots * blocks / (waves * slots * threads * per_thread)
            key = (cost, blocks < sms, -used, -rb * bt)
            if best_key is None or key < best_key:
                best, best_key = (rb, bt), key
    return best


def _plan(t: int, nm: int, rows: int, q: int, nj: int, cols: int, pointers,
          sms: int = CARD_SMS, e: int = 1) -> Plan:
    """The plan of one call: a_t ([e,] t, q, nj, cols), delta_eff ([e,] nm,
    q, rows, nj, cols), ``pointers`` the addresses of delta_eff and the mask
    (and of a stack's second product).

    A block owns ``rows_per_block`` global output rows (every slot of
    them: at most TUPLES tuples) and a T tile: all of T at decode (T <=
    DECODE_T: each weight formed once), else one of T_TILES, the T tiles
    of a row group adjacent so their detunings meet in L2.  Of those, the
    plan with the least modelled time: waves of resident blocks (by
    registers, shared memory and threads) times one block's work (its
    tuples per thread, each forming its weights and working through the T
    tile, plus the staging and a fixed cost), over the ``e`` products'
    blocks; ties go to plans that give
    every SM a block, then to the plan whose waves leave the fewest
    thread-tuple slots idle, then to larger blocks.  Raises ValueError if
    no plan fits."""
    rb, bt = _tiling(t, nm * rows, q * nj, cols, sms, e)
    plan = Plan(_variant(cols, pointers), rb, bt)
    _check_plan(plan, t, q, nj, cols, pointers)
    return plan


def _check_plan(plan: Plan, t: int, q: int, nj: int, cols: int, pointers) -> None:
    """Raise ValueError on a plan the kernel cannot run on these operands
    (a plan handed in by a caller, as the card's tests do for every plan)."""
    if plan.variant in (VECTOR, SCALAR) and cols != BANK_COLS:
        raise ValueError(f"the {VARIANTS[plan.variant]} variant takes C={BANK_COLS}, got "
                         f"C={cols}")
    if plan.variant == VECTOR and any(p is not None and p % 16 for p in pointers):
        raise ValueError("the vector variant needs 16-byte-aligned detunings and mask")
    if not (plan.rows_per_block >= 1 and 1 <= plan.t_tile <= t):
        raise ValueError(f"plan {plan.name}: rows per block >= 1 and T tile in [1, T={t}]")
    smem = smem_bytes(plan, q, nj, cols)
    if smem > SMEM_MAX:
        raise ValueError(f"plan {plan.name} needs {smem} bytes of shared memory, more than "
                         f"a block's {SMEM_MAX}: S={q * nj} slots at C={cols}")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _pointers(delta_eff, dead_mask):
    """The addresses the vector variant loads 16 bytes at a time from: the
    detunings, the mask, and for a stack the second product's detunings (so
    that every product's offset is checked)."""
    out = (delta_eff.data_ptr(), dead_mask.data_ptr() if dead_mask is not None else None)
    if delta_eff.ndim == 6 and delta_eff.shape[0] > 1:
        out += (delta_eff[1].data_ptr(),)
    return out


def _stack(a_t) -> int:
    """The products in a launch: E of a stack, else 1."""
    return a_t.shape[0] if a_t.ndim == 5 else 1


def launch_bytes(a_shape, a_itemsize: int, delta_shape, masked: bool) -> int:
    """Bytes one launch must move: a_t ([E,] T, Q, NJ, C) in its dtype,
    δ ([E,] nm, Q, rows, NJ, C) f32 and the (Q, rows, C) f32 dead-ring mask
    read once, the f32 ([E,] T, nm·rows) output written once.  The wrapper
    reports these to ``utils.flop_cost``; ``chip_smoke.py``'s bounds divide
    them by the card's memory rate."""
    e = a_shape[0] if len(a_shape) == 5 else 1
    t, q, nj, cols = a_shape[-4:]
    nm, _q, rows, _nj, _c = delta_shape[-5:]
    return (math.prod(a_shape) * a_itemsize + math.prod(delta_shape) * 4
            + q * rows * cols * 4 * bool(masked) + e * t * nm * rows * 4)


def plan_for(a_t, delta_eff, dead_mask) -> Plan:
    """The plan ``launch_kernel`` picks for these CUDA operands."""
    t, q_buses, nj, cols = a_t.shape[-4:]
    nm, _q, rows, _nj, _c = delta_eff.shape[-5:]
    return _plan(t, nm, rows, q_buses, nj, cols, _pointers(delta_eff, dead_mask),
                 _sm_count(a_t.device.index), _stack(a_t))


def candidate_plans(t: int, nm: int, rows: int, q: int, nj: int, cols: int, pointers,
                    sms: int = CARD_SMS, e: int = 1) -> list[Plan]:
    """The planner's plan first, then every other plan of a small grid
    that the kernel can run on these operands: each variant they allow x
    rows per block {the planner's, 1, twice the planner's} x T tile {the
    planner's, 1, 4, all of T}.  The card's checks run them all against
    the plain version."""
    chosen = _plan(t, nm, rows, q, nj, cols, pointers, sms, e)
    variants = [chosen.variant]
    if cols == BANK_COLS:
        variants += [v for v in (SCALAR, GENERIC) if v != chosen.variant]
    rb, bt = chosen.rows_per_block, chosen.t_tile
    plans = [chosen]
    for variant in variants:
        for r in dict.fromkeys((rb, 1, 2 * rb)):
            for b in dict.fromkeys((bt, 1, min(t, 4), t)):
                plan = Plan(variant, r, b)
                if plan not in plans and smem_bytes(plan, q, nj, cols) <= SMEM_MAX:
                    plans.append(plan)
    return plans


def launch_kernel(a_t, delta_eff, dead_mask, *, n_panels: int, gamma: float, sigma: float,
                  shot: float, adc_bits: int | None, amax: float, seed=None,
                  plan: Plan | None = None, row_base: int = 0, col_base: int = 0):
    """Launch the CUDA kernel on checked CUDA operands -> f32 (T, nm·rows),
    or (E, T, nm·rows) for a stack; ``plan`` defaults to ``_plan``'s
    choice, ``row_base`` is the global row of a_t's first row and
    ``col_base`` the global output column of delta_eff's first row.  Raises
    ValueError for what no plan can run and RuntimeError if
    the launch fails."""
    if a_t.device.type != "cuda":
        raise ValueError(f"no emu_bank_product kernel for device {a_t.device}")
    if not all(x is None or x.is_contiguous() for x in (a_t, delta_eff, dead_mask)):
        raise ValueError("the kernel takes contiguous operands")
    t, q_buses, nj, cols = a_t.shape[-4:]
    nm, _q, rows, _nj, _c = delta_eff.shape[-5:]
    n_e = _stack(a_t)
    if min(t, nm, rows, cols) == 0:
        raise ValueError(f"the kernel takes no empty operands: T={t} nm={nm} rows={rows} "
                         f"C={cols}")
    noisy = sigma > 0.0 or shot > 0.0
    if noisy and seed is None:
        raise ValueError("noisy fused bank requires a PRNG seed")
    k0, k1 = (int(x) & _M32 for x in seed) if noisy else (0, 0)
    pointers = _pointers(delta_eff, dead_mask)
    if plan is None:
        plan = plan_for(a_t, delta_eff, dead_mask)
    else:
        _check_plan(plan, t, q_buses, nj, cols, pointers)
    out = torch.empty((*a_t.shape[:-4], t, nm * rows), device=a_t.device,
                      dtype=torch.float32)
    with torch.cuda.device(a_t.device):
        stream = torch.cuda.current_stream(a_t.device).cuda_stream
        err = pm._library().emu_bank_product_launch(
            a_t.data_ptr(), *pointers[:2], out.data_ptr(),
            n_e, t, q_buses, nj, cols, nm, rows, n_panels,
            _DTYPES[a_t.dtype], float(gamma * gamma), float(sigma), float(shot),
            _levels(adc_bits), float(amax), k0, k1, stream,
            plan.variant, plan.rows_per_block, plan.t_tile, int(row_base), int(col_base))
    if err != 0:
        raise RuntimeError(f"emu_bank_product kernel launch failed ({plan.name}): CUDA error "
                           f"{err}")
    return out


def division_mismatches(device, *, divisor: float | None = None,
                        gamma: float | None = None) -> int:
    """The kernel's branch-free division against IEEE division (``__fdiv_rn``)
    on the card, over every float the kernel sends through it: every
    numerator over ``divisor`` (the ADC's full scale and levels), or the
    Lorentzian (δ² − γ²)/(δ² + γ²) of every δ >= 0 for ``gamma`` -> the
    number of quotients that differ in any bit."""
    if (divisor is None) == (gamma is None):
        raise ValueError("give divisor or gamma")
    count = torch.zeros(1, dtype=torch.int64, device=device)
    mode, g2 = (0, 0.0) if gamma is None else (1, float(gamma) * float(gamma))
    with torch.cuda.device(count.device):
        stream = torch.cuda.current_stream(count.device).cuda_stream
        err = pm._library().emu_division_check(mode, float(divisor or 0.0), g2,
                                               count.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"division check launch failed: CUDA error {err}")
    return int(count.item())


def emu_bank_product_cuda(a_t, delta_eff, dead_mask, *, n_panels: int, gamma: float,
                          sigma: float, shot: float, adc_bits: int | None, amax: float,
                          seed=None, row_base: int = 0, col_base: int = 0):
    """One fused panel loop for a whole bus-tiled GEMM, or for a stack of E
    of them in one launch.  a_t ([E,] T, Q, NJ, C) in f32 or bf16, delta_eff
    ([E,] nm, Q, rows, NJ, C) f32, dead_mask (Q, rows, C) f32 or None, seed
    two uint32 words (needed when σ or shot is nonzero), ``row_base`` the
    global row of a_t's first row, ``col_base`` the global output column of
    delta_eff's first row (whole panels) -> the accumulated f32 ([E,] T,
    nm·rows) (the caller slices M)."""
    global launches
    check_operands(a_t, delta_eff, dead_mask, n_panels, seed, row_base, col_base)
    kw = dict(n_panels=n_panels, gamma=gamma, sigma=sigma, shot=shot, adc_bits=adc_bits,
              amax=amax, seed=seed, row_base=row_base, col_base=col_base)
    if a_t.device.type == "cpu":
        return emu_bank_product_plain(a_t, delta_eff, dead_mask, **kw)
    out = launch_kernel(a_t, delta_eff, dead_mask, **kw)
    launches += 1
    # the launch's MACs: E products × T rows × (nm·rows) outputs × n_panels·C
    # ring products
    flop_cost.count_launch(2 * _stack(a_t) * a_t.shape[-4] * delta_eff.shape[-5]
                           * delta_eff.shape[-3] * n_panels * a_t.shape[-1],
                           launch_bytes(a_t.shape, a_t.element_size(), delta_eff.shape,
                                        dead_mask is not None))
    return out


def seed_words(key: int) -> tuple[int, int]:
    """An integer key -> the kernel's two uint32 seed words (high, low)."""
    key = int(key)
    return ((key >> 32) & _M32, key & _M32)


def fused_bank_product(a_n, b_n, cfg, key=None, *, residual=None, col_base: int = 0):
    """Drop-in for ``hardware.channel.bank_product`` on the fused path:
    a_n (T, K), b_n (M, K) normalised operands -> (T, M) in bank output units
    (the caller rescales by s_a·s_b).  A stack a_n (E, T, K), b_n (E, M, K)
    is tiled in one pass and runs as one launch -> (E, T, M).  Inside a
    data-parallel row window the noise counters start at this rank's first
    global row; ``col_base`` is the global output column of b_n's first row
    (whole panels: a tensor-parallel rank's first column)."""
    from repro_torch.core import photonics
    from repro_torch.hardware import channel  # lazy: channel imports us lazily
    from repro_torch.hardware import mrr

    device = cfg.mrr or mrr.MRRConfig()
    t, m = a_n.shape[-2], b_n.shape[-2]
    a_t, b_t, n_panels = channel.tile_operands(a_n, b_n, cfg)
    residual = channel.alive_residual(residual, cfg)
    delta_eff = channel.effective_deltas(b_t, cfg, residual).contiguous()
    dead_mask = channel.alive_dead_ring_mask(cfg, a_n.device)
    sigma = channel._per_pass_sigma(cfg)
    shot = device.shot_noise
    seed = None
    if sigma > 0.0 or shot > 0.0:
        if key is None:
            raise ValueError("noisy emulated bank requires a PRNG key")
        seed = seed_words(key)
    out = emu_bank_product_cuda(a_t, delta_eff, dead_mask, n_panels=n_panels,
                                gamma=float(device.gamma), sigma=float(sigma),
                                shot=float(shot), adc_bits=device.adc_bits,
                                amax=float(cfg.bank_cols), seed=seed,
                                row_base=photonics.global_rows(t)[0], col_base=col_base)
    return check_finite(out[..., :t, :m], "fused_bank_product output")
