#!/usr/bin/env python3
"""The sweep behind the emu kernel's planner, on the card: device time of
the vector variant over rows per block x T tile at every bank product of
path B (emu_offchip: bf16 inputs, f32 detunings, σ 0.098, 10-bit ADC), at
decode (T = 4) and prefill (T = 64), beside the plan ``emu_matmul._plan``
picks.  ``emu_matmul``'s cost constants (WEIGHT_COST, STAGE_COST,
BLOCK_COST) were fitted to it.

    python3 tools/emu_plan_sweep.py

Run from the repository root on a machine with one CUDA card and nvcc.
Prints one line per shape: ``r<rows per block>/t<T tile> <device ms>``
(profiler, median of 25, cold L2).  At decode it tries every row count,
above it a coarse grid.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main():
    import torch

    if not torch.cuda.is_available():
        print("emu_plan_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import photonics as ph
    from repro_torch.hardware import channel as ch
    from repro_torch.hardware import mrr
    from repro_torch.kernels import emu_matmul as em

    cfg = ph.PRESETS["emu_offchip"]
    gen = torch.Generator(device="cuda").manual_seed(78)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[emu_plans] device ms per call (profiler, median of 25, cold L2), vector variant; "
          f"card: {card}")
    for t in (4, 64):
        for (m, k) in cs.PATH_SHAPES:
            a_t, delta, mask, n_panels = cs._emu_case(torch, ph, ch, mrr, t, m, k, {},
                                                      {"adc_bits": 10}, True, torch.bfloat16,
                                                      gen)
            kw = dict(n_panels=n_panels, gamma=1.0, sigma=ch._per_pass_sigma(cfg), shot=0.0,
                      adc_bits=10, amax=float(cfg.bank_cols), seed=cs.EMU_SEED)
            n_slots = a_t.shape[1] * a_t.shape[2]
            chosen = em.plan_for(a_t, delta, mask)
            most = em.TUPLES // n_slots
            if t <= em.DECODE_T:  # every row count at decode, a coarse grid above
                rbs, bts = range(1, most + 1), [t]
            else:
                rbs = sorted({1, 2, 3, 4, 5, 7, 10, 14, 19, 29, 39, chosen.rows_per_block}
                             & set(range(1, most + 1)))
                bts = [4, 8, 16, 32]
            cells = []
            for bt in bts:
                for rb in rbs:
                    plan = em.Plan(chosen.variant, rb, bt)
                    if em.smem_bytes(plan, a_t.shape[1], a_t.shape[2], a_t.shape[3]) > em.SMEM_MAX:
                        continue
                    ms = cs._device_ms(torch, lambda plan=plan: em.launch_kernel(
                        a_t, delta, mask, plan=plan, **kw))
                    cells.append(f"r{rb}/t{bt} {ms:.4f}")
            print(f"[emu_plans] T={t} M={m} K={k} (planner {chosen.name}): " + ", ".join(cells),
                  flush=True)
            del a_t, delta, mask
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
