#!/usr/bin/env python3
"""Where the emu kernel's time goes, on the card: build copies of
``csrc/emu_matmul.cu`` with one part of the work taken out and time each
beside the kernel itself at the bank products of path B (emu_offchip:
bf16 inputs, f32 detunings, σ 0.098, 10-bit ADC) under the planner's plan.

    python3 tools/emu_kernel_ablation.py

Run from the repository root on a machine with one CUDA card and nvcc.
The copies compute wrong values on purpose; they are timed, never
checked, and the port never loads them.  Parts taken out:

- no_stage:   the inputs are not read (the staged tile holds zeros);
- no_delta:   the detunings are not read (constants in their place);
- no_weights: no Lorentzian (the weight is its numerator: no division);
- no_prng:    no threefry rounds (the counter words stand in);
- no_sum:     each output takes its first slot's value, no chain.

Prints one line per shape: device µs (profiler, median of 25, cold L2).
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "emu_ablation"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
SHAPES = [(4, 1024, 1024), (4, 2816, 1024), (4, 1024, 2816), (4, 151936, 1024),
          (64, 1024, 1024)]
# (what the kernel says, what the copy says instead)
CUTS = {
    "no_stage": [("x[b] = __ldg(src4 + v);", "x[b] = make_uint4(0u, 0u, 0u, 0u);"),
                 ("x[b] = e < n_real ? to_f32(src[e]) : 0.0f;", "x[b] = 0.0f;")],
    "no_delta": [("load_row<CT, kVec>(tu.delta, cols, d);",
                  "for (int c = 0; c < CM; ++c) d[c] = 0.25f * c;"),
                 ("load_row<CT, kVec>(tu.delta + c_next, cols - c_next, d);",
                  "for (int c = 0; c < CM; ++c) d[c] = 0.25f * c;")],
    "no_weights": [("w[c] = div_by(num, den, div_reciprocal(den));", "w[c] = num;")],
    "no_prng": [("  threefry2x32(k0, k1, x0, x1);\n", "  x0 ^= k0;\n  x1 ^= k1;\n")],
    "no_sum": [("for (int s = 0; s < n_slots; ++s) acc = __fadd_rn(acc, v[s]);",
                "acc = v[0];")],
}


def build(pm):
    """Compile the kernel and each copy in parallel -> {name: CDLL}."""
    source = (CSRC / "emu_matmul.cu").read_text()
    sources = {"kernel": source}
    for name, edits in CUTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the kernel no longer contains {old!r}")
            text = text.replace(old, new)
        sources[name] = text
    procs = {}
    for name, text in sources.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "emu_matmul.cu").write_text(text)
        (d / "threefry.cuh").write_text((CSRC / "threefry.cuh").read_text())
        procs[name] = subprocess.Popen(
            [pm._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-o", str(d / "lib.so"), str(d / "emu_matmul.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.emu_bank_product_launch.argtypes = pm._library().emu_bank_product_launch.argtypes
        lib.emu_bank_product_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    import torch

    if not torch.cuda.is_available():
        print("emu_kernel_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import photonics as ph
    from repro_torch.hardware import channel as ch
    from repro_torch.hardware import mrr
    from repro_torch.kernels import emu_matmul as em
    from repro_torch.kernels import photonic_matmul as pm

    libs = build(pm)
    cfg = ph.PRESETS["emu_offchip"]
    sigma = ch._per_pass_sigma(cfg)
    gen = torch.Generator(device="cuda").manual_seed(78)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[ablation] device µs per call (profiler, median of 25, cold L2); card: {card}")
    for t, m, k in SHAPES:
        a_t, delta, mask, n_panels = cs._emu_case(torch, ph, ch, mrr, t, m, k, {},
                                                  {"adc_bits": 10}, True, torch.bfloat16, gen)
        plan = em.plan_for(a_t, delta, mask)
        _, q, nj, cols = a_t.shape
        nm, _, rows, _, _ = delta.shape
        k0, k1 = cs.EMU_SEED

        def launch(lib):
            out = torch.empty((t, nm * rows), device="cuda", dtype=torch.float32)
            err = lib.emu_bank_product_launch(
                a_t.data_ptr(), delta.data_ptr(), None, out.data_ptr(), t, q, nj, cols, nm,
                rows, n_panels, 1, 1.0, sigma, 0.0, em._levels(10), float(cfg.bank_cols), k0,
                k1, torch.cuda.current_stream().cuda_stream, plan.variant,
                plan.rows_per_block, plan.t_tile)
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return out

        cells = [f"{name} {cs._device_ms(torch, lambda lib=lib: launch(lib)) * 1e3:.1f}"
                 for name, lib in libs.items()]
        print(f"[ablation] T={t} M={m} K={k} {plan.name}: " + ", ".join(cells), flush=True)
        del a_t, delta
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
