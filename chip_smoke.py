#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root of a checkout; it needs one CUDA card and
builds the port's CUDA kernels (``photonic_matmul``, ``dfa_gradient`` and
``emu_bank_product``, one ``nvcc`` per source, one library) from the
sources in the checkout.  Phases:

1. card and build: the card's name and power limit, the library's build
   time, and ``nvcc -Xptxas -v``'s registers, shared memory and spills per
   kernel; the SASS instructions of one threefry draw of the emu kernel and
   of the bank kernel's prng mode (``cuobjdump -sass`` of probes built
   beside the library), which set the two kernels' PRNG bounds;
2. kernel vs plain version at every shape the serving path gives it
   (T = 4 and 64 rows), the ragged 200×300×257, the paper's 64×10×800,
   both sides of the planner's seam between the skinny and the tiled
   variants, and 16-byte-misaligned views (which must take a scalar-load
   variant), in f32 and bf16, noise modes none / input / prng;
3. the ``dfa_gradient`` kernel vs its plain version at the reference's
   kernel-test shapes plus the training shapes 64×10×800 and 256×10×800, in
   f32 and bf16, modes none / input / prng, with a binary (relu') and a
   non-binary (tanh') mask;
4. full-width serve: qwen1.5-0.5b (24 layers, random weights from --seed)
   in bf16 on the ``cuda`` backend with the offchip_bpd preset, counting
   the kernel's launches; then a prefill tick and two decode ticks under
   the profiler (wall, device busy time, idle share, the kernels that take
   the time);
5. full-width parity: the same model in f32 on the ideal preset, the
   ``cuda`` backend against the ``ref`` backend with teacher forcing;
6. full-width DFA training: the paper's 784×800×800×10 MLP on the ``cuda``
   backend, 96 steps at batch 64 on the procedural digits for each of the
   ideal, offchip_bpd and onchip_bpd presets, held to the reference's
   accuracy bands, counting kernel launches per step; one ``bp`` and one
   ``dfa-fused`` step; step time on CUDA events and five steps under the
   profiler;
7. the masked projection on one training step's own operands: the fused
   ``dfa_gradient`` kernel against the bank kernel times relu'(a_k);
8. timing: device time of each kernel, its plain version and
   ``torch.matmul`` (profiler, cold L2) and the card's bound at each path
   shape, with the variant that ran, its GB/s, its share of the bound and
   the host overhead per launch; the sums over one decode step and one
   prefill forward; the skinny and mma variants side by side at T = 4, 8
   and 16 (the seam);
9. ``emu_bank_product``: its branch-free division against IEEE division
   on every float it takes; the kernel vs its plain version, bit for bit,
   at tests/test_emu_kernel.py's shapes, a failed bus with dead rings, a
   drift residual, banks of 40 and 64 columns (the generic variant's
   column chunks), path A's 64×800×10, the reference's emu benchmark
   64×1024×1024 on 4 buses and the qwen head at decode, × f32/bf16 inputs
   (f32 detunings, as the port inscribes) × noise off/σ/σ+shot × ADC
   none/8 bits under the planner's plan, and under every plan of the
   forced grid (variant × rows per block × T tile); determinism; the
   noise σ;
10. path A: the paper's MLP at full width trained through the emulated
    banks (``emu`` backend, drift on, recalibration every 500) on
    emu_offchip and emu_onchip, 2 kernel launches per step, the onchip
    band; step time and profile; the reference's 2-point protocol (hidden
    (128, 128), 8192/2048 digits, 512 steps, ref vs emu);
11. benchmarks/drift_recovery.py's four variants on the port, gated on the
    residual with recalibration lying below the residual without;
12. path B: qwen1.5-0.5b at full width in bf16 served through the emulated
    banks (emu_offchip), 169 launches per forward; the kernel against its
    plain version on the operands path B gave it, bit for bit under every
    plan; a profiled prefill tick and two decode ticks with the kernel's
    ms per tick; then f32 emu_ideal logits, the kernel against the unfused
    chain;
13. ``emu_bank_product`` timing at path A's shape and the benchmark shape
    beside its plain version and its bound (bytes, f32 work, PRNG work),
    then at every bank product of path B at decode (T = 4) and prefill
    (T = 64) with its plan, share of the bound and GB/s, and the sums per
    forward;
14. DFA training of qwen1.5-0.5b at full width in f32 (``[lm_train]``,
    ``[lm_timing]``, ``[lm_emu]``, ``[lm_ckpt]``; see ``phase_lm_train``);
15. the observability plane (``[observe]``, ``phase_observe``): the
    full-width LM's fit with the null observer, an ``Observer`` and the
    alignment probe every 4 steps (the probe's rows and launches, probed =
    unprobed state bit for bit, the trace, step ms of each, the probe's
    ms and peak memory, ``StepTimer`` and ``step_cost``, ``debug_checks``
    on a NaN), the MLP on emulated banks with the noise budget and the
    hardware monitor, and full-width serving with an observer.

Every phase that fails raises and the script exits non-zero.  The line
before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
ARCH = "qwen1.5-0.5b"
DEVICE = "cuda"
# (M, K) of every bank product of one qwen1.5-0.5b token, with its count
# per forward: q/k/v/o 4 per layer, gate/up 2, down 1, and the head
PATH_SHAPES = {(1024, 1024): 96, (2816, 1024): 48, (1024, 2816): 24, (151936, 1024): 1}
EXTRA_SHAPES = [(200, 300, 257), (64, 10, 800)]  # (T, K, M): ragged, the paper's MLP
# (T, K, M) for the dfa_gradient kernel: tests/test_kernels.py's shapes and
# the DFA projection of the paper's MLP at batch 64 and 256
DFA_SHAPES = [(4, 8, 16), (64, 10, 800), (128, 128, 128), (200, 300, 257), (256, 512, 384),
              (256, 10, 800)]
TRAIN_PRESETS = ("ideal", "offchip_bpd", "onchip_bpd")
TRAIN_STEPS, TRAIN_BATCH = 96, 64  # tests/test_train.py's protocol
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # the reference's kernel-test bounds
# published dense peaks (NVIDIA data sheets, SXM parts): bytes/s and op/s by type
CARDS = {"H100": {"bw": 3.35e12, "bfloat16": 989e12, "float32": 67e12},
         "H200": {"bw": 4.8e12, "bfloat16": 989e12, "float32": 67e12}}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def card_peaks(name):
    for key, peaks in CARDS.items():
        if key in name:
            return key, peaks
    return "H100 (assumed)", CARDS["H100"]


def bound_ms(t, m, k, dtype_name, peaks, masked=False, noise="none", draw=None, sms=None):
    """Least time for C = A·Bᵀ (+ noise) (⊙ mask): each input read once (the
    f32 mask and an "input" noise operand too), the f32 output written once,
    2·T·M·K operations at the peak rate of the input type, and in "prng"
    mode the T·M·⌈K/32⌉ threefry draws at ``draw``'s SM clocks each (the
    bank probe's SASS) on ``sms`` SMs at the boost clock.  Returns (ms,
    what binds, bytes moved)."""
    itemsize = 2 if dtype_name == "bfloat16" else 4
    nbytes = ((t * k + m * k) * itemsize
              + t * m * 4 * (1 + (noise == "input") + masked))
    ops = 2 * t * m * k
    by_bytes, by_ops = nbytes / peaks["bw"], ops / peaks[dtype_name]
    if noise == "prng":
        draws = t * m * math.ceil(k / 32)
        by_ops = max(by_ops, draws * draw["clocks"] / (sms * SM_CLOCK))
    return (max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations",
            nbytes)


def phase_build(torch, pm):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    probes = {name: _start_draw_probe(pm, name, src) for name, src in DRAW_PROBES.items()}
    lib = pm.build()
    pm._library()
    print(f"[build] {lib.name} ready in {time.perf_counter() - t0:.1f}s "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    kernels = _ptxas_report(pm.ptxas_log(lib).read_text())
    check(kernels, "nvcc's ptxas report lists no kernel")
    print(f"[build] ptxas -v, {len(kernels)} kernels (static shared memory only; the skinny "
          "variant adds T·K·itemsize of dynamic, the mma variant its 3-stage ring, the emu "
          "kernel its input tile and per-slot values):")
    for name, info in kernels.items():
        print(f"[build]   {info['regs']:3d} registers, {info['smem']:6d} B smem, spill "
              f"{info['spill_st']}/{info['spill_ld']} B st/ld, {info['stack']:3d} B stack  {name}")
    draws = {name: _finish_draw_probe(pm, probe) for name, probe in probes.items()}
    for name, what in (("emu", "one emu threefry draw (ih4_gaussian)"),
                       ("bank", "one bank-kernel prng draw without its Box-Muller transform "
                                "(threefry2x32 and the two 24-bit conversions)"),
                       ("bank_full", "one whole bank-kernel draw (counter_gaussian, not a "
                                     "bound: its log1pf and cosf carry slow paths)")):
        draw = draws[name]
        ops = ", ".join(f"{op} {n}" for op, n in sorted(draw["opcodes"].items()))
        print(f"[build] {what}, SASS: {draw['total']} instructions ({ops}); ALU only "
              f"{draw['alu']}, integer adds and moves {draw['add']}, FMA-heavy only "
              f"{draw['fma_heavy']}, f32 {draw['fp32']}, conversions {draw['xu']}, uniform and "
              f"control {draw['other']}: {draw['clocks']:.4f} SM clocks a draw, bound by "
              f"{draw['by']}")
    return card, draws


def _start_draw_probe(pm, name, source):
    """Start compiling one draw probe (nvcc -cubin, the library's flags)
    beside the library -> (process, source path, cubin path)."""
    out = pm._BUILD_DIR
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"draw_probe_{name}-{os.getpid()}.cu"
    src.write_text(source)
    cubin = src.with_suffix(".cubin")
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    proc = subprocess.Popen([pm._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                             "-std=c++17", "-O3", "-cubin", "-I", str(csrc), "-o", str(cubin),
                             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, src, cubin


def _sass_opcodes(sass, function):
    """Opcode counts (without modifiers) of one function of cuobjdump -sass."""
    import re

    counts, inside = {}, False
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            inside = m.group(1) == function
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
        if inside and m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def draw_cost(opcodes):
    """One draw's instructions by pipe, and the SM clocks it takes at
    least: the ALU-only, FMA-heavy-only or conversion instructions over
    their pipe's rate, or all of them over the issue rate, whichever is
    most (the adds can go to whichever of the two integer pipes is free)."""
    pipes = {"alu": 0, "add": 0, "fma_heavy": 0, "fp32": 0, "xu": 0, "other": 0}
    for op, n in opcodes.items():  # n < 0: one fewer move in the two-draw kernel
        if op == "NOP":
            continue
        if op in ADD_OPS:
            pipes["add"] += n
        elif op in FMA_HEAVY_OPS:
            pipes["fma_heavy"] += n
        elif op in FP32_OPS:
            pipes["fp32"] += n
        elif op in XU_OPS:
            pipes["xu"] += n
        elif op.startswith("U") or op in ISSUE_ONLY_OPS:
            pipes["other"] += n
        else:
            pipes["alu"] += n
    pipes = {pipe: max(n, 0) for pipe, n in pipes.items()}
    total = sum(pipes.values())
    clocks = {"alu": pipes["alu"] / PIPE_RATES["alu"],
              "fma_heavy": pipes["fma_heavy"] / PIPE_RATES["fma_heavy"],
              "xu": pipes["xu"] / PIPE_RATES["xu"], "issue": total / PIPE_RATES["issue"]}
    by = max(clocks, key=clocks.get)
    return {**pipes, "total": total, "clocks": clocks[by], "by": by,
            "opcodes": dict(opcodes)}


def _finish_draw_probe(pm, probe):
    """Wait for the probe, read its SASS and return one draw's cost."""
    proc, src, cubin = probe
    try:
        _, err = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"nvcc failed on the draw probe:\n{err}")
        cuobjdump = pathlib.Path(pm._nvcc()).with_name("cuobjdump")
        dump = subprocess.run([str(cuobjdump), "-sass", str(cubin)], capture_output=True,
                              text=True, timeout=120)
        check(dump.returncode == 0, f"cuobjdump failed on the draw probe:\n{dump.stderr}")
    finally:
        src.unlink(missing_ok=True)
        cubin.unlink(missing_ok=True)
    one = _sass_opcodes(dump.stdout, "probe_one_draw")
    two = _sass_opcodes(dump.stdout, "probe_two_draws")
    check(one and two, "cuobjdump listed no probe kernel")
    diff = {op: two.get(op, 0) - one.get(op, 0) for op in set(one) | set(two)}
    diff = {op: n for op, n in diff.items() if n}
    # threefry2x32 alone is 20 rounds of an add, a rotate and an xor
    check(sum(n for op, n in diff.items() if op != "NOP") >= 40,
          f"the draw probe's SASS difference is not one draw: {diff}")
    return draw_cost(diff)


def _demangle(names):
    try:
        proc = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                              text=True, timeout=60)
    except OSError:
        return list(names)
    out = proc.stdout.splitlines() if proc.returncode == 0 else []
    if len(out) != len(names):
        return list(names)
    return [n.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
            for n in out]


def _ptxas_report(log):
    """Registers, static shared memory, spills and stack per kernel from
    ``nvcc -Xptxas -v``'s report."""
    import re

    rows, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            rows[name] = {"regs": 0, "smem": 0, "spill_st": 0, "spill_ld": 0, "stack": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows[name].update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                              spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[name]["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            rows[name]["smem"] = int(sm.group(1)) if sm else 0
    return dict(zip(_demangle(list(rows)), rows.values()))


def _operands(torch, t, k, m, dtype, gen, misaligned=False):
    """Normalised operands, as the wrapper hands them to the kernel;
    ``misaligned``: contiguous views one element past a 16-byte boundary."""
    def make(rows):
        x = (torch.rand((rows, k), generator=gen, device=DEVICE) * 2 - 1).to(dtype)
        if misaligned:
            flat = torch.empty(rows * k + 1, device=DEVICE, dtype=dtype)
            x = flat[1:].view(rows, k).copy_(x)
        return x

    return make(t), make(m)


def seam_shapes(pm):
    """(T, K, M) on both sides of the planner's seam between the skinny and
    the tiled variants, at the decode layers' shapes."""
    return [(t, k, m) for t in (pm.SEAM, pm.SEAM + 1) for (m, k) in ((1024, 1024), (1024, 2816))]


def phase_kernel_vs_plain(torch, pm):
    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    cases = ([(t, k, m, False) for (m, k) in PATH_SHAPES for t in (4, 64)]
             + [(t, k, m, False) for t, k, m in EXTRA_SHAPES + seam_shapes(pm)]
             + [(t, 1024, 1024, True) for t in (4, 64)])  # 16-byte-misaligned views
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        tol = TOL[dname]
        pooled, pairs, variants = [], [], set()
        for t, k, m, misaligned in cases:
            a, b = _operands(torch, t, k, m, dtype, gen, misaligned)
            plan = pm._plan(t, m, k, dtype, (a.data_ptr(), b.data_ptr()))
            variants.add(plan.name)
            check(not misaligned or plan.variant not in pm.VECTOR_VARIANTS,
                  f"a misaligned view got the vector variant {plan.name}")
            noise = 0.1 * torch.randn((t, m), generator=gen, device=DEVICE)
            for mode, kw in (("none", {}), ("input", {"noise": noise})):
                got = pm.photonic_matmul_cuda(a, b, **kw)
                sync(torch)
                expect = pm.photonic_matmul_plain(a, b, **kw)
                err = (got - expect).abs().max().item()
                scale = expect.abs().max().item()
                ok = torch.allclose(got, expect, rtol=tol, atol=tol * scale + 1e-6)
                check(bool(ok), f"kernel != plain: {dname} {mode} T={t} K={k} M={m} err={err}")
                max_err = max(max_err, err)
            # prng: the kernel's counter noise, statistics and the plain twin
            nk = math.ceil(k / pm.BLOCK_K)
            sigma_total = 0.5
            step = sigma_total / math.sqrt(nk)
            exact = pm.photonic_matmul_cuda(a, b)
            got = pm.photonic_matmul_cuda(a, b, seed=77, sigma_step=step)
            again = pm.photonic_matmul_cuda(a, b, seed=77, sigma_step=step)
            other = pm.photonic_matmul_cuda(a, b, seed=78, sigma_step=step)
            sync(torch)
            err = (got - exact).double() / sigma_total
            std = err.std().item()
            check(abs(std - 1) < 0.05, f"prng σ {std * sigma_total} vs {sigma_total} T={t} M={m}")
            pooled.append(err.flatten())
            if m > 64:
                # each element against the one a 64-column tile to the right
                pair = torch.stack([err[:, :-64].flatten(), err[:, 64:].flatten()])
                pairs.append(pair)
                if pair.shape[1] >= 50_000:  # 0.02 is then >= 4.5 standard errors
                    corr = torch.corrcoef(pair)[0, 1].item()
                    check(abs(corr) < 0.02, f"prng tiles correlated: {corr} T={t} M={m}")
            check(torch.equal(got, again), "prng: same seed, different output")
            check(not torch.equal(got, other), "prng: another seed, same output")
            twin = pm.photonic_matmul_plain(a, b, seed=77, sigma_step=step)
            check(bool(torch.allclose(got, twin, rtol=tol, atol=tol * twin.abs().max().item())),
                  f"prng kernel != plain twin T={t} M={m} {dname}")
        # mean and tile correlation over every shape's noise (in units of σ)
        allz = torch.cat(pooled)
        mean = allz.mean().item()
        corr = torch.corrcoef(torch.cat(pairs, dim=1))[0, 1].item()
        check(abs(mean) < 3 / math.sqrt(allz.numel()), f"prng mean {mean}σ over {allz.numel()}")
        check(abs(corr) < 0.02, f"prng tiles correlated: {corr} over all shapes")
        print(f"[kernel] {dname} prng: mean {mean:.2e}σ over {allz.numel()} samples, "
              f"tile correlation {corr:.2e}")
        print(f"[kernel] {dname}: {len(cases)} shapes (seam T = {pm.SEAM} / {pm.SEAM + 1}, "
              f"2 misaligned views) x none/input/prng agree with the plain version (tol {tol}); "
              f"variants: {', '.join(sorted(variants))}")
    print(f"[kernel] max |kernel - plain| over none/input: {max_err:.3e}")
    return max_err


def _masks(torch, t, m, gen):
    """g'(a) of random pre-activations: relu' (binary) and tanh' (not)."""
    pre = torch.randn((t, m), generator=gen, device=DEVICE)
    return {"relu'": (pre > 0).float(), "tanh'": 1 - torch.tanh(pre) ** 2}


def phase_dfa_kernel_vs_plain(torch, pm, dg):
    """The fused dfa_gradient kernel against dfa_gradient_plain (the bank
    product's plain version times the mask, with the same prng counters)."""
    gen = torch.Generator(device=DEVICE).manual_seed(4321)
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        tol = TOL[dname]
        pooled = []
        for t, k, m in DFA_SHAPES:
            a, b = _operands(torch, t, k, m, dtype, gen)
            noise = 0.1 * torch.randn((t, m), generator=gen, device=DEVICE)
            nk = math.ceil(k / pm.BLOCK_K)
            sigma_total = 0.5
            step = sigma_total / math.sqrt(nk)
            for mname, mask in _masks(torch, t, m, gen).items():
                zero = mask == 0
                for mode, kw in (("none", {}), ("input", {"noise": noise}),
                                 ("prng", {"seed": 77, "sigma_step": step})):
                    got = dg.dfa_gradient_cuda(a, b, mask, **kw)
                    sync(torch)
                    expect = dg.dfa_gradient_plain(a, b, mask, **kw)
                    err = (got - expect).abs().max().item()
                    scale = expect.abs().max().item()
                    check(err <= tol * scale + 1e-6,
                          f"dfa_gradient != plain: {dname} {mode} {mname} T={t} K={k} M={m} "
                          f"err={err} max={scale}")
                    check(bool((got[zero] == 0).all()),
                          f"dfa_gradient: nonzero where the mask is 0 ({dname} {mode} T={t})")
                    if mode != "prng":
                        max_err = max(max_err, err)
                if mname == "relu'":
                    # σ of the prng noise on the entries the mask keeps
                    exact = dg.dfa_gradient_cuda(a, b, mask)
                    noisy = dg.dfa_gradient_cuda(a, b, mask, seed=78, sigma_step=step)
                    sync(torch)
                    z = ((noisy - exact)[~zero].double() / sigma_total)
                    pooled.append(z)
                    if z.numel() >= 10_000:  # 5% is then >= 7 standard errors
                        check(abs(z.std().item() - 1) < 0.05,
                              f"dfa_gradient prng σ {z.std().item() * sigma_total} vs "
                              f"{sigma_total}, T={t} K={k} M={m} {dname}")
        allz = torch.cat(pooled)
        std = allz.std().item()
        check(abs(std - 1) < 0.05, f"dfa_gradient prng σ {std}·σ_total over all shapes")
        print(f"[dfa_gradient] {dname}: {len(DFA_SHAPES)} shapes x relu'/tanh' masks x "
              f"none/input/prng agree with the plain version (tol {tol} of max|out|), exact "
              f"zeros under the mask; prng σ {std:.4f}·σ_step·√nk over {allz.numel()} kept "
              f"entries")
    print(f"[dfa_gradient] max |kernel - plain| over none/input: {max_err:.3e}")
    return max_err


def _prompts(rng, n, length, vocab):
    return [rng.integers(0, vocab, length).tolist() for _ in range(n)]


def phase_serve(torch, np, pm, api, seed):
    from repro_torch.serve import Request

    session = api.build_session(arch=ARCH, algo="bp", smoke=False, hardware="offchip_bpd",
                                backend="cuda", dtype=torch.bfloat16, seed=seed,
                                device=DEVICE)
    model = session.model
    check(model.cfg.n_layers == 24 and model.cfg.d_model == 1024, "not the full model")
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(seed)
    # warm-up: one short request (allocator, first launches)
    warm = session.engine(batch_slots=4, max_len=128, prefill_chunk=16, seed=seed)
    warm.run([Request(prompt=_prompts(rng, 1, 8, vocab)[0], max_new=2)])

    eng = session.engine(batch_slots=4, max_len=128, prefill_chunk=16, seed=seed)
    finite = torch.ones((), dtype=torch.bool, device=DEVICE)
    for name, idx in (("_prefill", 0), ("_decode", 1)):
        fn = getattr(eng, name)

        def wrapped(*args, fn=fn, idx=idx):
            nonlocal finite
            out = fn(*args)
            finite = finite & torch.isfinite(out[idx]).all()
            return out

        setattr(eng, name, wrapped)
    reqs = [Request(prompt=p, max_new=16) for p in _prompts(rng, 8, 32, vocab)]
    sync(torch)
    pm.launches = 0
    t0 = time.perf_counter()
    eng.run(reqs)
    sync(torch)
    wall = time.perf_counter() - t0
    launches = pm.launches
    forwards = eng.stats["prefill_steps"] + eng.stats["decode_steps"]
    tokens = sum(len(r.out) for r in reqs)
    ttft = statistics.median(r.ttft_s for r in reqs)
    print(f"[serve] {len(reqs)} requests, {tokens} tokens in {wall:.3f}s: "
          f"{tokens / wall:.1f} tok/s, ttft p50 {ttft * 1e3:.1f} ms, "
          f"prefill steps {eng.stats['prefill_steps']}, decode steps {eng.stats['decode_steps']}")
    print(f"[serve] photonic_matmul launches {launches} = 169 x {forwards} forwards: "
          f"{launches == 169 * forwards}")
    check(all(r.done and len(r.out) == 16 for r in reqs), "requests unfinished")
    check(launches == 169 * forwards, f"launches {launches} != 169 x {forwards}")
    check(bool(finite.item()), "non-finite logits")
    del eng, warm, session, model
    torch.cuda.empty_cache()
    return launches


def phase_parity(torch, np, api, seed):
    from repro_torch.core import photonics as ph

    model = api.build_model(ARCH, dtype=torch.float32, device=DEVICE, seed=seed)
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(seed)
    tokens = torch.tensor(_prompts(rng, 4, 32, vocab), device=DEVICE)
    n_decode, chunk = 8, 16

    def run(backend, forced=None):
        caches = model.init_caches(4, 128)
        cache_len = torch.zeros(4, dtype=torch.long, device=DEVICE)
        full = torch.full((4,), chunk, dtype=torch.long, device=DEVICE)
        logits_seq, chosen = [], []
        with torch.no_grad(), ph.forward_execution(ph.PRESETS["ideal"], backend):
            for c0 in range(0, tokens.shape[1], chunk):
                logits, caches = model.prefill_step(tokens[:, c0:c0 + chunk], caches,
                                                    cache_len, full)
                cache_len = cache_len + chunk
                logits_seq.append(logits)
            tok = logits[:, -1].argmax(-1)
            for s in range(n_decode):
                tok = forced[s] if forced is not None else tok
                chosen.append(tok)
                logits, caches = model.decode_step(tok[:, None], caches, cache_len)
                cache_len = cache_len + 1
                logits_seq.append(logits)
                tok = logits[:, -1].argmax(-1)
        return logits_seq, chosen

    ref_logits, ref_tokens = run("ref")
    cuda_logits, _ = run("cuda", forced=ref_tokens)
    worst, gated, agree = 0.0, 0, 0
    for r, c in zip(ref_logits, cuda_logits):
        scale = r.abs().max().item()
        rel = (r - c).abs().max().item() / scale
        worst = max(worst, rel)
        top2 = r.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > 10 * 1e-4 * scale
        gated += int(sure.sum())
        agree += int((r.argmax(-1) == c.argmax(-1))[sure].sum())
    print(f"[parity] f32 ideal, cuda vs ref over {len(ref_logits)} forwards: "
          f"max |Δlogit| / max|logit| = {worst:.3e} (limit 1e-4); greedy tokens agree at "
          f"{agree}/{gated} positions with a top-2 gap > 1e-3·max|logit|")
    check(worst <= 1e-4, f"cuda vs ref logits differ by {worst:.3e} of max|logit|")
    check(agree == gated, "greedy tokens differ where the top-2 gap is clear")
    del model
    torch.cuda.empty_cache()


def to_device_batch(batch):
    from repro_torch.data.pipeline import to_device

    return to_device(batch, DEVICE)


def _digits():
    """tests/test_train.py's data: procedural digits, 2048 train / 512 test,
    batches of 64 drawn from seed 0."""
    from repro_torch.data import mnist, pipeline

    xtr, ytr = mnist.procedural_digits(2048, seed=0)
    xte, yte = mnist.procedural_digits(512, seed=10_000)
    return pipeline.ArrayClassification(xtr, ytr, TRAIN_BATCH, seed=0), (xte, yte)


def _mlp_session(api, preset, seed, algo="dfa"):
    from repro_torch.train import SGDM

    session = api.build_session(arch="mnist_mlp", algo=algo, hardware=preset, backend="cuda",
                                optimizer=SGDM(lr=0.01, momentum=0.9), seed=seed,
                                log_every=10**9, device=DEVICE)
    model = session.model
    check(model.in_dim == 784 and model.hidden == (800, 800) and model.n_classes == 10,
          "not the paper's 784x800x800x10 MLP")
    return session


def _profile_steps(torch, session, state, batches):
    """Wall time and device busy time of len(batches) steps under the
    profiler, and the kernels that take the device time."""
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            state, _ = session.step(state, batch)
        sync(torch)
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in _device_kernels(torch, prof):
        name = next((kernel for kernel, parts in KERNEL_PARTS.items()
                     if any(part in e.name for part in parts)), e.name[:70])
        by_name[name] = by_name.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return wall, by_name


def _time_steps(torch, session, pipe, tag, label):
    """Step time: CUDA events around each synchronised step (median of the
    last 30 of 40), steps/s over 40 unsynchronised steps, and the device
    busy time, idle share and largest kernels of 5 steps under the
    profiler."""
    state = session.init_state()
    batches = [to_device_batch(pipe.batch(i)) for i in range(40)]
    times = []
    for batch in batches:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, _ = session.step(state, batch)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    step_ms = statistics.median(times[10:])
    sync(torch)
    t0 = time.perf_counter()
    for batch in batches:
        state, _ = session.step(state, batch)
    sync(torch)
    steps_s = len(batches) / (time.perf_counter() - t0)
    print(f"[{tag}] {label} step (batch {TRAIN_BATCH}): {step_ms:.4f} ms median over "
          f"{len(times) - 10} steady steps (CUDA events, synchronised steps); "
          f"{steps_s:.1f} steps/s, {steps_s * TRAIN_BATCH:.0f} examples/s over "
          f"{len(batches)} unsynchronised steps")
    wall, by_name = _profile_steps(torch, session, state, batches[:5])
    if not by_name:
        print(f"[{tag}] device busy time not measured (the profiler traced no device kernels)")
        return
    busy = sum(by_name.values())
    print(f"[{tag}] profile of 5 steps: wall {wall / 5:.4f} ms/step, device busy "
          f"{busy / 5:.4f} ms/step, idle share {1 - busy / wall:.3f}, "
          f"{len(by_name)} kernel names")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[{tag}]   {ms / 5:8.4f} ms/step  {ms / wall:6.1%} of wall  {name}")


def phase_train(torch, np, api, pm, dg, seed):
    """Full-width DFA training of the paper's MLP on the cuda backend, held
    to the reference's bands; launches per step; bp and dfa-fused steps;
    step time and the profile of five steps."""
    from repro_torch.utils import prng

    pipe, (xte, yte) = _digits()
    accs, loss = {}, {}
    for preset in TRAIN_PRESETS:
        session = _mlp_session(api, preset, seed)
        sync(torch)
        pm.launches = dg.launches = 0
        t0 = time.perf_counter()
        state, _ = session.fit(pipe.batch, total_steps=TRAIN_STEPS, verbose=False)
        sync(torch)
        wall = time.perf_counter() - t0
        a_launches, b_launches = pm.launches, dg.launches
        ev = session.evaluate(state, pipe.eval_batches(xte, yte, 256))
        accs[preset], loss[preset] = ev["accuracy"], ev["ce_loss"]
        print(f"[train] {preset}: {TRAIN_STEPS} dfa steps in {wall:.2f}s, test accuracy "
              f"{accs[preset]:.4f}, test loss {loss[preset]:.4f}; photonic_matmul launches "
              f"{a_launches} = {a_launches / TRAIN_STEPS:g} per step, dfa_gradient "
              f"launches {b_launches}")
        check(math.isfinite(loss[preset]), f"{preset}: non-finite test loss")
        check(a_launches == 2 * TRAIN_STEPS,
              f"{preset}: {a_launches} bank-kernel launches, expected 2 per step (h0, h1)")
        check(all(bool(torch.isfinite(p).all()) for p in state["params"].values()),
              f"{preset}: non-finite parameters")
    train_launches = 2 * TRAIN_STEPS * len(TRAIN_PRESETS)
    print(f"[train] bands: ideal {accs['ideal']:.4f} > 0.6, onchip_bpd "
          f"{accs['onchip_bpd']:.4f} > 0.5, ideal >= onchip_bpd - 0.02")
    check(accs["ideal"] > 0.6, f"ideal accuracy {accs['ideal']} <= 0.6")
    check(accs["onchip_bpd"] > 0.5, f"onchip_bpd accuracy {accs['onchip_bpd']} <= 0.5")
    check(accs["ideal"] >= accs["onchip_bpd"] - 0.02,
          f"ideal {accs['ideal']} < onchip_bpd {accs['onchip_bpd']} - 0.02")

    # one bp step; one dfa-fused step against dfa followed by SGDM.update
    batch = to_device_batch(pipe.batch(0))
    bp = _mlp_session(api, "offchip_bpd", seed, algo="bp")
    state = bp.init_state()
    new, metrics = bp.step(state, batch)
    check(math.isfinite(float(metrics["loss"])) and all(
        bool(torch.isfinite(p).all()) for p in new["params"].values()), "bp step not finite")
    fused = _mlp_session(api, "offchip_bpd", seed, algo="dfa-fused")
    state = fused.init_state()
    rng = prng.step_key(seed, 0, "noise")
    p_f, opt_f, loss_f = fused.fused_step()(state["params"], state["fb"], state["opt"], batch,
                                            rng)
    (loss_u, _), grads = fused.value_and_grad()(state["params"], state["fb"], batch, rng)
    p_u, opt_u, _ = fused.config.optimizer.update(grads, state["opt"], state["params"])
    worst = max((p_f[k] - p_u[k]).abs().max().item() / p_u[k].abs().max().item() for k in p_u)
    worst_m = max((opt_f["mom"][k] - opt_u["mom"][k]).abs().max().item() for k in p_u)
    print(f"[train] bp step: loss {float(metrics['loss']):.4f}; dfa-fused step vs dfa + "
          f"SGDM.update: max |Δparam| / max|param| = {worst:.3e}, max |Δmomentum| = "
          f"{worst_m:.3e}, loss {float(loss_f):.6f} vs {float(loss_u):.6f}")
    check(math.isfinite(float(loss_f)), "dfa-fused loss not finite")
    check(worst <= 1e-6 and worst_m <= 1e-6 and float(loss_f) == float(loss_u),
          "dfa-fused differs from dfa followed by SGDM.update")

    session = _mlp_session(api, "offchip_bpd", seed)
    _time_steps(torch, session, pipe, "train", "offchip_bpd")
    return train_launches


def phase_masked_projection(torch, api, dg, seed):
    """photonic_project(mask=relu'(a_k)) through the fused kernel against the
    bank kernel times relu'(a_k), on one offchip_bpd step's own e, B(k) and
    pre-activations, with the step's own noise keys."""
    from repro_torch.algos import dfa as dfa_lib
    from repro_torch.core import photonics as ph
    from repro_torch.core.feedback import feedback_for
    from repro_torch.utils import prng

    pipe, _ = _digits()
    session = _mlp_session(api, "offchip_bpd", seed)
    state = session.init_state()
    params, cfg = state["params"], session.config.dfa
    batch = to_device_batch(pipe.batch(0))
    rng = prng.step_key(seed, 0, "noise")
    fwd = dfa_lib.forward_with_error(session.model, params, cfg, batch)
    dg.launches = 0
    for spec in session.model.segment_specs():
        p = spec.layer_params(params, 0)
        x = fwd["saved"][spec.name].inputs[0]
        mask = (x @ p["weight"].T + p["bias"] > 0).float()  # relu'(a_k)
        bmat = feedback_for(state["fb"][spec.name], 0)
        key = prng.fold(prng.fold(rng, spec.name), 0)
        fused = ph.photonic_project(fwd["e_tap"], bmat, cfg.photonics, key, mask=mask,
                                    backend="cuda")
        unfused = ph.photonic_project(fwd["e_tap"], bmat, cfg.photonics, key,
                                      backend="cuda") * mask
        sync(torch)
        rel = (fused - unfused).abs().max().item() / unfused.abs().max().item()
        print(f"[masked] {spec.name}: δ {tuple(fused.shape)}, kept {mask.mean().item():.3f} of "
              f"entries; fused vs bank kernel x relu'(a): max |Δ| / max|δ| = {rel:.3e}")
        check(rel <= 2e-5, f"{spec.name}: fused masked projection differs by {rel:.3e}")
    launches = dg.launches
    print(f"[masked] dfa_gradient launches {launches}")
    check(launches > 0, "the masked projection launched no dfa_gradient kernel")
    return launches


def _device_kernels(torch, prof):
    from torch.autograd import DeviceType

    return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def _event_ms(torch, fn, reps=25):
    """Time of one call of ``fn`` on CUDA events: the median over ``reps``
    single calls, each after a write of 64 MiB that evicts the operands
    from the 50 MB L2.  The interval opens before the call is issued, so
    it includes the host's launch overhead when that exceeds the kernel."""
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=DEVICE)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.bitwise_not_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _device_ms(torch, fn, reps=25, attempts=8, spare=16):
    """Device time of one call of ``fn``: the median over ``reps`` calls of
    the summed durations of the device kernels it ran, read from the
    profiler (CUPTI), so the host's launch overhead is not counted.  Before
    each call a 64 MiB bitwise_not evicts the operands from the 50 MB L2,
    as a decode step finds its weights, and marks where the call starts.
    The profiler runs ``spare`` calls more than it counts, after a pause
    inside the window: it can miss the first calls of a window (seen on the
    card: 24 of 25, and 23 of 26 in every window of the emu kernel; 24 of
    33 in eight windows in a row, twice), and the median of the last
    ``reps`` calls is then still a median of whole calls.  It has also lost
    most of a window on a loaded machine (7 of 26 calls; 4, 0 and 16 of 33
    in three windows in a row): such a window is profiled again after a
    pause, up to ``attempts`` times, and then the phase fails."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=DEVICE)
    for _ in range(3):
        fn()
    sync(torch)
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(reps + spare):
                flush.bitwise_not_()
                fn()
            sync(torch)
        per_call, cur = [], None
        for e in _device_kernels(torch, prof):
            if "bitwise_not" in e.name:
                if cur is not None:
                    per_call.append(cur)
                cur = 0.0
            elif cur is not None:
                cur += e.time_range.end - e.time_range.start
        if cur is not None:
            per_call.append(cur)
        if len(per_call) >= reps:
            return statistics.median(per_call[-reps:]) / 1e3
        print(f"[timing] the profiler saw {len(per_call)} of {reps + spare} calls; profiling "
              "again")
        time.sleep(1.0)
    raise PhaseError(f"device time not measured: the profiler saw fewer than {reps} of "
                     f"{reps + spare} calls in each of {attempts} windows")


# the device kernels of each hand-written kernel's variants, by name
KERNEL_PARTS = {"photonic_matmul": ("skinny_kernel", "mma_kernel", "ffma_kernel"),
                "emu_bank_product": ("emu_bank_product",)}


def _profile_ticks(torch, eng, ticks, tag, label, kernel):
    """``ticks`` engine ticks under the profiler: wall time, device busy
    time and idle share per tick, and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.tick()
        sync(torch)
        wall = (time.perf_counter() - t0) / ticks * 1e3
    by_name = {}
    for e in _device_kernels(torch, prof):
        ours = any(part in e.name for part in KERNEL_PARTS[kernel])
        name = kernel if ours else e.name[:70]
        by_name[name] = by_name.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    if not by_name:
        print(f"[{tag}] {label}: wall {wall:.2f} ms; device time not measured (the profiler "
              "traced no device kernels)")
        return
    busy = sum(by_name.values()) / ticks
    print(f"[{tag}] {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms, idle share "
          f"{1 - busy / wall:.3f}; {kernel} {by_name.get(kernel, 0.0) / ticks:.3f} ms per tick")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{tag}]   {ms / ticks:8.3f} ms/tick  {ms / ticks / wall:6.1%} of wall  {name}")


def phase_profile_ticks(torch, np, api, seed, tag="profile", hardware="offchip_bpd",
                        backend="cuda", kernel="photonic_matmul"):
    """A prefill tick (4 slots x chunk 16: 64 rows through every
    projection) and two steady decode ticks (4 active slots), bf16, under
    the profiler."""
    from repro_torch.serve import DECODE, Request

    session = api.build_session(arch=ARCH, algo="bp", smoke=False, hardware=hardware,
                                backend=backend, dtype=torch.bfloat16, seed=seed,
                                device=DEVICE)
    eng = session.engine(batch_slots=4, max_len=128, prefill_chunk=16, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for p in _prompts(rng, 4, 32, session.model.cfg.vocab_size):
        eng.submit(Request(prompt=p, max_new=8))
    eng.tick()  # the first prefill chunk
    _profile_ticks(torch, eng, 1, tag, f"prefill tick (4 slots x 16 tokens, bf16, {hardware})",
                   kernel)
    eng.tick()  # one unprofiled decode tick
    check(all(r is not None and r.state == DECODE for r in eng._requests), "slots not decoding")
    _profile_ticks(torch, eng, 2, tag, f"decode tick (4 slots, bf16, {hardware})", kernel)
    del eng, session
    torch.cuda.empty_cache()


def _fmt(x):
    return f"{x:10.4f}" if x is not None else "       n/a"


def _time_fns(torch, fns, reps):
    """Event and device ms of each function, ``reps[key]`` calls each."""
    row = {}
    for key, fn in fns.items():
        row[key] = _event_ms(torch, fn, reps=reps[key])
        row[key.replace("ms", "dev_ms")] = _device_ms(torch, fn, reps=reps[key])
    return row


def _time_row(torch, fns, bound, reps=None):
    """Event and device ms of each function (25 calls each unless ``reps``
    says otherwise), achieved GB/s and share of the bound from the kernel's
    device time, host overhead per launch (events minus device) of the
    kernel and the library call."""
    row = _time_fns(torch, fns, reps or dict.fromkeys(fns, 25))
    row["bound_ms"], row["bound_by"], nbytes = bound
    row["gb_s"] = nbytes / (row["dev_ms"] * 1e-3) / 1e9
    row["bound_share"] = row["bound_ms"] / row["dev_ms"]
    row["host_us"] = (row["ms"] - row["dev_ms"]) * 1e3
    row["library_host_us"] = (row["library_ms"] - row["library_dev_ms"]) * 1e3
    return row


def _print_row(tag, head, row):
    cells = " ".join(_fmt(row[key]) for key in (
        "ms", "dev_ms", "plain_ms", "plain_dev_ms", "library_ms", "library_dev_ms", "bound_ms"))
    print(f"[{tag}] {head} {cells}  {row['bound_by']:5s} {row['gb_s']:7.1f} "
          f"{row['bound_share']:6.1%} {row['host_us']:7.1f} {row['library_host_us']:7.1f}  "
          f"{row['variant']}")


TIMING_HEAD = ("kernel_ms kernel_dev   plain_ms  plain_dev  matmul_ms matmul_dev   bound_ms  "
               "by       GB/s  bound  host_us  mm_host  variant")


def phase_timing(torch, pm, card):
    """Each bank-product shape of the serving path at T = 4 (decode) and
    T = 64 (prefill, 4 slots x chunk 16) in bf16: the kernel, its plain
    version and torch.matmul; the sums over one decode step's and one
    prefill forward's 169 launches."""
    kind, peaks = card_peaks(card)
    gen = torch.Generator(device=DEVICE).manual_seed(99)
    rows = []
    print(f"[timing] bf16 operands, {kind} peaks: {peaks['bw'] / 1e12:.2f} TB/s, "
          f"{peaks['bfloat16'] / 1e12:.0f} TFLOP/s bf16; card: {card}")
    print("[timing] ms: CUDA events around one call (median of 25, cold L2); dev: the "
          "call's device kernels only (profiler, median of 25); GB/s and bound share from the "
          "kernel's dev; host_us / mm_host: events minus dev per launch, kernel / matmul")
    print(f"[timing]      T      M      K  count  {TIMING_HEAD}")
    for t in (4, 64):
        for (m, k), count in PATH_SHAPES.items():
            a, b = _operands(torch, t, k, m, torch.bfloat16, gen)
            fns = {"ms": lambda: pm.photonic_matmul_cuda(a, b),
                   "plain_ms": lambda: pm.photonic_matmul_plain(a, b),
                   "library_ms": lambda: torch.matmul(a, b.T)}
            bound = bound_ms(t, m, k, "bfloat16", peaks)
            row = dict(t=t, m=m, k=k, count=count, **_time_row(torch, fns, bound),
                       variant=pm._plan(t, m, k, a.dtype, (a.data_ptr(), b.data_ptr())).name)
            rows.append(row)
            _print_row("timing", f"{t:6d} {m:6d} {k:6d} {count:6d}", row)
    keys = ("ms", "dev_ms", "plain_ms", "plain_dev_ms", "library_ms", "library_dev_ms",
            "bound_ms")
    sums = {}
    for t, label in ((4, "one decode step at T=4"), (64, "one prefill forward at T=64")):
        step = [r for r in rows if r["t"] == t]
        total = {key: sum(r[key] * r["count"] for r in step) for key in keys}
        total["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in step)
                             else "operations")
        total["launches"] = sum(r["count"] for r in step)
        total["host_us_per_launch"] = (total["ms"] - total["dev_ms"]) / total["launches"] * 1e3
        total["library_host_us_per_launch"] = ((total["library_ms"] - total["library_dev_ms"])
                                               / total["launches"] * 1e3)
        sums[t] = total
        print(f"[timing] {label} ({total['launches']} launches), ms: "
              + ", ".join(f"{key} {total[key]:.4f}" for key in keys)
              + f"; host overhead per launch {total['host_us_per_launch']:.2f} us (matmul "
              f"{total['library_host_us_per_launch']:.2f} us)")
    return sums[4], sums[64]


def phase_seam(torch, pm, card):
    """The skinny and the mma variant side by side at T = 4, 8 and 16 on
    the decode shapes (bf16, device time, cold L2): the measurement behind
    the planner's seam."""
    kind, peaks = card_peaks(card)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    print(f"[seam] device ms per call, bf16, cold L2; planner seam T <= {pm.SEAM} -> skinny; "
          f"card: {card}")
    print("[seam]      T      M      K     skinny        mma     matmul   bound_ms  planner")
    for t in (4, 8, 16):
        for (m, k) in PATH_SHAPES:
            a, b = _operands(torch, t, k, m, torch.bfloat16, gen)
            ptrs = (a.data_ptr(), b.data_ptr())
            tiled = pm._plan(max(t, pm.SEAM + 1), m, k, a.dtype, ptrs)
            ms = {name: _device_ms(torch, lambda plan=plan: pm.launch_kernel(a, b, plan=plan))
                  for name, plan in (("skinny", pm.Plan(pm.SKINNY)), ("mma", tiled))}
            ms["matmul"] = _device_ms(torch, lambda: torch.matmul(a, b.T))
            bound = bound_ms(t, m, k, "bfloat16", peaks)[0]
            print(f"[seam] {t:6d} {m:6d} {k:6d} {_fmt(ms['skinny'])} {_fmt(ms['mma'])} "
                  f"{_fmt(ms['matmul'])} {_fmt(bound)}  {pm._plan(t, m, k, a.dtype, ptrs).name}")


def phase_timing_train(torch, pm, dg, card):
    """Both kernels at the DFA projection of the paper's MLP, (T, K, M) =
    (64, 10, 800) in f32, beside their plain versions, torch.matmul (times
    the mask for dfa_gradient) and the card's bound."""
    kind, peaks = card_peaks(card)
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    t, k, m = 64, 10, 800
    a, b = _operands(torch, t, k, m, torch.float32, gen)
    mask = _masks(torch, t, m, gen)["relu'"]
    cases = {
        "photonic_matmul": {"ms": lambda: pm.photonic_matmul_cuda(a, b),
                            "plain_ms": lambda: pm.photonic_matmul_plain(a, b),
                            "library_ms": lambda: torch.matmul(a, b.T)},
        "dfa_gradient": {"ms": lambda: dg.dfa_gradient_cuda(a, b, mask),
                         "plain_ms": lambda: dg.dfa_gradient_plain(a, b, mask),
                         "library_ms": lambda: torch.matmul(a, b.T) * mask},
    }
    print(f"[timing] training shape T={t} K={k} M={m}, f32 operands, {kind} peaks: "
          f"{peaks['bw'] / 1e12:.2f} TB/s, {peaks['float32'] / 1e12:.0f} TFLOP/s f32; card: "
          f"{card}; the bound is far below a kernel launch at this size")
    print(f"[timing]                {TIMING_HEAD}")
    rows = {}
    for name, fns in cases.items():
        masked = name == "dfa_gradient"
        bound = bound_ms(t, m, k, "float32", peaks, masked=masked)
        plan = pm._plan(t, m, k, a.dtype, (a.data_ptr(), b.data_ptr()))
        rows[name] = row = dict(**_time_row(torch, fns, bound), variant=plan.name)
        _print_row("timing", f"{name:15s}", row)
    return rows


# ---------------------------------------------------------------------------
# device emulation (slice 3): the emu backend and its emu_bank_product kernel
# ---------------------------------------------------------------------------

# (name, T, M, K, PhotonicConfig keywords, MRRConfig keywords, drift residual):
# tests/test_emu_kernel.py's four shapes, its failed bus with dead rings and
# its carried drift residual, banks of 40 and 64 columns (PhotonicConfig's
# bank_cols; the generic variant in chunks), the DFA projection of path A, the reference's
# emu benchmark GEMM (benchmarks/emu_kernel.py: 64 x 1024 x 1024 on 4 buses)
# and the qwen1.5-0.5b head at decode (path B's largest launch)
EMU_SHAPES = [
    ("one_panel", 4, 50, 20, {}, {}, False),
    ("ragged", 7, 61, 83, {"n_buses": 2}, {}, False),
    ("idle_slots", 5, 61, 83, {"n_buses": 5}, {}, False),
    ("tiles", 16, 130, 260, {"n_buses": 4}, {}, False),
    ("failed_bus_dead_rings", 9, 120, 130, {"n_buses": 3, "failed_buses": (1,)},
     {"dead_ring_rate": 0.05}, False),
    ("drift_residual", 6, 77, 95, {"n_buses": 2}, {}, True),
    ("wide_bank_40", 6, 90, 130, {"bank_cols": 40}, {}, False),
    ("wide_bank_64", 5, 77, 300, {"bank_cols": 64, "n_buses": 2}, {"dead_ring_rate": 0.05},
     True),
    ("path_a", 64, 800, 10, {}, {}, True),
    ("benchmark", 64, 1024, 1024, {"n_buses": 4}, {}, False),
    ("head_decode", 4, 151936, 1024, {}, {}, True),
]
EMU_NOISE = {"off": (0.0, 0.0), "sigma": (0.098, 0.0), "sigma+shot": (0.202, 0.05)}
EMU_SEED = (0x1234ABCD, 0x0BADF00D)
# benchmarks/drift_recovery.py: accelerated drift, its four variants' defaults
FAST_DRIFT = dict(drift_sigma=2.5, drift_tau=32.0, cal_noise=0.01)
# SASS opcodes by the pipe they issue to, and each pipe's results per SM
# per clock (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0): logic, shifts, compares, selects, permutes and
# the like on the ALU pipe (64); integer dot products on the FMA-heavy half
# of the FMA pipe (64); conversions and special functions 16.  Integer adds
# and moves issue to either pipe (IADD3 / VIADD / MOV on the ALU, IMAD as
# an add or a move on the FMA-heavy half), f32 add/multiply/FMA to either
# FMA half; uniform (U*) and control instructions take only an issue slot.
# A warp scheduler issues one instruction a clock: 4 x 32 = 128 lanes per
# SM per clock over all pipes.  NOPs are the padding after EXIT.
ADD_OPS = {"IADD3", "IADD", "VIADD", "IMAD", "MOV"}
FMA_HEAVY_OPS = {"IDP", "IDP4A", "IMUL"}
FP32_OPS = {"FFMA", "FADD", "FMUL", "FFMA32I", "FADD32I", "FMUL32I"}
XU_OPS = {"MUFU", "I2F", "F2I", "F2F", "FRND", "POPC", "FLO", "BREV"}
ISSUE_ONLY_OPS = {"BRA", "EXIT", "RET", "CALL", "BAR", "BSSY", "BSYNC", "WARPSYNC", "S2R",
                  "S2UR", "CS2R", "LDC", "LDG", "STG", "LDS", "STS", "DEPBAR", "YIELD"}
PIPE_RATES = {"alu": 64, "fma_heavy": 64, "xu": 16, "issue": 128}
SM_CLOCK = 1.98e9  # H100 SXM boost clock (data sheet: 1980 MHz)
# pairs of straight-line probe kernels that differ by one draw: the
# difference of their SASS is the instructions of one draw as the kernel's
# source compiles it (the key schedule is shared, in uniform registers).
# "emu": the emu kernel's ih4_gaussian.  "bank": the bank kernel's prng draw
# up to its Box-Muller transform (threefry2x32 and the two 24-bit
# conversions), the part a lower bound may charge: log1pf and cosf compile
# with branches to slow paths that a draw never takes, so counting their
# instructions would overstate the least time.  "bank_full": the whole
# counter_gaussian, printed beside it.
_PROBE_PAIR = r'''
extern "C" __global__ void probe_one_draw(unsigned k0, unsigned k1, float* out) {
  const unsigned c0 = blockIdx.x, c1 = threadIdx.x;
  out[c0 * blockDim.x + c1] = DRAW(k0, k1, c0, c1);
}
extern "C" __global__ void probe_two_draws(unsigned k0, unsigned k1, float* out) {
  const unsigned c0 = blockIdx.x, c1 = threadIdx.x;
  out[c0 * blockDim.x + c1] = DRAW(k0, k1, c0, c1) + DRAW(k0, k1, c1, c0);
}
'''
DRAW_PROBES = {
    "emu": '#include "emu_matmul.cu"\n#define DRAW ih4_gaussian\n' + _PROBE_PAIR,
    "bank": r'''#include "photonic_matmul.cu"
__device__ __forceinline__ float bank_bits(unsigned seed, unsigned kt, unsigned r, unsigned c) {
  uint32_t x0 = r, x1 = c;
  threefry2x32(seed, kt, x0, x1);
  return static_cast<float>(x0 >> 8) + static_cast<float>(x1 >> 8);
}
#define DRAW bank_bits
''' + _PROBE_PAIR,
    "bank_full": '#include "photonic_matmul.cu"\n#define DRAW counter_gaussian\n' + _PROBE_PAIR,
}


def _emu_case(torch, ph, ch, mrr, t, m, k, pkw, mkw, resid, dtype, gen):
    """Tiled operands and effective detunings for one shape, as the emu
    backend hands them to the kernel."""
    cfg = ph.PhotonicConfig(mrr=mrr.MRRConfig(**mkw), **pkw)
    a, b = _operands(torch, t, k, m, dtype, gen)
    a_t, b_t, n_panels = ch.tile_operands(a, b, cfg)
    r = None
    if resid:
        r = 0.08 * torch.randn((max(cfg.n_buses, 1), cfg.bank_rows, cfg.bank_cols),
                               generator=gen, device=DEVICE)
    # f32 whatever the operands are (the port inscribes in f32): the bf16
    # rows hand the kernel bf16 inputs with f32 detunings, as path B does
    delta = ch.effective_deltas(b_t, cfg, ch.alive_residual(r, cfg)).contiguous()
    return a_t, delta, ch.alive_dead_ring_mask(cfg, DEVICE), n_panels


def _emu_candidates(em, a_t, delta, mask):
    """The planner's plan for these operands and the grid of forced plans."""
    t, q, nj, cols = a_t.shape
    nm, _, rows, _, _ = delta.shape
    return em.candidate_plans(t, nm, rows, q, nj, cols, em._pointers(delta, mask),
                              em._sm_count(a_t.device.index))


def _emu_exact(torch, em, got, expect, kw, what):
    """Demand the plain version's bits -> max |got - expect| (0); ADC flips
    are counted for the message."""
    err = (got - expect).abs()
    flips = 0
    if kw["adc_bits"] is not None:
        flips = int((err >= kw["amax"] / em._levels(kw["adc_bits"]) / 2).sum())
    worst = err.max().item()
    check(torch.equal(got, expect),
          f"emu kernel != plain: {what}: max err {worst}, ADC flips {flips}")
    return worst


def phase_emu_kernel_vs_plain(torch, em, ph, ch, mrr):
    """emu_bank_product against its plain version, demanding the same bits,
    at every EMU_SHAPES shape x inputs {f32, bf16} (detunings f32) x noise
    {off, σ, σ + shot} x ADC {none, 8 bits} under the planner's plan; the
    grid of forced plans (every variant x rows per block x T tile of
    ``candidate_plans``) at noise off / no ADC and σ + shot / 8 bits;
    determinism across launches; the noise σ against noise_sigma_total's
    per-panel accounting."""
    # the kernel's branch-free division against IEEE division on every float
    # it takes: the ADC's divisors and the Lorentzian of every δ >= 0 (γ = 1)
    for kw in ({"divisor": 20.0}, {"divisor": 127.0}, {"divisor": 511.0}, {"gamma": 1.0}):
        wrong = em.division_mismatches(DEVICE, **kw)
        check(wrong == 0, f"branch-free division != __fdiv_rn in {wrong} cases ({kw})")
    print("[emu_kernel] branch-free division equals __fdiv_rn on every float numerator it "
          "takes over 20, 127 and 511, and on the Lorentzian of every float δ >= 0 (γ = 1)")
    gen = torch.Generator(device=DEVICE).manual_seed(2024)
    max_err, pooled, plans_run, n_forced = 0.0, [], set(), 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for name, t, m, k, pkw, mkw, resid in EMU_SHAPES:
            a_t, delta, mask, n_panels = _emu_case(torch, ph, ch, mrr, t, m, k, pkw, mkw,
                                                   resid, dtype, gen)
            plans = _emu_candidates(em, a_t, delta, mask)
            plans_run.add(plans[0].name)
            outs = {}
            for noise, (sigma, shot) in EMU_NOISE.items():
                for adc in (None, 8):
                    kw = dict(n_panels=n_panels, gamma=1.0, sigma=sigma, shot=shot,
                              adc_bits=adc, amax=20.0, seed=EMU_SEED if sigma else None)
                    got = em.emu_bank_product_cuda(a_t, delta, mask, **kw)
                    sync(torch)
                    expect = em.emu_bank_product_plain(a_t, delta, mask, **kw)
                    what = f"{name} {dname} {noise} adc={adc} {plans[0].name}"
                    max_err = max(max_err, _emu_exact(torch, em, got, expect, kw, what))
                    check(bool(torch.isfinite(got).all()), f"emu kernel: non-finite {name}")
                    outs[noise, adc] = got
                    if (noise, adc) in (("off", None), ("sigma+shot", 8)):
                        for plan in plans[1:]:
                            forced = em.launch_kernel(a_t, delta, mask, plan=plan, **kw)
                            max_err = max(max_err, _emu_exact(torch, em, forced, expect, kw,
                                                              f"{what} forced {plan.name}"))
                            n_forced += 1
                        again = em.emu_bank_product_cuda(a_t, delta, mask, **kw)
                        check(torch.equal(again, got), f"emu kernel not deterministic: {what}")
            # σ only, no ADC: the accumulated read noise is σ·√n_panels per output
            z = (outs["sigma", None] - outs["off", None]).double() / (0.098 * n_panels ** 0.5)
            if z.numel() >= 10_000:  # 5% is then >= 3.5 standard errors
                check(abs(z.std().item() - 1) < 0.05,
                      f"emu noise σ {z.std().item():.4f}·σ_total at {name} {dname}")
            pooled.append(z.flatten())
        print(f"[emu_kernel] a_t {dname}, δ float32: {len(EMU_SHAPES)} shapes x noise "
              f"off/σ/σ+shot x ADC none/8 equal the plain version bit for bit (0 error, 0 ADC "
              f"flips), deterministic across launches")
    allz = torch.cat(pooled)
    std = allz.std().item()
    check(abs(std - 1) < 0.05, f"emu noise σ {std}·σ_total over all shapes")
    print(f"[emu_kernel] planner's plans: {', '.join(sorted(plans_run))}; {n_forced} launches "
          f"of forced plans (every variant x rows x T tile the grid allows) equal the plain "
          f"version bit for bit (max |kernel - plain| {max_err:.3e}); read noise σ "
          f"{std:.4f}·σ_total over {allz.numel()} outputs")
    return max_err


def _emu_mlp_session(api, preset, seed, **kw):
    from repro_torch.train import SGDM

    session = api.build_session(arch=kw.pop("arch", "mnist_mlp"), algo="dfa", hardware=preset,
                                backend=kw.pop("backend", "emu"),
                                optimizer=SGDM(lr=0.01, momentum=0.9), seed=seed,
                                log_every=10**9, device=DEVICE, **kw)
    return session


def phase_emu_train(torch, np, api, em, seed):
    """Path A: the paper's MLP at full width trained with DFA through the
    emulated banks (drift on, recalibration every 500) on emu_offchip and
    emu_onchip; then the reference's 2-point acceptance protocol."""
    from repro_torch.data import mnist, pipeline
    from repro_torch.models.mlp import MLPClassifier

    pipe, (xte, yte) = _digits()
    launches = 0
    for preset in ("emu_offchip", "emu_onchip"):
        session = _emu_mlp_session(api, preset, seed)
        model = session.model
        check(model.in_dim == 784 and model.hidden == (800, 800), "not the paper's MLP")
        check(session.config.recalibrate_every == 500, "default recalibration is not 500")
        sync(torch)
        em.launches = 0
        t0 = time.perf_counter()
        state, metrics = session.fit(pipe.batch, total_steps=TRAIN_STEPS, verbose=False)
        sync(torch)
        wall = time.perf_counter() - t0
        n = em.launches
        launches += n
        ev = session.evaluate(state, pipe.eval_batches(xte, yte, 256))
        host = session.trainer.to_host(metrics)
        print(f"[emu_train] {preset}: {TRAIN_STEPS} dfa steps in {wall:.2f}s, test accuracy "
              f"{ev['accuracy']:.4f}, test loss {ev['ce_loss']:.4f}; emu_bank_product launches "
              f"{n} = {n / TRAIN_STEPS:g} per step; hw_drift_rms {host['hw_drift_rms']:.5f}, "
              f"hw_residual_rms {host['hw_residual_rms']:.5f}, hw_dead_rings "
              f"{host['hw_dead_rings']:g}")
        check(n == 2 * TRAIN_STEPS, f"{preset}: {n} emu launches, expected 2 per step")
        check(math.isfinite(ev["ce_loss"]), f"{preset}: non-finite test loss")
        check(ev["accuracy"] > 0.5, f"{preset}: accuracy {ev['accuracy']} <= 0.5")
        check(state["hw"]["drift"].shape == (1, 50, 20), "hardware state missing")

    _time_steps(torch, _emu_mlp_session(api, "emu_onchip", seed), pipe, "emu_train",
                "emu_onchip")

    # tests/test_hardware.py::test_emu_dfa_trains_mnist_within_2pct_of_ref
    data = mnist.load((8192, 2048), seed=0)
    xtr, ytr = data["train"]
    xte2, yte2 = data["test"]
    acc = {}
    for backend in ("ref", "emu"):
        big = pipeline.ArrayClassification(xtr, ytr, batch_size=64, seed=0)
        session = _emu_mlp_session(api, "ideal", 0, backend=backend,
                                   arch=MLPClassifier(hidden=(128, 128), device=DEVICE))
        state, _ = session.fit(big.batch, total_steps=512, verbose=False)
        acc[backend] = 100 * session.evaluate(state, big.eval_batches(xte2, yte2, 256))["accuracy"]
    gap = abs(acc["emu"] - acc["ref"])
    print(f"[emu_train] 2-point protocol ({data['source']} digits 8192/2048, hidden (128, 128), "
          f"512 steps): ref {acc['ref']:.2f}%, emu {acc['emu']:.2f}% (drift on, recal 500), "
          f"gap {gap:.2f} points (limit 2)")
    check(gap < 2.0, f"emu vs ref gap {gap:.2f} points")
    return launches


def phase_drift(torch, api, seed):
    """benchmarks/drift_recovery.py's four variants at its defaults on the
    port; gate only on the mechanism (recalibration lowers the residual)."""
    import dataclasses

    from repro_torch.core import photonics as ph
    from repro_torch.data import mnist, pipeline
    from repro_torch.hardware.mrr import MRRConfig
    from repro_torch.models.mlp import MLPClassifier

    base = ph.preset("offchip_bpd")
    emu = dataclasses.replace(base, mrr=MRRConfig(**FAST_DRIFT))
    variants = [("ref", base, "ref", 0),
                ("emu_static", dataclasses.replace(base, mrr=MRRConfig.ideal()), "emu", 0),
                ("emu_drift", emu, "emu", 0), ("emu_drift_recal", emu, "emu", 8)]
    data = mnist.load((4096, 1024), seed=seed)
    xtr, ytr = data["train"]
    xte, yte = data["test"]
    rows = {}
    for name, hw, backend, recal in variants:
        pipe = pipeline.ArrayClassification(xtr, ytr, batch_size=64, seed=seed)
        session = _emu_mlp_session(api, hw, seed, backend=backend, recalibrate_every=recal,
                                   arch=MLPClassifier(hidden=(100,), device=DEVICE))
        state, metrics = session.fit(pipe.batch, total_steps=192, verbose=False)
        ev = session.evaluate(state, pipe.eval_batches(xte, yte, 256))
        host = session.trainer.to_host(metrics)
        rows[name] = (100 * ev["accuracy"], host.get("hw_residual_rms"))
        resid = rows[name][1]
        print(f"[drift] {name}: recal_every {recal}, test accuracy {rows[name][0]:.2f}%, "
              f"hw_residual_rms {'n/a' if resid is None else f'{resid:.4f}'}")
    check(rows["emu_drift_recal"][1] < rows["emu_drift"][1],
          f"recalibration did not lower the residual: {rows}")
    print(f"[drift] drift cost {rows['emu_static'][0] - rows['emu_drift'][0]:.2f} points, "
          f"recalibration recovers {rows['emu_drift_recal'][0] - rows['emu_drift'][0]:.2f}")


def _teacher_forced(torch, np, model, cfg, backend, seed, n_decode=4, chunk=16):
    """Logits of one prefill chunk and ``n_decode`` decode steps of 4 slots
    under ``backend``; the second run replays the first's tokens."""
    from repro_torch.core import photonics as ph

    vocab = model.cfg.vocab_size
    tokens = torch.tensor(_prompts(np.random.default_rng(seed), 4, chunk, vocab), device=DEVICE)
    caches = model.init_caches(4, 64)
    cache_len = torch.zeros(4, dtype=torch.long, device=DEVICE)
    full = torch.full((4,), chunk, dtype=torch.long, device=DEVICE)
    logits_seq, chosen = [], []
    with torch.no_grad(), ph.forward_execution(cfg, backend):
        logits, caches = model.prefill_step(tokens, caches, cache_len, full)
        cache_len = cache_len + chunk
        logits_seq.append(logits)
        tok = logits[:, -1].argmax(-1)
        for _ in range(n_decode):
            chosen.append(tok)
            logits, caches = model.decode_step(tok[:, None], caches, cache_len)
            cache_len = cache_len + 1
            logits_seq.append(logits)
            tok = logits[:, -1].argmax(-1)
    return logits_seq, chosen


def phase_emu_serve(torch, np, api, em, seed):
    """Path B: qwen1.5-0.5b at full width in bf16 served through emulated
    banks (emu_offchip, drift state of a freshly calibrated chip); the
    kernel against its plain version on the operands path B gave it (bf16
    inputs, f32 detunings; the first call of each shape); then a profiled
    decode tick; then noise off in f32, the kernel against the unfused
    chain."""
    from repro_torch.core import photonics as ph
    from repro_torch.serve import Request

    session = api.build_session(arch=ARCH, algo="bp", smoke=False, hardware="emu_offchip",
                                backend="emu", dtype=torch.bfloat16, seed=seed, device=DEVICE)
    model = session.model
    check(model.cfg.n_layers == 24 and model.cfg.d_model == 1024, "not the full model")
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(seed + 2)
    eng = session.engine(batch_slots=4, max_len=128, prefill_chunk=16, seed=seed)
    check(eng.hw_state is not None and eng._backend.name == "emu", "no drift state / backend")
    finite = torch.ones((), dtype=torch.bool, device=DEVICE)
    for name, idx in (("_prefill", 0), ("_decode", 1)):
        fn = getattr(eng, name)

        def wrapped(*args, fn=fn, idx=idx):
            nonlocal finite
            out = fn(*args)
            finite = finite & torch.isfinite(out[idx]).all()
            return out

        setattr(eng, name, wrapped)
    reqs = [Request(prompt=p, max_new=8) for p in _prompts(rng, 4, 32, vocab)]
    captured = {}
    kernel = em.emu_bank_product_cuda

    def capture(a_t, delta_eff, dead_mask, **kw):
        captured.setdefault((tuple(a_t.shape), tuple(delta_eff.shape)),
                            (a_t, delta_eff, dead_mask, kw))
        return kernel(a_t, delta_eff, dead_mask, **kw)

    em.emu_bank_product_cuda = capture
    try:
        sync(torch)
        em.launches = 0
        t0 = time.perf_counter()
        eng.run(reqs)
        sync(torch)
        wall = time.perf_counter() - t0
        launches = em.launches
    finally:
        em.emu_bank_product_cuda = kernel
    forwards = eng.stats["prefill_steps"] + eng.stats["decode_steps"]
    tokens = sum(len(r.out) for r in reqs)
    ttft = statistics.median(r.ttft_s for r in reqs)
    print(f"[emu_serve] {len(reqs)} requests, {tokens} tokens in {wall:.3f}s: "
          f"{tokens / wall:.2f} tok/s, ttft p50 {ttft * 1e3:.1f} ms; "
          f"emu_bank_product launches {launches} = 169 x {forwards} forwards: "
          f"{launches == 169 * forwards}")
    check(all(r.done and len(r.out) == 8 for r in reqs), "requests unfinished")
    check(launches == 169 * forwards, f"launches {launches} != 169 x {forwards}")
    check(bool(finite.item()), "non-finite logits")

    max_err, n_plans = 0.0, 0
    for (a_shape, d_shape), (a_t, delta, mask, kw) in captured.items():
        check(a_t.dtype == torch.bfloat16 and delta.dtype == torch.float32,
              f"path B handed the kernel {a_t.dtype} inputs and {delta.dtype} detunings")
        expect = em.emu_bank_product_plain(a_t, delta, mask, **kw)
        plans = _emu_candidates(em, a_t, delta, mask)
        for plan in plans:
            got = em.launch_kernel(a_t, delta, mask, plan=plan, **kw)
            max_err = max(max_err, _emu_exact(
                torch, em, got, expect, kw,
                f"path B's operands a_t {a_shape} δ {d_shape} {plan.name}"))
        n_plans += len(plans)
    print(f"[emu_serve] kernel vs plain on path B's own operands (bf16 a_t, f32 δ), "
          f"{len(captured)} shapes x {n_plans} plans in all (the planner's and the forced "
          f"grid): equal bit for bit (max |kernel - plain| {max_err:.3e}, 0 ADC flips)")
    captured.clear()

    del eng, session, model
    torch.cuda.empty_cache()
    phase_profile_ticks(torch, np, api, seed, tag="emu_serve", hardware="emu_offchip",
                        backend="emu", kernel="emu_bank_product")

    # noise off, f32: the fused kernel against the unfused chain
    model = api.build_model(ARCH, dtype=torch.float32, device=DEVICE, seed=seed)
    cfg = ph.PRESETS["emu_ideal"]
    ref_logits, ref_tokens = _teacher_forced(torch, np, model, cfg,
                                             ph.EmulatedMRRBackend(emu_kernel="ref"), seed)
    em.launches = 0
    cuda_logits, cuda_tokens = _teacher_forced(torch, np, model, cfg,
                                               ph.EmulatedMRRBackend(emu_kernel="cuda"), seed)
    worst = max((r - c).abs().max().item() / r.abs().max().item()
                for r, c in zip(ref_logits, cuda_logits))
    agree = sum(int((a == b).sum()) for a, b in zip(ref_tokens, cuda_tokens))
    print(f"[emu_serve] f32 emu_ideal, cuda kernel vs unfused chain over {len(ref_logits)} "
          f"forwards: max |Δlogit| / max|logit| = {worst:.3e} (limit 1e-4); greedy tokens "
          f"agree at {agree}/{4 * len(ref_tokens)}; launches {em.launches}")
    check(worst <= 1e-4, f"emu cuda vs ref logits differ by {worst:.3e} of max|logit|")
    check(em.launches == 169 * len(cuda_logits), "the parity run missed the kernel")
    del model
    torch.cuda.empty_cache()
    return launches, max_err


def emu_bound(case, sigma, shot, peaks, draw, sms):
    """Least time for one emu_bank_product call: the larger of its bytes
    (each input once, the f32 output once) over the memory rate, its f32
    multiply-adds over the f32 rate, and its threefry draws at ``draw``'s
    SM clocks each (``draw_cost`` of one draw's SASS) on ``sms`` SMs at
    the boost clock."""
    a_t, delta, mask, n_panels = case
    t, q, nj, c = a_t.shape
    nm, _, rows, _, _ = delta.shape
    nbytes = (a_t.numel() * a_t.element_size() + delta.numel() * delta.element_size()
              + (mask.numel() * 4 if mask is not None else 0) + t * nm * rows * 4)
    flops = 2 * t * nm * rows * q * nj * c
    draws = t * nm * rows * n_panels * ((sigma > 0) + (shot > 0))
    terms = {"bytes": nbytes / peaks["bw"], "f32": flops / peaks["float32"],
             "prng": draws * draw["clocks"] / (sms * SM_CLOCK)}
    binding = max(terms, key=terms.get)
    return terms[binding] * 1e3, ("bytes" if binding == "bytes" else "operations"), binding, terms


def phase_emu_timing(torch, em, ph, ch, mrr, card, draw):
    """The kernel and its plain version at path A's shape (64, 800, 10; f32,
    emu_onchip, a drift residual as path A carries) and at the reference's emu
    benchmark shape (64, 1024, 1024 on 4 buses; f32, emu_onchip); then the
    kernel alone at every bank product of path B (emu_offchip: bf16 inputs,
    f32 detunings, σ 0.098, 10-bit ADC) at decode (T = 4) and prefill
    (T = 64), with the plan it ran, and the sums over one forward's 169
    launches."""
    kind, peaks = card_peaks(card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=DEVICE).manual_seed(77)
    print(f"[emu_timing] {kind} peaks: {peaks['bw'] / 1e12:.2f} TB/s, "
          f"{peaks['float32'] / 1e12:.0f} TFLOP/s f32; threefry draws at {draw['clocks']:.4f} "
          f"SM clocks each (bound by {draw['by']}, SASS of one draw), {sms} SMs x "
          f"{SM_CLOCK / 1e9:.2f} GHz = {sms * SM_CLOCK / draw['clocks'] / 1e12:.3f} T draws/s; "
          f"card: {card}; no single PyTorch call computes this function (library: none)")
    print("[emu_timing] shape               kernel_ms kernel_dev   plain_ms  plain_dev   bound_ms"
          "  bound_by (bytes / f32 / prng ms)  plan")
    rows = {}
    for name, t, m, k, pkw, resid in (("path_a", 64, 800, 10, {}, True),
                                      ("benchmark", 64, 1024, 1024, {"n_buses": 4}, False)):
        case = _emu_case(torch, ph, ch, mrr, t, m, k, pkw, {}, resid, torch.float32, gen)
        a_t, delta, mask, n_panels = case
        kw = dict(n_panels=n_panels, gamma=1.0, sigma=0.202, shot=0.0, adc_bits=8, amax=20.0,
                  seed=EMU_SEED)
        fns = {"ms": lambda: em.emu_bank_product_cuda(a_t, delta, mask, **kw),
               "plain_ms": lambda: em.emu_bank_product_plain(a_t, delta, mask, **kw)}
        row = {"shape": [t, m, k], "n_buses": pkw.get("n_buses", 1),
               **_time_fns(torch, fns, {"ms": 25, "plain_ms": 5})}
        row["bound_ms"], row["bound_by"], binding, terms = emu_bound(case, 0.202, 0.0, peaks,
                                                                     draw, sms)
        row["library_ms"] = None
        row["plan"] = em.plan_for(a_t, delta, mask).name
        rows[name] = row
        cells = " ".join(_fmt(row[key]) for key in ("ms", "dev_ms", "plain_ms", "plain_dev_ms",
                                                     "bound_ms"))
        print(f"[emu_timing] {name:10s} {t:4d}x{m:5d}x{k:5d} {cells}  {binding} "
              f"({terms['bytes'] * 1e3:.5f} / {terms['f32'] * 1e3:.5f} / "
              f"{terms['prng'] * 1e3:.5f})  {row['plan']}")

    # path B: every bank product of one qwen1.5-0.5b forward through emu_offchip banks
    print("[emu_timing] path B (emu_offchip: bf16 a_t, f32 δ, σ 0.098, shot 0, 10-bit ADC); "
          "ms: CUDA events (median of 25, cold L2; the plain version's of 3, its device time "
          "not measured); dev: profiler (median of 25); share and GB/s from dev")
    print("[emu_timing]      T      M      K  count  kernel_ms kernel_dev   plain_ms   bound_ms  "
          "by     bytes_ms    prng_ms   share    GB/s  plan")
    cfg = ph.PRESETS["emu_offchip"]
    sigma, shot = ch._per_pass_sigma(cfg), cfg.mrr.shot_noise
    path_b = []
    for t in (4, 64):
        for (m, k), count in PATH_SHAPES.items():
            case = _emu_case(torch, ph, ch, mrr, t, m, k, {}, {"adc_bits": 10}, True,
                             torch.bfloat16, gen)
            a_t, delta, mask, n_panels = case
            kw = dict(n_panels=n_panels, gamma=1.0, sigma=sigma, shot=shot, adc_bits=10,
                      amax=float(cfg.bank_cols), seed=EMU_SEED)

            # the plain version on CUDA events only: its ~10^4 small launches a
            # call, profiled, overflow the profiler, which then drops the
            # first calls of every later window (seen on the card)
            row = {"t": t, "m": m, "k": k, "count": count, **_time_fns(torch, {
                "ms": lambda: em.emu_bank_product_cuda(a_t, delta, mask, **kw)}, {"ms": 25}),
                "plain_ms": _event_ms(torch, lambda: em.emu_bank_product_plain(
                    a_t, delta, mask, **kw), reps=3)}
            row["bound_ms"], row["bound_by"], _, terms = emu_bound(case, sigma, shot, peaks,
                                                                   draw, sms)
            row["bytes_ms"], row["prng_ms"] = terms["bytes"] * 1e3, terms["prng"] * 1e3
            row["share"] = row["bound_ms"] / row["dev_ms"]
            nbytes = terms["bytes"] * peaks["bw"]
            row["gb_s"] = nbytes / (row["dev_ms"] * 1e-3) / 1e9
            row["plan"] = em.plan_for(a_t, delta, mask).name
            path_b.append(row)
            print(f"[emu_timing] {t:6d} {m:6d} {k:6d} {count:6d} {_fmt(row['ms'])} "
                  f"{_fmt(row['dev_ms'])} {_fmt(row['plain_ms'])} "
                  f"{_fmt(row['bound_ms'])}  {row['bound_by'][:5]:5s} "
                  f"{_fmt(row['bytes_ms'])} {_fmt(row['prng_ms'])} {row['share']:7.1%} "
                  f"{row['gb_s']:7.1f}  {row['plan']}")
            del case, a_t, delta, mask
            torch.cuda.empty_cache()
    rows["path_b"] = path_b
    for t, label in ((4, "decode"), (64, "prefill")):
        step = [r for r in path_b if r["t"] == t]
        total = {key: sum(r[key] * r["count"] for r in step)
                 for key in ("ms", "dev_ms", "plain_ms", "bound_ms")}
        total["launches"] = sum(r["count"] for r in step)
        total["share"] = total["bound_ms"] / total["dev_ms"]
        rows[f"path_b_{label}_forward"] = total
        print(f"[emu_timing] path B {label} forward at T={t} ({total['launches']} launches): "
              f"kernel {total['ms']:.4f} ms events, {total['dev_ms']:.4f} ms device, plain "
              f"{total['plain_ms']:.4f} ms events, bound "
              f"{total['bound_ms']:.4f} ms, share {total['share']:.1%}")
    return rows


# ---------------------------------------------------------------------------
# DFA training of the language model: qwen1.5-0.5b at full width
# ---------------------------------------------------------------------------

LM_BATCH, LM_SEQ = 64, 64  # 4096 rows through every DFA projection
LM_STEPS, LM_EMU_STEPS = 16, 4
LM_LAUNCHES = 25  # bank products per dfa step: 24 blocks + the embedding


def _lm_session(api, torch, seed, **kw):
    """qwen1.5-0.5b at full width in f32 (24 layers, d 1024, d_ff 2816,
    vocab 151936, random weights from ``seed``) on the card."""
    kw = {"algo": "dfa", "hardware": "offchip_bpd", "backend": "cuda", "log_every": 10**9,
          **kw}
    return api.build_session(arch=ARCH, smoke=False, dtype=torch.float32, seed=seed,
                             device=DEVICE, **kw)


def _wrap(module, name, store, limit=None):
    """Record (args, kwargs, result) of the first ``limit`` calls of
    ``module.name`` in ``store``; returns the function that restores it."""
    fn = getattr(module, name)

    def recording(*args, **kw):
        out = fn(*args, **kw)
        if limit is None or len(store) < limit:
            store.append((args, kw, out))
        return out

    setattr(module, name, recording)
    return lambda: setattr(module, name, fn)


def _lm_step_flops(cfg, rows):
    """Matrix-product FLOPs of one dfa step (attention scores and the
    elementwise work left out): the digital forward, each block's
    recompute and its backward (weights and inputs), the head forward and
    its two backward products, and the 25 projections."""
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    layer = (2 * cfg.d_model * cfg.n_heads * hd + 2 * cfg.d_model * cfg.n_kv_heads * hd
             + 3 * cfg.d_model * cfg.d_ff)
    blocks = 2 * rows * layer * cfg.n_layers
    head = 2 * rows * cfg.d_model * cfg.v_padded
    return 4 * blocks + 3 * head + LM_LAUNCHES * 2 * rows * cfg.d_model * cfg.d_model


def _max_rel(got, expect):
    return (got - expect).abs().max().item() / max(expect.abs().max().item(), 1e-30)


def phase_lm_train(torch, np, api, pm, em, seed, card, draws):
    """DFA training of qwen1.5-0.5b at full width: 16 fit steps on
    offchip_bpd (finite loss at every step, a fixed batch's loss falls, 25
    bank-kernel launches a step, peak memory); block 0's and the
    embedding's δ against the plain version on the step's own operands
    (and in prng mode against the plain twin); ideal cuda vs ref
    gradients; one bp, dfa-fused and dfa-layerwise step; step time and a
    profile; the bank kernel at (4096, 1024, 1024) beside its plain
    version, torch.matmul and its bound; 4 steps on emu_offchip with the
    emu kernel held bit for bit on a step's own operands and timed; crash
    and resume of the smoke LM on the card."""
    import dataclasses
    import shutil

    from repro_torch import algos
    from repro_torch.core import photonics as ph
    from repro_torch.data import tokens
    from repro_torch.kernels import ops as kops
    from repro_torch.utils import prng

    kind, peaks = card_peaks(card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log = pm._BUILD_DIR / f"lm_train-{os.getpid()}.csv"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    session = _lm_session(api, torch, seed, log_every=1, log_path=str(log))
    model, cfg = session.model, session.model.cfg
    check((cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (24, 1024, 2816, 151936)
          and model.head["out"].weight.dtype == torch.float32, "not the full f32 model")
    n_params = sum(p.numel() for p in model.parameters())
    gen = tokens.MarkovTokens(cfg.vocab_size, LM_SEQ, LM_BATCH, seed)
    fixed = to_device_batch(gen.batch(10**6))
    with torch.no_grad():
        ce0 = model.loss(session.init_state()["params"], fixed)[1]["ce_loss"].item()

    # 16 fit steps
    sync(torch)
    pm.launches = 0
    t0 = time.perf_counter()
    state, _ = session.fit(gen.batch, total_steps=LM_STEPS, verbose=False)
    sync(torch)
    wall = time.perf_counter() - t0
    launches = pm.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    lines = log.read_text().splitlines()
    log.unlink()
    col = lines[0].split(",").index("loss")
    losses = [float(line.split(",")[col]) for line in lines[1:]]
    with torch.no_grad():
        ce1 = model.loss(state["params"], fixed)[1]["ce_loss"].item()
    print(f"[lm_train] qwen1.5-0.5b full width f32 ({n_params / 1e6:.1f} M parameters), "
          f"offchip_bpd, cuda backend, batch {LM_BATCH} x seq {LM_SEQ}: {LM_STEPS} fit steps in "
          f"{wall:.2f}s; loss per step {', '.join(f'{x:.4f}' for x in losses)}; fixed batch "
          f"ce_loss {ce0:.4f} -> {ce1:.4f}; photonic_matmul launches {launches} = "
          f"{launches / LM_STEPS:g} per step; peak device memory {peak_gib:.2f} GiB")
    check(len(losses) == LM_STEPS and all(math.isfinite(x) for x in losses),
          f"non-finite or missing step losses: {losses}")
    check(ce1 < ce0, f"the fixed batch's loss did not fall: {ce0} -> {ce1}")
    check(launches == LM_LAUNCHES * LM_STEPS,
          f"{launches} bank-kernel launches, expected {LM_LAUNCHES} per step")

    # one step's own operands: block 0 and the embedding against the plain version
    rng = prng.step_key(seed, state["step"], "noise")
    batch = to_device_batch(gen.batch(state["step"]))
    params, fb, dcfg = state["params"], state["fb"], session.config.dfa
    calls = []
    restore = _wrap(kops, "photonic_matmul_cuda", calls)
    try:
        (loss, _), grads = session.value_and_grad()(params, fb, batch, rng)
    finally:
        restore()
    check(len(calls) == LM_LAUNCHES, f"{len(calls)} projections in one step")
    errs = {}
    for label, idx in (("block 0", 0), ("embedding", LM_LAUNCHES - 1)):
        (a, b), kw, out = calls[idx]
        check(tuple(a.shape) == (LM_BATCH * LM_SEQ, cfg.d_model) and "noise" in kw,
              f"{label}: operands {tuple(a.shape)}, {sorted(kw)}")
        expect = pm.photonic_matmul_plain(a, b, **kw)
        errs[label] = err = (out - expect).abs().max().item()
        scale = expect.abs().max().item()
        check(err <= TOL["float32"] * scale + 1e-6,
              f"{label}: δ kernel vs plain {err} of max {scale}")
    (a, b), kw, _ = calls[0]
    nk = math.ceil(a.shape[1] / pm.BLOCK_K)
    step_sigma = ph.noise_sigma_total(a.shape[1], 1.0, 1.0, dcfg.photonics) / math.sqrt(nk)
    key0 = prng.fold(prng.fold(rng, "blocks"), 0)
    got = pm.photonic_matmul_cuda(a, b, seed=key0, sigma_step=step_sigma)
    twin = pm.photonic_matmul_plain(a, b, seed=key0, sigma_step=step_sigma)
    prng_err = (got - twin).abs().max().item()
    check(prng_err <= TOL["float32"] * twin.abs().max().item() + 1e-6,
          f"prng mode kernel vs plain twin at the LM shape: {prng_err}")
    print(f"[lm_train] one step's own operands (T={a.shape[0]}, K={a.shape[1]}, M={b.shape[0]}, "
          f"f32, the path's input-mode noise from the step's keys): max |kernel - plain| "
          f"block 0 {errs['block 0']:.3e}, embedding {errs['embedding']:.3e} (tol "
          f"{TOL['float32']} of max|δ|); prng mode vs plain twin {prng_err:.3e}")

    # ideal: the cuda backend against the ref backend, every gradient
    vg = {b_: algos.get("dfa").value_and_grad(model, dataclasses.replace(
        dcfg, photonics=ph.PRESETS["ideal"], backend=b_)) for b_ in ("cuda", "ref")}
    (_, _), g_cuda = vg["cuda"](params, fb, batch, rng)
    (_, _), g_ref = vg["ref"](params, fb, batch, rng)
    worst = max((_max_rel(g_cuda[k], g_ref[k]), k) for k in g_ref)
    del g_cuda, g_ref
    print(f"[lm_train] ideal, cuda vs ref backend: every gradient within {worst[0]:.3e} of its "
          f"max |value| (worst {worst[1]}; limit 1e-4, the f32 bank tolerance through a block's "
          f"backward)")
    check(worst[0] <= 1e-4, f"ideal cuda vs ref gradients differ: {worst}")

    # one bp, dfa-fused and dfa-layerwise step at full width
    fused = algos.get("dfa-fused").fused_step(model, dcfg, session.config.optimizer)
    p_f, opt_f, loss_f = fused(params, fb, state["opt"], batch, rng)
    p_u, opt_u, _ = session.config.optimizer.update(grads, state["opt"], params)
    worst_p = max(_max_rel(p_f[k], p_u[k]) for k in p_u)
    worst_m = max((opt_f["mom"][k] - opt_u["mom"][k]).abs().max().item() for k in p_u)
    del p_f, opt_f, p_u, opt_u, grads, fused, vg
    others = {}
    for algo in ("bp", "dfa-layerwise"):
        sync(torch)
        t0 = time.perf_counter()
        (l_a, _), g_a = algos.get(algo).value_and_grad(model, dcfg)(params, fb, batch, rng)
        sync(torch)
        finite = all(bool(torch.isfinite(g).all()) for g in g_a.values())
        others[algo] = (float(l_a), time.perf_counter() - t0, finite)
        del g_a
    print(f"[lm_train] dfa-fused vs dfa + SGDM.update: max |Δparam| / max|param| = "
          f"{worst_p:.3e}, max |Δmomentum| = {worst_m:.3e}, loss {float(loss_f):.6f} vs "
          f"{float(loss):.6f}; " + "; ".join(
              f"{algo}: loss {l_a:.4f}, gradients in {dt:.2f}s, finite {fin}"
              for algo, (l_a, dt, fin) in others.items()))
    check(worst_p <= 1e-6 and worst_m <= 1e-6 and float(loss_f) == float(loss),
          "dfa-fused differs from dfa followed by SGDM.update")
    check(all(math.isfinite(l_a) and fin for l_a, _, fin in others.values()),
          f"bp / dfa-layerwise step not finite: {others}")
    torch.cuda.empty_cache()

    # step time (CUDA events) and three steps under the profiler
    batches = [to_device_batch(gen.batch(i)) for i in range(LM_STEPS, LM_STEPS + 8)]
    times = []
    for b_ in batches:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, _ = session.step(state, b_)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    step_ms = statistics.median(times[2:])
    wall_p, by_name = _profile_steps(torch, session, state, batches[:3])
    flops = _lm_step_flops(cfg, LM_BATCH * LM_SEQ)
    print(f"[lm_train] dfa step: {step_ms:.2f} ms median of {len(times) - 2} steps (CUDA events, "
          f"synchronised steps; all: {', '.join(f'{x:.1f}' for x in times)}); matrix products "
          f"{flops / 1e12:.2f} TFLOP a step, {flops / (step_ms * 1e-3) / 1e12:.1f} TFLOP/s; f32 "
          f"bound {flops / peaks['float32'] * 1e3:.1f} ms at {peaks['float32'] / 1e12:.0f} "
          f"TFLOP/s; card: {card}")
    prof = {"step_ms": step_ms, "step_ms_all": times, "tflop_per_step": flops / 1e12}
    if by_name:
        busy = sum(by_name.values()) / 3
        bank = by_name.get("photonic_matmul", 0.0) / 3
        prof.update(wall_ms=wall_p / 3, busy_ms=busy, idle_share=1 - busy * 3 / wall_p,
                    bank_ms=bank)
        print(f"[lm_train] profile of 3 steps: wall {wall_p / 3:.2f} ms/step, device busy "
              f"{busy:.2f} ms/step, idle share {1 - busy * 3 / wall_p:.3f}; the bank kernel "
              f"{bank:.3f} ms/step ({bank / busy:.1%} of busy)")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"[lm_train]   {ms / 3:9.3f} ms/step  {ms / wall_p:6.1%} of wall  {name}")
    else:
        print("[lm_train] device busy time not measured (the profiler traced no device kernels)")

    # the bank kernel at the LM shape: the path's input mode and prng mode
    (a, b), kw, _ = calls[0]
    t, k, m = a.shape[0], a.shape[1], b.shape[0]
    noise = kw["noise"]
    print(f"[lm_timing] bank kernel at (T, K, M) = ({t}, {k}, {m}) f32, {kind} peaks: "
          f"{peaks['bw'] / 1e12:.2f} TB/s, {peaks['float32'] / 1e12:.0f} TFLOP/s f32, prng draws "
          f"at {draws['bank']['clocks']:.4f} SM clocks each on {sms} SMs; card: {card}")
    print(f"[lm_timing]       mode {TIMING_HEAD}")
    bank_rows = {}
    for mode, kw_ in (("input", {"noise": noise}),
                      ("prng", {"seed": key0, "sigma_step": step_sigma})):
        fns = {"ms": lambda kw_=kw_: pm.photonic_matmul_cuda(a, b, **kw_),
               "plain_ms": lambda kw_=kw_: pm.photonic_matmul_plain(a, b, **kw_),
               "library_ms": lambda: torch.matmul(a, b.T)}
        bound = bound_ms(t, m, k, "float32", peaks, noise=mode, draw=draws["bank"], sms=sms)
        row = _time_row(torch, fns, bound, reps={"ms": 25, "library_ms": 25,
                                                 "plain_ms": 25 if mode == "input" else 3})
        row.update(variant=pm._plan(t, m, k, a.dtype, (a.data_ptr(), b.data_ptr())).name,
                   launches_per_step=LM_LAUNCHES if mode == "input" else 0)
        bank_rows[mode] = row
        _print_row("lm_timing", f"{mode:>10s}", row)
    per_step = bank_rows["input"]["dev_ms"] * LM_LAUNCHES
    print(f"[lm_timing] the path's 25 launches a step: {per_step:.3f} ms device "
          f"({per_step / step_ms:.1%} of the step's {step_ms:.1f} ms)")
    del calls, session, model, state, params, fb, batch, batches, a, b, noise, kw
    torch.cuda.empty_cache()

    # emu_offchip: 4 steps through the emulated banks
    emu = _lm_session(api, torch, seed, hardware="emu_offchip", backend="emu")
    ecalls = []
    restore = _wrap(em, "emu_bank_product_cuda", ecalls, limit=1)
    try:
        sync(torch)
        em.launches = 0
        t0 = time.perf_counter()
        e_state, e_metrics = emu.fit(gen.batch, total_steps=LM_EMU_STEPS, verbose=False)
        sync(torch)
        e_wall = time.perf_counter() - t0
        e_launches = em.launches
    finally:
        restore()
    e_host = emu.trainer.to_host(e_metrics)
    print(f"[lm_emu] emu_offchip (drift on, recalibration every "
          f"{emu.config.recalibrate_every}): {LM_EMU_STEPS} dfa steps in {e_wall:.2f}s, loss "
          f"{e_host['loss']:.4f}, hw_residual_rms {e_host.get('hw_residual_rms', float('nan')):.5f}; "
          f"emu_bank_product launches {e_launches} = {e_launches / LM_EMU_STEPS:g} per step")
    check(e_launches == LM_LAUNCHES * LM_EMU_STEPS,
          f"{e_launches} emu launches, expected {LM_LAUNCHES} per step")
    check(math.isfinite(e_host["loss"]), "emu: non-finite loss")
    (a_t, delta, mask), ekw, e_out = ecalls[0]
    ecalls.clear()
    plan = em.plan_for(a_t, delta, mask)
    t0 = time.perf_counter()
    e_expect = em.emu_bank_product_plain(a_t, delta, mask, **ekw)
    sync(torch)
    e_plain_s = time.perf_counter() - t0
    worst = _emu_exact(torch, em, e_out, e_expect, ekw,
                       f"the LM step's block 0 a_t {tuple(a_t.shape)} {plan.name}")
    print(f"[lm_emu] block 0 of the first step: a_t {tuple(a_t.shape)} {a_t.dtype}, δ "
          f"{tuple(delta.shape)}, {ekw['n_panels']} slots, σ {ekw['sigma']:.4f}, shot "
          f"{ekw['shot']}, ADC {ekw['adc_bits']} bits; plan {plan.name}; kernel equals the plain "
          f"version bit for bit (max |Δ| {worst:.1e}; plain version {e_plain_s:.2f}s)")
    e_row = _time_fns(torch, {"ms": lambda: em.emu_bank_product_cuda(a_t, delta, mask, **ekw)},
                      {"ms": 25})
    # the plain version on CUDA events only, as path B's (phase_emu_timing)
    e_row["plain_ms"] = _event_ms(
        torch, lambda: em.emu_bank_product_plain(a_t, delta, mask, **ekw), reps=3)
    case = (a_t, delta, mask, ekw["n_panels"])
    e_row["bound_ms"], e_row["bound_by"], binding, terms = emu_bound(
        case, ekw["sigma"], ekw["shot"], peaks, draws["emu"], sms)
    e_row.update(library_ms=None, plan=plan.name, launches_per_step=LM_LAUNCHES,
                 bound_share=e_row["bound_ms"] / e_row["dev_ms"],
                 terms_ms={name: v * 1e3 for name, v in terms.items()})
    print(f"[lm_timing] emu_bank_product at (T, K, M) = ({a_t.shape[0]}, {cfg.d_model}, "
          f"{cfg.d_model}): kernel {e_row['ms']:.4f} / {e_row['dev_ms']:.4f} ms (events / "
          f"device), plain {e_row['plain_ms']:.4f} (events), bound "
          f"{e_row['bound_ms']:.4f} ({binding}: bytes {terms['bytes'] * 1e3:.5f} / f32 "
          f"{terms['f32'] * 1e3:.5f} / prng {terms['prng'] * 1e3:.5f}), share "
          f"{e_row['bound_share']:.1%}, plan {plan.name}; 25 a step: "
          f"{e_row['dev_ms'] * LM_LAUNCHES:.3f} ms device; card: {card}")
    del emu, e_state, a_t, delta, mask, e_out, e_expect, case
    torch.cuda.empty_cache()

    # crash and resume on the card: the smoke LM on offchip_bpd
    base = pm._BUILD_DIR / f"lm_ckpt-{os.getpid()}"
    small = tokens.MarkovTokens(128, 16, 4, seed)

    def trainer(name, every):
        return api.build_session(arch=ARCH, smoke=True, hardware="offchip_bpd", backend="cuda",
                                 seed=seed, ckpt_dir=str(base / name), ckpt_every=every,
                                 log_every=10**9, device=DEVICE).trainer

    try:
        straight, _ = trainer("a", 100).fit(small.batch, total_steps=6, verbose=False)
        trainer("b", 3).fit(small.batch, total_steps=3, verbose=False)
        resumed_tr = trainer("b", 3)
        start = resumed_tr.restore_or_init()[1]
        resumed, _ = resumed_tr.fit(small.batch, total_steps=6, verbose=False)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    same = (start == 3 and resumed["step"] == straight["step"] == 6
            and all(torch.equal(straight["params"][k], resumed["params"][k])
                    for k in straight["params"])
            and all(torch.equal(straight["opt"]["mom"][k], resumed["opt"]["mom"][k])
                    for k in straight["params"]))
    print(f"[lm_ckpt] smoke LM on the card, offchip_bpd: 3 steps, a new Trainer resumed from "
          f"step {start} to 6; params and momentum bit-identical to 6 straight steps: {same}")
    check(same, "crash and resume differ from the straight run")
    return {"launches": launches, "emu_launches": e_launches, "max_abs_err": max(errs.values()),
            "max_abs_err_prng": prng_err, "emu_max_abs_err": worst, "bank": bank_rows,
            "emu": e_row, "profile": prof, "peak_gib": peak_gib}


# ---------------------------------------------------------------------------
# The observability plane: probe, noise budget, observer, trace, telemetry
# ---------------------------------------------------------------------------

OBS_STEPS, OBS_PROBE_EVERY = 8, 4
# the reference's probe rows on the LM (tests/test_torch_introspect.py holds
# the port's key set to repro's on the CPU)
LM_PROBE_KEYS = {f"{kind}_{name}" for kind in ("align", "gnorm_dfa", "gnorm_bp", "upd_ratio")
                 for name in ("blocks", "embed", "head")} | {"align_global"}


def _event_timer(torch, bench):
    """A ``bench.StepTimer`` that also records a CUDA event at every step
    boundary, so one fit gives synchronised wall times and the stream's own
    step times."""

    class EventTimer(bench.StepTimer):
        def start(self):
            self.events = [torch.cuda.Event(enable_timing=True)]
            self.events[0].record()
            super().start()

        def tick(self, sync=None):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            super().tick(sync)

        def event_ms(self):
            return [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]

    return EventTimer(warmup=1)


def _count_probe_launches(introspect, counters):
    """Record the kernels' launches of every ``AlignmentProbe.probe`` call
    (``counters``: name -> module with a ``launches`` count) in the returned
    list; returns (list, restore)."""
    per_call = []
    fn = introspect.AlignmentProbe.probe

    def counted(self, state, batch):
        before = {k: m.launches for k, m in counters.items()}
        out = fn(self, state, batch)
        per_call.append({k: m.launches - before[k] for k, m in counters.items()})
        return out

    introspect.AlignmentProbe.probe = counted
    introspect.AlignmentProbe.__call__ = counted

    def restore():
        introspect.AlignmentProbe.probe = fn
        introspect.AlignmentProbe.__call__ = fn

    return per_call, restore


def _steady(ms, probe_steps=()):
    """Median of the event step times after the first, probe steps out."""
    return statistics.median(x for i, x in enumerate(ms) if i > 0 and i not in probe_steps)


def phase_observe(torch, np, api, pm, em, seed, card):
    """The observability plane on the card.  (a) qwen1.5-0.5b at full width
    in f32, offchip_bpd, 8 dfa fit steps three times: with the null
    observer, with an ``Observer`` (JSONL + trace), and with the probe
    every 4 steps: the probe's rows at steps 0 and 4 with the reference's
    keys, finite, |cos| <= 1, 25 bank-kernel launches a probe, the final
    state bit-identical to the unprobed run, the trace's step / probe /
    drain spans, ``summarize``'s alignment table; the probe's own ms and
    peak memory; ``StepTimer`` + ``report_throughput`` with ``step_cost``.
    (b) the paper's MLP on emu_onchip (drift on), the same three fits: the
    ``nb_*`` rows, closure and thermal-vs-analytic, 2 emu launches a
    probe, the ``hw_*`` gauges through ``HardwareMonitor``.  (c) full-width
    serving with an observer: a track per request, a span per tick, the
    tokens of the unobserved run.  (d) ``debug_checks``: a clean LM step
    passes, a NaN in one parameter raises."""
    import contextlib
    import dataclasses
    import tempfile

    from repro_torch import bench, obs
    from repro_torch.data import tokens
    from repro_torch.lint import runtime
    from repro_torch.obs import introspect, summarize
    from repro_torch.serve import Request
    from repro_torch.train import SGDM, Trainer

    counters = {"photonic_matmul": pm, "emu_bank_product": em}
    out = {"probe_launches": {}}
    tmp = tempfile.TemporaryDirectory(prefix="observe-", dir=pm._BUILD_DIR)
    root = pathlib.Path(tmp.name)
    try:
        # (a) the LM at full width
        gen = tokens.MarkovTokens(151936, LM_SEQ, LM_BATCH, seed)
        finals, timers, observers, fit_gib = {}, {}, {}, {}
        per_probe = []
        for mode in ("null", "observer", "probe"):
            torch.cuda.empty_cache()
            session = _lm_session(api, torch, seed, log_every=OBS_PROBE_EVERY,
                                  probe_every=OBS_PROBE_EVERY if mode == "probe" else None)
            observer = None
            if mode != "null":
                observer = session.observe(metrics_path=str(root / f"lm-{mode}.jsonl"),
                                           trace_path=str(root / f"lm-{mode}.json"))
            timer = _event_timer(torch, bench)
            calls, restore = _count_probe_launches(introspect, counters)
            try:
                sync(torch)
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
                pm.launches = 0
                state, _ = session.fit(gen.batch, total_steps=OBS_STEPS, verbose=False,
                                       timer=timer, observer=observer)
                sync(torch)
                launches = pm.launches
            finally:
                restore()
            # the fit's peak above what was resident when it started (the
            # earlier runs' final parameters stay for the bit-for-bit check)
            fit_gib[mode] = (torch.cuda.max_memory_allocated() - resident) / 2**30
            if mode == "probe":
                per_probe = calls
            finals[mode] = {k: v for k, v in state["params"].items()}
            timers[mode], observers[mode] = timer, observer
            check(launches == LM_LAUNCHES * (OBS_STEPS + len(calls)),
                  f"LM {mode}: {launches} bank launches over {OBS_STEPS} steps and "
                  f"{len(calls)} probes")
            if mode == "probe":
                probe_session, probe_state = session, state
            else:
                del state, session
        same = {mode: all(torch.equal(finals["null"][k], finals[mode][k])
                          for k in finals["null"])
                for mode in ("observer", "probe")}
        del finals
        ob = observers["probe"]
        trace_path = ob.close()
        observers["observer"].close()
        rows = summarize.read_rows(str(root / "lm-probe.jsonl"))
        probe_rows = [r for r in rows if "align_global" in r["metrics"]]
        values = [v for r in probe_rows for v in r["metrics"].values()]
        cosines = [v for r in probe_rows for k, v in r["metrics"].items() if k.startswith("align_")]
        doc = json.loads(pathlib.Path(trace_path).read_text())
        spans = {}
        for e in doc["traceEvents"]:
            if e["ph"] == "X":
                spans[e["name"]] = spans.get(e["name"], 0) + 1
        lines = []
        summarize.render_alignment(summarize.alignment_table(rows), out=lines.append)
        ms = {mode: timers[mode].event_ms() for mode in timers}
        probe_steps = {i for i in range(OBS_STEPS) if i % OBS_PROBE_EVERY == 0}
        lm_ms = {"null": _steady(ms["null"]), "observer": _steady(ms["observer"]),
                 "probe_steps": _steady(ms["probe"], probe_steps),
                 "probe_mean": statistics.mean(ms["probe"][1:])}
        with_probe = [ms["probe"][i] for i in sorted(probe_steps) if i > 0]
        print(f"[observe] qwen1.5-0.5b full width f32, offchip_bpd, cuda backend, batch "
              f"{LM_BATCH} x seq {LM_SEQ}, {OBS_STEPS} dfa steps, probe every "
              f"{OBS_PROBE_EVERY}: probe rows at steps {[r['step'] for r in probe_rows]}, "
              f"{len(probe_rows[0]['metrics']) if probe_rows else 0} keys; bank launches per "
              f"probe {[c['photonic_matmul'] for c in per_probe]}; final params bit-identical "
              f"to the unprobed run: observer {same['observer']}, probe {same['probe']}; trace "
              f"spans {dict(sorted(spans.items()))}")
        for r in probe_rows:
            m = r["metrics"]
            print(f"[observe]   step {r['step']}: " + ", ".join(
                f"{k} {m[k]:.6g}" for k in sorted(m)))
        for line in lines:
            print(f"[observe] {line}")
        print(f"[observe] LM step ms on CUDA events (median of steps 1-7; card {card}): null "
              f"observer {lm_ms['null']:.2f}, Observer {lm_ms['observer']:.2f}, with the probe "
              f"{lm_ms['probe_steps']:.2f} on unprobed steps, {statistics.mean(with_probe):.2f} "
              f"on the probed step 4, mean {lm_ms['probe_mean']:.2f}; all (null) "
              f"{', '.join(f'{x:.1f}' for x in ms['null'])}")
        check([r["step"] for r in probe_rows] == [0, 4], f"probe rows at "
              f"{[r['step'] for r in probe_rows]}")
        check(all(set(r["metrics"]) == LM_PROBE_KEYS for r in probe_rows),
              f"probe keys {sorted(probe_rows[0]['metrics'])}")
        check(all(math.isfinite(v) for v in values), "non-finite probe values")
        check(all(abs(v) <= 1 + 1e-6 for v in cosines), f"|cos| > 1: {cosines}")
        check([c["photonic_matmul"] for c in per_probe] == [LM_LAUNCHES] * 2,
              f"bank launches per probe {per_probe}")
        check(same["probe"] and same["observer"], "probe-on or observed state differs")
        check(all(spans.get(name, 0) > 0 for name in ("step", "probe", "drain")),
              f"trace spans {spans}")
        check(any("align_global" in line for line in lines), "no alignment table")
        out["probe_launches"]["photonic_matmul"] = sum(c["photonic_matmul"] for c in per_probe)

        # the probe's own time and peak memory, beside one plain step's
        batch = to_device_batch(gen.batch(OBS_STEPS))
        probe = introspect.AlignmentProbe(probe_session.trainer)
        peaks, times = {}, {}
        for what, fn in (("step", lambda: probe_session.trainer.step(probe_state, batch)),
                         ("probe", lambda: probe(probe_state, batch))):
            for _ in range(2):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                result = fn()
                e1.record()
                e1.synchronize()
                del result
                times[what] = e0.elapsed_time(e1)
                peaks[what] = torch.cuda.max_memory_allocated() / 2**30
        print(f"[observe] the probe alone: {times['probe']:.2f} ms (CUDA events, second call), "
              f"peak device memory {peaks['probe']:.2f} GiB; one plain step {times['step']:.2f} "
              f"ms, peak {peaks['step']:.2f} GiB (the same state resident); each fit's peak above "
              f"the memory resident at its start: " + ", ".join(
                  f"{mode} {gib:.2f} GiB" for mode, gib in fit_gib.items()))
        out["lm"] = {**lm_ms, "probe_ms": times["probe"], "step_ms": times["step"],
                     "fit_peak_gib": fit_gib,
                     "probe_peak_gib": peaks["probe"], "step_peak_gib": peaks["step"]}

        # StepTimer + report_throughput with step_cost
        t_null = timers["null"]
        path, summary = bench.report_throughput(probe_session, probe_state, gen.batch(0), t_null,
                                                meta={"arch": ARCH, "algo": "dfa",
                                                      "preset": "offchip_bpd"},
                                                out_dir=str(root))
        cost = probe_session.step_cost(probe_state, gen.batch(0))
        flops = _lm_step_flops(probe_session.model.cfg, LM_BATCH * LM_SEQ)
        report = bench.load_bench(path)
        print(f"[observe] StepTimer (synchronised wall, warmup 1): {summary['steps_measured']} "
              f"steps, {summary['mean_step_s'] * 1e3:.2f} ms mean, {summary['steps_per_s']:.3f} "
              f"steps/s, {summary['examples_per_s']:.1f} examples/s, macs_per_s "
              f"{summary['macs_per_s']:.4e}; env {report['env']}")
        print(f"[observe] step_cost: {cost.flops / 1e12:.4f} TFLOP ({cost.counted_flops / 1e12:.4f} "
              f"seen by FlopCounterMode, {cost.kernel_flops / 1e12:.4f} in {cost.kernel_launches} "
              f"bank-kernel launches) against _lm_step_flops {flops / 1e12:.4f}: ratio "
              f"{cost.flops / flops:.5f} (the difference: attention's score and value products)")
        check(cost.kernel_launches == LM_LAUNCHES, f"step_cost saw {cost.kernel_launches} launches")
        check(flops <= cost.flops <= 1.02 * flops, f"step_cost {cost.flops} vs {flops}")
        check(summary["macs_per_s"] > 0 and report["env"]["device"] == torch.cuda.get_device_name(0),
              "bench report")
        out["step_cost"] = {"flops": cost.flops, "lm_step_flops": flops,
                            "macs_per_s": summary["macs_per_s"]}

        # (d) debug_checks on the same model: a clean step passes, a NaN raises
        dbg = Trainer(probe_session.model,
                      dataclasses.replace(probe_session.config, debug_checks=True), device=DEVICE)
        t0 = time.perf_counter()
        _, m = dbg.step(probe_state, batch)
        sync(torch)
        clean_s = time.perf_counter() - t0
        name = "blocks.0.attn.q.weight"
        bad = dict(probe_state, params={**probe_state["params"]})
        bad["params"][name] = bad["params"][name].clone()
        bad["params"][name].view(-1)[0] = float("nan")
        raised = None
        try:
            dbg.step(bad, batch)
        except runtime.NonFiniteError as err:
            raised = str(err)
        print(f"[observe] debug_checks: a clean full-width step passes in {clean_s:.2f}s (loss "
              f"{float(m['loss']):.4f}); with a NaN in {name}: raised {raised!r}")
        check(raised is not None, "debug_checks let a NaN through")
        del dbg, bad, probe, probe_session, probe_state, batch, m, timers, observers, ob
        torch.cuda.empty_cache()

        # (b) the paper's MLP on emu_onchip, drift on
        pipe, _ = _digits()
        emu_ms, emu_per_probe = {"null": [], "observer": [], "probe": [], "probed_step": []}, []
        # two rounds in opposite orders: a session's own spread shows beside the gaps
        for rnd, mode in enumerate(("null", "observer", "probe", "probe", "observer", "null")):
            session = api.build_session(
                arch="mnist_mlp", algo="dfa", hardware="emu_onchip", backend="emu",
                optimizer=SGDM(lr=0.01, momentum=0.9), seed=seed, log_every=OBS_PROBE_EVERY,
                probe_every=OBS_PROBE_EVERY if mode == "probe" else None, device=DEVICE)
            check(session.model.hidden == (800, 800) and session.config.recalibrate_every == 500,
                  "not the paper's MLP on a drifting, recalibrated bank")
            observer = session.observe(metrics_path=str(root / f"mlp-{mode}-{rnd}.jsonl")) \
                if mode != "null" else None
            timer = _event_timer(torch, bench)
            calls, restore = _count_probe_launches(introspect, counters)
            try:
                sync(torch)
                em.launches = 0
                session.fit(pipe.batch, total_steps=OBS_STEPS * 3, verbose=False, timer=timer,
                            observer=observer)
                sync(torch)
                launches = em.launches
            finally:
                restore()
            check(launches == 2 * (OBS_STEPS * 3 + len(calls)),
                  f"MLP {mode}: {launches} emu launches")
            probed = {i for i in range(OBS_STEPS * 3) if i % OBS_PROBE_EVERY == 0}
            emu_ms[mode].append(_steady(timer.event_ms(), probed if mode == "probe" else ()))
            if mode == "probe":
                emu_per_probe += calls
                emu_ms["probed_step"].append(statistics.mean(
                    timer.event_ms()[i] for i in sorted(probed) if i > 0))
                hwmon = observer.hwmon
                mlp_rows = summarize.read_rows(str(root / f"mlp-probe-{rnd}.jsonl"))
            if observer is not None:
                observer.close()
        nb_rows = [r for r in mlp_rows if "nb_total_var" in r["metrics"]]
        hw_rows = [r for r in mlp_rows if "hw_residual_rms" in r["metrics"]]
        last = nb_rows[-1]["metrics"] if nb_rows else {}
        budget = summarize.noise_budget_table(mlp_rows)
        print(f"[observe] mnist_mlp 784x800x800x10, emu_onchip (drift on, recalibration every "
              f"500), {OBS_STEPS * 3} dfa steps, probe every {OBS_PROBE_EVERY}: nb rows at "
              f"{[r['step'] for r in nb_rows]}, closure {last.get('nb_closure', float('nan')):.4f}, "
              f"thermal vs analytic {last.get('nb_thermal_vs_analytic', float('nan')):.4f}, shares "
              + ", ".join(f"{k} {v['share']:.3%}" for k, v in budget.get("sources", {}).items())
              + f"; emu launches per probe {[c['emu_bank_product'] for c in emu_per_probe]}; hw "
              f"rows {len(hw_rows)} with hwmon gauges "
              f"{sorted(k for k in hw_rows[-1]['metrics'] if k.startswith('hw_')) if hw_rows else []}")
        print(f"[observe] MLP step ms on CUDA events (median of steps 1-23, probed steps out; "
              f"two rounds, the second in the opposite order): " + ", ".join(
                  f"{label} {' / '.join(f'{x:.3f}' for x in emu_ms[mode])}"
                  for mode, label in (("null", "null observer"), ("observer", "Observer"),
                                      ("probe", "with the probe"),
                                      ("probed_step", "probed steps")))
              + f"; card {card}")
        check(len(nb_rows) == 6 and all(
            f"nb_{src}_var" in r["metrics"] for r in nb_rows
            for src in ("quantization", "thermal", "shot", "adc", "drift", "crosstalk",
                        "dead_rings")), f"nb rows {[r['step'] for r in nb_rows]}")
        check(all(abs(r["metrics"]["nb_closure"] - 1) <= 0.1 for r in nb_rows), "closure")
        check(all(abs(r["metrics"]["nb_thermal_vs_analytic"] - 1) <= 0.15 for r in nb_rows),
              "thermal vs analytic")
        check([c["emu_bank_product"] for c in emu_per_probe] == [2] * 12,
              f"emu launches per probe {emu_per_probe}")
        check(hwmon is not None and hw_rows and all(
            {"hw_expected_sigma", "hw_residual_vs_expected", "hw_effective_bits"}
            <= set(r["metrics"]) for r in hw_rows), "hw gauges did not go through hwmon")
        out["probe_launches"]["emu_bank_product"] = sum(c["emu_bank_product"]
                                                        for c in emu_per_probe)
        out["mlp"] = emu_ms

        # (c) serving with the observer
        serve = api.build_session(arch=ARCH, algo="bp", smoke=False, hardware="offchip_bpd",
                                  backend="cuda", dtype=torch.bfloat16, seed=seed, device=DEVICE)
        vocab = serve.model.cfg.vocab_size
        outs, engines = {}, {}
        o = obs.Observer(trace_path=str(root / "serve.json"))
        for mode in ("plain", "observer"):
            rng = np.random.default_rng(seed)
            reqs = [Request(prompt=p, max_new=16) for p in _prompts(rng, 8, 32, vocab)]
            eng = serve.engine(batch_slots=4, max_len=128, prefill_chunk=16, seed=seed,
                               observer=o if mode == "observer" else None)
            sync(torch)
            t0 = time.perf_counter()
            eng.run(reqs)
            sync(torch)
            outs[mode] = ([r.out for r in reqs], time.perf_counter() - t0)
            engines[mode] = eng.stats
        doc = json.loads(pathlib.Path(o.close()).read_text())
        tracks = {e["id"] for e in doc["traceEvents"]
                  if e["ph"] == "b" and e["name"].startswith("request-")}
        ticks = [e for e in doc["traceEvents"]
                 if e["ph"] == "X" and e["name"] in ("prefill_tick", "decode_tick")]
        stats = engines["observer"]
        print(f"[observe] serving qwen1.5-0.5b full width bf16, 4 slots, 8 requests: {len(tracks)} "
              f"request tracks, {len(ticks)} tick spans = prefill {stats['prefill_steps']} + "
              f"decode {stats['decode_steps']}; tokens equal to the unobserved run: "
              f"{outs['plain'][0] == outs['observer'][0]}; wall {outs['plain'][1]:.3f}s unobserved, "
              f"{outs['observer'][1]:.3f}s observed")
        check(len(tracks) == 8, f"{len(tracks)} request tracks")
        check(len(ticks) == stats["prefill_steps"] + stats["decode_steps"], "tick spans")
        check(outs["plain"][0] == outs["observer"][0], "the observer changed the tokens")
        del serve, eng
        torch.cuda.empty_cache()
    finally:
        with contextlib.suppress(OSError):
            tmp.cleanup()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import api
    from repro_torch.core import photonics as ph
    from repro_torch.hardware import channel as ch
    from repro_torch.hardware import mrr
    from repro_torch.kernels import dfa_gradient as dg
    from repro_torch.kernels import emu_matmul as em
    from repro_torch.kernels import photonic_matmul as pm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card, draws = phase_build(torch, pm)
    max_err = phase_kernel_vs_plain(torch, pm)
    max_err_b = phase_dfa_kernel_vs_plain(torch, pm, dg)
    serve_launches = phase_serve(torch, np, pm, api, args.seed)
    phase_profile_ticks(torch, np, api, args.seed)
    phase_parity(torch, np, api, args.seed)
    train_launches = phase_train(torch, np, api, pm, dg, args.seed)
    masked_launches = phase_masked_projection(torch, api, dg, args.seed)
    per_step, per_prefill = phase_timing(torch, pm, card)
    phase_seam(torch, pm, card)
    train_rows = phase_timing_train(torch, pm, dg, card)
    max_err_c = phase_emu_kernel_vs_plain(torch, em, ph, ch, mrr)
    emu_train_launches = phase_emu_train(torch, np, api, em, args.seed)
    phase_drift(torch, api, args.seed)
    emu_serve_launches, max_err_serve = phase_emu_serve(torch, np, api, em, args.seed)
    emu_rows = phase_emu_timing(torch, em, ph, ch, mrr, card, draws["emu"])
    lm = phase_lm_train(torch, np, api, pm, em, args.seed, card, draws)
    observed = phase_observe(torch, np, api, pm, em, args.seed, card)
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    row_b = train_rows["dfa_gradient"]
    records = [
        {"name": "photonic_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/photonic_matmul.cu",
         "replaces": "src/repro/kernels/photonic_matmul.py:95",
         "launches": (serve_launches + train_launches + lm["launches"]
                      + observed["probe_launches"]["photonic_matmul"]),
         "launches_by_path": {"serve": serve_launches, "train": train_launches,
                              "lm_train": lm["launches"],
                              "probe": observed["probe_launches"]["photonic_matmul"]},
         "max_abs_err": max(max_err, lm["max_abs_err"]),
         "ms": per_step["ms"], "plain_ms": per_step["plain_ms"],
         "bound_ms": per_step["bound_ms"], "bound_by": per_step["bound_by"],
         "library_ms": per_step["library_ms"],
         "decode_step": per_step, "prefill_forward": per_prefill,
         "lm_train_shape": lm["bank"], "lm_step": lm["profile"], "draw_sass": draws["bank"],
         "observe": {k: observed[k] for k in ("lm", "mlp", "step_cost")}},
        {"name": "dfa_gradient", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/photonic_matmul.cu",
         "replaces": "src/repro/kernels/dfa_gradient.py:67",
         "launches": masked_launches,
         "launches_by_path": {"masked_projection": masked_launches},
         "max_abs_err": max_err_b,
         "ms": row_b["ms"], "plain_ms": row_b["plain_ms"],
         "bound_ms": row_b["bound_ms"], "bound_by": row_b["bound_by"],
         "library_ms": row_b["library_ms"]},
        {"name": "emu_bank_product", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/emu_matmul.cu",
         "replaces": "src/repro/kernels/emu_matmul.py:200",
         "launches": (emu_train_launches + emu_serve_launches + lm["emu_launches"]
                      + observed["probe_launches"]["emu_bank_product"]),
         "launches_by_path": {"train": emu_train_launches, "serve": emu_serve_launches,
                              "lm_train": lm["emu_launches"],
                              "probe": observed["probe_launches"]["emu_bank_product"]},
         "max_abs_err": max(max_err_c, max_err_serve, lm["emu_max_abs_err"]),
         "ms": emu_rows["path_a"]["ms"], "plain_ms": emu_rows["path_a"]["plain_ms"],
         "bound_ms": emu_rows["path_a"]["bound_ms"], "bound_by": emu_rows["path_a"]["bound_by"],
         "library_ms": None, "library": "none: no single PyTorch call computes it",
         "draw_sass": draws["emu"], "timing": {**emu_rows, "lm_train_shape": lm["emu"]}},
    ]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
