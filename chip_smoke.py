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
   beside the library), which set the two kernels' PRNG bounds; then the
   static linter (``python -m repro_torch.lint src/repro_torch``, no
   baseline), failing on any finding;
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
   prefill forward; at each shape the bytes the wrapper reports to
   ``utils.flop_cost`` (= the kernel's ``launch_bytes``), and the decode
   step's bytes over the memory rate = the recorded bound within 0.5%; the
   skinny and mma variants side by side at T = 4, 8 and 16 (the seam);
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
    hardware monitor, and full-width serving with an observer;
16. the simulator, the energy model and the autotuned schedule
    (``[schedule]``, ``phase_schedule``): the energy model's headline
    numbers (the modelled photonic chip's, not the card's); qwen1.5-0.5b at
    full width in f32 tuned by ``build_session(schedule="auto",
    power_budget_w=78, recalibrate_every="auto")`` on emu_onchip (the
    reference's pick: 2 buses at 10 GHz, recalibration every 100 steps,
    drift budget 0.025; the hardware monitor carries it), 2 dfa steps with
    the observer at 25 emu launches a step at q = 2; tuned again without a
    budget (8 buses) and 1 step at q = 8 (nj = 7, four padded slots); the
    emu kernel bit for bit on the first launch of each run (under every
    plan at q = 8) and timed; the search again with the card's measured
    step as its digital time; ``autotune_serving`` on a 200 req/s Poisson
    trace (1 bus, 5 GHz, 4 slots); both trace exporters into one file;
17. the Mamba-2 family (``[mamba_*]``, ``phase_mamba``): mamba2-130m at
    full width (24 layers, d 768, vocab 50280, d_state 128, random
    weights from --seed) served in bf16 on offchip_bpd through the bank
    kernel (49 launches a forward; the prefill by the masked decode-scan,
    49 a prefilled token; the kernel against its plain version on the
    path's own operands at the three decode shapes) with a profiled
    prefill tick and two decode ticks; f32 ideal cuda-vs-ref parity and chunk 16 = chunk 1; 4
    requests through emulated banks (emu_offchip), the emu kernel bit for
    bit on the path's operands; DFA training in f32 at batch 8 × seq 512
    (two SSD chunks), 16 steps on ``cuda`` and 4 on ``emu``, 25 launches a
    step, δ against the plain version, ideal cuda = ref gradients, step
    ms, profile, peak memory and ``step_cost``; both kernels timed at the
    Mamba shapes;
18. the dense attention families (``[dense_*]``, ``phase_dense``):
    qwen3-1.7b (qk-norm), minicpm3-4b (MLA) and granite-8b at full width,
    random weights from --seed, each served in bf16 on offchip_bpd through
    the bank kernel (197, 435 and 253 launches a forward; the kernel
    against its plain version on the path's own operands at every shape,
    granite's K = 14336 by both skinny variants in bf16 and f32) with a
    profiled prefill tick and two decode ticks, and f32 ideal cuda-vs-ref
    parity; DFA training in f32 at batch 64 x seq 64 of qwen3 (2 steps,
    29 launches a step, ideal cuda = ref gradients, step ms, profile,
    ``step_cost``, peak memory; 2 steps on emu_offchip with the emu kernel
    bit for bit; 1 step at batch 2 x seq 4096 whose every block runs
    ``flash_attention``, held to ``reference_attention`` on the card) and
    of minicpm3 (2 steps, at the depth that leaves 5 GiB of the card free,
    printed); the bank kernel timed at every decode shape and both
    training shapes.  One ``{"dense_model": ...}`` line per model precedes
    the kernels record;
19. the mixture-of-experts family (``[moe_*]``, ``phase_moe``):
    qwen2-moe-a2.7b at full width (24 layers, 60 experts top-4, 4 shared;
    14.32 B parameters, random weights from --seed) served in bf16 on
    offchip_bpd through the bank kernel (241 launches a forward: each of
    the experts' three products is one batched launch over all 60; the
    kernel against its plain version at every (E, T, K, M) of the path,
    the batched launches against their per-expert 2-D launches bit for
    bit) with a profiled prefill tick and two decode ticks; f32 ideal
    cuda-vs-ref parity; emu serving at 2 layers (21 emu launches a forward,
    each expert product one batched launch over the 60 experts; the emu
    kernel bit for bit on the path's operands and each batched launch's
    index e = the 2-D launch of expert e under every plan; the batched
    launches timed beside the loop of 60 they replace); f32 ``dfa`` training at batch 64 x
    seq 64 at the depth the card holds (reckoned and printed; the aux loss
    and each layer's dropped fraction, ideal cuda = ref gradients, the
    router's included); kimi-k2-1t-a32b's full() on the meta device and
    its expert products (384 experts) against the plain version; the bank
    kernel timed at every decode shape, the experts' prefill shapes and
    kimi's.  One ``{"moe_model": ...}`` line follows the dense lines;
20. the recurrentgemma family (``[rg_*]``, ``phase_recurrentgemma``):
    recurrentgemma-9b at full width (38 layers = 12 x (RG-LRU, RG-LRU,
    local attention) + 2 RG-LRU, d 4096, vocab 256000, window 2048; 10.44
    B parameters, random weights from --seed) served in bf16 on
    offchip_bpd through the bank kernel (293 launches a forward; the
    prefill by the masked decode-scan; the kernel against its plain
    version at every (T, K, M) of the path, the K = 12288 down projection
    by both skinny variants) with a profiled prefill tick and two decode
    ticks; f32 ideal cuda-vs-ref parity; a full-width local attention
    layer decoding 2100 tokens through its 2048-slot ring against its
    windowed forward, and the windowed ``flash_attention`` at batch 2 x
    seq 4096 against its oracle; f32 ``dfa`` training at 4 layers (one of
    each segment) at the largest batch of 64 / 32 / 16 x seq 64 that
    leaves 5 GiB free (printed), ideal cuda = ref gradients; emu serving
    at 4 layers with the emu kernel bit for bit; the bank kernel timed at
    every decode shape.  One ``{"rg_model": ...}`` line follows the MoE
    line;
21. whisper-small (``[whisper_*]``, ``phase_whisper``): the
    encoder-decoder at full width (12 + 12 layers, d 768, vocab 51865,
    1500 frames; 279.6 M parameters, random weights from --seed) served
    in bf16 on offchip_bpd through the bank kernel: 4 clips encoded once
    (72 launches at T = 6000) and 4 prompt + 16 greedy decode steps
    through ``make_serve_step(whisper_enc=True)`` (72 a step; the cross
    attention and the head digital), the kernel against its plain version
    at every path shape, a profiled encode and two decode steps; f32 ideal
    cuda-vs-ref parity of the encoder output and the logits; f32 ``dfa``
    training at full depth, batch 8 x seq 64 (25 launches a step, the
    encoder's 12 on the pooled error), ideal cuda = ref gradients and
    ``head.ln_enc``'s exactly zero; 2 steps on emu_offchip with the emu
    kernel bit for bit at both shapes; the bank kernel timed at the
    encode, decode and training shapes.  One ``{"whisper_model": ...}``
    line;
22. internvl2-2b (``[internvl2_*]``, ``phase_internvl2``): full width (24
    layers, d 2048, vocab 92553, a 256-patch vision prefix; 1.891 B
    parameters) served text-only in bf16 like qwen1.5 (169 launches a
    forward, the odd 92553-row head held to the plain version), f32
    parity, f32 ``dfa`` training at full depth with the patch prefix and
    seq 64 at batch 16 where it leaves 5 GiB free (the card holds 64; 16
    keeps the script's wall near 700 s; 25 launches a step, ideal cuda = ref gradients); the bank kernel
    timed at every decode shape and the training shape.  One
    ``{"internvl2_model": ...}`` line.

23. data parallelism (``[dp]``, ``phase_data_parallel``, after the
    schedule phase): qwen1.5-0.5b at full width, f32, offchip_bpd, two dfa
    steps with ``data_parallel=True`` (a world of one NCCL rank) equal the
    single-device steps bit for bit; the emu kernel on rows [r, T) with
    ``row_base = r`` = its plain version and rows [r, T) of a whole launch
    under every candidate plan; two ranks spawned on the one card over gloo
    (NCCL refuses two ranks on one device), qwen1.5-0.5b's full width at 8
    of its 24 layers (``DP_LAYERS``, as every two-rank LM part and its
    one-process check): step 1's loss and gradients within 1e-5 of the
    one-process step, 9 bank launches a rank a step (rank 0's profile too), the group's s_a and each rank's rows of the
    global noise in use (rank-local noise misses by more than 1e-3), the
    parameters after 2 steps within 1e-5, step ms and the gradient
    all-reduce's ms (gloo staged through host memory, not a multi-card
    rate); the MLP on emu_offchip (gradients within 1e-5, the hardware
    state equal on both ranks); the step-2 snapshot resumed by one process,
    whose step 3 equals rank 0's within 1e-5.  FSDP (``[fsdp]``, the same
    spawn): ``launch/dryrun.build_train``'s sharded step on a (1, 1) mesh of
    the NCCL world of one = the single-device steps bit for bit (losses,
    parameters and momentum after 2 steps, 25 launches a step); on the two
    gloo ranks (32 x 64 rows each) every shard the rule's slice of an
    independent init, step 1's loss and gradients and the parameters after
    2 steps within 1e-5 of the one-process steps with the noise on, 9
    launches a rank a step, each rank's resident parameter and momentum
    bytes, ``step_cost``'s all-gather / reduce-scatter / all-reduce bytes
    against those the leaves give, each collective's ms; ``DTensor``'s plain
    ``Replicate`` backward must miss the gradient check; the emu MLP's
    sharded step within 1e-6 of one process with the hardware state equal.
    One ``{"data_parallel": ...}`` line.
24. sharded serving (``[shard_serve]``, ``phase_shard_serve``): qwen1.5-0.5b
    at full width and depth, f32, offchip_bpd through the bank kernel, on
    two ranks over gloo on (2, 1) and (1, 2) (data, model): build_prefill's
    logits of a (4, 32) batch, a parallel prefill_step into caches placed
    by ``serve.decode.cache_shardings`` and 8 greedy decode steps, each
    against one process (distances printed), 169 bank launches a rank a
    forward; on (1, 2) the dense blocks' and the head's products
    column-parallel (``nn/linear.py``): every launch on the rank's M/2 rows,
    the weight bytes a rank's launches read 0.50 of one process's, the first
    launch of each new shape equal to the kernel's plain version; on (1, 2)
    recurrentgemma-9b (the head_dim rule) and minicpm3-4b (the latent
    caches' sequence rule at 1024 slots) at 4 layers, one decode step within
    1e-4, minicpm3's launches each on the rank's M/2 rows but q_up's
    (served whole), 0.5136 of one process's weight bytes, each new shape
    equal to the plain version; qwen2-moe's 30-expert batched bank launch against its
    60-expert launch at T = 1 and 5 (distance and plans printed).  One
    ``{"shard_serve": ...}`` line.
25. the dry-run against the card (``[dryrun]``, ``phase_dryrun``):
    ``launch/dryrun.run_cell`` for qwen1.5-0.5b at full width in bf16 on a
    train and a decode cell at reduced shapes, on a fake world of one and on
    a real NCCL world of one, in a fresh process: FLOPs, bytes and
    collective bytes equal, the fake peak within 10% of the allocator's.
    One ``{"dryrun": ...}`` line.

Every timed full-width training step (``_step_timing``: qwen1.5, Mamba,
qwen3, minicpm3, qwen2-moe, recurrentgemma, whisper, internvl2) and the
tuned q = 2 step read ``step_cost`` with their launches' shapes captured
(``_captured_cost``) and print the step against the card's roofline
(``_step_roofline``): ``mem_bytes`` and ``kernel_bytes``, t_compute at the
f32 peak, t_memory, the bound, the step and the share bound / step, and
the model FLOPs utilisation; ``kernel_bytes`` must equal the kernels'
helpers over the captured launches and every share be at most 1.05.

Every phase that fails raises and the script exits non-zero.  The line
before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
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
DECODE_BOUND_MS = 0.2794  # PERF.md's bound of one T = 4 bf16 decode step (169 launches)
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


def bound_ms(t, m, k, dtype_name, peaks, masked=False, noise="none", draw=None, sms=None, e=1):
    """Least time for C = A·Bᵀ (+ noise) (⊙ mask): each input read once (the
    f32 mask and an "input" noise operand too), the f32 output written once,
    2·T·M·K operations at the peak rate of the input type, and in "prng"
    mode the T·M·⌈K/32⌉ threefry draws at ``draw``'s SM clocks each (the
    bank probe's SASS) on ``sms`` SMs at the boost clock; ``e`` such
    products in a batched launch, which reads its one (T, M) noise operand
    once.  The bytes are the kernel's own helper's (``launch_bytes``), the
    ones its wrapper reports to ``step_cost``.  Returns (ms, what binds,
    bytes moved)."""
    from repro_torch.kernels import dfa_gradient as dg
    from repro_torch.kernels import photonic_matmul as pm

    itemsize = 2 if dtype_name == "bfloat16" else 4
    helper = dg.launch_bytes if masked else pm.launch_bytes
    nbytes = helper(t, m, k, itemsize, e=e, noise=noise == "input")
    ops = 2 * e * t * m * k
    by_bytes, by_ops = nbytes / peaks["bw"], ops / peaks[dtype_name]
    if noise == "prng":
        draws = e * t * m * math.ceil(k / 32)
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


def phase_lint(torch):
    """The static linter (``python -m repro_torch.lint``, stdlib only) over
    ``src/repro_torch`` with no baseline: any finding fails the run."""
    del torch
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.lint", "src/repro_torch",
                          "--format", "json"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    report = json.loads(out.stdout) if out.returncode in (0, 1) else {}
    print(f"[lint] python -m repro_torch.lint src/repro_torch: exit {out.returncode}, "
          f"{len(report.get('findings', []))} finding(s), {report.get('suppressed')} "
          f"suppressed inline, {time.perf_counter() - t0:.2f}s")
    for f in report.get("findings", []):
        print(f"[lint]   {f['path']}:{f['line']}: {f['rule']} {f['message']}")
    check(out.returncode == 0 and not report.get("findings"),
          f"the linter failed (exit {out.returncode}): {out.stderr[-2000:]}")
    return report


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


def _finite_outputs(torch, eng):
    """Wrap the engine's prefill and decode steps so that every logit they
    return is checked finite; returns the function that reads the flag."""
    finite = [torch.ones((), dtype=torch.bool, device=DEVICE)]
    for name, idx in (("_prefill", 0), ("_decode", 1)):
        fn = getattr(eng, name)

        def wrapped(*args, fn=fn, idx=idx):
            out = fn(*args)
            finite[0] = finite[0] & torch.isfinite(out[idx]).all()
            return out

        setattr(eng, name, wrapped)
    return lambda: bool(finite[0].item())


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
    finite = _finite_outputs(torch, eng)
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
    check(finite(), "non-finite logits")
    del eng, warm, session, model
    torch.cuda.empty_cache()
    return launches


def _logit_agreement(ref_logits, cuda_logits):
    """(max |Δlogit| / max|logit|, positions with a clear top-2 gap, of
    them where the greedy tokens agree) over paired logits."""
    worst, gated, agree = 0.0, 0, 0
    for r, c in zip(ref_logits, cuda_logits):
        scale = r.abs().max().item()
        worst = max(worst, (r - c).abs().max().item() / scale)
        top2 = r.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > 10 * 1e-4 * scale
        gated += int(sure.sum())
        agree += int((r.argmax(-1) == c.argmax(-1))[sure].sum())
    return worst, gated, agree


def phase_parity(torch, np, api, seed, arch=ARCH, tag="parity"):
    """f32 on the ideal preset: the ``cuda`` backend against the ``ref``
    backend, teacher-forced (two prefill chunks of 16, then 8 decode
    steps), on ``arch``."""
    from repro_torch.core import photonics as ph

    model = api.build_model(arch, dtype=torch.float32, device=DEVICE, seed=seed)
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
    worst, gated, agree = _logit_agreement(ref_logits, cuda_logits)
    print(f"[{tag}] f32 ideal, cuda vs ref over {len(ref_logits)} forwards: "
          f"max |Δlogit| / max|logit| = {worst:.3e} (limit 1e-4); greedy tokens agree at "
          f"{agree}/{gated} positions with a top-2 gap > 1e-3·max|logit|")
    check(worst <= 1e-4, f"cuda vs ref logits differ by {worst:.3e} of max|logit|")
    check(agree == gated, "greedy tokens differ where the top-2 gap is clear")
    del model, ref_logits, cuda_logits
    torch.cuda.empty_cache()
    return {"max_rel": worst, "clear_positions": gated, "agree": agree}


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


def _profile_steps(torch, session, run, batches):
    """Wall time and device busy time of len(batches) steps under the
    profiler, continuing ``run["state"]``, and the kernels that take the
    device time."""
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            run["state"], _ = session.step(run["state"], batch)
        sync(torch)
        wall = (time.perf_counter() - t0) * 1e3
    return wall, _kernel_ms(torch, prof)


def _kernel_ms(torch, prof):
    """{kernel name: device ms} of a profile, the hand-written kernels'
    variants under their kernel's name."""
    by_name = {}
    for e in _device_kernels(torch, prof):
        name = next((kernel for kernel, parts in KERNEL_PARTS.items()
                     if any(part in e.name for part in parts)), e.name[:70])
        by_name[name] = by_name.get(name, 0.0) + e.us / 1e3
    return by_name


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
    wall, by_name = _profile_steps(torch, session, {"state": state}, batches[:5])
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


DeviceEvent = collections.namedtuple("DeviceEvent", "name start_us us")


def _device_kernels(torch, prof):
    """The device's events in a profile (kernels, copies and fills), in the
    order they started, each with its duration in µs.  They are read from
    the profiler's raw results: building its FunctionEvent tree costs host
    time for every event, host operators included, which came to most of a
    minute for one profiled prefill tick of a scanned model, and only the
    device events are needed here."""
    from torch.autograd import DeviceType

    events = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or getattr(e, "is_hidden_event", lambda: False)():
            continue
        events.append(DeviceEvent(torch._C._demangle(e.name()), e.start_ns() / 1e3,
                                  (e.end_ns() - e.start_ns()) / 1e3))
    return sorted(events, key=lambda e: e.start_us)


def _event_ms(torch, fn, reps=25, warm=3):
    """Time of one call of ``fn`` on CUDA events: the median over ``reps``
    single calls after ``warm`` unmeasured ones, each after a write of 64
    MiB that evicts the operands from the 50 MB L2.  The interval opens
    before the call is issued, so it includes the host's launch overhead
    when that exceeds the kernel."""
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=DEVICE)
    for _ in range(warm):
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


def _device_ms(torch, fn, reps=25, attempts=8, spare=24):
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
    in three windows in a row), and late in a long run it lost the first 18
    of 41 three-millisecond calls in eight windows in a row (and the first
    16 or 17 of most windows of 26 or 41 calls late in the full script,
    when 16 spare calls were run: 24 are now): such a window
    is profiled again after a pause, with twice the spare calls and twice
    the pause inside the window each time (up to 16 times), up to
    ``attempts`` times, and then the phase fails."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=DEVICE)
    for _ in range(3):
        fn()
    sync(torch)
    for attempt in range(attempts):
        grow = 1 << min(attempt, 4)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05 * grow)
            for _ in range(reps + spare * grow):
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
                cur += e.us
        if cur is not None:
            per_call.append(cur)
        if len(per_call) >= reps:
            return statistics.median(per_call[-reps:]) / 1e3
        print(f"[timing] the profiler saw {len(per_call)} of {reps + spare * grow} calls; "
              "profiling again with more")
        time.sleep(1.0)
    raise PhaseError(f"device time not measured: the profiler saw fewer than {reps} calls "
                     f"in each of {attempts} windows")


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
        by_name[name] = by_name.get(name, 0.0) + e.us / 1e3
    if not by_name:
        print(f"[{tag}] {label}: wall {wall:.2f} ms; device time not measured (the profiler "
              "traced no device kernels)")
        return {"wall_ms": wall}
    busy = sum(by_name.values()) / ticks
    print(f"[{tag}] {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms, idle share "
          f"{1 - busy / wall:.3f}; {kernel} {by_name.get(kernel, 0.0) / ticks:.3f} ms per tick")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{tag}]   {ms / ticks:8.3f} ms/tick  {ms / ticks / wall:6.1%} of wall  {name}")
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "kernel_ms": by_name.get(kernel, 0.0) / ticks}


def phase_profile_ticks(torch, np, api, seed, tag="profile", hardware="offchip_bpd",
                        backend="cuda", kernel="photonic_matmul", arch=ARCH, session=None):
    """A prefill tick (4 slots x chunk 16: 64 rows through every projection
    of a transformer, 16 decode-scan steps of 4 rows for Mamba) and two
    steady decode ticks (4 active slots), bf16, under the profiler; on a
    new session of ``arch`` or on the given bf16 serving ``session``."""
    from repro_torch.serve import DECODE, Request

    if session is None:
        session = api.build_session(arch=arch, algo="bp", smoke=False, hardware=hardware,
                                    backend=backend, dtype=torch.bfloat16, seed=seed,
                                    device=DEVICE)
    eng = session.engine(batch_slots=4, max_len=128, prefill_chunk=16, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for p in _prompts(rng, 4, 32, session.model.cfg.vocab_size):
        eng.submit(Request(prompt=p, max_new=8))
    eng.tick()  # the first prefill chunk
    prefill = _profile_ticks(torch, eng, 1, tag,
                             f"prefill tick (4 slots x 16 tokens, bf16, {hardware})", kernel)
    eng.tick()  # one unprofiled decode tick
    check(all(r is not None and r.state == DECODE for r in eng._requests), "slots not decoding")
    decode = _profile_ticks(torch, eng, 2, tag, f"decode tick (4 slots, bf16, {hardware})",
                            kernel)
    del eng, session
    torch.cuda.empty_cache()
    return {"prefill_tick": prefill, "decode_tick": decode}


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
    prefill forward's 169 launches.  At each shape one call under
    ``flop_cost.measure`` reports the bank helper's bytes, and the decode
    step's helper bytes over the card's memory rate give PERF.md's bound
    (DECODE_BOUND_MS) within 0.5%."""
    from repro_torch.utils import flop_cost

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
            _, cost = flop_cost.measure(pm.photonic_matmul_cuda, a, b)
            helper = pm.launch_bytes(t, m, k, a.element_size())
            check(cost.kernel_launches == 1 and cost.kernel_bytes == helper == bound[2],
                  f"({t}, {k}, {m}): the wrapper reported {cost.kernel_bytes} B in "
                  f"{cost.kernel_launches} launches, the helper gives {helper}")
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
        total["kernel_bytes"] = sum(pm.launch_bytes(t, r["m"], r["k"], 2) * r["count"]
                                    for r in step)
        sums[t] = total
        print(f"[timing] {label} ({total['launches']} launches), ms: "
              + ", ".join(f"{key} {total[key]:.4f}" for key in keys)
              + f"; host overhead per launch {total['host_us_per_launch']:.2f} us (matmul "
              f"{total['library_host_us_per_launch']:.2f} us)")
    decode_ms = sums[4]["kernel_bytes"] / CARDS["H100"]["bw"] * 1e3
    print(f"[timing] the decode step's kernel bytes (each shape's, as its wrapper reports them "
          f"to step_cost): {sums[4]['kernel_bytes']} B, {decode_ms:.4f} ms at "
          f"{CARDS['H100']['bw'] / 1e12:.2f} TB/s against PERF.md's {DECODE_BOUND_MS} ms bound")
    check(abs(decode_ms / DECODE_BOUND_MS - 1) <= 0.005,
          f"the decode step's helper bytes give {decode_ms:.4f} ms, not {DECODE_BOUND_MS}")
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
# The probes take the sources' device functions alone (no entry point, so
# no kernel of the library is compiled again beside the library's own build).
_PROBE_HEAD = "#define REPRO_DEVICE_FUNCTIONS_ONLY\n"
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
    "emu": _PROBE_HEAD + '#include "emu_matmul.cu"\n#define DRAW ih4_gaussian\n' + _PROBE_PAIR,
    "bank": _PROBE_HEAD + r'''#include "photonic_matmul.cu"
__device__ __forceinline__ float bank_bits(unsigned seed, unsigned kt, unsigned r, unsigned c) {
  uint32_t x0 = r, x1 = c;
  threefry2x32(seed, kt, x0, x1);
  return static_cast<float>(x0 >> 8) + static_cast<float>(x1 >> 8);
}
#define DRAW bank_bits
''' + _PROBE_PAIR,
    "bank_full": (_PROBE_HEAD + '#include "photonic_matmul.cu"\n#define DRAW counter_gaussian\n'
                  + _PROBE_PAIR),
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
    """The planner's plan for these operands (a stack of E products too) and
    the grid of forced plans."""
    t, q, nj, cols = a_t.shape[-4:]
    nm, _, rows, _, _ = delta.shape[-5:]
    return em.candidate_plans(t, nm, rows, q, nj, cols, em._pointers(delta, mask),
                              em._sm_count(a_t.device.index), em._stack(a_t))


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
    finite = _finite_outputs(torch, eng)
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
    check(finite(), "non-finite logits")

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
    the boost clock.  A stack of E products moves E times the operands and
    does E times the multiply-adds, but draws one product's noise: every
    product shares it.  The bytes are ``emu_matmul.launch_bytes``'s, the
    ones the wrapper reports to ``step_cost``."""
    from repro_torch.kernels import emu_matmul as em

    a_t, delta, mask, n_panels = case
    t, q, nj, c = a_t.shape[-4:]
    nm, _, rows, _, _ = delta.shape[-5:]
    e = a_t.shape[0] if a_t.ndim == 5 else 1
    nbytes = em.launch_bytes(tuple(a_t.shape), a_t.element_size(), tuple(delta.shape),
                             mask is not None)
    flops = 2 * e * t * nm * rows * q * nj * c
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
        def plain():
            return em.emu_bank_product_plain(a_t, delta, mask, **kw)

        # the plain version's device time from one profiled call: its ~10^4
        # small launches a call make a window of many calls slow to read
        row = {"shape": [t, m, k], "n_buses": pkw.get("n_buses", 1),
               **_time_fns(torch, {"ms": lambda: em.emu_bank_product_cuda(
                   a_t, delta, mask, **kw)}, {"ms": 25}),
               "plain_ms": _event_ms(torch, plain, reps=5),
               "plain_dev_ms": _device_ms(torch, plain, reps=1, spare=2)}
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
          "ms: CUDA events (median of 25, cold L2; the plain version's: one call after one "
          "warm-up, its device time not measured); dev: profiler (median of 25); share and GB/s "
          "from dev")
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
            # first calls of every later window (seen on the card).  One
            # call after one warm-up: the plain version is a yardstick
            row = {"t": t, "m": m, "k": k, "count": count, **_time_fns(torch, {
                "ms": lambda: em.emu_bank_product_cuda(a_t, delta, mask, **kw)}, {"ms": 25}),
                "plain_ms": _event_ms(torch, lambda: em.emu_bank_product_plain(
                    a_t, delta, mask, **kw), reps=1, warm=1)}
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
    # a tensor-parallel rank's LM projection on (1, 2): its 512 rows of a
    # (1024, 1024) B(k) widened to the bank panels they touch, [500, 1024),
    # so col_base = 500 (emu_offchip, f32, as the LM's emu step runs it)
    case = _emu_case(torch, ph, ch, mrr, LM_BATCH * LM_SEQ, 524, 1024, {}, {"adc_bits": 10},
                     True, torch.float32, gen)
    kw = dict(n_panels=case[3], gamma=1.0, sigma=sigma, shot=shot, adc_bits=10,
              amax=float(cfg.bank_cols), seed=EMU_SEED, col_base=500)
    rows["tp_rank"] = _emu_row(torch, em, case, kw, peaks, draw, sms)
    _print_emu_row("emu_timing", "a tensor-parallel rank's LM projection (4096, 1024 -> 524 "
                   "rows, col_base 500), f32 a_t and δ, σ 0.098, 10-bit ADC", rows["tp_rank"])
    del case
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# DFA training of the language model: qwen1.5-0.5b at full width
# ---------------------------------------------------------------------------

LM_BATCH, LM_SEQ = 64, 64  # 4096 rows through every DFA projection
LM_STEPS, LM_EMU_STEPS = 16, 2
LM_LAUNCHES = 25  # bank products per dfa step: 24 blocks + the embedding


def _lm_session(api, torch, seed, arch=ARCH, **kw):
    """qwen1.5-0.5b at full width in f32 (24 layers, d 1024, d_ff 2816,
    vocab 151936, random weights from ``seed``) on the card; ``arch`` a
    model instance in its place (``_dp_model``'s cut depth)."""
    kw = {"algo": "dfa", "hardware": "offchip_bpd", "backend": "cuda", "log_every": 10**9,
          **kw}
    return api.build_session(arch=arch, smoke=False, dtype=torch.float32, seed=seed,
                             device=DEVICE, **kw)


def _wrap(module, name, store, limit=None, key=None):
    """Record (args, kwargs, result) of the first ``limit`` calls of
    ``module.name`` in ``store`` (with ``key``: the first call of each
    ``key(*args)``); returns the function that restores it."""
    fn = getattr(module, name)
    seen = set()

    def recording(*args, **kw):
        out = fn(*args, **kw)
        if key is not None:
            k = key(*args)
            if k not in seen:
                seen.add(k)
                store.append((args, kw, out))
        elif limit is None or len(store) < limit:
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


def _fit_logged(torch, pm, session, gen, steps, log):
    """``steps`` fit steps of a session built with ``log_path=log`` and
    ``log_every=1``, the bank kernel's count set to 0 just before: a dict
    that alone holds the final ``state``, with the ``wall`` seconds, the
    ``launches`` and the log's loss of every step (``losses``)."""
    sync(torch)
    pm.launches = 0
    t0 = time.perf_counter()
    state, _ = session.fit(gen.batch, total_steps=steps, verbose=False)
    sync(torch)
    wall = time.perf_counter() - t0
    launches = pm.launches
    lines = log.read_text().splitlines()
    log.unlink()
    cols = lines[0].split(",")
    logged = {name: [float(line.split(",")[i]) for line in lines[1:]]
              for i, name in enumerate(cols)}
    return {"state": state, "wall": wall, "launches": launches, "losses": logged["loss"],
            "log": logged}


def _check_fit(fit, steps, per_step):
    """A fit's gates: a finite loss at every step, ``per_step`` bank-kernel
    launches a step."""
    losses, launches = fit["losses"], fit["launches"]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"non-finite or missing step losses: {losses}")
    check(launches == per_step * steps,
          f"{launches} bank-kernel launches, expected {per_step} per step")


def _step_projections(torch, pm, session, state, gen, seed, per_step, rows, tag, picks=None):
    """One dfa step on the state's next batch with the bank kernel's calls
    recorded: ``per_step`` projections, and block 0's and the embedding's
    δ (``picks``: (label, call index, rows) of each, by default the first
    and the last call, ``rows`` rows each) held against the plain version
    on their own operands with the path's input-mode noise.  -> (the
    calls, {label: max |kernel - plain|}, the step's (batch, rng), its
    ((loss, metrics), grads))."""
    from repro_torch.kernels import ops as kops
    from repro_torch.utils import prng

    d_model = session.model.cfg.d_model
    rng = prng.step_key(seed, state["step"], "noise")
    batch = to_device_batch(gen.batch(state["step"]))
    calls = []
    restore = _wrap(kops, "photonic_matmul_cuda", calls)
    try:
        out = session.value_and_grad()(state["params"], state["fb"], batch, rng)
    finally:
        restore()
    check(len(calls) == per_step, f"{len(calls)} projections in one step")
    errs = {}
    picks = picks or (("block 0", 0, rows), ("embedding", -1, rows))
    for label, idx, n in picks:
        (a, b), kw, got = calls[idx]
        check(tuple(a.shape) == (n, d_model) and "noise" in kw,
              f"{label}: operands {tuple(a.shape)}, {sorted(kw)}")
        expect = pm.photonic_matmul_plain(a, b, **kw)
        errs[label] = err = (got - expect).abs().max().item()
        scale = expect.abs().max().item()
        check(err <= TOL["float32"] * scale + 1e-6,
              f"{label}: δ kernel vs plain {err} of max {scale}")
    t_rows = "/".join(str(n) for n in dict.fromkeys(n for _, _, n in picks))
    print(f"[{tag}] one step's own operands (T={t_rows}, K={d_model}, M={d_model}, f32, the "
          f"path's input-mode noise from the step's keys): max |kernel - plain| "
          + ", ".join(f"{label} {errs[label]:.3e}" for label, _, _ in picks)
          + f" (tol {TOL['float32']} of max|δ|)")
    return calls, errs, (batch, rng), out


def _ideal_cuda_vs_ref(torch, session, state, step, tag, watch=(), scale_of=None):
    """One step's dfa gradients on the ideal preset, the ``cuda`` backend
    against the ``ref`` backend: each within 1e-4 of its max |value|, the
    f32 bank tolerance through a block's backward (``scale_of(name)``: the
    gradient whose max |value| is its scale, for one that is near zero in
    exact arithmetic; their error against their own max is printed too);
    the gradients named in ``watch`` are printed on their own.  -> (the
    worst difference, its gradient's name)."""
    import dataclasses

    from repro_torch import algos
    from repro_torch.core import photonics as ph

    batch, rng = step
    g = {b_: algos.get("dfa").value_and_grad(session.model, dataclasses.replace(
        session.config.dfa, photonics=ph.PRESETS["ideal"], backend=b_))(
            state["params"], state["fb"], batch, rng)[1] for b_ in ("cuda", "ref")}
    scale_of = scale_of or (lambda k: k)

    def rel(k):
        diff = (g["cuda"][k] - g["ref"][k]).abs().max().item()
        return diff / max(g["ref"][scale_of(k)].abs().max().item(), 1e-30)

    worst = max((rel(k), k) for k in g["ref"])
    watched = {k: rel(k) for k in watch}
    scaled = [k for k in g["ref"] if scale_of(k) != k]
    own = max((_max_rel(g["cuda"][k], g["ref"][k]), k) for k in scaled) if scaled else None
    del g
    print(f"[{tag}] ideal, cuda vs ref backend: every gradient within {worst[0]:.3e} of its "
          f"max |value| (worst {worst[1]}; limit 1e-4"
          + (f"; {len(scaled)} held to another's scale, within {own[0]:.3e} of their own "
             f"max, worst {own[1]}" if own else "") + ")"
          + "".join(f"; {k} {v:.3e}" for k, v in watched.items()))
    check(worst[0] <= 1e-4, f"ideal cuda vs ref gradients differ: {worst}")
    return worst


def _captured_cost(session, state, batch):
    """``session.step_cost`` of one step with the shapes of its kernel
    launches captured -> (the ``StepCost``, the launches, the bytes the
    kernels' helpers give for those shapes): what the wrappers report, as
    the script recomputes it."""
    from repro_torch.kernels import emu_matmul as em
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import photonic_matmul as pm

    shapes = []
    bank, emu = kops.photonic_matmul_cuda, em.emu_bank_product_cuda

    def bank_capture(a, b, **kw):
        shapes.append(("bank", a.shape[-2], b.shape[-2], a.shape[-1], a.element_size(),
                       a.shape[0] if a.ndim == 3 else 1, kw.get("noise") is not None))
        return bank(a, b, **kw)

    def emu_capture(a_t, delta, mask, **kw):
        shapes.append(("emu", tuple(a_t.shape), a_t.element_size(), tuple(delta.shape),
                       mask is not None))
        return emu(a_t, delta, mask, **kw)

    kops.photonic_matmul_cuda, em.emu_bank_product_cuda = bank_capture, emu_capture
    try:
        cost = session.step_cost(state, batch)
    finally:
        kops.photonic_matmul_cuda, em.emu_bank_product_cuda = bank, emu
    nbytes = sum(pm.launch_bytes(t, m, k, size, e=e, noise=noise)
                 for _, t, m, k, size, e, noise in (x for x in shapes if x[0] == "bank"))
    nbytes += sum(em.launch_bytes(*x[1:]) for x in shapes if x[0] == "emu")
    return cost, shapes, nbytes


def _step_roofline(session, state, batch, step_ms, tag, card, captured):
    """The step's cost against the card's roofline (``launch/analysis``):
    its bytes (``mem_bytes``, the kernels' ``kernel_bytes``), t_compute at
    the f32 peak, t_memory, the bound, the measured step and the share
    bound / step, and model FLOPs utilisation, 6·N·D (N the active
    parameters, D the batch's tokens) over the step at the f32 peak.  Gates:
    ``kernel_bytes`` = the helpers' bytes over the captured launches, every
    launch counted, ``mem_bytes`` > ``kernel_bytes``, and a share of at most
    1.05 (more is impossible: the count would be wrong).  ``captured`` is
    ``_captured_cost``'s reading of the step.  -> a dict."""
    from repro_torch.launch import analysis

    cost, shapes, expect = captured
    peak = analysis.PEAK_FLOPS_F32
    terms = analysis.roofline_terms(cost.flops, cost.mem_bytes, 0.0, 1, peak_flops=peak)
    step_s = step_ms * 1e-3
    active = analysis.active_param_count(state["params"], session.model)
    n_tokens = int(batch["tokens"].numel())
    model_flops = analysis.model_flops_reference(active, n_tokens, "train")
    out = {"flops": cost.flops, "mem_bytes": cost.mem_bytes, "kernel_bytes": cost.kernel_bytes,
           "kernel_launches": cost.kernel_launches, "t_compute_ms": terms["t_compute_s"] * 1e3,
           "t_memory_ms": terms["t_memory_s"] * 1e3, "bound_ms": terms["bound_s"] * 1e3,
           "dominant": terms["dominant"], "step_ms": step_ms,
           "share": terms["bound_s"] / step_s, "active_params": active, "tokens": n_tokens,
           "model_flops": model_flops, "mfu": model_flops / (step_s * peak)}
    print(f"[{tag}] roofline (NVIDIA H100 SXM peaks: {peak / 1e12:.0f} TFLOP/s f32, "
          f"{analysis.HBM_BW / 1e12:.2f} TB/s; card: {card}): step_cost {cost.flops / 1e12:.4f} "
          f"TFLOP, mem_bytes {cost.mem_bytes / 1e9:.4f} GB of which kernel_bytes "
          f"{cost.kernel_bytes / 1e9:.4f} GB in {cost.kernel_launches} launches; t_compute "
          f"{out['t_compute_ms']:.2f} ms, t_memory {out['t_memory_ms']:.2f} ms, bound "
          f"{out['bound_ms']:.2f} ms ({terms['dominant']}), step {step_ms:.2f} ms: share "
          f"{out['share']:.3f}; MFU {out['mfu']:.4f} (6·N·D, N {active / 1e9:.4f} B active, "
          f"D {n_tokens} tokens)")
    check(cost.kernel_bytes == expect and cost.kernel_launches == len(shapes),
          f"kernel_bytes {cost.kernel_bytes} in {cost.kernel_launches} launches, the helpers "
          f"give {expect} over {len(shapes)} captured launches")
    check(cost.mem_bytes > cost.kernel_bytes, f"mem_bytes {cost.mem_bytes} <= kernel_bytes")
    check(out["share"] <= 1.05, f"bound / step {out['share']:.3f} > 1.05: the count is wrong")
    return out


def _step_timing(torch, session, fit, batches, warm, n_prof, tag, card, flops=None,
                 launches=None):
    """Step time on CUDA events around each synchronised step of
    ``batches`` (the median after the first ``warm``) and its FLOP rate,
    then ``n_prof`` steps under the profiler: wall, device busy time, idle
    share, the bank kernel's share and the largest kernels.  The steps
    continue ``fit["state"]``, which ``fit`` alone holds: at full width a
    second live state beside a step's update may not fit the card.
    ``flops`` is (FLOP a step, what they count); by default
    ``step_cost``'s.  ``step_cost`` is read in any case, for the roofline
    (``_step_roofline``); ``launches``, where given, is its kernel launches
    a step."""
    times = []
    for batch in batches:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fit["state"], _ = session.step(fit["state"], batch)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    step_ms = statistics.median(times[warm:])
    captured = _captured_cost(session, fit["state"], batches[0])
    cost = captured[0]
    check(launches is None or cost.kernel_launches == launches,
          f"step_cost saw {cost.kernel_launches} launches, expected {launches}")
    if flops is None:
        flops = (cost.flops, f"step_cost {cost.flops / 1e12:.4f} TFLOP ({cost.kernel_launches} "
                             "kernel launches in it)")
    prof = {"step_ms": step_ms, "step_ms_all": times, "tflop_per_step": flops[0] / 1e12,
            "tflop_s": flops[0] / (step_ms * 1e-3) / 1e12}
    print(f"[{tag}] dfa step: {step_ms:.2f} ms median of {len(times) - warm} steps (CUDA events, "
          f"synchronised steps; all: {', '.join(f'{x:.1f}' for x in times)}); {flops[1]}, "
          f"{prof['tflop_s']:.1f} TFLOP/s; card: {card}")
    prof["roofline"] = _step_roofline(session, fit["state"], batches[0], step_ms, tag, card,
                                      captured)
    wall_p, by_name = _profile_steps(torch, session, fit, batches[:n_prof])
    if not by_name:
        print(f"[{tag}] device busy time not measured (the profiler traced no device kernels)")
        return prof
    busy = sum(by_name.values()) / n_prof
    bank = by_name.get("photonic_matmul", 0.0) / n_prof
    prof.update(wall_ms=wall_p / n_prof, busy_ms=busy, idle_share=1 - busy * n_prof / wall_p,
                bank_ms=bank)
    print(f"[{tag}] profile of {n_prof} steps: wall {wall_p / n_prof:.2f} ms/step, device busy "
          f"{busy:.2f} ms/step, idle share {prof['idle_share']:.3f}; the bank kernel "
          f"{bank:.3f} ms/step ({bank / busy:.1%} of busy)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{tag}]   {ms / n_prof:9.3f} ms/step  {ms / wall_p:6.1%} of wall  {name}")
    return prof


def _emu_fit(torch, em, make_session, gen, steps, per_step, tag, timing_tag, card, draws,
             label, per_shape=False):
    """``steps`` dfa fit steps of the emulated-bank session that
    ``make_session`` builds (emu_offchip, drift on), the emu kernel's count
    set to 0 just before: ``per_step`` launches a step and a finite loss;
    the first launch (block 0 of the first step) bit for bit against the
    plain version on its own operands, and the kernel timed at that shape
    beside its plain version and its bound.  ``per_shape``: the first
    launch of every other (a_t, δ) shape too, bit for bit under every plan
    of the forced grid.  The session is freed before the checks."""
    peaks = card_peaks(card)[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    emu = make_session()
    d_model, every = emu.model.cfg.d_model, emu.config.recalibrate_every
    ecalls = []
    restore = _wrap(em, "emu_bank_product_cuda", ecalls, limit=1,
                    key=(lambda a_t, delta, mask: (tuple(a_t.shape), tuple(delta.shape)))
                    if per_shape else None)
    try:
        sync(torch)
        em.launches = 0
        t0 = time.perf_counter()
        metrics = emu.fit(gen.batch, total_steps=steps, verbose=False)[1]
        sync(torch)
        wall = time.perf_counter() - t0
        launches = em.launches
    finally:
        restore()
    host = emu.trainer.to_host(metrics)
    del emu, metrics
    torch.cuda.empty_cache()
    print(f"[{tag}] emu_offchip (drift on, recalibration every {every}): {steps} dfa steps in "
          f"{wall:.2f}s, loss {host['loss']:.4f}, hw_residual_rms "
          f"{host.get('hw_residual_rms', float('nan')):.5f}; emu_bank_product launches "
          f"{launches} = {launches / steps:g} per step")
    check(launches == per_step * steps, f"{launches} emu launches, expected {per_step} per step")
    check(math.isfinite(host["loss"]), "emu: non-finite loss")
    n_plans = 0
    for (a_t, delta, mask), kw, out in ecalls[1:]:
        expect = em.emu_bank_product_plain(a_t, delta, mask, **kw)
        plans = _emu_candidates(em, a_t, delta, mask)
        for plan in plans:
            _emu_exact(torch, em, em.launch_kernel(a_t, delta, mask, plan=plan, **kw), expect,
                       kw, f"{label}'s a_t {tuple(a_t.shape)} {plan.name}")
        n_plans += len(plans)
        print(f"[{tag}] the first launch at a_t {tuple(a_t.shape)}, δ {tuple(delta.shape)}: "
              f"kernel equals the plain version bit for bit under {len(plans)} plans")
    (a_t, delta, mask), kw, out = ecalls[0]
    del ecalls
    plan = em.plan_for(a_t, delta, mask)
    t0 = time.perf_counter()
    expect = em.emu_bank_product_plain(a_t, delta, mask, **kw)
    sync(torch)
    plain_s = time.perf_counter() - t0
    err = _emu_exact(torch, em, out, expect, kw,
                     f"{label}'s block 0 a_t {tuple(a_t.shape)} {plan.name}")
    print(f"[{tag}] block 0 of the first step: a_t {tuple(a_t.shape)} {a_t.dtype}, δ "
          f"{tuple(delta.shape)}, {kw['n_panels']} slots, σ {kw['sigma']:.4f}, shot "
          f"{kw['shot']}, ADC {kw['adc_bits']} bits; plan {plan.name}; kernel equals the plain "
          f"version bit for bit (max |Δ| {err:.1e}; plain version {plain_s:.2f}s)")
    row = _time_fns(torch, {"ms": lambda: em.emu_bank_product_cuda(a_t, delta, mask, **kw)},
                    {"ms": 25})
    # the plain version on CUDA events only, one call after one warm-up, as
    # path B's (phase_emu_timing)
    row["plain_ms"] = _event_ms(
        torch, lambda: em.emu_bank_product_plain(a_t, delta, mask, **kw), reps=1, warm=1)
    row["bound_ms"], row["bound_by"], binding, terms = emu_bound(
        (a_t, delta, mask, kw["n_panels"]), kw["sigma"], kw["shot"], peaks, draws["emu"], sms)
    row.update(library_ms=None, plan=plan.name, launches_per_step=per_step,
               shape=[a_t.shape[0], d_model, d_model], n_panels=kw["n_panels"],
               bound_share=row["bound_ms"] / row["dev_ms"],
               terms_ms={name: v * 1e3 for name, v in terms.items()})
    print(f"[{timing_tag}] emu_bank_product at {label}'s (T, K, M) = ({a_t.shape[0]}, {d_model}, "
          f"{d_model}) f32: kernel {row['ms']:.4f} / {row['dev_ms']:.4f} ms (events / device), "
          f"plain {row['plain_ms']:.4f} (events), bound {row['bound_ms']:.4f} ({binding}: bytes "
          f"{terms['bytes'] * 1e3:.5f} / f32 {terms['f32'] * 1e3:.5f} / prng "
          f"{terms['prng'] * 1e3:.5f}), share {row['bound_share']:.1%}, plan {plan.name}; "
          f"{per_step} a step: {row['dev_ms'] * per_step:.3f} ms device; card: {card}")
    del a_t, delta, mask, out, expect
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": err, "wall_s": wall, "loss": host["loss"],
            "row": row, "other_shape_plans": n_plans}


def _bank_row(torch, pm, a, b, kw, peaks, noise, tag, label, reps=None):
    """The bank kernel, its plain version and torch.matmul on (a, b) with
    ``kw``, beside the bound, printed as a ``[tag]`` row after ``label``."""
    t, k, m = a.shape[0], a.shape[1], b.shape[0]
    dtype_name = "bfloat16" if a.dtype == torch.bfloat16 else "float32"
    fns = {"ms": lambda: pm.photonic_matmul_cuda(a, b, **kw),
           "plain_ms": lambda: pm.photonic_matmul_plain(a, b, **kw),
           "library_ms": lambda: torch.matmul(a, b.T)}
    row = dict(t=t, k=k, m=m, dtype=dtype_name, noise=noise,
               **_time_row(torch, fns, bound_ms(t, m, k, dtype_name, peaks, noise=noise),
                           reps=reps),
               variant=pm._plan(t, m, k, a.dtype, (a.data_ptr(), b.data_ptr())).name)
    short = "bf16" if dtype_name == "bfloat16" else "f32"
    _print_row(tag, f"{label}{t:6d} {k:6d} {m:6d} {short:>5s}", row)
    return row


def _decode_rows(torch, pm, shapes, peaks, gen, tag, label, reps=None,
                 what="one decode forward at T=4"):
    """``_bank_row`` at each (T, K, M) of ``shapes`` ({shape: launches a
    forward}; bf16, no noise) and the sums over one forward (``what``)."""
    print(f"[{tag}] {label}     T      K      M  dtype {TIMING_HEAD}")
    rows = []
    for (t, k, m), count in shapes.items():
        a, b = _operands(torch, t, k, m, torch.bfloat16, gen)
        rows.append({**_bank_row(torch, pm, a, b, {}, peaks, "none", tag, label, reps),
                     "count": count})
        del a, b
    keys = ("ms", "dev_ms", "plain_ms", "plain_dev_ms", "library_ms", "library_dev_ms",
            "bound_ms")
    forward = {key: sum(r[key] * r["count"] for r in rows) for key in keys}
    forward.update(launches=sum(r["count"] for r in rows), bound_by="bytes" if all(
        r["bound_by"] == "bytes" for r in rows) else "operations")
    print(f"[{tag}] {label.strip() + ': ' if label else ''}{what} "
          f"({forward['launches']} launches), ms: "
          + ", ".join(f"{key} {forward[key]:.4f}" for key in keys))
    torch.cuda.empty_cache()
    return rows, forward


def phase_lm_train(torch, np, api, pm, em, seed, card, draws):
    """DFA training of qwen1.5-0.5b at full width: 16 fit steps on
    offchip_bpd (finite loss at every step, a fixed batch's loss falls, 25
    bank-kernel launches a step, peak memory); block 0's and the
    embedding's δ against the plain version on the step's own operands
    (and in prng mode against the plain twin); ideal cuda vs ref
    gradients; one bp, dfa-fused and dfa-layerwise step; step time and a
    profile; the bank kernel at (4096, 1024, 1024) beside its plain
    version, torch.matmul and its bound; 2 steps on emu_offchip with the
    emu kernel held bit for bit on a step's own operands and timed; crash
    and resume of the smoke LM on the card."""
    import shutil

    from repro_torch import algos
    from repro_torch.core import photonics as ph
    from repro_torch.data import tokens
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
    fit = _fit_logged(torch, pm, session, gen, LM_STEPS, log)
    launches, losses, state = fit["launches"], fit["losses"], fit["state"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        ce1 = model.loss(state["params"], fixed)[1]["ce_loss"].item()
    print(f"[lm_train] qwen1.5-0.5b full width f32 ({n_params / 1e6:.1f} M parameters), "
          f"offchip_bpd, cuda backend, batch {LM_BATCH} x seq {LM_SEQ}: {LM_STEPS} fit steps in "
          f"{fit['wall']:.2f}s; loss per step {', '.join(f'{x:.4f}' for x in losses)}; fixed "
          f"batch ce_loss {ce0:.4f} -> {ce1:.4f}; photonic_matmul launches {launches} = "
          f"{launches / LM_STEPS:g} per step; peak device memory {peak_gib:.2f} GiB")
    _check_fit(fit, LM_STEPS, LM_LAUNCHES)
    check(ce1 < ce0, f"the fixed batch's loss did not fall: {ce0} -> {ce1}")

    # one step's own operands: block 0 and the embedding against the plain
    # version, block 0 in prng mode against the plain twin
    calls, errs, step, ((loss, _), grads) = _step_projections(
        torch, pm, session, state, gen, seed, LM_LAUNCHES, LM_BATCH * LM_SEQ, "lm_train")
    batch, rng = step
    params, fb, dcfg = state["params"], state["fb"], session.config.dfa
    (a, b), kw, _ = calls[0]
    nk = math.ceil(a.shape[1] / pm.BLOCK_K)
    step_sigma = ph.noise_sigma_total(a.shape[1], 1.0, 1.0, dcfg.photonics) / math.sqrt(nk)
    key0 = prng.fold(prng.fold(rng, "blocks"), 0)
    got = pm.photonic_matmul_cuda(a, b, seed=key0, sigma_step=step_sigma)
    twin = pm.photonic_matmul_plain(a, b, seed=key0, sigma_step=step_sigma)
    prng_err = (got - twin).abs().max().item()
    check(prng_err <= TOL["float32"] * twin.abs().max().item() + 1e-6,
          f"prng mode kernel vs plain twin at the LM shape: {prng_err}")
    print(f"[lm_train] block 0 in prng mode (T={a.shape[0]}, K={a.shape[1]}, M={b.shape[0]}): "
          f"max |kernel - plain twin| {prng_err:.3e}")
    del got, twin

    # ideal: the cuda backend against the ref backend, every gradient
    _ideal_cuda_vs_ref(torch, session, state, step, "lm_train")

    # one bp, dfa-fused and dfa-layerwise step at full width
    fused = algos.get("dfa-fused").fused_step(model, dcfg, session.config.optimizer)
    p_f, opt_f, loss_f = fused(params, fb, state["opt"], batch, rng)
    p_u, opt_u, _ = session.config.optimizer.update(grads, state["opt"], params)
    worst_p = max(_max_rel(p_f[k], p_u[k]) for k in p_u)
    worst_m = max((opt_f["mom"][k] - opt_u["mom"][k]).abs().max().item() for k in p_u)
    del p_f, opt_f, p_u, opt_u, grads, fused
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
    del state, params, fb, batch, step
    torch.cuda.empty_cache()

    # step time (CUDA events) and three steps under the profiler
    batches = [to_device_batch(gen.batch(i)) for i in range(LM_STEPS, LM_STEPS + 8)]
    flops = _lm_step_flops(cfg, LM_BATCH * LM_SEQ)
    prof = _step_timing(torch, session, fit, batches, 2, 3, "lm_train", card, flops=(
        flops, f"matrix products {flops / 1e12:.2f} TFLOP a step (f32 bound "
               f"{flops / peaks['float32'] * 1e3:.1f} ms at {peaks['float32'] / 1e12:.0f} "
               "TFLOP/s)"), launches=LM_LAUNCHES)
    step_ms = prof["step_ms"]

    # the bank kernel at the LM shape: the path's input mode and prng mode
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
    del calls, session, model, fit, batches, a, b, noise, kw
    torch.cuda.empty_cache()

    # emu_offchip: 4 steps through the emulated banks
    emu = _emu_fit(torch, em, lambda: _lm_session(api, torch, seed, hardware="emu_offchip",
                                                   backend="emu"),
                   gen, LM_EMU_STEPS, LM_LAUNCHES, "lm_emu", "lm_timing", card, draws,
                   "the LM step")

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
    return {"launches": launches, "emu_launches": emu["launches"],
            "max_abs_err": max(errs.values()), "max_abs_err_prng": prng_err,
            "emu_max_abs_err": emu["max_abs_err"], "bank": bank_rows, "emu": emu["row"],
            "profile": prof, "peak_gib": peak_gib}


# ---------------------------------------------------------------------------
# Data parallelism: a world of one over NCCL, two ranks on the one card over gloo
# ---------------------------------------------------------------------------

DP_WORLD = 2  # ranks on the one card, over gloo (NCCL refuses two ranks on one device)
# the two-rank LM parts (data parallel, FSDP, dense tensor parallel) run
# qwen1.5-0.5b's full width at 8 of its 24 layers: they move GBs through gloo
# and host memory, the script's most load-sensitive work
DP_LAYERS = 8
DP_LAUNCHES = DP_LAYERS + 1  # bank products a dfa step: the blocks' and the embedding's
DP_STEPS = 2  # fit steps of the two-rank run; it saves at the last and runs one more
DP_TOL = 1e-5  # of each leaf's max |value|: step-1 gradients, parameters after a step
DP_LOCAL_MIN = 1e-3  # a rank drawing rank-local noise misses the one-process step by more
DP_MLP_BATCH = 64  # the emu MLP step's rows, 32 a rank
# (T, K, M, buses) of the emu kernel's row-base check: path A's projection
# (64 rows, the error's 10 columns -> 800) and an LM projection on 2 buses
DP_ROW_SHAPES = [(64, 10, 800, 1), (256, 1024, 1024, 2)]
DP_TIMEOUT_S = 600.0  # the two ranks' run, set-up included


def _dp_arch(torch):
    """qwen1.5-0.5b's full width in f32 at DP_LAYERS layers, as an ``Arch``
    that ``build_train`` takes."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.transformer import TransformerLM

    cfg = dataclasses.replace(_meta_model(torch, ARCH, torch.float32).cfg, n_layers=DP_LAYERS)

    def make_model(dtype=torch.float32, device=None):
        return TransformerLM(dataclasses.replace(cfg, dtype=dtype), device=device)

    return dataclasses.replace(configs.get(ARCH), make_model=make_model)


def _dp_model(torch, seed):
    """``_dp_arch``'s model on the card, its weights from ``seed`` (as
    ``api.build_model`` draws them)."""
    return _dp_arch(torch).make_model(torch.float32, device=DEVICE).init(seed)


def _dp_world_one(torch, api, pm, seed):
    """qwen1.5-0.5b at full width, f32, offchip_bpd: two dfa steps with
    data_parallel=True (a world of one NCCL rank, made by the trainer) and
    with data_parallel=False; the losses and parameters must be equal bit
    for bit, 25 bank launches a step each."""
    import torch.distributed as dist

    from repro_torch.data import tokens

    runs = {}
    try:
        for dp in (True, False):
            gc.collect()
            torch.cuda.empty_cache()
            session = _lm_session(api, torch, seed, data_parallel=dp)
            if dp:
                check(session.config.dfa == _fsdp_dfa(),
                      "the sharded step's DFAConfig is not the session's")
            gen = tokens.MarkovTokens(session.model.cfg.vocab_size, LM_SEQ, LM_BATCH, seed)
            batches = [gen.batch(i) for i in range(2)]
            if dp:
                check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
                      and tuple(session.mesh.shape) == (1, 1),
                      f"not a world of one NCCL rank: {session.mesh}")
            state = session.init_state()
            losses, step_ms = [], []
            sync(torch)
            pm.launches = 0
            for batch in batches:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                state, metrics = session.step(state, batch)
                e1.record()
                losses.append(metrics["loss"].item())
                e1.synchronize()
                step_ms.append(e0.elapsed_time(e1))
            runs[dp] = {"losses": losses, "launches": pm.launches, "step_ms": step_ms,
                        "params": {k: v.cpu() for k, v in state["params"].items()},
                        "mom": {k: v.cpu() for k, v in state["opt"]["mom"].items()}}
            del session, state, metrics
            if dp:  # the sharded step on the same NCCL world of one
                gc.collect()
                torch.cuda.empty_cache()
                runs["fsdp"] = _fsdp_world_one(torch, pm, seed, batches)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    one, many = runs[False], runs[True]
    same = one["losses"] == many["losses"] and all(
        torch.equal(one["params"][k], many["params"][k]) for k in one["params"])
    print(f"[dp] world of one over NCCL (data_parallel=True, no launcher): qwen1.5-0.5b full "
          f"width f32, offchip_bpd, batch {LM_BATCH} x seq {LM_SEQ}, 2 dfa steps, losses "
          f"{', '.join(f'{x:.6f}' for x in many['losses'])}, step ms (CUDA events; the first "
          f"starts NCCL) {', '.join(f'{x:.2f}' for x in many['step_ms'])}, "
          f"{many['launches']} bank launches; one process "
          f"{', '.join(f'{x:.6f}' for x in one['losses'])}, "
          f"{', '.join(f'{x:.2f}' for x in one['step_ms'])} ms, {one['launches']}; losses and "
          f"parameters bit for bit: {same}")
    check(same, "the world-of-one data-parallel steps differ from the single-device steps")
    check(many["launches"] == one["launches"] == 2 * LM_LAUNCHES,
          f"bank launches {many['launches']} / {one['launches']}, expected {2 * LM_LAUNCHES}")
    fsdp = runs["fsdp"]
    fsdp_same = fsdp["losses"] == one["losses"] and all(
        torch.equal(one["params"][k], fsdp["params"][k])
        and torch.equal(one["mom"][k], fsdp["mom"][k]) for k in one["params"])
    print(f"[fsdp] world of one over NCCL: build_train's sharded step on a (1, 1) mesh, 2 "
          f"steps, losses {', '.join(f'{x:.6f}' for x in fsdp['losses'])}, step ms (CUDA "
          f"events) {', '.join(f'{x:.2f}' for x in fsdp['step_ms'])}, bank launches "
          f"{fsdp['launches']}; losses, parameters and momentum = the single-device steps' bit "
          f"for bit: {fsdp_same}")
    check(fsdp_same, "the world-of-one sharded steps differ from the single-device steps")
    check(fsdp["launches"] == [LM_LAUNCHES] * 2,
          f"the sharded step's bank launches {fsdp['launches']}, expected {LM_LAUNCHES} a step")
    return {"bit_for_bit": same, "launches": many["launches"], "losses": many["losses"],
            "step_ms": many["step_ms"], "one_process_step_ms": one["step_ms"],
            "fsdp_bit_for_bit": fsdp_same, "fsdp_launches": sum(fsdp["launches"]),
            "fsdp_step_ms": fsdp["step_ms"]}


def _dp_row_base(torch, em):
    """The emu kernel on rows [r, T) of a batch with row_base = r, under the
    planner's plan and every candidate plan, against its plain version and
    against rows [r, T) of a row_base = 0 launch over the whole batch under
    every plan: bit for bit."""
    from repro_torch.core import photonics as ph
    from repro_torch.hardware import channel, mrr

    rows_out = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for t, k, m, q in DP_ROW_SHAPES:
        cfg = ph.PhotonicConfig(noise_std=0.202, n_buses=q,
                                mrr=mrr.MRRConfig(adc_bits=8, shot_noise=0.05))
        g = torch.Generator(device=DEVICE).manual_seed(t + k + m)
        a = torch.rand((t, k), generator=g, device=DEVICE) * 2 - 1
        b = torch.rand((m, k), generator=g, device=DEVICE) * 2 - 1
        a_t, b_t, n_panels = channel.tile_operands(a, b, cfg)
        delta = channel.effective_deltas(b_t, cfg).contiguous()
        mask = channel.alive_dead_ring_mask(cfg, DEVICE)
        kw = dict(n_panels=n_panels, gamma=float(cfg.mrr.gamma), sigma=0.202, shot=0.05,
                  adc_bits=8, amax=float(cfg.bank_cols), seed=EMU_SEED)
        r = t // 2
        part = a_t[r:].contiguous()
        _t, qb, nj, cols = a_t.shape
        nm, _q, rows, _nj, _c = delta.shape
        ptrs = em._pointers(delta, mask)
        plain = em.emu_bank_product_plain(part, delta, mask, row_base=r, **kw)
        bad, plans = [], 0
        for plan in em.candidate_plans(t - r, nm, rows, qb, nj, cols, ptrs, sms):
            plans += 1
            if not torch.equal(em.launch_kernel(part, delta, mask, plan=plan, row_base=r, **kw),
                               plain):
                bad.append(f"part {plan.name}")
        for plan in em.candidate_plans(t, nm, rows, qb, nj, cols, ptrs, sms):
            plans += 1
            whole = em.launch_kernel(a_t, delta, mask, plan=plan, **kw)
            if not torch.equal(whole[r:], plain):
                bad.append(f"whole {plan.name}")
        sync(torch)
        print(f"[dp] emu kernel row_base: (T={t}, K={k}, M={m}, {q} bus{'es' * (q > 1)}) rows "
              f"[{r}, {t}) with row_base={r}: {plans} launches under every candidate plan, "
              f"= the plain version and rows [{r}, {t}) of the row_base=0 launches bit for bit: "
              f"{not bad}")
        check(not bad, f"row_base launches differ: {bad}")
        rows_out.append({"shape": [t, k, m, q], "row_base": r, "plans": plans})
    return rows_out


def _tp_col_base(torch, em):
    """The emu kernel on panels [p, nm) of delta with col_base = p·rows
    (and rows [r, T) of a_t with row_base = r), a tensor-parallel rank's
    columns, under the planner's plan and every candidate plan, against its
    plain version and against those rows and columns of the col_base = 0
    launch over the whole product under every plan: bit for bit."""
    from repro_torch.core import photonics as ph
    from repro_torch.hardware import channel, mrr

    out = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for t, k, m, q in DP_ROW_SHAPES:
        cfg = ph.PhotonicConfig(noise_std=0.202, n_buses=q,
                                mrr=mrr.MRRConfig(adc_bits=8, shot_noise=0.05))
        g = torch.Generator(device=DEVICE).manual_seed(t + k + m + 1)
        a = torch.rand((t, k), generator=g, device=DEVICE) * 2 - 1
        b = torch.rand((m, k), generator=g, device=DEVICE) * 2 - 1
        a_t, b_t, n_panels = channel.tile_operands(a, b, cfg)
        delta = channel.effective_deltas(b_t, cfg).contiguous()
        mask = channel.alive_dead_ring_mask(cfg, DEVICE)
        kw = dict(n_panels=n_panels, gamma=float(cfg.mrr.gamma), sigma=0.202, shot=0.05,
                  adc_bits=8, amax=float(cfg.bank_cols), seed=EMU_SEED)
        _t, qb, nj, cols = a_t.shape
        nm, _q, rows, _nj, _c = delta.shape
        r, panel = t // 2, nm // 2
        c0 = panel * rows
        a_part, d_part = a_t[r:].contiguous(), delta[panel:].contiguous()
        plain = em.emu_bank_product_plain(a_part, d_part, mask, row_base=r, col_base=c0, **kw)
        bad, plans = [], 0
        ptrs = em._pointers(d_part, mask)
        for plan in em.candidate_plans(t - r, nm - panel, rows, qb, nj, cols, ptrs, sms):
            plans += 1
            got = em.launch_kernel(a_part, d_part, mask, plan=plan, row_base=r, col_base=c0,
                                   **kw)
            if not torch.equal(got, plain):
                bad.append(f"part {plan.name}")
        for plan in em.candidate_plans(t, nm, rows, qb, nj, cols, em._pointers(delta, mask),
                                       sms):
            plans += 1
            whole = em.launch_kernel(a_t, delta, mask, plan=plan, **kw)
            if not torch.equal(whole[r:, c0:], plain):
                bad.append(f"whole {plan.name}")
        sync(torch)
        print(f"[tp] emu kernel col_base: (T={t}, K={k}, M={m}, {q} bus{'es' * (q > 1)}) rows "
              f"[{r}, {t}) and columns [{c0}, {nm * rows}) (panels [{panel}, {nm}) of {rows}) "
              f"with row_base={r}, col_base={c0}: {plans} launches under every candidate plan, "
              f"= the plain version and those rows and columns of the col_base=0 launches bit "
              f"for bit: {not bad}")
        check(not bad, f"col_base launches differ: {bad}")
        out.append({"shape": [t, k, m, q], "row_base": r, "col_base": c0, "plans": plans})
    return out


def _dp_rank(rank, world, port, seed, base, queue):
    """One rank of the two-rank run (a spawned process): its results, or its
    traceback, go to ``queue``; a failure then re-raises, so the rank exits
    nonzero."""
    import traceback

    try:
        queue.put((rank, _dp_rank_work(rank, world, port, seed, base), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


def _dp_rank_work(rank, world, port, seed, base):
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import api
    from repro_torch.kernels import photonic_matmul as pm

    # the kernels load the library phase_build built (its file exists, so
    # no rank runs nvcc)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    t0 = time.perf_counter()
    try:
        out = _dp_lm_rank(torch, api, pm, rank, seed, base)
        t1 = time.perf_counter()
        out.update(_dp_emu_rank(torch, api, rank, seed))
        t2 = time.perf_counter()
        out.update(_fsdp_lm_rank(torch, api, pm, rank, seed))
        out.update(_fsdp_emu_rank(torch, api, rank, seed))
        t3 = time.perf_counter()
        out.update(_tp_lm_rank(torch, api, pm, rank, seed))
        t4 = time.perf_counter()
        out.update(_fsdp_emu_rank(torch, api, rank, seed, model_axis=TP_MESH[1]))
        out.update(_tp_emu_window(torch, rank))
        t5 = time.perf_counter()
        out.update(_tp_family_rank(torch, api, pm, rank, seed, "moe"))
        t6 = time.perf_counter()
        out.update(_tp_family_rank(torch, api, pm, rank, seed, "mla"))
        out["seconds"] = {"lm": t1 - t0, "emu": t2 - t1, "fsdp": t3 - t2, "tp": t4 - t3,
                          "tp_emu": t5 - t4, "tp_moe": t6 - t5,
                          "tp_mla": time.perf_counter() - t6}
        peer = out.pop("peer")  # rank 1's first projection's noise rows and s_a, to rank 0
        for t in peer:
            dist.broadcast(t, src=1)
    finally:
        dist.destroy_process_group()
    # the one-process checks: step 1 and 2 steps on rank 0, the resume on
    # rank 1, side by side
    t1 = time.perf_counter()
    if rank == 0:
        out["noise"] = (out["noise"], peer[0].cpu())
        out["s_a"] = (out["s_a"], peer[1].item())
        out.update(_dp_one_process(torch, api, seed, out))
    else:
        out.update(_dp_resume(torch, api, seed, base, out))
    out["seconds"]["one_process"] = time.perf_counter() - t1
    for key in ("grads", "local", "params2", "params3", "noise", "emu_grads", "fsdp_grads",
                "fsdp_control", "fsdp_params2", "fsdp_emu_params", "tp_grads", "tp_params2",
                "tp_emu_params"):
        out.pop(key, None)  # tensors stay in the rank
    return out


def _dp_capture(ph, pm, store):
    """Record the first bank-kernel launch's input-mode noise and the first
    s_a of a step -> the function that restores both."""
    launch, normalise = pm.photonic_matmul_cuda, ph.normalise_operands

    def launch_rec(a, b, **kw):
        if "noise" not in store:
            store["noise"] = kw["noise"].detach().cpu()
        return launch(a, b, **kw)

    def normalise_rec(a, b, cfg):
        out = normalise(a, b, cfg)
        store.setdefault("s_a", out[2].detach().clone())
        return out

    pm.photonic_matmul_cuda, ph.normalise_operands = launch_rec, normalise_rec

    def restore():
        pm.photonic_matmul_cuda, ph.normalise_operands = launch, normalise

    return restore


def _dp_lm_rank(torch, api, pm, rank, seed, base):
    """This rank's share of the full-width LM: a 2-step fit that saves at
    step 2 (step 1's gradients, its first projection's noise and s_a
    captured; step ms and the gradient all-reduce's ms on CUDA events),
    step 3's gradients with rank-local noise (rank 0 profiled), and step 3."""
    import contextlib

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import photonics as ph
    from repro_torch.data import tokens
    from repro_torch.dist import sharding
    from repro_torch.kernels import ops
    from repro_torch.utils import flop_cost, prng

    session = _lm_session(api, torch, seed, arch=_dp_model(torch, seed), data_parallel=True,
                          ckpt_dir=str(base / "lm"))
    trainer = session.trainer
    gen = tokens.MarkovTokens(session.model.cfg.vocab_size, LM_SEQ, LM_BATCH, seed)
    rows = trainer.put(gen.batch(0)).rows
    check(tuple(rows) == (rank * LM_BATCH // DP_WORLD, LM_BATCH // DP_WORLD, LM_BATCH),
          f"rank {rank} holds rows {rows}")
    # the fit, with step 1's gradients and its first projection's operands
    # kept, each step and each large all-reduce timed on CUDA events
    cap, first, steps, reduces = {}, {}, [], []
    step_fn, grads_fn, mean = trainer._step_fn, trainer._grads, sharding.all_reduce_mean

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed_step(state, batch):
        e0, e1 = events()
        e0.record()
        result = step_fn(state, batch)
        e1.record()
        e1.synchronize()
        steps.append(e0.elapsed_time(e1))
        return result

    def first_grads(*args):
        out = grads_fn(*args)
        if not first:
            (loss, _), grads = out
            first.update(loss=loss.item(), grads={k: v.cpu() for k, v in grads.items()}
                         if rank == 0 else None)
            restore()  # the capture sees step 1 only
        return out

    def timed_mean(tensors, group, world, *args, **kw):
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        if nbytes < 1 << 24:
            return mean(tensors, group, world, *args, **kw)
        e0, e1 = events()
        e0.record()
        result = mean(tensors, group, world, *args, **kw)
        e1.record()
        e1.synchronize()
        reduces.append((e0.elapsed_time(e1), nbytes))
        return result

    restore = _dp_capture(ph, ops, cap)  # ops calls the bank kernel's wrapper
    trainer._step_fn, trainer._grads, sharding.all_reduce_mean = \
        timed_step, first_grads, timed_mean
    try:
        pm.launches = 0
        t0 = time.perf_counter()
        state2, _ = session.fit(gen.batch, DP_STEPS, verbose=False)
        fit_s = time.perf_counter() - t0
        fit_launches = pm.launches
    finally:
        restore()
        trainer._step_fn, sharding.all_reduce_mean = step_fn, mean
        del trainer._grads
    out = {"loss1": first["loss"], "grads": first["grads"], "noise": cap["noise"],
           "s_a": cap["s_a"].item(), "fit_launches": fit_launches, "fit_s": fit_s}
    # step 3's gradients with rank-local noise (the group's s_a, this rank's
    # own draw); rank 0 profiles it (again, up to 3 times, where the profiler
    # missed launches at the start of its window), both ranks repeat it
    batch3, rng3 = trainer.put(gen.batch(DP_STEPS)), prng.step_key(seed, DP_STEPS, "noise")
    trainer._window = lambda rows: ph.RowWindow(0, rows.count, rows.count, trainer._group)
    try:
        for _attempt in range(3):
            local = None
            pm.launches = 0
            with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                  if rank == 0 else contextlib.nullcontext()) as prof:
                time.sleep(0.05)
                (_, _), local = trainer._grads(state2["params"], state2["fb"], batch3, rng3)
                sync(torch)
            grad_launches = pm.launches
            profiled = (sum(any(part in e.name for part in KERNEL_PARTS["photonic_matmul"])
                            for e in _device_kernels(torch, prof)) if rank == 0 else None)
            done = torch.tensor([rank != 0 or profiled >= DP_LAUNCHES], device=DEVICE)
            dist.broadcast(done, src=0)
            if done.item():
                break
    finally:
        del trainer._window
    out.update(local={k: v.cpu() for k, v in local.items()} if rank == 1 else None,
               grad_launches=grad_launches, profiled=profiled)
    del local
    trainer._step_fn = timed_step
    try:  # step 3 counted by step_cost's collective bytes (its ms include the counting)
        (state3, metrics3), cost = flop_cost.measure(session.step, state2,
                                                     gen.batch(DP_STEPS))
    finally:
        trainer._step_fn = step_fn
    trainer.check_replicas(state3)  # rank 1's step 3 is rank 0's
    out.update(step_ms=steps, reduce=reduces, loss3=metrics3["loss"].item(),
               dp_cost={"counted": dict(cost.coll_bytes_by_kind),
                        "count": dict(cost.coll_count_by_kind),
                        "grads": sum(v.numel() * v.element_size()
                                     for v in state2["params"].values())})
    if rank == 0:
        out["params2"] = {k: v.cpu() for k, v in state2["params"].items()}
    else:
        out["params3"] = {k: v.cpu() for k, v in state3["params"].items()}
    out["peer"] = [torch.zeros(cap["noise"].shape, device=DEVICE) if rank == 0
                   else cap["noise"].to(DEVICE),
                   torch.tensor([out["s_a"]], device=DEVICE)]
    del session, trainer, state2, state3, metrics3
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _dp_mlp_batch(seed):
    from repro_torch.data import mnist

    x, y = mnist.procedural_digits(DP_MLP_BATCH, seed=seed)
    return {"x": x, "y": y}


def _dp_emu_session(api, seed, data_parallel):
    return api.build_session(arch="mnist_mlp", hardware="emu_offchip", backend="emu",
                             seed=seed, data_parallel=data_parallel, log_every=10**9,
                             device=DEVICE)


def _dp_emu_grads(torch, session, batch):
    """-> (loss, gradients, the emu kernel's launches) of one step's
    gradients at the initial hardware state, the hardware state after one
    step and the parameters after it."""
    from repro_torch.hardware import drift
    from repro_torch.kernels import emu_matmul as em

    state = session.init_state()
    em.launches = 0
    with drift.use_state(state["hw"]):
        (loss, _), grads = session.trainer._grads(state["params"], state["fb"],
                                                  session.trainer.put(batch), 7)
    sync(torch)
    launches = em.launches
    new, _ = session.step(state, batch)
    return (loss.item(), {k: v.cpu() for k, v in grads.items()}, launches,
            {k: v.cpu().numpy() for k, v in new["hw"].items()},
            {k: v.cpu() for k, v in new["params"].items()})


def _dp_emu_rank(torch, api, rank, seed):
    """The paper's MLP on emu_offchip, 32 rows a rank: one step's gradients
    through the emu kernel (2 launches, its counters from the rank's global
    row) and the hardware state after one step."""
    session = _dp_emu_session(api, seed, True)
    loss, grads, launches, hw, _ = _dp_emu_grads(torch, session, _dp_mlp_batch(seed))
    return {"emu_loss": loss, "emu_grads": grads if rank == 0 else None, "emu_hw": hw,
            "emu_launches": launches}


# ---------------------------------------------------------------------------
# FSDP: launch/dryrun.build_train's sharded step (ZeRO-3 DTensor state)
# ---------------------------------------------------------------------------

FSDP_MLP_TOL = 1e-6  # the emu MLP's sharded step against one process


def _fsdp_dfa():
    """The LM sessions' DFAConfig (``_lm_session``): offchip_bpd through the
    bank kernel."""
    from repro_torch.algos.dfa import DFAConfig
    from repro_torch.core import photonics as ph

    return DFAConfig(photonics=ph.preset("offchip_bpd"), backend="cuda")


def _fsdp_build(torch, mesh, seed, batch, arch=ARCH, dfa=None):
    """``build_train``'s step of ``arch`` at full width in f32 on ``mesh``,
    its parameters and feedback drawn from ``seed`` as a session's, its
    first batch the host ``batch``."""
    from repro_torch.launch import dryrun

    host = {k: torch.as_tensor(v) for k, v in batch.items()}
    return dryrun.build_train(arch, mesh, dfa=dfa or _fsdp_dfa(), dtype=torch.float32,
                              device=DEVICE, seed=seed, batch=host)


def _placed_batch(torch, extra, batch):
    from repro_torch.dist import sharding

    return sharding.place({k: torch.as_tensor(v) for k, v in batch.items()},
                          extra["in_shardings"][3])


def _fsdp_world_one(torch, pm, seed, batches):
    """The sharded step on a (1, 1) mesh of the NCCL world of one: 2 steps
    from the session's seed, with the trainer's noise keys."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.utils import prng

    mesh = mesh_lib.make_host_mesh(1, device_type="cuda")
    fn, (p, fb, o, _, _), extra = _fsdp_build(torch, mesh, seed, batches[0])
    losses, launches, step_ms = [], [], []
    for i, batch in enumerate(batches):
        placed = _placed_batch(torch, extra, batch)
        sync(torch)
        pm.launches = 0
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        p, o, loss = fn(p, fb, o, placed, prng.step_key(seed, i, "noise"))
        e1.record()
        losses.append(loss.to_local().item())
        e1.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        launches.append(pm.launches)
    out = {"losses": losses, "launches": launches, "step_ms": step_ms,
           "params": {k: v.to_local().cpu() for k, v in p.items()},
           "mom": {k: v.to_local().cpu() for k, v in o["mom"].items()}}
    del fn, p, fb, o, extra
    return out


def _rule_piece(full, x):
    """This rank's piece of the whole tensor ``full`` under the ``DTensor``
    ``x``'s placements (the rule's slice on every mesh dim that splits
    it)."""
    mesh = x.device_mesh
    for i, p in enumerate(x.placements):
        if p.is_shard():
            full = full.chunk(mesh.size(i), dim=p.dim)[mesh.get_local_rank(mesh.mesh_dim_names[i])]
    return full


def _timed_collectives(torch, dist, log):
    """Wrap the collectives the sharded step issues (all-gather,
    reduce-scatter, all-reduce) with CUDA events, appending (kind, ms,
    operand bytes) to ``log`` -> the function that restores them."""
    names = {"all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
             "all_reduce": "all-reduce"}
    saved = {n: getattr(dist, n) for n in names}

    def wrap(name):
        fn = saved[name]

        def timed(*args, **kw):
            operand = args[1] if name != "all_reduce" else args[0]
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            e1.synchronize()
            log.append((names[name], e0.elapsed_time(e1), operand.numel() * operand.element_size()))
            return out

        return timed

    for n in names:
        setattr(dist, n, wrap(n))

    def restore():
        for n, fn in saved.items():
            setattr(dist, n, fn)

    return restore


def _collectives_from_leaves(params, metrics) -> dict:
    """The collective bytes a rank's sharded dfa step issues, from its
    placed parameters: each split leaf's shard all-gathered by the forward
    and a block's again by its recompute, each split leaf's whole gradient
    reduce-scattered, the replicated leaves' gradients with the metrics
    mean-all-reduced (the loss is the metrics' "loss": one tensor, reduced
    once; the MAX of each distinct projection operand, 4 B each, comes on
    top)."""
    from repro_torch.dist import sharding

    split = {k for k, x in params.items() if sharding._fsdp_dim(x) is not None}
    local = {k: x.to_local().numel() * x.element_size() for k, x in params.items()}
    full = {k: x.numel() * x.element_size() for k, x in params.items()}
    block = {k for k in params if not k.startswith(("embed.", "head."))}
    return {"all-gather": sum(local[k] * (2 if k in block else 1) for k in split),
            "reduce-scatter": sum(full[k] for k in split),
            "all-reduce": sum(full[k] for k in params if k not in split) + 4 * len(metrics)}


def _fsdp_lm_rank(torch, api, pm, rank, seed):
    """This rank's share of the full-width LM's sharded step on a (2, 1)
    mesh: its shards against an independent init, step 1's gradients
    counted by ``step_cost`` (kept whole on rank 0), the update, the
    control's gradients with DTensor's plain Replicate backward (rank 0's
    shards), step 2 timed with each collective's ms, and the parameters
    after 2 steps (whole, rank 0)."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data import tokens
    from repro_torch.dist import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.utils import flop_cost, prng

    t0 = time.perf_counter()
    mesh = mesh_lib.make_host_mesh(DP_WORLD, device_type="cuda")
    vocab = configs.get(ARCH).make_model(device="meta").cfg.vocab_size
    gen = tokens.MarkovTokens(vocab, LM_SEQ, LM_BATCH, seed)
    fn, (p, fb, o, b0, _), extra = _fsdp_build(torch, mesh, seed, gen.batch(0),
                                               arch=_dp_arch(torch))
    vg, opt = extra["value_and_grad"], extra["trainer"].cfg.optimizer
    full = _dp_model(torch, seed)
    not_rules = [k for k, v in full.named_parameters()
                 if not torch.equal(p[k].to_local(), _rule_piece(v.detach(), p[k]))]
    del full
    gc.collect()
    torch.cuda.empty_cache()
    resident = [sum(x.to_local().numel() * x.element_size() for x in tree.values())
                for tree in (p, o["mom"])]
    released = all(x.is_meta for x in extra["model"].parameters())
    key0, key1 = prng.step_key(seed, 0, "noise"), prng.step_key(seed, 1, "noise")
    sync(torch)
    pm.launches = 0
    ((loss1, metrics), grads), cost = flop_cost.measure(vg, p, fb, b0, key0)
    launches = [pm.launches]
    expect = _collectives_from_leaves(p, metrics)
    grads1 = {k: sharding.full_tensor(g) for k, g in grads.items()}
    grads1 = {k: g.cpu() for k, g in grads1.items()} if rank == 0 else None
    p1, o1, _ = opt.update(grads, o, p)
    del grads
    gather = sharding.gather_fsdp
    sharding.gather_fsdp = _replicate_backward_gather
    try:
        (_, _), control = vg(p, fb, b0, key0)
    finally:
        sharding.gather_fsdp = gather
    control = ({k: (g.to_local().cpu(), sharding._fsdp_dim(g)) for k, g in control.items()}
               if rank == 0 else None)
    del p, o
    gc.collect()
    torch.cuda.empty_cache()
    b1 = _placed_batch(torch, extra, gen.batch(1))
    log = []
    sync(torch)
    restore = _timed_collectives(torch, dist, log)
    pm.launches = 0
    try:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        p2, o2, loss2 = fn(p1, fb, o1, b1, key1)
        e1.record()
        e1.synchronize()
    finally:
        restore()
    launches.append(pm.launches)
    params2 = {k: sharding.full_tensor(v) for k, v in p2.items()}
    params2 = {k: v.cpu() for k, v in params2.items()} if rank == 0 else None
    out = {"fsdp_loss1": loss1.item(), "fsdp_loss2": loss2.to_local().item(),
           "fsdp_full_bytes": sum(x.numel() * x.element_size() for x in p2.values()),
           "fsdp_grads": grads1, "fsdp_control": control, "fsdp_params2": params2,
           "fsdp_not_rules": not_rules, "fsdp_resident": resident, "fsdp_released": released,
           "fsdp_launches": launches, "fsdp_step2_ms": e0.elapsed_time(e1),
           "fsdp_collectives": {k: [(ms, b) for kind, ms, b in log if kind == k]
                                for k in ("all-gather", "reduce-scatter", "all-reduce")},
           "fsdp_cost": {"counted": dict(cost.coll_bytes_by_kind),
                         "count": dict(cost.coll_count_by_kind), "leaves": expect,
                         "as_dict": cost.as_dict()},
           "fsdp_transport": f"{dist.get_backend(sharding.batch_group(mesh))} on "
                             f"{b1['tokens'].to_local().device.type} tensors, in place"}
    del fn, p1, o1, p2, o2, fb, extra, b0, b1
    gc.collect()
    torch.cuda.empty_cache()
    out["fsdp_seconds"] = time.perf_counter() - t0
    return out


def _replicate_backward_gather(xs):
    """The control of ``sharding.gather_fsdp``: the same gather with the
    backward of DTensor's redistribute to ``Replicate`` (each split leaf's
    shard takes this rank's chunk of its own gradient, a replicated leaf its
    own gradient: nothing summed across ranks).  DTensor's redistribute
    itself runs functional collectives, which crash on gloo with CUDA
    tensors on the card's torch 2.11 (the CPU tests run it as it is)."""
    import torch
    from repro_torch.dist import sharding

    class Gather(torch.autograd.Function):
        @staticmethod
        def forward(ctx, plan, *shards):
            ctx.plan = plan
            return tuple(plan.gather(shards))

        @staticmethod
        def backward(ctx, *grads):
            plan = ctx.plan
            mine = [g if d is None else g.chunk(plan.world, dim=d)[plan.index].contiguous()
                    for g, d in zip(grads, plan.dims)]
            return (None, *mine)

    if not xs:
        return []
    plan = sharding._Plan(xs[0].device_mesh, [sharding._fsdp_dim(x) for x in xs])
    plan.index = xs[0].device_mesh.get_local_rank("data")
    return list(Gather.apply(plan, *(x.to_local() for x in xs)))


def _fsdp_emu_rank(torch, api, rank, seed, model_axis=1):
    """The paper's MLP at full width on emu_offchip, sharded on a (2, 1)
    mesh, or tensor parallel on (1, 2) with ``model_axis=2``: one step at
    the session's initial hardware state advanced as the trainer advances
    it (2 emu launches, the counters from the rank's global row, and on
    (1, 2) from its first global column: rank 1's 400 rows of each 800-row
    feedback matrix start at panel 8, col_base 400); the loss, the
    parameters after it (whole, rank 0), the hardware state and the
    launches' column bases."""
    from repro_torch.dist import sharding
    from repro_torch.hardware import calibrate, drift
    from repro_torch.kernels import emu_matmul as em
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.utils import prng

    session = _dp_emu_session(api, seed, True)
    cfg = session.config
    hw = session.init_state()["hw"]
    del session
    mesh = mesh_lib.make_host_mesh(DP_WORLD, model_axis=model_axis, device_type="cuda")
    fn, args, _ = _fsdp_build(torch, mesh, seed, _dp_mlp_batch(seed), arch="mnist_mlp",
                              dfa=cfg.dfa)
    hw = calibrate.advance(hw, cfg.dfa.photonics, 0, prng.step_key(seed, 0, "hardware"),
                           recalibrate_every=cfg.recalibrate_every)
    launch, bases = em.emu_bank_product_cuda, []

    def recorded(*a, **kw):
        bases.append(kw.get("col_base", 0))
        return launch(*a, **kw)

    em.launches = 0
    em.emu_bank_product_cuda = recorded
    try:
        with drift.use_state(hw):
            p, _, loss = fn(*args[:4], prng.step_key(seed, 0, "noise"))
    finally:
        em.emu_bank_product_cuda = launch
    sync(torch)
    launches = em.launches
    params = {k: sharding.full_tensor(v) for k, v in p.items()}
    tag = "fsdp_emu" if model_axis == 1 else "tp_emu"
    return {f"{tag}_loss": loss.to_local().item(), f"{tag}_launches": launches,
            f"{tag}_params": {k: v.cpu() for k, v in params.items()} if rank == 0 else None,
            f"{tag}_hw": {k: v.cpu().numpy() for k, v in hw.items()}, f"{tag}_col_base": bases}


# ---------------------------------------------------------------------------
# tensor parallelism: build_train's step on a (1, 2) mesh (the model axis)
# ---------------------------------------------------------------------------

TP_MESH = (1, DP_WORLD)  # (data, model): the weights split over the two ranks
# the training head split too, as fractions of the 1e-5 gate (step 1's
# gradients, the parameters after 2 steps) on an NVIDIA H100 80GB HBM3 at
# 700 W: ``tools/tp_split_ablation.py all``'s measure of the part training
# keeps on its gathered weight (a full-width step on its own is not
# repeated here)
HEAD_SPLIT_GATE = (0.973, 1.136)
# (T, K, M) of the emu projection whose bank panels the ranks share: the LM
# step's error (64 x 64 rows, d_tap 1024) through a 1024-row B(k), 512 rows
# a rank, which is no whole number of 50-row panels
TP_EMU_WINDOW = (LM_BATCH * LM_SEQ, 1024, 1024)


def _tp_emu_window(torch, rank):
    """The emu backend's projection at the LM step's shape in this rank's
    column window of the (1, 2) mesh: its 512 rows of a 1024-row B(k),
    widened to the whole bank panels they touch by the neighbour's edge
    rows, all-gathered over the model group (rank 1 from column 500), and
    cut back; against this rank's columns of the one-process product on
    the same card, the launches and their column bases, and the bytes
    ``step_cost`` counts for the window's collectives."""
    from repro_torch.core import photonics as ph
    from repro_torch.dist import sharding
    from repro_torch.kernels import emu_matmul as em
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.utils import flop_cost

    t, k, m = TP_EMU_WINDOW
    cfg = ph.preset("emu_offchip")
    g = torch.Generator(device=DEVICE).manual_seed(29)
    e = torch.randn((t, k), generator=g, device=DEVICE)
    b = torch.randn((m, k), generator=g, device=DEVICE)
    whole = ph.photonic_project(e, b, cfg, 7, backend="emu")
    n = m // TP_MESH[1]
    mine = slice(rank * n, (rank + 1) * n)
    mesh = mesh_lib.make_host_mesh(TP_MESH[0] * TP_MESH[1], model_axis=TP_MESH[1],
                                   device_type="cuda")
    launch, bases = em.emu_bank_product_cuda, []

    def recorded(*a, **kw):
        bases.append(kw.get("col_base", 0))
        return launch(*a, **kw)

    em.launches = 0
    em.emu_bank_product_cuda = recorded
    try:
        with sharding.use_mesh(mesh), ph.column_window(
                ph.ColumnWindow(rank * n, n, m, sharding.model_group(mesh))):
            part, cost = flop_cost.measure(ph.photonic_project, e, b[mine], cfg, 7,
                                           backend="emu")
    finally:
        em.emu_bank_product_cuda = launch
    sync(torch)
    return {"tp_window": {"equal": torch.equal(part, whole[:, mine]),
                          "max_abs": float((part - whole[:, mine]).abs().max()),
                          "launches": em.launches, "col_base": bases,
                          "columns": [rank * n, (rank + 1) * n],
                          "collective_bytes": dict(cost.coll_bytes_by_kind)}}


def _tp_lm_rank(torch, api, pm, rank, seed):
    """This rank's share of the full-width LM's tensor-parallel step on a
    (1, 2) mesh (the dense blocks' products column-parallel): its pieces
    against an independent init, step 1's gradients (whole on rank 0)
    counted by ``step_cost`` (FLOPs by product, collectives) beside the
    operand bytes the collectives were handed, the path's first bank launch
    against the plain version on its own operands, the update, the parts
    the model reports on gathered weights on this mesh, step 2 timed with
    each collective's ms, and the parameters after 2 steps (whole, rank
    0)."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data import tokens
    from repro_torch.dist import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.utils import flop_cost, prng

    t0 = time.perf_counter()
    mesh = mesh_lib.make_host_mesh(TP_MESH[0] * TP_MESH[1], model_axis=TP_MESH[1],
                                   device_type="cuda")
    vocab = configs.get(ARCH).make_model(device="meta").cfg.vocab_size
    gen = tokens.MarkovTokens(vocab, LM_SEQ, LM_BATCH, seed)
    fn, (p, fb, o, b0, _), extra = _fsdp_build(torch, mesh, seed, gen.batch(0),
                                               arch=_dp_arch(torch))
    vg, opt = extra["value_and_grad"], extra["trainer"].cfg.optimizer
    full = _dp_model(torch, seed)
    not_rules = [k for k, v in full.named_parameters()
                 if not torch.equal(p[k].to_local(), _rule_piece(v.detach(), p[k]))]
    split = sum(p[k].to_local().shape != v.shape for k, v in full.named_parameters())
    del full
    gc.collect()
    torch.cuda.empty_cache()
    resident = [sum(x.to_local().numel() * x.element_size() for x in tree.values())
                for tree in (p, o["mom"])]
    key0, key1 = prng.step_key(seed, 0, "noise"), prng.step_key(seed, 1, "noise")
    launch, cap = ops.photonic_matmul_cuda, {}

    def first_launch(a, b, **kw):
        out = launch(a, b, **kw)
        if not cap:
            cap.update(a=a.clone(), b=b.clone(), kw={k: v.clone() for k, v in kw.items()},
                       out=out.clone())
        return out

    log = []
    sync(torch)
    restore = _timed_collectives(torch, dist, log)
    ops.photonic_matmul_cuda = first_launch
    pm.launches = 0
    try:
        ((loss1, _), grads), cost = flop_cost.measure(vg, p, fb, b0, key0)
    finally:
        ops.photonic_matmul_cuda = launch
        restore()
    launches = [pm.launches]
    plain = pm.photonic_matmul_plain(cap["a"], cap["b"], **cap["kw"])
    kernel_err = ((cap["out"] - plain).abs().max() / plain.abs().max()).item()
    shape = (cap["a"].shape[0], cap["a"].shape[1], cap["b"].shape[0])
    del cap, plain
    seen = {}
    for kind, _, nbytes in log:
        seen[kind] = seen.get(kind, 0) + nbytes
    grads1 = {k: sharding.full_tensor(g) for k, g in grads.items()}
    grads1 = {k: g.cpu() for k, g in grads1.items()} if rank == 0 else None
    p1, o1, _ = opt.update(grads, o, p)
    with sharding.use_mesh(mesh):
        kept = extra["model"].column_fallbacks(p)
    del grads, p, o
    gc.collect()
    torch.cuda.empty_cache()
    b1 = _placed_batch(torch, extra, gen.batch(1))
    log = []
    sync(torch)
    restore = _timed_collectives(torch, dist, log)
    pm.launches = 0
    try:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        p2, o2, loss2 = fn(p1, fb, o1, b1, key1)
        e1.record()
        e1.synchronize()
    finally:
        restore()
    launches.append(pm.launches)
    params2 = {k: sharding.full_tensor(v) for k, v in p2.items()}
    params2 = {k: v.cpu() for k, v in params2.items()} if rank == 0 else None
    out = {"tp_loss1": loss1.item(), "tp_loss2": loss2.to_local().item(),
           "tp_full_bytes": sum(x.numel() * x.element_size() for x in p2.values()),
           "tp_grads": grads1, "tp_params2": params2, "tp_not_rules": not_rules,
           "tp_split": split, "tp_resident": resident, "tp_launches": launches,
           "tp_kernel_err": kernel_err, "tp_shape": shape,
           "tp_step2_ms": e0.elapsed_time(e1),
           "tp_collectives": {k: [(ms, b) for kind, ms, b in log if kind == k]
                              for k in ("all-gather", "reduce-scatter", "all-reduce")},
           "tp_cost": {"counted": dict(cost.coll_bytes_by_kind),
                       "count": dict(cost.coll_count_by_kind), "seen": seen},
           "tp_flops": {"flops": cost.flops, "regions": dict(cost.region_flops)},
           "tp_kept": kept,
           "tp_groups": (dist.get_process_group_ranks(sharding.model_group(mesh)),
                         sharding.model_index(mesh))}
    del fn, p1, o1, p2, o2, fb, extra, b0, b1
    gc.collect()
    torch.cuda.empty_cache()
    out["tp_seconds"] = time.perf_counter() - t0
    return out


# the families' tensor-parallel checks at full width in f32 on (1, 2): tag ->
# (arch, layers); qwen2-moe at its one-card f32 training depth (phase_moe's),
# minicpm3 (latent attention) cut to 2 layers
TP_FAMILIES = {"moe": ("qwen2-moe-a2.7b", 4), "mla": ("minicpm3-4b", 2)}


def _tp_family_arch(torch, name, layers):
    """``name``'s full width in f32 at ``layers`` layers, as an ``Arch``
    that ``build_train`` takes."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.transformer import TransformerLM

    arch = configs.get(name)
    cfg = dataclasses.replace(_meta_model(torch, name, torch.float32).cfg, n_layers=layers)

    def make_model(dtype=torch.float32, device=None):
        return TransformerLM(dataclasses.replace(cfg, dtype=dtype), device=device)

    return dataclasses.replace(arch, make_model=make_model)


def _tp_family_one_process(torch, api, seed, mesh, rank, arch):
    """``arch``'s one-process step 1 from ``seed`` (its loss, its FLOPs by
    product) and its parameters after 2 steps, as a session trains them:
    ``rank``'s piece of each leaf of the gradients and of the parameters,
    as the rules split it on the (1, 2) ``mesh``, on the host."""
    from repro_torch.data import tokens
    from repro_torch.utils import flop_cost, prng

    stamps = [time.perf_counter()]
    model = arch.make_model(torch.float32, device=DEVICE)
    session = api.build_session(arch=model, algo="dfa", hardware="offchip_bpd", backend="cuda",
                                seed=seed, data_parallel=False, log_every=10**9, device=DEVICE)
    state = session.init_state()
    model.release_parameters()  # the training methods read the state's parameters
    trainer = session.trainer
    gen = tokens.MarkovTokens(model.cfg.vocab_size, LM_SEQ, LM_BATCH, seed)
    sync(torch)
    stamps.append(time.perf_counter())
    ((loss1, _), grads), cost = flop_cost.measure(
        trainer._grads, state["params"], state["fb"], trainer.put(gen.batch(0)),
        prng.step_key(seed, 0, "noise"))
    sync(torch)
    stamps.append(time.perf_counter())
    out = {"loss1": loss1.item(), "grads": _rank_pieces(grads, mesh, rank),
           "regions": dict(cost.region_flops), "flops": cost.flops}
    del grads
    stamps.append(time.perf_counter())
    for i in range(DP_STEPS):
        state, _ = session.step(state, gen.batch(i))
    sync(torch)
    stamps.append(time.perf_counter())
    out["params2"] = _rank_pieces(state["params"], mesh, rank)
    stamps.append(time.perf_counter())
    out["stages"] = dict(zip(("init", "step 1 counted", "its pieces to the host", "2 steps",
                              "its pieces to the host"),
                             (b - a for a, b in zip(stamps, stamps[1:]))))
    del state, session, trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rank_pieces(tree, mesh, rank) -> dict:
    """``rank``'s piece of every whole leaf of ``tree`` on the (1, 2)
    ``mesh``, as the rules split it, on the host."""
    from repro_torch.dist import sharding

    out = {}
    for k, v in tree.items():
        spec = sharding.leaf_spec(k, tuple(v.shape), mesh)
        dims = [d for d, e in enumerate(spec) if e == sharding.MODEL]
        out[k] = (v.chunk(TP_MESH[1], dim=dims[0])[rank] if dims else v).cpu()
    return out


def _pieces_rel(torch, tree, one) -> dict:
    """Each leaf of a sharded tree against the one process's (``one``: this
    rank's piece of each leaf, ``_rank_pieces``), over both ranks: {leaf:
    max |got - one| / max |one|}, in f64 on the card; every rank calls it
    and gets the same."""
    import torch.distributed as dist

    keys = list(tree)
    diff = torch.zeros(len(keys), dtype=torch.float64, device=DEVICE)
    ref = torch.zeros_like(diff)
    for i, k in enumerate(keys):
        got = tree[k].to_local().to(torch.float64)
        want = one[k].to(DEVICE, torch.float64)
        diff[i], ref[i] = (got - want).abs().max(), want.abs().max()
        del got, want
    both = torch.stack([diff, ref]).cpu()
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    return {k: both[0, i].item() / max(both[1, i].item(), 1e-30) for i, k in enumerate(keys)}


def _tp_family_rank(torch, api, pm, rank, seed, tag):
    """``TP_FAMILIES[tag]``'s step on the (1, 2) mesh at full width as the
    port runs it (qwen2-moe: the experts expert parallel, the attention
    and the shared experts column-parallel, the router whole; minicpm3: the
    latent attention's q_down, kv_down, heads and ``o`` and the FFN
    column-parallel): first the one process's step on each rank in turn
    (the other waits), which keeps that rank's piece of its gradients and
    of its parameters after 2 steps on the host; then this rank's share:
    its pieces' resident expert bytes, step 1's gradients counted by
    ``step_cost`` (its FLOPs by product and collective bytes) beside the
    operand bytes the collectives were handed, the parts the model reports
    whole, the update, step 2 timed.  Each leaf of step 1's gradients and
    of the parameters after 2 steps is held to the one process's
    (``_pieces_rel``: the ranks' pieces against the one process's, with no
    leaf gathered).  -> the results, keyed ``{tag}_...``."""
    import torch.distributed as dist

    from repro_torch.data import tokens
    from repro_torch.dist import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.utils import flop_cost, prng

    name, layers = TP_FAMILIES[tag]
    gc.collect()
    torch.cuda.empty_cache()
    # the full-width MoE step's tensors come in many sizes: grow segments
    # rather than strand reserved blocks (both ranks and the control share
    # the card)
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    t0 = time.perf_counter()
    mesh = mesh_lib.make_host_mesh(TP_MESH[0] * TP_MESH[1], model_axis=TP_MESH[1],
                                   device_type="cuda")
    arch = _tp_family_arch(torch, name, layers)
    one = None
    for r in range(TP_MESH[1]):
        if r == rank:
            one = _tp_family_one_process(torch, api, seed, mesh, rank, arch)
        dist.barrier()
    t1 = time.perf_counter()
    stamps = [t1]
    torch.cuda.reset_peak_memory_stats()
    vocab = _meta_model(torch, name, torch.float32).cfg.vocab_size
    gen = tokens.MarkovTokens(vocab, LM_SEQ, LM_BATCH, seed)
    fn, (p, fb, o, b0, _), extra = _fsdp_build(torch, mesh, seed, gen.batch(0), arch=arch)
    vg, opt = extra["value_and_grad"], extra["trainer"].cfg.optimizer
    experts = [k for k in p if ".experts." in k]
    expert_bytes = [sum(p[k].to_local().numel() * p[k].element_size() for k in experts),
                    sum(p[k].numel() * p[k].element_size() for k in experts)]
    local_experts = sorted({p[k].to_local().shape[0] for k in experts})
    resident = [sum(x.to_local().numel() * x.element_size() for x in tree.values())
                for tree in (p, o["mom"])]
    full_bytes = sum(x.numel() * x.element_size() for x in p.values())
    with sharding.use_mesh(mesh):
        kept = extra["model"].column_fallbacks(p)
    key0, key1 = prng.step_key(seed, 0, "noise"), prng.step_key(seed, 1, "noise")
    log = []
    sync(torch)
    stamps.append(time.perf_counter())
    restore = _timed_collectives(torch, dist, log)
    pm.launches = 0
    try:
        ((loss1, _), grads), cost = flop_cost.measure(vg, p, fb, b0, key0)
    finally:
        restore()
    sync(torch)
    stamps.append(time.perf_counter())
    launches = [pm.launches]
    seen = {}
    for kind, _, nbytes in log:
        seen[kind] = seen.get(kind, 0) + nbytes
    grad_rel = _pieces_rel(torch, grads, one.pop("grads"))
    stamps.append(time.perf_counter())
    p1, o1, _ = opt.update(grads, o, p)
    del grads, p, o
    gc.collect()
    torch.cuda.empty_cache()
    b1 = _placed_batch(torch, extra, gen.batch(1))
    sync(torch)
    pm.launches = 0
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    p2, _, loss2 = fn(p1, fb, o1, b1, key1)
    e1.record()
    e1.synchronize()
    launches.append(pm.launches)
    del p1, o1
    peak = torch.cuda.max_memory_allocated()
    stamps.append(time.perf_counter())
    params2_rel = _pieces_rel(torch, p2, one.pop("params2"))
    stamps.append(time.perf_counter())
    out = {"loss1": loss1.item(), "loss2": loss2.to_local().item(),
           "expert_bytes": expert_bytes, "local_experts": local_experts,
           "resident": resident, "full_bytes": full_bytes, "kept": kept,
           "launches": launches, "step2_ms": e0.elapsed_time(e1),
           "regions": dict(cost.region_flops), "flops": cost.flops,
           "regions_one": one["regions"], "flops_one": one["flops"],
           "loss1_one": one["loss1"], "one_stages": one["stages"],
           "grad_rel": grad_rel, "params2_rel": params2_rel,
           "cost": {"counted": dict(cost.coll_bytes_by_kind),
                    "count": dict(cost.coll_count_by_kind), "seen": seen},
           "peak_gib": peak / 2**30, "one_s": t1 - t0,
           "stages": dict(zip(("build", "step 1 counted", "gradients held",
                               "update and step 2", "parameters held"),
                              (b - a for a, b in zip(stamps, stamps[1:]))))}
    del fn, p2, fb, extra, b0, b1
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t1
    dist.barrier()
    return {f"{tag}_{k}": v for k, v in out.items()}


def _tp_worst(rel: dict, experts: bool) -> tuple[float, str]:
    """(the largest distance of ``rel``'s expert leaves, or of its other
    leaves, that leaf)."""
    return max(((v, k) for k, v in rel.items() if (".experts." in k) == experts),
               default=(0.0, "none"))


def _tp_family_report(r0, r1, tag) -> dict:
    """Print and check ``TP_FAMILIES[tag]``'s tensor-parallel steps against
    one process -> the summary for the ``data_parallel`` line's ``tp``
    block."""
    name, layers = TP_FAMILIES[tag]
    r0 = {k[len(tag) + 1:]: v for k, v in r0.items() if k.startswith(f"{tag}_")}
    r1 = {k[len(tag) + 1:]: v for k, v in r1.items() if k.startswith(f"{tag}_")}
    ranks = ((0, r0), (1, r1))
    gb = 1e9
    m = TP_MESH[1]
    moe = bool(r0["local_experts"])
    full_layers = (MOE_FULL.get(name) or DENSE_FULL[name])[0]
    print(f"[tp] {name} at full width, {layers} of {full_layers} layers, f32, offchip_bpd "
          f"(cuda), batch {LM_BATCH} x seq {LM_SEQ}, on the {TP_MESH} mesh as the port runs it"
          + (f" (the experts expert parallel: each rank holds {r0['local_experts']} / "
             f"{r1['local_experts']} experts a stack; the attention and the shared experts "
             f"column-parallel, the router whole)" if moe else
             " (the latent attention's q_down, kv_down, q_up, k_up, v_up and o and the FFN "
             "column-parallel)")
          + f"; the ranks' part {r0['seconds']:.1f} / {r1['seconds']:.1f}s after the one "
          f"process's on each rank in turn, {r0['one_s']:.1f}s; peak device memory "
          f"{r0['peak_gib']:.2f} / {r1['peak_gib']:.2f} GiB a rank; seconds by stage, "
          f"rank 0: " + ", ".join(f"{k} {v:.1f}" for k, v in r0["stages"].items())
          + "; its one process: "
          + ", ".join(f"{k} {v:.1f}" for k, v in r0["one_stages"].items()))
    print(f"[tp] {name}: kept on gathered weights in training, the parts the model reports on "
          f"this mesh: {r0['kept'] or 'none'} (the head: TransformerLM.head_logits)")
    for r, res in ranks:
        mine, whole = res["expert_bytes"]
        par, mom = res["resident"]
        print(f"[tp] {name} rank {r}"
              + (f" resident expert weights {mine / gb:.4f} GB against the replicated "
                 f"{whole / gb:.4f} GB ({mine / whole:.4f} of it);" if moe else "")
              + f" all its parameters {par / gb:.4f} GB + momentum {mom / gb:.4f} GB against 2 "
              f"x {res['full_bytes'] / gb:.4f} GB ({(par + mom) / (2 * res['full_bytes']):.4f});"
              f" bank launches {res['launches']} (step 1's gradients, step 2); step 2 "
              f"{res['step2_ms']:.2f} ms (CUDA events, gloo collectives staged through host "
              f"memory)")
    for r, res in ranks:
        counted, seen = res["cost"]["counted"], res["cost"]["seen"]
        mine, one = res["regions"], res["regions_one"]
        print(f"[tp] {name} rank {r} step_cost of step 1's gradients: "
              + ", ".join(f"{k} {counted.get(k, 0) / gb:.6f} GB in "
                          f"{res['cost']['count'].get(k, 0)} (handed to torch.distributed "
                          f"{seen.get(k, 0) / gb:.6f})" for k in sorted(set(counted) | set(seen)))
              + "; TFLOP by product, the rank / one process: "
              + ", ".join(f"{n} {mine.get(n, 0) / 1e12:.6f} / {f / 1e12:.6f}"
                          for n, f in sorted(one.items()))
              + f" (the step's {res['flops'] / 1e12:.4f} against one process's "
              f"{res['flops_one'] / 1e12:.4f})")
    grad, par2 = max((v, k) for k, v in r0["grad_rel"].items()), \
        max((v, k) for k, v in r0["params2_rel"].items())
    parts = ({name: (_tp_worst(r0["grad_rel"], e), _tp_worst(r0["params2_rel"], e))
              for name, e in (("experts", True), ("the other leaves", False))} if moe else {})
    equal = [sum(v == 0.0 for v in r0[k].values()) for k in ("grad_rel", "params2_rel")]
    print(f"[tp] {name} step 1: loss {r0['loss1']:.6f} (rank 1 {r1['loss1']:.6f}) vs "
          f"one process {r0['loss1_one']:.6f}; gradients max rel {grad[0]:.3e} ({grad[1]}) "
          f"= {grad[0] / DP_TOL:.3f} of the 1e-5 gate; parameters after 2 steps {par2[0]:.3e} "
          f"({par2[1]}) = {par2[0] / DP_TOL:.3f}"
          + ("; by kind, gradients / parameters: "
             + "; ".join(f"{n} {g[0]:.3e} ({g[1]}) / {p[0]:.3e} ({p[1]})"
                         for n, (g, p) in parts.items()) if parts else "")
          + f" (each rank's piece of each of the {len(r0['grad_rel'])} leaves against the "
          f"one process's piece, in f64 on the card; leaves equal bit for bit: {equal[0]} "
          f"gradients, {equal[1]} parameters)")
    for r, res in ranks:
        mine, whole = res["expert_bytes"]
        counted, seen = res["cost"]["counted"], res["cost"]["seen"]
        regions, one = res["regions"], res["regions_one"]
        # every product the blocks split runs on the rank's rows (the experts
        # on its E/m); the head, which training keeps gathered, and the
        # router whole
        whole_products = ("head", "router")
        halved = [n for n in one if n not in whole_products]
        if moe:
            check(res["local_experts"] == [60 // m] and mine * m == whole,
                  f"rank {r} holds {res['local_experts']} experts, {mine} of {whole} B")
        check(res["launches"] == [layers + 1] * 2,
              f"{name} rank {r}: tensor-parallel bank launches {res['launches']}")
        check(counted == seen and counted.get("all-gather", 0) > 0,
              f"{name} rank {r}: step_cost's collectives {counted} against the calls' {seen}")
        check(len(halved) == (8 if moe else 9)
              and all(regions.get(n, 0) > 0 and regions[n] * m == one[n] for n in halved)
              and all(regions.get(n) == one.get(n) for n in whole_products),
              f"{name} rank {r}: the split products' FLOPs {regions} against 1/{m} of {one}")
    check(r0["loss1"] == r1["loss1"] and r0["loss2"] == r1["loss2"]
          and abs(r0["loss1"] - r0["loss1_one"]) <= DP_TOL * abs(r0["loss1_one"]),
          f"{name}: the tensor-parallel step 1's loss differs from one process")
    check(r0["grad_rel"] == r1["grad_rel"] and r0["params2_rel"] == r1["params2_rel"],
          f"{name}: the ranks' distances from one process differ")
    check(grad[0] <= DP_TOL, f"{name}'s tensor-parallel gradients {grad}")
    check(par2[0] <= DP_TOL, f"{name}'s tensor-parallel parameters after 2 steps {par2}")
    return {"arch": name, "layers": layers, "loss1": r0["loss1"],
            "grad_err": grad, "params2_err": par2, "kept": r0["kept"],
            "by_kind": {n: {"grad_err": g, "params2_err": p} for n, (g, p) in parts.items()},
            "bit_for_bit_leaves": equal,
            "expert_bytes": [r0["expert_bytes"], r1["expert_bytes"]],
            "flops": [r0["regions"], r1["regions"]],
            "flops_one": r0["regions_one"],
            "collective_bytes": [r0["cost"]["counted"], r1["cost"]["counted"]],
            "collective_bytes_seen": [r0["cost"]["seen"], r1["cost"]["seen"]],
            "step2_ms": [r0["step2_ms"], r1["step2_ms"]],
            "bank_launches": sum(r0["launches"])}


def _tp_report(torch, pm, r0, r1, card) -> dict:
    """Print and check the two ranks' tensor-parallel steps against one
    process (the LM's and the emu MLP's), and time the bank kernel at the
    rank's projection shape -> the summary for the ``data_parallel``
    line."""
    import numpy as np

    ranks = ((0, r0), (1, r1))
    gb = 1e9
    print(f"[tp] two ranks on one card, build_train's sharded step on a {TP_MESH} (data, "
          f"model) mesh: the weights, the vocabulary and the feedback rows split over the "
          f"model axis; model groups {r0['tp_groups']} / {r1['tp_groups']}; pieces = the "
          f"rule's slices of an independent init: {not r0['tp_not_rules']} / "
          f"{not r1['tp_not_rules']} ({r0['tp_split']} leaves split); the ranks' part "
          f"{r0['tp_seconds']:.1f} / {r1['tp_seconds']:.1f}s")
    full = r0["tp_full_bytes"]
    for r, res in ranks:
        par, mom = res["tp_resident"]
        print(f"[tp] rank {r} resident: parameters {par / gb:.4f} GB + momentum {mom / gb:.4f} "
              f"GB = {(par + mom) / gb:.4f} GB, against the replicated run's 2 x {full / gb:.4f}"
              f" = {2 * full / gb:.4f} GB ({(par + mom) / (2 * full):.4f} of it); bank launches "
              f"{res['tp_launches']} (step 1's gradients, step 2)")
    cost = r0["tp_cost"]
    counted, seen = cost["counted"], cost["seen"]
    print(f"[tp] step_cost of step 1's gradients, rank 0: "
          + ", ".join(f"{k} {counted.get(k, 0) / gb:.6f} GB in {cost['count'].get(k, 0)} "
                      f"(handed to torch.distributed {seen.get(k, 0) / gb:.6f})"
                      for k in sorted(set(counted) | set(seen))))
    for r, res in ranks:
        parts = [f"{kind} {len(v)} x, {sum(ms for ms, _ in v):.2f} ms for "
                 f"{sum(b for _, b in v) / gb:.4f} GB" for kind, v in res["tp_collectives"].items()
                 if v]
        print(f"[tp] rank {r} step 2: {res['tp_step2_ms']:.2f} ms (CUDA events); collectives "
              f"(gloo, staged through host memory: not a multi-card rate): " + "; ".join(parts))
    print(f"[tp] step 1: loss {r0['tp_loss1']:.6f} (rank 1 {r1['tp_loss1']:.6f}) vs one process "
          f"{r0['loss1_one']:.6f}; gradients max rel {r0['tp_grad_err'][0]:.3e} "
          f"({r0['tp_grad_err'][1]}) = {r0['tp_grad_err'][0] / DP_TOL:.3f} of the 1e-5 gate; "
          f"parameters after 2 steps {r0['tp_params2_err'][0]:.3e} ({r0['tp_params2_err'][1]}) "
          f"= {r0['tp_params2_err'][0] / DP_TOL:.3f} (the blocks' products column-parallel, "
          f"the head on its gathered weight)")
    print(f"[tp] kept on gathered weights in training: the head "
          f"(TransformerLM.head_logits; split, it moved this step to {HEAD_SPLIT_GATE[0]:.3f} "
          f"of the gate in step 1's gradients and {HEAD_SPLIT_GATE[1]:.3f} in the parameters "
          f"after 2 steps: tools/tp_split_ablation.py, variant 'all', on this card), and the "
          f"parts the model reports on this mesh: {r0['tp_kept'] or 'none'}")
    flops, one_f = r0["tp_flops"], r0["tp_flops_one"]
    print(f"[tp] step_cost of step 1's gradients: {flops['flops'] / 1e12:.4f} TFLOP a rank vs one "
          f"process's {one_f['flops'] / 1e12:.4f} ({flops['flops'] / one_f['flops']:.4f}); by "
          f"product, rank 0 / one process: "
          + ", ".join(f"{n} {flops['regions'].get(n, 0) / 1e12:.4f} / {f / 1e12:.4f}"
                      for n, f in sorted(one_f["regions"].items())))
    t, k, m = r0["tp_shape"]
    print(f"[tp] the path's first bank launch (rank 0, ({t}, {k}) x ({m}, {k}) f32, input "
          f"mode: its rows of B) vs the plain version on its operands: "
          f"{r0['tp_kernel_err']:.3e} of max|plain| (rank 1 {r1['tp_kernel_err']:.3e})")
    peaks = card_peaks(card)[1]
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    a, b = (torch.randn(shape, generator=gen, device=DEVICE) for shape in ((t, k), (m, k)))
    noise = torch.randn((t, m), generator=gen, device=DEVICE) * 0.1
    print(f"[tp] the bank kernel at a rank's projection shape     T      K      M  dtype "
          f"{TIMING_HEAD}")
    row = _bank_row(torch, pm, a, b, {"noise": noise}, peaks, "input", "tp",
                    "a rank's rows of B(k), input mode ",
                    reps={"ms": 25, "plain_ms": 10, "library_ms": 25})
    del a, b, noise
    for r, res in ranks:
        check(not res["tp_not_rules"] and res["tp_split"] > 0,
              f"rank {r}: pieces not the rule's {res['tp_not_rules'][:3]}")
        check(sum(res["tp_resident"]) < 0.51 * 2 * full,
              f"rank {r} holds {res['tp_resident']} of {full} B: not split")
        check(res["tp_launches"] == [DP_LAUNCHES] * 2,
              f"rank {r}: tensor-parallel bank launches {res['tp_launches']}")
        check(res["tp_kernel_err"] <= TOL["float32"],
              f"rank {r}: the bank kernel vs plain at the rank's shape {res['tp_kernel_err']}")
    check(r0["tp_loss1"] == r1["tp_loss1"] and r0["tp_loss2"] == r1["tp_loss2"]
          and abs(r0["tp_loss1"] - r0["loss1_one"]) <= DP_TOL * abs(r0["loss1_one"]),
          "the tensor-parallel step 1's loss differs from one process")
    check(r0["tp_grad_err"][0] <= DP_TOL, f"tensor-parallel gradients {r0['tp_grad_err']}")
    blocks = {n for n in one_f["regions"] if n.startswith(("attn.", "ffn."))}
    check(blocks and all(2 * flops["regions"][n] == one_f["regions"][n] for n in blocks)
          and flops["regions"].get("head") == one_f["regions"].get("head")
          and flops["flops"] < one_f["flops"],
          f"a rank's product FLOPs {flops} against one process's {one_f}")
    check(r0["tp_params2_err"][0] <= DP_TOL,
          f"tensor-parallel parameters after 2 steps {r0['tp_params2_err']}")
    check(counted == seen and counted.get("all-gather", 0) > 0
          and counted.get("all-reduce", 0) > 0,
          f"step_cost's collectives {counted} against the calls' {seen}")
    hw_same = all(np.array_equal(r0["tp_emu_hw"][k], r1["tp_emu_hw"][k])
                  and np.array_equal(r0["tp_emu_hw"][k], r0["emu_hw_one"][k])
                  for k in r0["tp_emu_hw"])
    print(f"[tp] MLP on emu_offchip on the {TP_MESH} mesh (each rank 400 rows of each 800-row "
          f"B(k), the emu kernel's col_base {r0['tp_emu_col_base']} / "
          f"{r1['tp_emu_col_base']}): loss {r0['tp_emu_loss']:.6f} (rank 1 "
          f"{r1['tp_emu_loss']:.6f}) vs one process {r0['emu_loss_one']:.6f}; parameters after "
          f"the step max rel {r0['tp_emu_err'][0]:.3e} ({r0['tp_emu_err'][1]}); emu launches "
          f"{r0['tp_emu_launches']} / {r1['tp_emu_launches']}; hardware state equal on both "
          f"ranks and to one process: {hw_same}")
    check(r0["tp_emu_launches"] == r1["tp_emu_launches"] == 2
          and r0["tp_emu_col_base"] == [0, 0] and r1["tp_emu_col_base"] == [400, 400],
          f"the emu MLP's launches {r0['tp_emu_launches']} / {r1['tp_emu_launches']}, column "
          f"bases {r0['tp_emu_col_base']} / {r1['tp_emu_col_base']}")
    t_w, k_w, m_w = TP_EMU_WINDOW
    w0, w1 = r0["tp_window"], r1["tp_window"]
    print(f"[tp] emu projection at the LM step's shape ({t_w}, {k_w}) x ({m_w}, {k_w}) f32 on "
          f"emu_offchip in each rank's column window (columns {w0['columns']} / "
          f"{w1['columns']}: bank panels of 50 shared, the neighbour's edge rows all-gathered), "
          f"emu kernel's col_base {w0['col_base']} / {w1['col_base']}: = the one process's "
          f"columns bit for bit {w0['equal']} / {w1['equal']} (max |diff| {w0['max_abs']:.3e} / "
          f"{w1['max_abs']:.3e}); emu launches {w0['launches']} / {w1['launches']}; step_cost's "
          f"collective bytes {w0['collective_bytes']} / {w1['collective_bytes']} (the edge "
          f"rows' all-gather and s_b's MAX)")
    edges = 2 * min(50 - 1, -(-m_w // 2 // 2)) * k_w * 4  # each rank's edge rows, f32
    check(w0["equal"] and w1["equal"] and w0["launches"] == w1["launches"] == 1
          and w0["col_base"] == [0] and w1["col_base"] == [m_w // 2 // 50 * 50]
          and w0["collective_bytes"].get("all-gather") == edges
          and w1["collective_bytes"].get("all-gather") == edges,
          f"the emu projection in a shared-panel window: {w0} / {w1}")
    check(r0["tp_emu_err"][0] <= FSDP_MLP_TOL and r0["tp_emu_loss"] == r1["tp_emu_loss"]
          and abs(r0["tp_emu_loss"] - r0["emu_loss_one"]) <= FSDP_MLP_TOL
          * abs(r0["emu_loss_one"]) and hw_same,
          "the emu MLP's tensor-parallel step differs from one process")
    return {"mesh": list(TP_MESH), "loss1": r0["tp_loss1"], "grad_err": r0["tp_grad_err"],
            "kept": {"head": {"split_of_gate": list(HEAD_SPLIT_GATE),
                              "source": "tools/tp_split_ablation.py all"},
                     **r0["tp_kept"]},
            "flops": {"rank": flops, "one_process": one_f},
            "params2_err": r0["tp_params2_err"], "kernel_err": max(r0["tp_kernel_err"],
                                                                   r1["tp_kernel_err"]),
            "resident_bytes": [r0["tp_resident"], r1["tp_resident"]],
            "replicated_bytes": 2 * full, "collective_bytes": counted,
            "collective_bytes_seen": seen,
            "step2_ms": [r0["tp_step2_ms"], r1["tp_step2_ms"]],
            "collective_ms": {kind: [sum(ms for ms, _ in res["tp_collectives"][kind])
                                     for _, res in ranks] for kind in ("all-gather",
                                                                       "all-reduce")},
            "bank_launches": sum(r0["tp_launches"]), "shape": [t, k, m], "timing": row,
            "emu_err": r0["tp_emu_err"], "emu_launches": r0["tp_emu_launches"],
            "emu_col_base": [r0["tp_emu_col_base"], r1["tp_emu_col_base"]],
            "emu_window": [r0["tp_window"], r1["tp_window"]]}


def _dp_rel(got: dict, expect: dict) -> tuple[float, str]:
    """(max over leaves of max |got - expect| / max |expect|, that leaf), in
    f64 on the card (the host's f64 passes over a full-width state took
    seconds each)."""
    import torch

    def rel(g, e):
        g, e = g.to(DEVICE, torch.float64), e.to(DEVICE, torch.float64)
        return (g - e).abs().max().item() / max(e.abs().max().item(), 1e-30)

    return max((rel(got[k], e), k) for k, e in expect.items())


def _rank0_rel(shards: dict, full: dict) -> tuple[float, str]:
    """``_dp_rel`` of rank 0's shards ({name: (shard, split dim or None)})
    against rank 0's piece of each whole tensor."""
    return _dp_rel({k: g for k, (g, _) in shards.items()},
                   {k: full[k] if d is None else full[k].chunk(DP_WORLD, dim=d)[0]
                    for k, (_, d) in shards.items()})


def _dp_one_process(torch, api, seed, dp):
    """Rank 0 after the group is gone: the one-process step 1 (gradients,
    its first projection's s_a and noise) and 2 steps, and the emu MLP's
    step, against the two-rank run's."""
    from repro_torch.core import photonics as ph
    from repro_torch.data import tokens
    from repro_torch.kernels import ops
    from repro_torch.utils import flop_cost, prng

    session = _lm_session(api, torch, seed, arch=_dp_model(torch, seed), data_parallel=False)
    trainer = session.trainer
    gen = tokens.MarkovTokens(session.model.cfg.vocab_size, LM_SEQ, LM_BATCH, seed)
    state = session.init_state()
    cap = {}
    restore = _dp_capture(ph, ops, cap)
    try:
        ((loss1, _), grads), cost = flop_cost.measure(
            trainer._grads, state["params"], state["fb"], trainer.put(gen.batch(0)),
            prng.step_key(seed, 0, "noise"))
    finally:
        restore()
    sync(torch)
    grads = {k: v.cpu() for k, v in grads.items()}
    t_local = LM_BATCH // DP_WORLD * LM_SEQ
    noise = cap["noise"]
    out = {"loss1_one": loss1.item(), "grad_err": _dp_rel(dp["grads"], grads),
           "fsdp_grad_err": _dp_rel(dp["fsdp_grads"], grads),
           "tp_grad_err": _dp_rel(dp["tp_grads"], grads),
           "tp_flops_one": {"flops": cost.flops, "regions": dict(cost.region_flops)},
           "fsdp_control_err": _rank0_rel(dp["fsdp_control"], grads),
           "noise_rows": [torch.equal(dp["noise"][r], noise[r * t_local:(r + 1) * t_local])
                          for r in range(DP_WORLD)],
           "s_a_one": cap["s_a"].item()}
    del grads
    for i in range(DP_STEPS):  # the fit's steps, from the same initial state
        state, _ = session.step(state, gen.batch(i))
    one2 = {k: v.cpu() for k, v in state["params"].items()}
    out["params2_err"] = _dp_rel(one2, dp["params2"])
    out["fsdp_params2_err"] = _dp_rel(dp["fsdp_params2"], one2)
    out["tp_params2_err"] = _dp_rel(dp["tp_params2"], one2)
    del one2
    del state, session, trainer
    gc.collect()
    torch.cuda.empty_cache()
    loss, grads, _, hw, params = _dp_emu_grads(torch, _dp_emu_session(api, seed, False),
                                               _dp_mlp_batch(seed))
    out.update(emu_loss_one=loss, emu_grad_err=_dp_rel(dp["emu_grads"], grads),
               emu_hw_one=hw, fsdp_emu_err=_dp_rel(dp["fsdp_emu_params"], params),
               tp_emu_err=_dp_rel(dp["tp_emu_params"], params))
    return out


def _dp_resume(torch, api, seed, base, dp):
    """Rank 1 after the group is gone, beside rank 0's one-process checks:
    the two-rank run's step-2 snapshot resumed in one process; its step 3's
    gradients against the rank-local noise run's, and its step 3 against
    the replicas' (rank 1's = rank 0's, checked before the group went)."""
    from repro_torch.data import tokens
    from repro_torch.utils import prng

    resumed = _lm_session(api, torch, seed, arch=_dp_model(torch, seed), data_parallel=False,
                          ckpt_dir=str(base / "lm"))
    gen = tokens.MarkovTokens(resumed.model.cfg.vocab_size, LM_SEQ, LM_BATCH, seed)
    state, start = resumed.trainer.restore_or_init()
    (_, _), grads3 = resumed.trainer._grads(state["params"], state["fb"],
                                            resumed.trainer.put(gen.batch(DP_STEPS)),
                                            prng.step_key(seed, DP_STEPS, "noise"))
    out = {"local_err": _dp_rel(dp["local"], {k: v.cpu() for k, v in grads3.items()})}
    del grads3
    state3, metrics3 = resumed.step(state, gen.batch(DP_STEPS))
    out.update(resume_start=start, loss3_one=metrics3["loss"].item(),
               params3_err=_dp_rel({k: v.cpu() for k, v in state3["params"].items()},
                                   dp["params3"]))
    del resumed, state, state3, metrics3
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _dp_two_ranks(torch, pm, seed):
    """Two ranks on the one card over gloo (spawned: the parent has CUDA).
    Each loads the library phase_build built.  Returns (rank 0's results,
    rank 1's, the run's seconds); any rank's failure fails the phase."""
    import multiprocessing as mp
    import queue as queue_lib
    import shutil
    import socket

    base = pm._BUILD_DIR / f"dp-{os.getpid()}"
    base.mkdir(parents=True, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    gc.collect()
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_dp_rank, args=(r, DP_WORLD, port, seed, base, queue))
             for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    results, errors = {}, []
    try:
        for p in procs:
            p.start()
        while len(results) + len(errors) < DP_WORLD:
            if time.perf_counter() - t0 > DP_TIMEOUT_S:
                raise PhaseError(f"the two-rank run passed {DP_TIMEOUT_S} s")
            try:
                rank, res, err = queue.get(timeout=5.0)
            except queue_lib.Empty:  # see whether a rank died without a word
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in results]
                if dead:
                    raise PhaseError(f"rank {dead[0]} exited with {procs[dead[0]].exitcode}")
                continue
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
                break
            results[rank] = res
        if errors:
            raise PhaseError("a rank failed:\n" + "\n".join(errors))
        for p in procs:
            p.join(timeout=60)
        codes = [p.exitcode for p in procs]
        check(codes == [0] * DP_WORLD, f"rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(base, ignore_errors=True)
    return results[0], results[1], time.perf_counter() - t0


def _fsdp_report(np, r0, r1) -> dict:
    """Print and check the two ranks' sharded steps against one process ->
    the summary for the ``data_parallel`` line."""
    ranks = ((0, r0), (1, r1))
    gb = 1e9
    print(f"[fsdp] two ranks on one card, build_train's sharded step on a (2, 1) mesh: "
          f"collectives on {r0['fsdp_transport']}; module parameters released (meta): "
          f"{r0['fsdp_released']} / {r1['fsdp_released']}; shards = the rule's slices of an "
          f"independent init: {not r0['fsdp_not_rules']} / {not r1['fsdp_not_rules']}; the "
          f"ranks' part {r0['fsdp_seconds']:.1f} / {r1['fsdp_seconds']:.1f}s")
    full = r0["fsdp_full_bytes"]
    for r, res in ranks:
        par, mom = res["fsdp_resident"]
        print(f"[fsdp] rank {r} resident: parameters {par / gb:.4f} GB + momentum "
              f"{mom / gb:.4f} GB = {(par + mom) / gb:.4f} GB, against the replicated run's 2 x "
              f"{full / gb:.4f} = {2 * full / gb:.4f} GB ({(par + mom) / (2 * full):.4f} of it); "
              f"bank launches {res['fsdp_launches']} (step 1's gradients, step 2)")
    cost = r0["fsdp_cost"]
    counted, leaves = cost["counted"], cost["leaves"]
    n_max = (counted.get("all-reduce", 0) - leaves["all-reduce"]) / 4
    print(f"[fsdp] step_cost of step 1's gradients, rank 0: "
          + ", ".join(f"{k} {counted.get(k, 0) / gb:.6f} GB in {cost['count'].get(k, 0)} "
                      f"(from the leaves {leaves[k] / gb:.6f})" for k in leaves)
          + f"; the all-reduce's rest {n_max:g} x 4 B (the MAX of the one operand every "
          f"projection reads, the tapped error); "
          f"collective_bytes {cost['as_dict']['collective_bytes'] / gb:.6f} GB")
    for r, res in ranks:
        parts = [f"{kind} {len(v)} x, {sum(ms for ms, _ in v):.2f} ms for "
                 f"{sum(b for _, b in v) / gb:.4f} GB" for kind, v in res["fsdp_collectives"].items()]
        print(f"[fsdp] rank {r} step 2: {res['fsdp_step2_ms']:.2f} ms (CUDA events); collectives "
              f"(gloo, staged by gloo through host memory: not a multi-card rate): "
              + "; ".join(parts))
    print(f"[fsdp] step 1: loss {r0['fsdp_loss1']:.6f} (rank 1 {r1['fsdp_loss1']:.6f}) vs one "
          f"process {r0['loss1_one']:.6f}; gradients max rel {r0['fsdp_grad_err'][0]:.3e} "
          f"({r0['fsdp_grad_err'][1]}); parameters after 2 steps {r0['fsdp_params2_err'][0]:.3e} "
          f"({r0['fsdp_params2_err'][1]}); DTensor's plain Replicate backward (control, rank 0's "
          f"shards) {r0['fsdp_control_err'][0]:.3e} ({r0['fsdp_control_err'][1]})")
    print(f"[fsdp] gate 1e-5 (of each leaf's max |g|, step 1's gradients): data parallel "
          f"{r0['grad_err'][0]:.3e} = {r0['grad_err'][0] / DP_TOL:.3f} of it "
          f"({r0['grad_err'][1]}); FSDP {r0['fsdp_grad_err'][0]:.3e} = "
          f"{r0['fsdp_grad_err'][0] / DP_TOL:.3f} ({r0['fsdp_grad_err'][1]}); parameters after 2 "
          f"steps: data parallel {r0['params2_err'][0]:.3e} = {r0['params2_err'][0] / DP_TOL:.3f}, "
          f"FSDP {r0['fsdp_params2_err'][0]:.3e} = {r0['fsdp_params2_err'][0] / DP_TOL:.3f}")
    hw_same = all(np.array_equal(r0["fsdp_emu_hw"][k], r1["fsdp_emu_hw"][k])
                  and np.array_equal(r0["fsdp_emu_hw"][k], r0["emu_hw_one"][k])
                  for k in r0["fsdp_emu_hw"])
    print(f"[fsdp] MLP on emu_offchip sharded: loss {r0['fsdp_emu_loss']:.6f} (rank 1 "
          f"{r1['fsdp_emu_loss']:.6f}) vs one process {r0['emu_loss_one']:.6f}; parameters after "
          f"the step max rel {r0['fsdp_emu_err'][0]:.3e} ({r0['fsdp_emu_err'][1]}); emu launches "
          f"{r0['fsdp_emu_launches']} / {r1['fsdp_emu_launches']}; hardware state equal on both "
          f"ranks and to one process: {hw_same}")
    for r, res in ranks:
        check(res["fsdp_released"] and not res["fsdp_not_rules"],
              f"rank {r}: parameters not released or shards not the rule's "
              f"{res['fsdp_not_rules'][:3]}")
        check(sum(res["fsdp_resident"]) < 0.51 * 2 * full,
              f"rank {r} holds {res['fsdp_resident']} of {full} B: not sharded")
        check(res["fsdp_launches"] == [DP_LAUNCHES] * 2,
              f"rank {r}: sharded bank launches {res['fsdp_launches']}")
        check(res["fsdp_emu_launches"] == 2, f"rank {r}: emu launches {res['fsdp_emu_launches']}")
    check(r0["fsdp_loss1"] == r1["fsdp_loss1"]
          and abs(r0["fsdp_loss1"] - r0["loss1_one"]) <= DP_TOL * abs(r0["loss1_one"]),
          "the sharded step 1's loss differs from one process")
    check(r0["fsdp_grad_err"][0] <= DP_TOL, f"sharded gradients {r0['fsdp_grad_err']}")
    check(r0["fsdp_params2_err"][0] <= DP_TOL,
          f"sharded parameters after 2 steps {r0['fsdp_params2_err']}")
    check(r0["fsdp_control_err"][0] > DP_LOCAL_MIN,
          f"the Replicate-backward control passed: {r0['fsdp_control_err']}")
    check(all(counted.get(k) == leaves[k] for k in ("all-gather", "reduce-scatter"))
          and n_max == 1,
          f"step_cost's collectives {counted} against the leaves' {leaves}")
    check(r0["fsdp_emu_err"][0] <= FSDP_MLP_TOL and r0["fsdp_emu_loss"] == r1["fsdp_emu_loss"]
          and abs(r0["fsdp_emu_loss"] - r0["emu_loss_one"]) <= FSDP_MLP_TOL
          * abs(r0["emu_loss_one"]) and hw_same,
          "the emu MLP's sharded step differs from one process")
    return {"loss1": r0["fsdp_loss1"], "grad_err": r0["fsdp_grad_err"],
            "params2_err": r0["fsdp_params2_err"], "control_err": r0["fsdp_control_err"],
            "emu_err": r0["fsdp_emu_err"], "resident_bytes": [r0["fsdp_resident"],
                                                             r1["fsdp_resident"]],
            "replicated_bytes": 2 * full, "collective_bytes": counted,
            "collective_bytes_from_leaves": leaves,
            "step2_ms": [r0["fsdp_step2_ms"], r1["fsdp_step2_ms"]],
            "collective_ms": {k: [sum(ms for ms, _ in res["fsdp_collectives"][k])
                                  for _, res in ranks] for k in leaves},
            "bank_launches": sum(r0["fsdp_launches"]), "emu_launches": r0["fsdp_emu_launches"]}


def phase_data_parallel(torch, np, api, pm, em, seed, card):
    """Data parallelism on the one card: a world of one NCCL rank equals one
    process bit for bit (qwen1.5-0.5b at full width, 2 dfa steps); the emu
    kernel's row_base bit for bit under every plan; two ranks on the card
    over gloo (qwen1.5-0.5b's full width at DP_LAYERS = 8 of its 24 layers,
    f32 on offchip_bpd, 32 x 64 rows a rank): step 1's loss and every
    gradient leaf within 1e-5 of its max |g| of the one-process step (at
    the same depth), 9 bank launches a rank a step (rank 0's profile too), the group's s_a and each rank's rows of the global noise
    in use (a rank-local draw misses by more than 1e-3), the parameters
    after 2 steps within 1e-5, step ms and the gradient all-reduce's ms
    (gloo staged through the host, not a multi-card rate); the MLP on
    emu_offchip (gradients within 1e-5, the hardware state equal on both
    ranks); the step-2 snapshot resumed in one process, whose step 3 equals
    rank 0's within 1e-5.  In the same spawn the FSDP checks (``[fsdp]``)
    and tensor parallelism on a (1, 2) mesh (``[tp]``: the dense blocks'
    products column-parallel, step 1's gradients and the parameters after 2
    steps within 1e-5 of one process, a rank's product FLOPs by product
    against one process's, the head kept on its gathered weight (named with
    its split's distance from ``tools/tp_split_ablation.py``), 9 bank
    launches a rank a step, ``step_cost`` = the collectives' bytes), all at
    DP_LAYERS layers; and ``TP_FAMILIES``, qwen2-moe at full width and 4
    layers (the experts expert parallel, the attention and the shared
    experts column-parallel, the router whole) and minicpm3 at full width and 2 layers
    (the latent attention and the FFN column-parallel), as the port runs
    them on (1, 2), each leaf of step 1's gradients and of the parameters
    after 2 steps within 1e-5 of one process's, every split product's
    FLOPs a rank half of one process's, the kept parts printed."""
    t0 = time.perf_counter()
    print(f"[dp] card: {card}; torch {torch.__version__}")
    out = {"world1": _dp_world_one(torch, api, pm, seed)}
    out["row_base"] = _dp_row_base(torch, em)
    out["col_base"] = _tp_col_base(torch, em)
    r0, r1, wall = _dp_two_ranks(torch, pm, seed)
    per_step = {r: res["fit_launches"] / DP_STEPS for r, res in ((0, r0), (1, r1))}
    for r, res in ((0, r0), (1, r1)):
        ms = res["step_ms"]
        red = res["reduce"]
        print(f"[dp] rank {r} of {DP_WORLD} on one card (gloo): {DP_STEPS} fit steps at "
              f"{LM_BATCH // DP_WORLD} x {LM_SEQ} rows, step ms (CUDA events; the third "
              f"under step_cost's counting) {', '.join(f'{x:.2f}' for x in ms)}; gradient "
              f"all-reduce (gloo, staged "
              f"through host memory: not a multi-card rate) "
              f"{', '.join(f'{x:.2f} ms of {b / 1e9:.3f} GB' for x, b in red)}; bank launches "
              f"{res['fit_launches']} in the fit, {res['grad_launches']} in step 3's gradients "
              f"({per_step[r]:g} a step); emu launches {res['emu_launches']} a step; the fit "
              f"{res['fit_s']:.1f}s (init and broadcast included, rank 0 saves at its end), the "
              f"LM part {res['seconds']['lm']:.1f}s, the emu MLP {res['seconds']['emu']:.1f}s, "
              f"the one-process checks {res['seconds']['one_process']:.1f}s")
    print(f"[dp] rank 0's profile of step 3's gradients: {r0['profiled']} bank-kernel launches "
          f"on the device")
    s_a_rel = abs(r0["s_a"][0] - DP_WORLD * r0["s_a_one"]) / (DP_WORLD * r0["s_a_one"])
    print(f"[dp] step 1: loss {r0['loss1']:.6f} (rank 1 {r1['loss1']:.6f}) vs one process "
          f"{r0['loss1_one']:.6f}; max |g - g_one| / max |g_one| over leaves "
          f"{r0['grad_err'][0]:.3e} ({r0['grad_err'][1]}); step 3's with rank-local noise vs the "
          f"resumed one process's {r1['local_err'][0]:.3e} ({r1['local_err'][1]}); s_a of the "
          f"first projection "
          f"{r0['s_a'][0]:.9g} / {r0['s_a'][1]:.9g} on ranks 0 / 1, {DP_WORLD} x the one "
          f"process's {r0['s_a_one']:.9g} within {s_a_rel:.3e} (a rank's error is its rows' "
          f"mean loss's, {DP_WORLD} x the global mean's, up to the head product's rounding); "
          f"each rank's noise = its rows of the one-process draw: {r0['noise_rows']}")
    print(f"[dp] parameters after {DP_STEPS} steps vs one process: max rel "
          f"{r0['params2_err'][0]:.3e} ({r0['params2_err'][1]}); the step-{DP_STEPS} snapshot "
          f"resumed in one process at step {r1['resume_start']}: step {DP_STEPS + 1} loss "
          f"{r1['loss3_one']:.6f} vs rank 0's {r0['loss3']:.6f}, parameters max rel "
          f"{r1['params3_err'][0]:.3e} ({r1['params3_err'][1]}) (the ranks' step-3 states "
          f"agree)")
    hw_same = all(np.array_equal(r0["emu_hw"][k], r1["emu_hw"][k])
                  and np.array_equal(r0["emu_hw"][k], r0["emu_hw_one"][k]) for k in r0["emu_hw"])
    print(f"[dp] MLP on emu_offchip, {DP_MLP_BATCH // DP_WORLD} rows a rank: loss "
          f"{r0['emu_loss']:.6f} vs one process {r0['emu_loss_one']:.6f}, gradients max rel "
          f"{r0['emu_grad_err'][0]:.3e}; hardware state equal on both ranks and to one process: "
          f"{hw_same}; the two-rank run took {wall:.1f}s")
    dp_cost = r0["dp_cost"]
    rest = dp_cost["counted"].get("all-reduce", 0) - dp_cost["grads"]
    print(f"[dp] step_cost of step 3 (rank 0): all-reduce "
          f"{dp_cost['counted'].get('all-reduce', 0) / 1e9:.6f} GB in "
          f"{dp_cost['count'].get('all-reduce', 0)} collectives = the gradients' "
          f"{dp_cost['grads'] / 1e9:.6f} GB + {rest} B (the metrics' f32 scalars and the "
          f"tapped error's 4 B MAX); kinds {sorted(dp_cost['counted'])}")
    check(set(dp_cost["counted"]) == {"all-reduce"} and 4 < rest <= 64 and rest % 4 == 0,
          f"step_cost's data-parallel collectives {dp_cost}")
    check(per_step[0] == per_step[1] == DP_LAUNCHES
          and r0["grad_launches"] == r1["grad_launches"] == DP_LAUNCHES,
          f"bank launches a step {per_step}, expected {DP_LAUNCHES}")
    check(r0["profiled"] == DP_LAUNCHES,
          f"rank 0's profile saw {r0['profiled']} bank launches, expected {DP_LAUNCHES}")
    check(r0["loss1"] == r1["loss1"] and abs(r0["loss1"] - r0["loss1_one"]) <= DP_TOL
          * abs(r0["loss1_one"]), "step 1's loss differs from one process")
    check(r0["grad_err"][0] <= DP_TOL, f"gradients {r0['grad_err']} from one process")
    check(r1["local_err"][0] > DP_LOCAL_MIN,
          f"rank-local noise passed the check: {r1['local_err']}")
    # one MAX over the group: both ranks hold it, and it is the one
    # process's scale (x the world, up to the rounding of the rows' values)
    check(r0["s_a"][0] == r0["s_a"][1] and s_a_rel <= DP_TOL,
          f"s_a {r0['s_a']} vs {DP_WORLD} x {r0['s_a_one']}: not the group's MAX")
    check(all(r0["noise_rows"]), f"noise rows in use {r0['noise_rows']}")
    check(r0["params2_err"][0] <= DP_TOL,
          f"parameters after {DP_STEPS} steps {r0['params2_err']}")
    check(r1["resume_start"] == DP_STEPS and r0["loss3"] == r1["loss3"]
          and abs(r0["loss3"] - r1["loss3_one"]) <= DP_TOL * abs(r1["loss3_one"])
          and r1["params3_err"][0] <= DP_TOL, "the resumed step 3 differs from rank 0's")
    check(r0["emu_grad_err"][0] <= DP_TOL and r0["emu_launches"] == r1["emu_launches"] == 2
          and hw_same, "the emu MLP's two-rank step differs from one process")
    out["fsdp"] = _fsdp_report(np, r0, r1)
    out["tp"] = _tp_report(torch, pm, r0, r1, card)
    out["tp"]["moe"] = _tp_family_report(r0, r1, "moe")
    out["tp"]["mla"] = _tp_family_report(r0, r1, "mla")
    out["two_ranks"] = {k: r0[k] for k in ("loss1", "loss1_one", "grad_err", "params2_err",
                                            "emu_grad_err", "profiled")}
    out["two_ranks"].update({k: r1[k] for k in ("local_err", "params3_err", "loss3_one")})
    out["two_ranks"].update(collective_bytes=dp_cost["counted"],
                            step_ms=[r0["step_ms"], r1["step_ms"]],
                            allreduce_ms=[[x for x, _ in r["reduce"]] for r in (r0, r1)],
                            bank_launches=r0["fit_launches"] + r0["grad_launches"],
                            emu_launches=r0["emu_launches"], wall_s=wall)
    out["seconds"] = time.perf_counter() - t0
    print(f"[dp] done in {out['seconds']:.1f}s")
    return out


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
        cost, _, kernel_bytes = _captured_cost(probe_session, probe_state, gen.batch(0))
        flops = _lm_step_flops(probe_session.model.cfg, LM_BATCH * LM_SEQ)
        report = bench.load_bench(path)
        print(f"[observe] StepTimer (synchronised wall, warmup 1): {summary['steps_measured']} "
              f"steps, {summary['mean_step_s'] * 1e3:.2f} ms mean, {summary['steps_per_s']:.3f} "
              f"steps/s, {summary['examples_per_s']:.1f} examples/s, macs_per_s "
              f"{summary['macs_per_s']:.4e}; env {report['env']}")
        print(f"[observe] step_cost: {cost.flops / 1e12:.4f} TFLOP ({cost.counted_flops / 1e12:.4f} "
              f"seen by FlopCounterMode, {cost.kernel_flops / 1e12:.4f} in {cost.kernel_launches} "
              f"bank-kernel launches) against _lm_step_flops {flops / 1e12:.4f}: ratio "
              f"{cost.flops / flops:.5f} (the difference: attention's score and value products); "
              f"mem_bytes {cost.mem_bytes / 1e9:.4f} GB, kernel_bytes "
              f"{cost.kernel_bytes / 1e9:.4f} GB (the helpers over its launches: "
              f"{kernel_bytes / 1e9:.4f} GB)")
        check(cost.kernel_launches == LM_LAUNCHES, f"step_cost saw {cost.kernel_launches} launches")
        check(cost.kernel_bytes == kernel_bytes and cost.mem_bytes > cost.kernel_bytes,
              f"step_cost bytes: mem {cost.mem_bytes}, kernels {cost.kernel_bytes}, the "
              f"helpers {kernel_bytes}")
        check(flops <= cost.flops <= 1.02 * flops, f"step_cost {cost.flops} vs {flops}")
        check(summary["macs_per_s"] > 0 and report["env"]["device"] == torch.cuda.get_device_name(0),
              "bench report")
        out["step_cost"] = {"flops": cost.flops, "lm_step_flops": flops,
                            "macs_per_s": summary["macs_per_s"], "mem_bytes": cost.mem_bytes,
                            "kernel_bytes": cost.kernel_bytes}

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


# ---------------------------------------------------------------------------
# The simulator, the energy model and the autotuned schedule
# ---------------------------------------------------------------------------

SCHED_BUDGET_W = 78.0  # the modelled chip's wall-plug budget: room for 2 buses at 10 GHz
SCHED_STEPS = 2  # tuned dfa fit steps at batch LM_BATCH x seq LM_SEQ
# the reference's picks (sim.autotune on its own model, CPU): (buses, f_s,
# recalibration cadence) at SCHED_BUDGET_W and unconstrained, and the drift
# budget 0.5·drift_sigma of emu_onchip's device
SCHED_PICKS = {SCHED_BUDGET_W: (2, 10e9, 100), None: (8, 10e9, 100)}
SCHED_DRIFT_BUDGET = 0.025
# sim.autotune_serving's trace: 200 req/s, 256 requests of 32-token prompts
# and 16 decode tokens, p99 under 50 ms at 100 W; the reference picks (1
# bus, 5 GHz, 4 slots)
SERVE_TRACE = dict(rate=200.0, n=256, prompt_len=32, decode_len=16, seed=0)
SERVE_SLO_S, SERVE_BUDGET_W, SERVE_PICK = 0.05, 100.0, (1, 5e9, 4)


def _tuned_fit(torch, api, pm, em, seed, budget, steps, tag, card):
    """qwen1.5-0.5b at full width in f32 on emu_onchip, tuned by
    ``build_session(schedule="auto", power_budget_w=budget,
    recalibrate_every="auto")`` with the observer on, and ``steps`` dfa fit
    steps at LM_BATCH x LM_SEQ with the emu kernel's count set to 0 just
    before and its first launch captured; then one more step timed on the
    card.  Gates: the reference's pick (SCHED_PICKS) and drift budget, the
    monitor's budget the schedule's, a finite loss each step, LM_LAUNCHES
    emu launches a step at q = the tuned bus count, the drift state over
    the tuned buses.  -> a dict; the session is freed."""
    from repro_torch.data import tokens

    log = pm._BUILD_DIR / f"schedule-{os.getpid()}.csv"
    torch.cuda.empty_cache()
    session = _lm_session(api, torch, seed, hardware="emu_onchip", backend="emu",
                          schedule="auto", power_budget_w=budget, recalibrate_every="auto",
                          schedule_batch=LM_BATCH * LM_SEQ, observe=True, log_every=1,
                          log_path=str(log))
    tuned, hw = session.schedule, session.photonics
    got = (tuned.n_buses, tuned.f_s, tuned.recalibrate_every)
    print(f"[{tag}] build_session(schedule='auto', power_budget_w={budget}, "
          f"recalibrate_every='auto') on qwen1.5-0.5b's DFA backward ({LM_BATCH * LM_SEQ} "
          f"vectors, emu_onchip), the modelled chip: {tuned.describe()}; drift budget "
          f"{tuned.drift_budget}; {len(tuned.candidates)} candidates")
    check(got == SCHED_PICKS[budget] and tuned.drift_budget == SCHED_DRIFT_BUDGET
          and (hw.n_buses, hw.f_s) == got[:2] and session.config.recalibrate_every == got[2],
          f"tuned schedule {got}, drift budget {tuned.drift_budget}, not the reference's "
          f"{SCHED_PICKS[budget]}, {SCHED_DRIFT_BUDGET}")
    hwmon = session.observer.hwmon
    check(hwmon is not None and hwmon.drift_budget == tuned.drift_budget,
          "the hardware monitor does not carry the schedule's drift budget")
    gen = tokens.MarkovTokens(session.model.cfg.vocab_size, LM_SEQ, LM_BATCH, seed)
    calls = []
    restore = _wrap(em, "emu_bank_product_cuda", calls, limit=1)
    try:
        sync(torch)
        em.launches = 0
        t0 = time.perf_counter()
        state, _ = session.fit(gen.batch, total_steps=steps, verbose=False)
        sync(torch)
        wall = time.perf_counter() - t0
        launches = em.launches
    finally:
        restore()
    lines = log.read_text().splitlines()
    log.unlink()
    col = lines[0].split(",").index("loss")
    losses = [float(line.split(",")[col]) for line in lines[1:]]
    drift = tuple(state["hw"]["drift"].shape)
    batch = to_device_batch(gen.batch(steps))
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    state, _ = session.step(state, batch)
    e1.record()
    e1.synchronize()
    step_ms = e0.elapsed_time(e1)
    roofline = None
    if budget is not None:
        # one step_cost of the tuned step: LM_LAUNCHES emu launches at the
        # first launch's shapes, each the emu helper's bytes
        captured = _captured_cost(session, state, batch)
        (a_t, delta, mask), _, _ = calls[0]
        per_launch = em.launch_bytes(tuple(a_t.shape), a_t.element_size(), tuple(delta.shape),
                                     mask is not None)
        cost = captured[0]
        check(cost.kernel_launches == LM_LAUNCHES
              and cost.kernel_bytes == LM_LAUNCHES * per_launch,
              f"the tuned step's step_cost: {cost.kernel_launches} launches, kernel_bytes "
              f"{cost.kernel_bytes}, expected {LM_LAUNCHES} x {per_launch}")
        roofline = _step_roofline(session, state, batch, step_ms, tag, card, captured)
        del a_t, delta, mask
    print(f"[{tag}] {steps} dfa steps on the tuned chip ({hw.n_buses} buses, f32, batch "
          f"{LM_BATCH} x seq {LM_SEQ}, observer on) in {wall:.2f}s: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; emu_bank_product launches {launches} = "
          f"{launches / steps:g} a step; drift state {drift}; monitor budget "
          f"{hwmon.drift_budget}; one more step {step_ms:.2f} ms (CUDA events)")
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"non-finite or missing step losses: {losses}")
    check(launches == LM_LAUNCHES * steps,
          f"{launches} emu launches, expected {LM_LAUNCHES} a step")
    check(drift == (hw.n_buses, hw.bank_rows, hw.bank_cols), f"drift state {drift}")
    (a_t, delta, mask), kw, out = calls[0]
    check(a_t.shape[1] == hw.n_buses, f"the path ran a_t {tuple(a_t.shape)}")
    del state, session, batch
    torch.cuda.empty_cache()
    return {"tuned": tuned, "launches": launches, "losses": losses, "wall_s": wall,
            "step_ms": step_ms, "roofline": roofline, "call": ((a_t, delta, mask), kw, out)}


def _emu_row(torch, em, case, kw, peaks, draw, sms, reps=25):
    """The emu kernel on ``case`` (a_t, δ, mask, n_panels) beside its plain
    version (CUDA events, one call after one warm-up) and its bound."""
    a_t, delta, mask, _ = case
    row = _time_fns(torch, {"ms": lambda: em.emu_bank_product_cuda(a_t, delta, mask, **kw)},
                    {"ms": reps})
    row["plain_ms"] = _event_ms(torch, lambda: em.emu_bank_product_plain(a_t, delta, mask, **kw),
                                reps=1, warm=1)
    row["bound_ms"], row["bound_by"], binding, terms = emu_bound(case, kw["sigma"], kw["shot"],
                                                                 peaks, draw, sms)
    row.update(library_ms=None, plan=em.plan_for(a_t, delta, mask).name, binding=binding,
               terms_ms={name: v * 1e3 for name, v in terms.items()},
               bound_share=row["bound_ms"] / row["dev_ms"])
    return row


def _print_emu_row(tag, label, row):
    print(f"[{tag}] {label}: kernel {row['ms']:.4f} / {row['dev_ms']:.4f} ms (events / device), "
          f"plain {row['plain_ms']:.4f} (events), bound {row['bound_ms']:.4f} ({row['binding']}: "
          + " / ".join(f"{k} {v:.5f}" for k, v in row["terms_ms"].items())
          + f"), share {row['bound_share']:.1%}, plan {row['plan']}")


def phase_schedule(torch, np, api, pm, em, seed, card, draws):
    """The simulator and the energy model on the path they steer.  The
    energy model's headline numbers (the modelled photonic chip's); a
    full-width f32 qwen1.5-0.5b session tuned by ``build_session(
    schedule="auto", power_budget_w=78, recalibrate_every="auto")`` on
    emu_onchip (``_tuned_fit``: the reference's pick, 2 buses at 10 GHz,
    recalibration every 100 steps, drift budget 0.025), 2 dfa fit steps
    with the observer, 25 emu launches a step at q = 2; tuned again without
    a budget (8 buses) and 1 step at q = 8 (nj = 7, four padded slots); the
    kernel against its plain version bit for bit on the first launch of
    each run, under every plan at q = 8, and timed; the search again with
    the card's measured step as the digital time; ``autotune_serving`` on a
    Poisson trace; both trace exporters into one file that loads."""
    import dataclasses
    import tempfile

    from repro_torch import sim
    from repro_torch.core import energy
    from repro_torch.core import photonics as ph
    from repro_torch.obs import export

    tag = "schedule"
    peaks = card_peaks(card)[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    heat, trim = energy.EnergyConfig(), energy.EnergyConfig(trimming=True)
    head = {"tops": energy.ops_per_second(50, 20, heat) / 1e12,
            "pj_per_op_heaters": energy.energy_per_op(50, 20, heat) * 1e12,
            "pj_per_op_trimmed": energy.energy_per_op(50, 20, trim) * 1e12,
            "tops_mm2": energy.compute_density_tops_mm2(50, 20, heat),
            "bus_w": {n: energy.total_power(50, 20, dataclasses.replace(heat, n_buses=n))
                      for n in (1, 2, 4, 8)}}
    print(f"[{tag}] energy model (the modelled photonic chip, not the card): a 50x20 bank at "
          f"10 GHz {head['tops']:.2f} TOPS, {head['pj_per_op_heaters']:.4f} pJ/op with heaters, "
          f"{head['pj_per_op_trimmed']:.4f} pJ/op trimmed, {head['tops_mm2']:.4f} TOPS/mm²; "
          "wall-plug W by buses " + ", ".join(f"{n}: {w:.2f}" for n, w in head["bus_w"].items()))
    check(round(head["tops"], 6) == 20.0 and abs(head["pj_per_op_heaters"] - 1.0) < 0.05
          and abs(head["pj_per_op_trimmed"] - 0.28) < 0.02 and abs(head["tops_mm2"] - 5.78) < 0.05,
          f"energy model headline numbers: {head}")

    runs, rows, err, n_plans = {}, {}, 0.0, 0
    for name, budget, steps in (("q2", SCHED_BUDGET_W, SCHED_STEPS), ("q8", None, 1)):
        run = runs[name] = _tuned_fit(torch, api, pm, em, seed, budget, steps, tag, card)
        (a_t, delta, mask), kw, out = run.pop("call")
        nj = -(-52 // run["tuned"].n_buses)
        check(a_t.shape[-3:-1] == (run["tuned"].n_buses, nj) and kw["n_panels"] == 52,
              f"{name}: a_t {tuple(a_t.shape)}, {kw['n_panels']} panels")
        expect = em.emu_bank_product_plain(a_t, delta, mask, **kw)
        err = max(err, _emu_exact(torch, em, out, expect, kw, f"the {name} path's first launch"))
        plans = _emu_candidates(em, a_t, delta, mask) if name == "q8" else []
        for plan in plans:
            err = max(err, _emu_exact(torch, em, em.launch_kernel(a_t, delta, mask, plan=plan,
                                                                  **kw),
                                      expect, kw, f"{name} {plan.name}"))
        n_plans += len(plans)
        del expect, out
        rows[name] = _emu_row(torch, em, (a_t, delta, mask, kw["n_panels"]), kw, peaks,
                              draws["emu"], sms)
        _print_emu_row(tag, f"the {name} path's first launch, a_t {tuple(a_t.shape)} "
                       f"({LM_BATCH * LM_SEQ}, 1024, 1024) f32, σ {kw['sigma']}, ADC "
                       f"{kw['adc_bits']} bits: kernel = plain bit for bit"
                       + (f" under {len(plans)} plans" if plans else ""), rows[name])
        del a_t, delta, mask
        torch.cuda.empty_cache()
    tuned = runs["q2"]["tuned"]

    # the card's measured step as the digital step the photonic stream
    # overlaps: the same search on the meta device (nothing allocated)
    step_s = runs["q2"]["step_ms"] * 1e-3
    overlap = api.build_session(
        arch=ARCH, smoke=False, hardware="emu_onchip", backend="emu", schedule="auto",
        power_budget_w=SCHED_BUDGET_W, recalibrate_every="auto",
        schedule_batch=LM_BATCH * LM_SEQ, digital_step_s=step_s, device="meta").schedule
    meta = api.build_model(ARCH, device="meta")
    print(f"[{tag}] with the card's measured step ({step_s * 1e3:.2f} ms, {card}) as "
          f"digital_s, the modelled chip: {overlap.describe()}; without: {tuned.describe()}")
    check(overlap.digital_s == step_s and overlap.wall_clock_s >= step_s,
          "the overlapped step is shorter than its digital part")

    # serving: the SLO-constrained search on a Poisson trace
    reqs = sim.poisson_requests(**SERVE_TRACE)
    serving = sim.autotune_serving(meta, reqs, ph.PhotonicConfig(), slo_p99_s=SERVE_SLO_S,
                                   power_budget_w=SERVE_BUDGET_W)
    print(f"[{tag}] autotune_serving, {SERVE_TRACE['n']} requests at {SERVE_TRACE['rate']} req/s,"
          f" p99 SLO {SERVE_SLO_S * 1e3:.0f} ms, {SERVE_BUDGET_W} W, the modelled chip: "
          f"{serving.describe()}")
    check((serving.n_buses, serving.f_s, serving.batch_slots) == SERVE_PICK,
          f"serving pick {(serving.n_buses, serving.f_s, serving.batch_slots)}")

    # both exporters into one trace file
    with tempfile.TemporaryDirectory(prefix="schedule-", dir=pm._BUILD_DIR) as tmp:
        rec = export.pipeline_to_trace(tuned.report)
        svc = sim.service_model(meta, ph.PhotonicConfig(n_buses=serving.n_buses),
                                f_s=serving.f_s)
        sim.simulate_serving(reqs, svc, batch_slots=serving.batch_slots, trace=rec)
        path = export.write(rec, os.path.join(tmp, "sim.json"))
        events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    pipe = {(e["pid"], e["tid"]) for e in events
            if e["ph"] == "X" and e["pid"] == export.SIM_PIPELINE_PID}
    rounds = sum(e["ph"] == "X" and e["pid"] == export.SIM_SERVING_PID for e in events)
    lifecycles = sum(e["ph"] == "b" for e in events)
    want = tuned.n_buses * (len(sim.STAGES) + 1)
    print(f"[{tag}] trace: {len(events)} events, {len(pipe)} pipeline tracks (one per bus x "
          f"stage: {want}), {rounds} serving rounds, {lifecycles} request tracks")
    check(len(pipe) == want and lifecycles == SERVE_TRACE["n"] and rounds > 0,
          f"trace tracks {len(pipe)} (want {want}), {lifecycles} requests")
    return {"launches": {name: run["launches"] for name, run in runs.items()},
            "q8_plans": n_plans, "max_abs_err": err, "energy": head,
            "tuned": {name: run["tuned"].describe() for name, run in runs.items()},
            "overlap": overlap.describe(), "serving": serving.describe(),
            "step_ms": {name: run["step_ms"] for name, run in runs.items()},
            "roofline": runs["q2"]["roofline"],
            "losses": {name: run["losses"] for name, run in runs.items()}, "rows": rows}


# ---------------------------------------------------------------------------
# The Mamba-2 family: mamba2-130m served and DFA-trained at full width
# ---------------------------------------------------------------------------

MAMBA = "mamba2-130m"
# bank products of one token: in_proj (3352, 768) and out_proj (768, 1536)
# in each of the 24 layers, and the head (50280, 768); (M, K): count
MAMBA_SHAPES = {(3352, 768): 24, (768, 1536): 24, (50280, 768): 1}
MAMBA_FORWARD = sum(MAMBA_SHAPES.values())  # 49
MAMBA_BATCH, MAMBA_SEQ = 8, 512  # two SSD chunks of 256; 4096 rows per DFA projection
MAMBA_STEPS, MAMBA_EMU_STEPS = 8, 4  # f32 dfa fit steps, then emu steps


def _mamba_forwards(eng, chunk):
    """Forwards an engine ran: one per decode step and one per token
    position of every prefill chunk (the masked decode-scan)."""
    return eng.stats["decode_steps"] + eng.stats["prefill_steps"] * chunk


def _mamba_serve(torch, np, api, pm, seed):
    """mamba2-130m full() in bf16 on offchip_bpd, ``cuda`` backend, 4 slots:
    8 requests of 32-token prompts and 16 new tokens, prefill chunk 16; the
    bank kernel against its plain version on the operands the path gave it
    (the first call of each of the three shapes)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.serve import Request

    session = api.build_session(arch=MAMBA, algo="bp", smoke=False, hardware="offchip_bpd",
                                backend="cuda", dtype=torch.bfloat16, seed=seed, device=DEVICE)
    model = session.model
    cfg = model.cfg
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.d_state, cfg.head_dim, cfg.chunk)
          == (24, 768, 50280, 128, 64, 256), "not mamba2-130m's full config")
    n_params = sum(p.numel() for p in model.parameters())
    check(len(model.forward_gemm_specs()) == MAMBA_FORWARD, "not 49 bank products a token")
    rng = np.random.default_rng(seed + 3)
    warm = session.engine(batch_slots=4, max_len=128, prefill_chunk=16, seed=seed)
    warm.run([Request(prompt=_prompts(rng, 1, 8, cfg.vocab_size)[0], max_new=2)])
    eng = session.engine(batch_slots=4, max_len=128, prefill_chunk=16, seed=seed)
    finite = _finite_outputs(torch, eng)
    reqs = [Request(prompt=p, max_new=16) for p in _prompts(rng, 8, 32, cfg.vocab_size)]
    captured = {}
    kernel = kops.photonic_matmul_cuda

    def capture(a, b, **kw):
        out = kernel(a, b, **kw)
        captured.setdefault((tuple(a.shape), tuple(b.shape)), (a, b, kw, out))
        return out

    kops.photonic_matmul_cuda = capture
    try:
        sync(torch)
        pm.launches = 0
        t0 = time.perf_counter()
        eng.run(reqs)
        sync(torch)
        wall = time.perf_counter() - t0
        launches = pm.launches
    finally:
        kops.photonic_matmul_cuda = kernel
    forwards = _mamba_forwards(eng, 16)
    tokens = sum(len(r.out) for r in reqs)
    ttft = statistics.median(r.ttft_s for r in reqs)
    print(f"[mamba_serve] mamba2-130m full() ({n_params / 1e6:.1f} M parameters) bf16, "
          f"offchip_bpd, cuda backend: {len(reqs)} requests, {tokens} tokens in {wall:.3f}s: "
          f"{tokens / wall:.1f} tok/s, ttft p50 {ttft * 1e3:.1f} ms; prefill steps "
          f"{eng.stats['prefill_steps']} (x 16 token positions, the masked decode-scan), "
          f"decode steps {eng.stats['decode_steps']}")
    print(f"[mamba_serve] photonic_matmul launches {launches} = {MAMBA_FORWARD} x {forwards} "
          f"forwards ({eng.stats['decode_steps']} decode + {eng.stats['prefill_steps'] * 16} "
          f"prefilled positions): {launches == MAMBA_FORWARD * forwards}")
    check(all(r.done and len(r.out) == 16 for r in reqs), "requests unfinished")
    check(launches == MAMBA_FORWARD * forwards,
          f"launches {launches} != {MAMBA_FORWARD} x {forwards}")
    check(finite(), "non-finite logits")
    shapes = {(a[0], a[1], b[0]) for a, b in captured}
    check(shapes == {(4, k, m) for m, k in MAMBA_SHAPES},
          f"the path's (T, K, M) {sorted(shapes)}, not the three decode shapes")
    tol, max_err = TOL["bfloat16"], 0.0
    modes = sorted({"input" if "noise" in kw else "none" for _, _, kw, _ in captured.values()})
    for (a_shape, b_shape), (a, b, kw, out) in captured.items():
        check(a.dtype == b.dtype == torch.bfloat16,
              f"the path handed the kernel {a.dtype} / {b.dtype} operands")
        expect = pm.photonic_matmul_plain(a, b, **kw)
        err = (out - expect).abs().max().item()
        scale = expect.abs().max().item()
        check(err <= tol * scale + 1e-6,
              f"kernel vs plain at a {a_shape} b {b_shape}: {err} of max {scale}")
        max_err = max(max_err, err / scale)
    print(f"[mamba_serve] kernel vs plain on the path's own bf16 operands (first call of each "
          f"(T, K, M): {', '.join(str(x) for x in sorted(shapes))}; "
          f"{'/'.join(modes)} noise): max |kernel - plain| / max|plain| = {max_err:.3e} "
          f"(tol {tol})")
    del eng, warm, session, model, captured
    torch.cuda.empty_cache()
    return {"launches": launches, "tok_s": tokens / wall, "ttft_ms": ttft * 1e3,
            "wall_s": wall, "forwards": forwards, "n_params": n_params, "max_rel_err": max_err}


def _mamba_parity(torch, np, api, seed):
    """full() in f32 on the ideal preset: the ``cuda`` backend against the
    ``ref`` backend, teacher-forced (two prefill chunks of 16 by the
    decode-scan, then 8 decode steps); then the engine's greedy tokens at
    prefill chunk 16 and 1 on ``cuda``."""
    from repro_torch.core import photonics as ph
    from repro_torch.serve import Engine, Request
    from repro_torch.serve.decode import make_prefill_step

    model = api.build_model(MAMBA, dtype=torch.float32, device=DEVICE, seed=seed)
    rng = np.random.default_rng(seed + 4)
    prompts = _prompts(rng, 4, 32, model.cfg.vocab_size)
    tokens = torch.tensor(prompts, device=DEVICE)
    prefill, chunk, n_decode = make_prefill_step(model), 16, 8

    def run(backend, forced=None):
        caches = model.init_caches(4)
        cache_len = torch.zeros(4, dtype=torch.long, device=DEVICE)
        full = torch.full((4,), chunk, dtype=torch.long, device=DEVICE)
        logits_seq, chosen = [], []
        with torch.no_grad(), ph.forward_execution(ph.PRESETS["ideal"], backend):
            for c0 in range(0, tokens.shape[1], chunk):
                last, caches, cache_len = prefill(tokens[:, c0:c0 + chunk], full, caches,
                                                  cache_len)
                logits_seq.append(last)
            tok = last.argmax(-1)
            for s in range(n_decode):
                tok = forced[s] if forced is not None else tok
                chosen.append(tok)
                logits, caches = model.decode_step(tok[:, None], caches, cache_len)
                cache_len = cache_len + 1
                logits_seq.append(logits[:, -1].float())
                tok = logits[:, -1].argmax(-1)
        return logits_seq, chosen

    ref_logits, ref_tokens = run("ref")
    cuda_logits, _ = run("cuda", forced=ref_tokens)
    worst, gated, agree = _logit_agreement(ref_logits, cuda_logits)
    print(f"[mamba_parity] f32 ideal, cuda vs ref over {len(ref_logits)} forwards (2 decode-scan "
          f"prefill chunks + {n_decode} decode steps): max |Δlogit| / max|logit| = {worst:.3e} "
          f"(limit 1e-4); greedy tokens agree at {agree}/{gated} positions with a top-2 gap > "
          f"1e-3·max|logit|")
    check(worst <= 1e-4, f"cuda vs ref logits differ by {worst:.3e} of max|logit|")
    check(agree == gated, "greedy tokens differ where the top-2 gap is clear")

    outs = {}
    for c in (16, 1):
        eng = Engine(model, batch_slots=4, max_len=64, prefill_chunk=c, backend="cuda",
                     photonics=ph.PRESETS["ideal"], seed=seed)
        reqs = [Request(prompt=list(p), max_new=8) for p in prompts]
        eng.run(reqs)
        outs[c] = [r.out for r in reqs]
    same = outs[16] == outs[1]
    print(f"[mamba_parity] engine on cuda, f32 ideal: prefill chunk 16 and chunk 1 give the same "
          f"greedy tokens for 4 requests x 8: {same}")
    check(same, f"chunked and token-by-token prefill differ: {outs}")
    del model
    torch.cuda.empty_cache()
    return worst


def _emu_run_captured(torch, em, eng, reqs):
    """Run ``reqs`` on ``eng`` with the emu kernel's launches counted and
    the first call of each (a_t, δ) shape captured.  -> (captured {shapes:
    (a_t, δ, dead mask, kw)}, launches, wall seconds)."""
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
    return captured, launches, wall


def _emu_path_exact(torch, em, captured, label):
    """The emu kernel against its plain version on each captured path
    operand set (bf16 inputs, f32 detunings), bit for bit under every plan
    of the forced grid.  -> (max |kernel - plain|, plans run)."""
    max_err, n_plans = 0.0, 0
    for (a_shape, d_shape), (a_t, delta, mask, kw) in captured.items():
        check(a_t.dtype == torch.bfloat16 and delta.dtype == torch.float32,
              f"the path handed the kernel {a_t.dtype} inputs and {delta.dtype} detunings")
        expect = em.emu_bank_product_plain(a_t, delta, mask, **kw)
        plans = _emu_candidates(em, a_t, delta, mask)
        for plan in plans:
            got = em.launch_kernel(a_t, delta, mask, plan=plan, **kw)
            max_err = max(max_err, _emu_exact(
                torch, em, got, expect, kw, f"{label}'s operands a_t {a_shape} δ {d_shape} "
                f"{plan.name}"))
        n_plans += len(plans)
    return max_err, n_plans


def _mamba_emu_serve(torch, np, api, em, seed):
    """4 requests (16-token prompts, 8 new tokens) on emu_offchip in bf16:
    49 emu launches a forward; the kernel against its plain version on the
    operands the path gave it (the first call of each shape), bit for bit
    under the planner's plan and the forced grid."""
    from repro_torch.serve import Request

    session = api.build_session(arch=MAMBA, algo="bp", smoke=False, hardware="emu_offchip",
                                backend="emu", dtype=torch.bfloat16, seed=seed, device=DEVICE)
    vocab = session.model.cfg.vocab_size
    eng = session.engine(batch_slots=4, max_len=64, prefill_chunk=16, seed=seed)
    check(eng.hw_state is not None and eng._backend.name == "emu", "no drift state / backend")
    finite = _finite_outputs(torch, eng)
    reqs = [Request(prompt=p, max_new=8)
            for p in _prompts(np.random.default_rng(seed + 5), 4, 16, vocab)]
    captured, launches, wall = _emu_run_captured(torch, em, eng, reqs)
    forwards = _mamba_forwards(eng, 16)
    tokens = sum(len(r.out) for r in reqs)
    print(f"[mamba_emu] {len(reqs)} requests, {tokens} tokens in {wall:.3f}s: "
          f"{tokens / wall:.2f} tok/s; emu_bank_product launches {launches} = {MAMBA_FORWARD} x "
          f"{forwards} forwards: {launches == MAMBA_FORWARD * forwards}")
    check(all(r.done and len(r.out) == 8 for r in reqs), "requests unfinished")
    check(launches == MAMBA_FORWARD * forwards,
          f"launches {launches} != {MAMBA_FORWARD} x {forwards}")
    check(finite(), "non-finite logits")
    max_err, n_plans = _emu_path_exact(torch, em, captured, "mamba")
    print(f"[mamba_emu] kernel vs plain on the path's own operands (bf16 a_t, f32 δ; "
          f"{', '.join(str(a) for a, _ in captured)}), {n_plans} plans in all: equal bit for "
          f"bit (max |kernel - plain| {max_err:.3e})")
    check(len(captured) == len(MAMBA_SHAPES), f"{len(captured)} shapes captured")
    del eng, session, captured
    torch.cuda.empty_cache()
    return launches, max_err


def _mamba_train(torch, np, api, pm, em, seed, card, draws):
    """full() in f32, batch 8 x seq 512 of ``MarkovTokens``: 16 ``dfa`` fit
    steps on offchip_bpd (``cuda``) and 4 on emu_offchip (``emu``)."""
    from repro_torch.data import tokens

    log = pm._BUILD_DIR / f"mamba_train-{os.getpid()}.csv"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30
    session = api.build_session(arch=MAMBA, smoke=False, dtype=torch.float32, seed=seed,
                                algo="dfa", hardware="offchip_bpd", backend="cuda",
                                log_every=1, log_path=str(log), device=DEVICE)
    model, cfg = session.model, session.model.cfg
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.chunk) == (24, 768, 50280, 256)
          and model.head["out"].weight.dtype == torch.float32, "not the full f32 model")
    check(MAMBA_SEQ // cfg.chunk == 2, "not two SSD chunks")
    gen = tokens.MarkovTokens(cfg.vocab_size, MAMBA_SEQ, MAMBA_BATCH, seed)
    fixed = to_device_batch(gen.batch(10**6))
    with torch.no_grad():
        ce0 = model.loss(session.init_state()["params"], fixed)[1]["ce_loss"].item()
    fit = _fit_logged(torch, pm, session, gen, MAMBA_STEPS, log)
    launches, losses = fit["launches"], fit["losses"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 - base_gib
    with torch.no_grad():
        ce1 = model.loss(fit["state"]["params"], fixed)[1]["ce_loss"].item()
    print(f"[mamba_train] mamba2-130m full width f32, offchip_bpd, cuda backend, batch "
          f"{MAMBA_BATCH} x seq {MAMBA_SEQ} (2 SSD chunks of {cfg.chunk}): {MAMBA_STEPS} fit steps "
          f"in {fit['wall']:.2f}s; loss per step {', '.join(f'{x:.4f}' for x in losses)}; fixed "
          f"batch ce_loss {ce0:.4f} -> {ce1:.4f}; photonic_matmul launches {launches} = "
          f"{launches / MAMBA_STEPS:g} per step; peak device memory {peak_gib:.2f} GiB above "
          f"the {base_gib:.2f} GiB resident before the session")
    _check_fit(fit, MAMBA_STEPS, LM_LAUNCHES)
    check(math.isfinite(ce1), "non-finite fixed-batch loss")

    # one step's own operands against the plain version; ideal cuda vs ref
    calls, errs, step, out = _step_projections(torch, pm, session, fit["state"], gen, seed,
                                               LM_LAUNCHES, MAMBA_BATCH * MAMBA_SEQ,
                                               "mamba_train")
    del out
    _ideal_cuda_vs_ref(torch, session, fit["state"], step, "mamba_train")
    (a, b), kw, _ = calls[0]
    operands = (a, b, kw["noise"])
    del calls, step, a, b, kw
    torch.cuda.empty_cache()

    # step time on CUDA events, three steps under the profiler, step_cost
    batches = [to_device_batch(gen.batch(i)) for i in range(MAMBA_STEPS, MAMBA_STEPS + 8)]
    prof = _step_timing(torch, session, fit, batches, 2, 3, "mamba_train", card)
    prof["peak_gib"] = peak_gib
    del session, model, fit, batches
    torch.cuda.empty_cache()

    # emu_offchip: 4 steps through the emulated banks
    emu = _emu_fit(torch, em, lambda: api.build_session(
        arch=MAMBA, smoke=False, dtype=torch.float32, seed=seed, algo="dfa",
        hardware="emu_offchip", backend="emu", log_every=10**9, device=DEVICE),
        gen, MAMBA_EMU_STEPS, LM_LAUNCHES, "mamba_train", "mamba_timing", card, draws, "mamba")
    return {"launches": launches, "emu_launches": emu["launches"],
            "max_abs_err": max(errs.values()), "emu_max_abs_err": emu["max_abs_err"],
            "operands": operands, "emu": emu["row"], "profile": prof}


def phase_mamba(torch, np, api, pm, em, seed, card, draws):
    """The Mamba-2 family at full width (mamba2-130m: 24 layers, d 768,
    vocab 50280, d_state 128, chunk 256; random weights from ``seed``):
    serving in bf16 through the bank kernel (49 launches a forward, the
    prefill by the masked decode-scan, the kernel against its plain version
    on the path's operands) with a profiled prefill tick and two
    decode ticks; f32 cuda-vs-ref parity and chunk 16 = chunk 1; serving
    through emulated banks with the emu kernel bit for bit; DFA training
    (16 steps on ``cuda``, 4 on ``emu``, 25 launches a step each); both
    kernels timed at the Mamba shapes beside their plain versions,
    torch.matmul and their bounds."""
    kind, peaks = card_peaks(card)
    serve = _mamba_serve(torch, np, api, pm, seed)
    profile = phase_profile_ticks(torch, np, api, seed, tag="mamba_serve", arch=MAMBA)
    parity = _mamba_parity(torch, np, api, seed)
    emu_launches, emu_err = _mamba_emu_serve(torch, np, api, em, seed)
    train = _mamba_train(torch, np, api, pm, em, seed, card, draws)
    gen = torch.Generator(device=DEVICE).manual_seed(18)
    print(f"[mamba_timing] the bank kernel at mamba2-130m's decode shapes (T = 4, bf16) and its "
          f"training shape (input mode, f32); {kind} peaks; card: {card}")
    decode, per_token = _decode_rows(torch, pm, {(4, k, m): count for (m, k), count
                                                 in MAMBA_SHAPES.items()},
                                     peaks, gen, "mamba_timing", "")
    a, b, noise = train.pop("operands")
    train_row = _bank_row(torch, pm, a, b, {"noise": noise}, peaks, "input", "mamba_timing", "")
    train_row["launches_per_step"] = LM_LAUNCHES
    print(f"[mamba_timing] the path's {LM_LAUNCHES} launches a dfa step: "
          f"{train_row['dev_ms'] * LM_LAUNCHES:.3f} ms device of the step's "
          f"{train['profile']['step_ms']:.1f} ms")
    del a, b, noise
    torch.cuda.empty_cache()
    return {"serve_launches": serve["launches"], "train_launches": train["launches"],
            "emu_serve_launches": emu_launches, "emu_train_launches": train["emu_launches"],
            "max_abs_err": train["max_abs_err"],
            "emu_max_abs_err": max(emu_err, train["emu_max_abs_err"]),
            "serve": serve, "profile": profile, "parity": parity, "decode_forward": per_token,
            "decode_shapes": decode, "train_shape": train_row, "emu_train_shape": train["emu"],
            "train": train["profile"]}


# ---------------------------------------------------------------------------
# the dense attention families (phase_dense)
# ---------------------------------------------------------------------------
QWEN3, MINICPM3, GRANITE = "qwen3-1.7b", "minicpm3-4b", "granite-8b"
# (n_layers, d_model, d_ff, vocab) of each full() and its bank products a
# token: 7 a layer (MLA's q_down, q_up, kv_down and o in place of q, k, v
# and o; the absorbed k_up / v_up are digital) and the head
DENSE_FULL = {QWEN3: (28, 2048, 6144, 151936), MINICPM3: (62, 2560, 6400, 73448),
              GRANITE: (36, 4096, 14336, 49152)}
DENSE_FORWARD = {arch: 7 * dims[0] + 1 for arch, dims in DENSE_FULL.items()}  # 197, 435, 253
DENSE_STEPS = {QWEN3: 2, MINICPM3: 2}  # f32 dfa fit steps at batch 64 x seq 64
DENSE_EMU_STEPS = 2
LONG_BATCH, LONG_SEQ, LONG_STEPS = 2, 4096, 1  # above 2·k_chunk: flash_attention
FLASH_TOL = 2e-5  # the reference's flash-vs-reference bound (tests/test_layers.py)
SKINNY_K = 14336  # granite's down projection: f32 A staged in 229,376 B of shared memory
FREE_GIB = 5.0  # device memory a training run must leave free
# copies of the f32 parameters alive at a dfa step's update: the state's,
# its momentum, the gradients, the new parameters and momentum (the
# optimizer is functional, as the reference's), and the module's own copy,
# which the reference does not hold; a fit's module shares its state's
# parameters (``Trainer._adopt``), so a fit's update holds FIT_COPIES.
# The MoE and the batch-sized phases keep STATE_COPIES (their depths and
# batches as recorded)
STATE_COPIES = 6
FIT_COPIES = 5


def _dense_decode_shapes(model):
    """{(T, K, M): count} of one decode step's bank products (T = 4 slots)."""
    shapes = {}
    for _, m, k in model.forward_gemm_specs():
        shapes[(4, k, m)] = shapes.get((4, k, m), 0) + 1
    return shapes


def _serve_captured(torch, np, pm, session, seed, key, per_forward, tag, scan=False,
                    n_requests=8):
    """Serve ``session``'s model (4 slots, prefill chunk 16): a warm-up
    request, then ``n_requests`` of 32-token prompts and 16 new tokens with the
    bank kernel's launches counted (``per_forward`` a forward) and the first
    call of each ``key(a, b)`` captured as (a, b, kw, out); the requests
    finish, the logits are finite.  ``scan``: the model prefills by the
    masked decode-scan, one forward a token position of each chunk.  -> the
    run's numbers with ``captured``."""
    from repro_torch.kernels import ops as kops
    from repro_torch.serve import Request

    model = session.model
    vocab = model.cfg.vocab_size
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(seed + 7)
    warm = session.engine(batch_slots=4, max_len=128, prefill_chunk=16, seed=seed)
    warm.run([Request(prompt=_prompts(rng, 1, 8, vocab)[0], max_new=2)])
    del warm
    eng = session.engine(batch_slots=4, max_len=128, prefill_chunk=16, seed=seed)
    finite = _finite_outputs(torch, eng)
    reqs = [Request(prompt=p, max_new=16) for p in _prompts(rng, n_requests, 32, vocab)]
    captured = {}
    kernel = kops.photonic_matmul_cuda

    def capture(a, b, **kw):
        out = kernel(a, b, **kw)
        captured.setdefault(key(a, b), (a, b, kw, out))
        return out

    kops.photonic_matmul_cuda = capture
    try:
        sync(torch)
        pm.launches = 0
        t0 = time.perf_counter()
        eng.run(reqs)
        sync(torch)
        wall = time.perf_counter() - t0
        launches = pm.launches
    finally:
        kops.photonic_matmul_cuda = kernel
    forwards = (_mamba_forwards(eng, 16) if scan
                else eng.stats["prefill_steps"] + eng.stats["decode_steps"])
    tokens = sum(len(r.out) for r in reqs)
    ttft = statistics.median(r.ttft_s for r in reqs)
    print(f"[{tag}] full() ({n_params / 1e9:.3f} B parameters) bf16, offchip_bpd, cuda "
          f"backend: {len(reqs)} requests, {tokens} tokens in {wall:.3f}s: {tokens / wall:.1f} "
          f"tok/s, ttft p50 {ttft * 1e3:.1f} ms; prefill steps {eng.stats['prefill_steps']}, "
          f"decode steps {eng.stats['decode_steps']}")
    print(f"[{tag}] photonic_matmul launches {launches} = {per_forward} x {forwards} forwards: "
          f"{launches == per_forward * forwards}")
    check(all(r.done and len(r.out) == 16 for r in reqs), "requests unfinished")
    check(launches == per_forward * forwards,
          f"launches {launches} != {per_forward} x {forwards}")
    check(finite(), "non-finite logits")
    return {"launches": launches, "tok_s": tokens / wall, "ttft_ms": ttft * 1e3, "wall_s": wall,
            "forwards": forwards, "n_params": n_params, "captured": captured}


def _captured_vs_plain(torch, pm, captured, what):
    """Each captured bf16 launch (a, b, kw, out) against the plain version
    on its own operands, within the bf16 bound of max|plain|.  -> the
    largest such difference."""
    tol, max_err = TOL["bfloat16"], 0.0
    for key, (a, b, kw, out) in sorted(captured.items()):
        check(a.dtype == b.dtype == torch.bfloat16,
              f"the path handed the kernel {a.dtype} / {b.dtype} operands")
        expect = pm.photonic_matmul_plain(a, b, **kw)
        err = (out - expect).abs().max().item() / expect.abs().max().item()
        check(err <= tol, f"kernel vs plain at {what} = {key}: {err:.3e} of max|plain|")
        max_err = max(max_err, err)
        del expect
    return max_err


def _dense_serve(torch, np, api, pm, arch, seed):
    """``arch``'s full() in bf16 on offchip_bpd, ``cuda`` backend, 4 slots:
    8 requests of 32-token prompts and 16 new tokens, prefill chunk 16;
    the bank kernel against its plain version on the path's own operands
    (the first call of each (T, K, M)); then a prefill tick and two decode
    ticks under the profiler on the same session."""
    tag = f"dense_serve {arch}"
    session = api.build_session(arch=arch, algo="bp", smoke=False, hardware="offchip_bpd",
                                backend="cuda", dtype=torch.bfloat16, seed=seed, device=DEVICE)
    model = session.model
    cfg = model.cfg
    check((cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == DENSE_FULL[arch],
          f"not {arch}'s full config")
    per_forward = DENSE_FORWARD[arch]
    check(len(model.forward_gemm_specs()) == per_forward,
          f"not {per_forward} bank products a token")
    run = _serve_captured(torch, np, pm, session, seed,
                          lambda a, b: (a.shape[0], a.shape[1], b.shape[0]), per_forward, tag)
    captured = run.pop("captured")
    decode = _dense_decode_shapes(model)
    shapes = set(captured)
    check({s for s in shapes if s[0] == 4} == set(decode)
          and {s for s in shapes if s[0] != 4} == {(64, k, m) for _, k, m in decode},
          f"the path's (T, K, M) {sorted(shapes)}")
    tol = TOL["bfloat16"]
    max_err = _captured_vs_plain(torch, pm, captured, "(T, K, M)")
    modes = sorted({"input" if "noise" in kw else "none" for _, _, kw, _ in captured.values()})
    print(f"[{tag}] kernel vs plain on the path's own bf16 operands (first call of each of "
          f"{len(captured)} (T, K, M): {', '.join(str(s) for s in sorted(shapes))}; "
          f"{'/'.join(modes)} noise): max |kernel - plain| / max|plain| = {max_err:.3e} "
          f"(tol {tol})")
    skinny = {}
    for (t, k, m), (a, b, kw, _) in sorted(captured.items()):
        if t == 4 and k == SKINNY_K:
            skinny = _skinny_variants(torch, pm, a, b, kw, tag)
    del captured
    profile = phase_profile_ticks(torch, np, api, seed, tag=tag, session=session)
    del session, model
    gc.collect()
    torch.cuda.empty_cache()
    return {**run, "max_rel_err": max_err, "skinny_k14336": skinny, "profile": profile}


def _skinny_variants(torch, pm, a, b, kw, tag):
    """A path's largest-K decode product (A staged in shared memory near
    the limit in f32, T·K·4 bytes) by both skinny variants, in bf16 and
    f32, against the plain version.  -> {variant dtype: error of
    max|plain|}."""
    (t, k), m = a.shape, b.shape[0]
    skinny = {}
    for dtype in (torch.bfloat16, torch.float32):
        a_, b_ = a.to(dtype).contiguous(), b.to(dtype).contiguous()
        expect = pm.photonic_matmul_plain(a_, b_, **kw)
        for plan in (pm.Plan(pm.SKINNY), pm.Plan(pm.SKINNY_SCALAR)):
            got = pm.launch_kernel(a_, b_, plan=plan, **kw)
            err = (got - expect).abs().max().item() / expect.abs().max().item()
            name = f"{plan.name} {str(dtype).split('.')[-1]}"
            skinny[name] = err
            check(err <= TOL[str(dtype).split(".")[-1]],
                  f"{name} at (T, K, M) = {(t, k, m)}: {err:.3e} of max|plain|")
        del a_, b_, expect, got
    print(f"[{tag}] (T, K, M) = {(t, k, m)}: A staged in {t * k * 2} B (bf16) / {t * k * 4} "
          f"B (f32) of shared memory (limit {pm.SMEM_MAX}); planner picks "
          f"{pm._plan(t, m, k, torch.float32, (0, 0)).name} in f32; both skinny variants vs "
          f"plain: " + ", ".join(f"{n} {e:.3e}" for n, e in skinny.items()))
    return skinny


def _segment_params(model):
    """({segment: parameters of its layer 0}, parameters outside every
    segment) of a model, read from its ``segment_specs``."""
    specs = model.segment_specs()
    per_layer = {sp.name: sum(p.numel() for n, p in model.named_parameters()
                              if n.startswith(sp.layer_prefix(0))) for sp in specs}
    inside = tuple(f"{sp.name}." for sp in specs)
    rest = sum(p.numel() for n, p in model.named_parameters() if not n.startswith(inside))
    return per_layer, rest


def _dense_depth(torch, arch, steps_batch_rows, act=None, copies=STATE_COPIES):
    """The depth at which ``arch``'s f32 dfa training leaves FREE_GIB of the
    card free, reckoned from its parameter counts: ``copies`` f32 copies
    of every parameter, plus the activations of ``steps_batch_rows`` rows
    (the DFA tape, logits, their softmax and gradient, one block's
    recompute), under the card's memory.  Full depth where it fits.  A
    layer's parameters are its segment's layer 0's (``_segment_params``;
    these models have one segment).  ``act`` gives the activations in
    bytes, measured, in place of the reckoning."""
    from repro_torch import configs

    meta = configs.get(arch).make_model(torch.float32, device="meta")
    cfg = meta.cfg
    segments, rest = _segment_params(meta)
    per_layer = max(segments.values())  # one segment of homogeneous blocks here
    rows = steps_batch_rows
    if act is None:
        act = 4 * rows * (4 * cfg.v_padded + 16 * max(cfg.d_ff, cfg.d_model))
    total = torch.cuda.get_device_properties(0).total_memory
    room = total - FREE_GIB * 2**30 - copies * 4 * rest - act
    fit = int(room // (copies * 4 * per_layer + 4 * rows * cfg.d_model))
    depth = max(1, min(cfg.n_layers, fit))
    need = copies * 4 * (rest + cfg.n_layers * per_layer) + act
    return depth, {"layers": cfg.n_layers, "params_per_layer": per_layer, "params_rest": rest,
                   "copies": copies,
                   "reckoned_full_gib": need / 2**30, "card_gib": total / 2**30,
                   "act_gib": act / 2**30, "room_gib": room / 2**30}


def _dense_train(torch, api, pm, arch, seed, card, long_steps=False):
    """``arch``'s full width in f32 at batch 64 x seq 64 of ``MarkovTokens``
    (cut in depth where the card's memory needs it, printed): dfa fit
    steps on offchip_bpd (``cuda``), one block per projection plus the
    embedding's; block 0's δ against the plain version; for qwen3 the ideal
    cuda-vs-ref gradients and the steps at batch 2 x seq 4096 through
    ``flash_attention``; step ms, a profile, step_cost, peak memory; the
    bank kernel at the training shape."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import tokens
    from repro_torch.models.transformer import TransformerLM

    tag = f"dense_train {arch}"
    kind, peaks = card_peaks(card)
    steps = DENSE_STEPS[arch]
    rows = LM_BATCH * LM_SEQ
    depth, reckoning = _dense_depth(torch, arch, rows, copies=FIT_COPIES)
    full_cfg = DENSE_FULL[arch]
    if depth < full_cfg[0]:
        print(f"[{tag}] depth cut: {depth} of {full_cfg[0]} layers at full width "
              f"({reckoning['reckoned_full_gib']:.1f} GiB reckoned at full depth: "
              f"{FIT_COPIES} f32 copies (a fit's) of {reckoning['params_rest'] / 1e6:.1f} M + "
              f"{full_cfg[0]} x {reckoning['params_per_layer'] / 1e6:.2f} M parameters and the "
              f"activations, on a {reckoning['card_gib']:.1f} GiB card that must keep "
              f"{FREE_GIB:g} GiB free)")
    log = pm._BUILD_DIR / f"dense_train-{os.getpid()}.csv"
    gc.collect()  # the serving engines' wrapped steps hold their models in cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30
    meta_cfg = configs.get(arch).make_model(torch.float32, device="meta").cfg
    model = TransformerLM(dataclasses.replace(meta_cfg, n_layers=depth), device=DEVICE)
    session = api.build_session(arch=model, algo="dfa", hardware="offchip_bpd", backend="cuda",
                                seed=seed, log_every=1, log_path=str(log), device=DEVICE)
    cfg = model.cfg
    check(model.head["out"].weight.dtype == torch.float32
          and (cfg.d_model, cfg.d_ff, cfg.vocab_size) == full_cfg[1:], "not the full f32 width")
    per_step = cfg.n_layers + 1  # the blocks' projections and the embedding's
    n_params = sum(p.numel() for p in model.parameters())
    gen = tokens.MarkovTokens(cfg.vocab_size, LM_SEQ, LM_BATCH, seed)
    fit = _fit_logged(torch, pm, session, gen, steps, log)
    launches, losses = fit["launches"], fit["losses"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 - base_gib
    free_gib = reckoning["card_gib"] - torch.cuda.max_memory_reserved() / 2**30
    print(f"[{tag}] {cfg.n_layers} layers, full width, f32 ({n_params / 1e9:.3f} B parameters), "
          f"offchip_bpd, cuda backend, batch {LM_BATCH} x seq {LM_SEQ}: {steps} fit steps in "
          f"{fit['wall']:.2f}s; loss per step {', '.join(f'{x:.4f}' for x in losses)}; "
          f"photonic_matmul launches {launches} = {launches / steps:g} per step; peak device "
          f"memory {peak_gib:.2f} GiB above the {base_gib:.2f} GiB resident before the session, "
          f"{free_gib:.2f} GiB of the card never reserved")
    _check_fit(fit, steps, per_step)
    check(free_gib >= FREE_GIB, f"the run left {free_gib:.2f} GiB free, under {FREE_GIB} GiB")

    # one step's own operands against the plain version; qwen3: ideal cuda vs ref
    calls, errs, step, out = _step_projections(torch, pm, session, fit["state"], gen, seed,
                                               per_step, rows, tag)
    (a, b), kw, _ = calls[0]
    operands = (a, b, kw["noise"])
    del calls, out, a, b, kw
    ideal = _ideal_cuda_vs_ref(torch, session, fit["state"], step, tag) if arch == QWEN3 else None
    del step
    gc.collect()
    torch.cuda.empty_cache()

    # step time on CUDA events, a step under the profiler, step_cost
    n_timed = 2
    batches = [to_device_batch(gen.batch(i)) for i in range(steps, steps + n_timed)]
    prof = _step_timing(torch, session, fit, batches, 1, 1, tag, card)
    prof.update(layers=cfg.n_layers, peak_gib=peak_gib, free_gib=free_gib, losses=losses)
    del batches, fit
    torch.cuda.empty_cache()
    long = _dense_long(torch, session, pm, seed, tag) if long_steps else None
    del session, model
    torch.cuda.empty_cache()

    a, b, noise = operands
    print(f"[dense_timing] {arch} training shape, input mode      T      K      M  dtype "
          f"{TIMING_HEAD}")
    row = _bank_row(torch, pm, a, b, {"noise": noise}, peaks, "input", "dense_timing",
                    f"{arch} training shape, input mode ",
                    reps={"ms": 25, "plain_ms": 10, "library_ms": 25})
    row["launches_per_step"] = per_step
    print(f"[dense_timing] {arch}: the path's {per_step} launches a dfa step: "
          f"{row['dev_ms'] * per_step:.3f} ms device of the step's {prof['step_ms']:.1f} ms")
    del a, b, noise, operands
    torch.cuda.empty_cache()
    return {"launches": launches, "per_step": per_step, "max_abs_err": max(errs.values()),
            "ideal_max_rel": ideal[0] if ideal else None, "profile": prof, "train_shape": row,
            "long": long, "n_params": n_params}


def _dense_long(torch, session, pm, seed, tag):
    """LONG_STEPS dfa steps at batch 2 x seq 4096 from a fresh state of the
    training session: every block's forward and recompute run
    ``flash_attention`` (q_chunk 2048, k_chunk 1024); the first call's q,
    k, v held against ``reference_attention`` on the card."""
    from repro_torch.data import tokens
    from repro_torch.nn import attention

    cfg = session.model.cfg
    check(LONG_SEQ > 2 * cfg.k_chunk and (cfg.q_chunk, cfg.k_chunk) == (2048, 1024),
          f"seq {LONG_SEQ} with chunks {cfg.q_chunk} / {cfg.k_chunk}")
    gen = tokens.MarkovTokens(cfg.vocab_size, LONG_SEQ, LONG_BATCH, seed + 1)
    flash = attention.flash_attention
    calls, first = [0], []

    def counted(q, k, v, **kw):
        calls[0] += 1
        if not first:
            first.append((q.detach(), k.detach(), v.detach(), kw))
        return flash(q, k, v, **kw)

    state = session.init_state()
    torch.cuda.reset_peak_memory_stats()
    attention.flash_attention = counted
    try:
        sync(torch)
        pm.launches = 0
        t0 = time.perf_counter()
        losses = []
        for i in range(LONG_STEPS):
            state, metrics = session.step(state, gen.batch(i))
            losses.append(float(metrics["loss"]))
        sync(torch)
        wall = time.perf_counter() - t0
        launches = pm.launches
    finally:
        attention.flash_attention = flash
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    per_step = cfg.n_layers + 1
    print(f"[{tag}] batch {LONG_BATCH} x seq {LONG_SEQ}: {LONG_STEPS} dfa steps in {wall:.2f}s, "
          f"losses {', '.join(f'{x:.4f}' for x in losses)}; flash_attention calls {calls[0]} "
          f"(forward and recompute of each of {cfg.n_layers} blocks a step); photonic_matmul "
          f"launches {launches} = {launches / LONG_STEPS:g} per step; peak {peak_gib:.2f} GiB")
    check(all(math.isfinite(x) for x in losses), f"non-finite losses at seq {LONG_SEQ}: {losses}")
    check(calls[0] == 2 * cfg.n_layers * LONG_STEPS,
          f"{calls[0]} flash_attention calls, expected {2 * cfg.n_layers} a step")
    check(launches == per_step * LONG_STEPS, f"{launches} launches at seq {LONG_SEQ}")
    del state
    torch.cuda.empty_cache()
    q, k, v, kw = first[0]
    got = flash(q, k, v, **kw)
    expect = attention.reference_attention(q, k, v, q_pos=kw["q_pos"], kv_pos=kw["kv_pos"],
                                           causal=kw["causal"], scale=kw["scale"])
    excess = ((got - expect).abs() - FLASH_TOL * (1 + expect.abs())).max().item()
    err = (got - expect).abs().max().item()
    print(f"[{tag}] flash_attention vs reference_attention on block 0's q {tuple(q.shape)}, k/v "
          f"{tuple(k.shape)} f32 (q_chunk {kw['q_chunk']}, k_chunk {kw['k_chunk']}): max |Δ| "
          f"{err:.3e} (max|ref| {expect.abs().max().item():.3f}; tol {FLASH_TOL} abs + rel)")
    check(excess <= 0, f"flash_attention differs from reference_attention by {err:.3e}")
    del q, k, v, got, expect, first
    torch.cuda.empty_cache()
    return {"wall_s": wall, "losses": losses, "flash_calls": calls[0], "launches": launches,
            "flash_max_abs_err": err, "peak_gib": peak_gib}


def phase_dense(torch, np, api, pm, em, seed, card, draws):
    """The dense attention families at full width, random weights from
    ``seed``: qwen3-1.7b (qk-norm, GQA 16:8), minicpm3-4b (MLA: the latent
    cache, the absorbed decode and prefill) and granite-8b (GQA 32:8, K up
    to 14336).  Each serves in bf16 on offchip_bpd through the bank kernel
    (197, 435 and 253 launches a forward; the kernel against its plain
    version on the path's own operands at every shape; granite's K = 14336
    by both skinny variants in bf16 and f32) with a profiled prefill tick
    and two decode ticks, and holds f32 cuda to ref on ideal.  qwen3 and
    minicpm3 DFA-train in f32 at batch 64 x seq 64 (29 and 63 launches a
    step; minicpm3 at the depth the card's memory allows, printed), qwen3
    also 2 steps through emulated banks (the emu kernel bit for bit) and
    1 step at batch 2 x seq 4096 through ``flash_attention``.  The bank
    kernel is timed at every decode shape and both training shapes."""
    from repro_torch import configs
    from repro_torch.data import tokens

    kind, peaks = card_peaks(card)
    # this phase grows its segments in place: its full-width training runs
    # allocate multi-GiB tensors of many sizes, and fixed segments strand up
    # to 12 GiB of the card in unused cached blocks.  The earlier phases run
    # on the fixed segments their numbers were taken with.
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    out = {}
    for arch in (QWEN3, MINICPM3, GRANITE):
        t0 = time.perf_counter()
        res = {"serve": _dense_serve(torch, np, api, pm, arch, seed)}
        res["parity"] = phase_parity(torch, np, api, seed, arch=arch,
                                     tag=f"dense_parity {arch}")
        if arch in DENSE_STEPS:
            res["train"] = _dense_train(torch, api, pm, arch, seed, card,
                                        long_steps=arch == QWEN3)
        if arch == QWEN3:
            gen = tokens.MarkovTokens(DENSE_FULL[arch][3], LM_SEQ, LM_BATCH, seed)
            res["emu"] = _emu_fit(torch, em, lambda: api.build_session(
                arch=arch, smoke=False, dtype=torch.float32, seed=seed, algo="dfa",
                hardware="emu_offchip", backend="emu", log_every=10**9, device=DEVICE),
                gen, DENSE_EMU_STEPS, DENSE_FULL[arch][0] + 1, f"dense_emu {arch}",
                "dense_timing", card, draws, arch)
        shapes = _dense_decode_shapes(configs.get(arch).make_model(torch.bfloat16,
                                                                   device="meta"))
        gen = torch.Generator(device=DEVICE).manual_seed(19)
        rows, forward = _decode_rows(torch, pm, dict(sorted(shapes.items())), peaks, gen,
                                     "dense_timing", f"{arch} decode shapes ",
                                     reps={"ms": 10, "plain_ms": 10, "library_ms": 10})
        res["decode"] = {"shapes": rows, "forward": forward}
        res["seconds"] = time.perf_counter() - t0
        out[arch] = res
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[dense] {arch} done in {res['seconds']:.1f}s")
    return out


def dense_summary(arch, res):
    """One model's numbers for its own output line."""
    serve, tick = res["serve"], res["serve"]["profile"]
    line = {"arch": arch, "tok_s": serve["tok_s"], "ttft_p50_ms": serve["ttft_ms"],
            "decode_tick_wall_ms": tick["decode_tick"]["wall_ms"],
            "decode_tick_busy_ms": tick["decode_tick"].get("busy_ms"),
            "prefill_tick_wall_ms": tick["prefill_tick"]["wall_ms"],
            "prefill_tick_busy_ms": tick["prefill_tick"].get("busy_ms"),
            "serve_launches": serve["launches"], "parity_max_rel": res["parity"]["max_rel"]}
    if "train" in res:
        prof = res["train"]["profile"]
        line.update(train_layers=prof["layers"], step_ms=prof["step_ms"],
                    tflop_s=prof["tflop_s"], peak_gib=prof["peak_gib"],
                    idle_share=prof.get("idle_share"), train_launches=res["train"]["launches"])
        if res["train"]["long"]:
            line["seq4096_losses"] = res["train"]["long"]["losses"]
    if "emu" in res:
        line["emu_launches"] = res["emu"]["launches"]
    return line


# ---------------------------------------------------------------------------
# the mixture-of-experts family (phase_moe)
# ---------------------------------------------------------------------------
QWEN2MOE, KIMI = "qwen2-moe-a2.7b", "kimi-k2-1t-a32b"
# (n_layers, d_model, n_experts, top_k, d_ff_expert, shared d_ff, vocab) of each full()
MOE_FULL = {QWEN2MOE: (24, 2048, 60, 4, 1408, 4 * 1408, 151936),
            KIMI: (61, 7168, 384, 8, 2048, 2048, 163840)}
MOE_STEPS = 4  # f32 dfa fit steps at batch 64 x seq 64: one group of 4096 tokens
MOE_EMU_LAYERS = 2  # the emu serve's depth at full width
KIMI_SLICE = 32  # experts a slice of kimi's plain version (1.9 GB of f32 weights)


def _meta_model(torch, arch, dtype=None):
    """``arch``'s full() on the meta device, in bf16 unless ``dtype``."""
    from repro_torch import configs

    return configs.get(arch).make_model(dtype or torch.bfloat16, device="meta")


def _moe_launches(cfg):
    """Bank launches a forward: a layer's 4 attention products, its 3
    expert products (one batched launch each over every expert) and its
    shared experts' 3, and the head."""
    return 10 * cfg.n_layers + 1


def _moe_shapes(model, t):
    """{(E, rows, K, M): launches} of ``model``'s forward over ``t`` tokens;
    E is 0 for a 2-D launch, and the experts' rows are their capacity."""
    cfg, mo = model.cfg, model.cfg.moe
    d, hd, n_l = cfg.d_model, cfg.head_dim, cfg.n_layers
    cap = model.blocks[0].ffn.capacity(t)
    sh = mo.n_shared_experts * mo.d_ff_shared
    out = {}
    for key, n in (((0, t, d, cfg.n_heads * hd), n_l), ((0, t, d, cfg.n_kv_heads * hd), 2 * n_l),
                   ((0, t, cfg.n_heads * hd, d), n_l),
                   ((mo.n_experts, cap, d, mo.d_ff_expert), 2 * n_l),
                   ((mo.n_experts, cap, mo.d_ff_expert, d), n_l),
                   ((0, t, d, sh), 2 * n_l), ((0, t, sh, d), n_l), ((0, t, d, cfg.v_padded), 1)):
        out[key] = out.get(key, 0) + n
    return out


def _shape_key(a, b):
    return (a.shape[0] if a.ndim == 3 else 0, a.shape[-2], a.shape[-1], b.shape[-2])


def _batched_vs_single(torch, pm, a, b, kw):
    """A batched launch against one 2-D launch of each index under the
    batched launch's plan: equal bit for bit.  -> the plan's name."""
    e, t, k = a.shape
    m = b.shape[-2]
    plan = pm._plan(t, m, k, a.dtype, (a.data_ptr(), b.data_ptr()), e=e)
    got = pm.launch_kernel(a, b, plan=plan, **kw)
    for i in range(e):
        one = pm.launch_kernel(a[i], b[i], plan=plan, **kw)
        check(torch.equal(got[i], one),
              f"batched launch index {i} != its 2-D launch at (E, T, K, M) = {(e, t, k, m)} "
              f"{plan.name}")
    return plan.name


def _moe_serve(torch, np, api, pm, seed):
    """qwen2-moe's full() in bf16 on offchip_bpd, ``cuda`` backend, 4
    slots: 8 requests of 32-token prompts and 16 new tokens, prefill chunk
    16; 241 launches a forward; the kernel against its plain version on
    the path's own operands at every (E, T, K, M) it launched (the first
    call of each), and each batched expert launch against its E 2-D
    launches bit for bit; then a prefill tick and two decode ticks under
    the profiler."""
    tag = "moe_serve"
    session = api.build_session(arch=QWEN2MOE, algo="bp", smoke=False, hardware="offchip_bpd",
                                backend="cuda", dtype=torch.bfloat16, seed=seed, device=DEVICE)
    model = session.model
    cfg, mo = model.cfg, model.cfg.moe
    check((cfg.n_layers, cfg.d_model, mo.n_experts, mo.top_k, mo.d_ff_expert,
           mo.n_shared_experts * mo.d_ff_shared, cfg.vocab_size) == MOE_FULL[QWEN2MOE],
          "not qwen2-moe's full config")
    per_forward = _moe_launches(cfg)
    check(per_forward == 241, f"{per_forward} bank launches a forward")
    run = _serve_captured(torch, np, pm, session, seed, _shape_key, per_forward, tag)
    captured = run.pop("captured")
    want = set(_moe_shapes(model, 4)) | set(_moe_shapes(model, 64))
    check(set(captured) == want, f"the path's (E, T, K, M) {sorted(captured)}, not {sorted(want)}")
    max_err = _captured_vs_plain(torch, pm, captured, "(E, T, K, M)")
    single = {key: _batched_vs_single(torch, pm, a, b, kw)
              for key, (a, b, kw, _) in sorted(captured.items()) if key[0]}
    modes = sorted({"input" if "noise" in kw else "none" for _, _, kw, _ in captured.values()})
    print(f"[{tag}] kernel vs plain on the path's own bf16 operands (first call of each of "
          f"{len(captured)} (E, T, K, M), E = 0 for a 2-D launch: "
          f"{', '.join(str(k) for k in sorted(captured))}; {'/'.join(modes)} noise): max "
          f"|kernel - plain| / max|plain| = {max_err:.3e} (tol {TOL['bfloat16']})")
    print(f"[{tag}] layer 0's batched expert launches against their E 2-D launches under the "
          f"same plan: equal bit for bit at " + ", ".join(f"{k} ({v})" for k, v in
                                                          single.items()))
    del captured
    profile = phase_profile_ticks(torch, np, api, seed, tag=tag, session=session)
    del session, model
    gc.collect()
    torch.cuda.empty_cache()
    return {**run, "max_rel_err": max_err,
            "batched_vs_single": {str(k): v for k, v in single.items()}, "profile": profile}


def _stack_dims(a_t, delta, widths):
    """(E, T, K, M) of a captured expert stack: its tiled K and M padded to
    the bank (panels x C, row blocks x rows), read back as the model's
    width each pads (``widths``)."""
    e, t, q, nj, cols = a_t.shape
    nm, rows = delta.shape[1], delta.shape[3]
    by_k = {-(-w // cols) * cols: w for w in widths}
    by_m = {-(-w // rows) * rows: w for w in widths}
    return e, t, by_k[q * nj * cols], by_m[nm * rows]


def _stack_vs_2d(torch, em, captured, widths):
    """Each captured stack of expert products (a_t (E, T, Q, NJ, C)) under
    every plan of the forced grid: index e of the batched launch equals the
    2-D launch of product e under the same plan, bit for bit.  -> {(E, T,
    K, M): plans}."""
    out = {}
    for (a_shape, _), (a_t, delta, mask, kw) in captured.items():
        if a_t.ndim != 5:
            continue
        plans = _emu_candidates(em, a_t, delta, mask)
        for plan in plans:
            got = em.launch_kernel(a_t, delta, mask, plan=plan, **kw)
            for i in range(a_t.shape[0]):
                one = em.launch_kernel(a_t[i], delta[i], mask, plan=plan, **kw)
                check(torch.equal(got[i], one),
                      f"batched emu launch index {i} != its 2-D launch: a_t {a_shape} "
                      f"{plan.name}")
        out[_stack_dims(a_t, delta, widths)] = len(plans)
    return out


def _stack_rows(torch, em, captured, widths, peaks, draw, sms, tag):
    """The batched launch of each captured expert stack beside the loop of
    E 2-D launches it replaces, the batched plain version and the bound."""
    rows = []
    for _, (a_t, delta, mask, kw) in sorted(captured.items()):
        if a_t.ndim != 5:
            continue
        e = a_t.shape[0]
        row = _time_fns(torch, {
            "ms": lambda: em.emu_bank_product_cuda(a_t, delta, mask, **kw),
            "loop_ms": lambda: [em.emu_bank_product_cuda(a_t[i], delta[i], mask, **kw)
                                for i in range(e)]}, {"ms": 25, "loop_ms": 25})
        row["plain_ms"] = _event_ms(torch, lambda: em.emu_bank_product_plain(
            a_t, delta, mask, **kw), reps=1, warm=1)
        row["bound_ms"], row["bound_by"], binding, terms = emu_bound(
            (a_t, delta, mask, kw["n_panels"]), kw["sigma"], kw["shot"], peaks, draw, sms)
        _, t, k, m = _stack_dims(a_t, delta, widths)
        row.update(e=e, t=t, k=k, m=m, library_ms=None,
                   plan=em.plan_for(a_t, delta, mask).name, binding=binding)
        rows.append(row)
        print(f"[{tag}] ({e}, {row['t']}, {row['k']} -> {row['m']} rows) bf16 a_t, f32 δ: "
              f"batched {row['ms']:.4f} / {row['dev_ms']:.4f} ms (events / device), the loop of "
              f"{e} 2-D launches {row['loop_ms']:.4f} / {row['loop_dev_ms']:.4f}, plain "
              f"{row['plain_ms']:.4f} (events), bound {row['bound_ms']:.4f} ({binding}: bytes "
              f"{terms['bytes'] * 1e3:.5f} / f32 {terms['f32'] * 1e3:.5f} / prng "
              f"{terms['prng'] * 1e3:.5f}), plan {row['plan']}")
    return rows


def _moe_emu_serve(torch, np, api, em, seed, card, draws):
    """qwen2-moe at full width cut to MOE_EMU_LAYERS layers, bf16, on
    emu_offchip: 2 requests (16-token prompts, 4 new tokens) on 2 slots,
    one emu launch a layer's attention and shared product and one batched
    launch a stack of expert products (all 60); the emu kernel against its
    plain version on the path's own operands (the first call of each
    shape), bit for bit under every plan of the forced grid, and each
    batched launch's index e against the 2-D launch of expert e under each
    plan; the batched launches timed beside the loop of 60 they replace."""
    import dataclasses

    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serve import Request

    tag = "moe_emu"
    cfg = dataclasses.replace(_meta_model(torch, QWEN2MOE).cfg, n_layers=MOE_EMU_LAYERS)
    model = TransformerLM(cfg, device=DEVICE).init(seed)
    session = api.build_session(arch=model, algo="bp", hardware="emu_offchip", backend="emu",
                                seed=seed, device=DEVICE)
    eng = session.engine(batch_slots=2, max_len=64, prefill_chunk=16, seed=seed)
    check(eng.hw_state is not None and eng._backend.name == "emu", "no drift state / backend")
    finite = _finite_outputs(torch, eng)
    reqs = [Request(prompt=p, max_new=4)
            for p in _prompts(np.random.default_rng(seed + 11), 2, 16, cfg.vocab_size)]
    per_forward = cfg.n_layers * (4 + 3 + 3) + 1
    captured, launches, wall = _emu_run_captured(torch, em, eng, reqs)
    forwards = eng.stats["prefill_steps"] + eng.stats["decode_steps"]
    tokens = sum(len(r.out) for r in reqs)
    print(f"[{tag}] {cfg.n_layers} of 24 layers at full width, bf16, emu_offchip: {len(reqs)} "
          f"requests, {tokens} tokens in {wall:.3f}s ({forwards} forwards); emu_bank_product "
          f"launches {launches} = {per_forward} x {forwards}: {launches == per_forward * forwards}"
          f" (a layer: 4 attention, 3 batched over {cfg.moe.n_experts} experts, 3 shared; and "
          "the head)")
    check(all(r.done and len(r.out) == 4 for r in reqs), "requests unfinished")
    check(launches == per_forward * forwards,
          f"launches {launches} != {per_forward} x {forwards}")
    check(finite(), "non-finite logits")
    del eng, session, model
    gc.collect()
    torch.cuda.empty_cache()
    max_err, n_plans = _emu_path_exact(torch, em, captured, "qwen2-moe")
    print(f"[{tag}] kernel vs plain on the path's own operands (bf16 a_t, f32 δ; "
          f"{len(captured)} shapes: {', '.join(str(a) for a, _ in captured)}), {n_plans} plans "
          f"in all: equal bit for bit (max |kernel - plain| {max_err:.3e})")
    widths = (cfg.d_model, cfg.moe.d_ff_expert)
    stacks = _stack_vs_2d(torch, em, captured, widths)
    check(len(stacks) >= 2, f"the path launched {len(stacks)} expert stack shapes")
    print(f"[{tag}] each batched expert launch against the 2-D launch of each of its experts "
          f"under every plan: equal bit for bit at " + ", ".join(
              f"(E, T, K, M) = {k} ({v} plans)" for k, v in stacks.items()))
    peaks = card_peaks(card)[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = _stack_rows(torch, em, captured, widths, peaks, draws["emu"], sms, tag)
    del captured
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": max_err, "wall_s": wall, "forwards": forwards,
            "layers": cfg.n_layers, "per_forward": per_forward,
            "stack_vs_2d": {str(k): v for k, v in stacks.items()}, "stack_rows": rows}


def _moe_act_probe(torch, api, seed, rows):
    """The activations of qwen2-moe's f32 dfa step at full width, measured:
    the peak device memory of two fit steps of a 1-layer model above the
    memory resident before it, less FIT_COPIES f32 copies of its
    parameters (at least 0).  What they hold (the logits, one block's
    recompute with its (rows, E, cap) routing tensors) does not grow with
    depth.  -> bytes."""
    import dataclasses

    from repro_torch.data import tokens
    from repro_torch.models.transformer import TransformerLM

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(_meta_model(torch, QWEN2MOE).cfg, n_layers=1, dtype=torch.float32)
    model = TransformerLM(cfg, device=DEVICE)
    session = api.build_session(arch=model, algo="dfa", hardware="offchip_bpd", backend="cuda",
                                seed=seed, device=DEVICE)
    gen = tokens.MarkovTokens(cfg.vocab_size, LM_SEQ, LM_BATCH, seed)
    state, _ = session.fit(gen.batch, total_steps=2, verbose=False)
    sync(torch)
    peak = torch.cuda.max_memory_allocated() - base
    n_params = sum(p.numel() for p in model.parameters())
    check(rows == LM_BATCH * LM_SEQ, "the probe's rows differ from the run's")
    del state, session, model
    gc.collect()
    torch.cuda.empty_cache()
    act = max(0, peak - FIT_COPIES * 4 * n_params)
    print(f"[moe_train] activations measured on a 1-layer model ({n_params / 1e9:.3f} B "
          f"parameters, 2 f32 dfa fit steps at {rows} rows): peak {peak / 2**30:.2f} GiB above "
          f"resident, less {FIT_COPIES} f32 copies of its parameters "
          f"({FIT_COPIES * 4 * n_params / 2**30:.2f} GiB): {act / 2**30:.2f} GiB")
    return act


def _moe_train(torch, api, pm, seed, card):
    """qwen2-moe at full width in f32, batch 64 x seq 64 of ``MarkovTokens``
    (one routing group of 4096 tokens, capacity 341), at the depth the
    card's memory holds (reckoned with the activations measured on one
    layer, and printed): MOE_STEPS dfa fit steps on
    offchip_bpd (``cuda``), one launch a block and the embedding's, a
    finite loss and aux loss at every step; one step's aux terms per layer
    (the dropped fraction among them); block 0's and the embedding's δ
    against the plain version; ideal cuda = ref gradients, the router's
    included; step ms, a profile, step_cost and peak memory."""
    import dataclasses

    from repro_torch.data import tokens
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.nn import moe as moe_lib

    tag = "moe_train"
    rows = LM_BATCH * LM_SEQ
    depth, reck = _dense_depth(torch, QWEN2MOE, rows,
                               act=_moe_act_probe(torch, api, seed, rows))
    full = MOE_FULL[QWEN2MOE]
    print(f"[{tag}] depth {depth} of {full[0]} layers at full width: {STATE_COPIES} f32 copies "
          f"of {reck['params_rest'] / 1e6:.1f} M parameters outside the blocks "
          f"({STATE_COPIES * 4 * reck['params_rest'] / 2**30:.2f} GiB) and of "
          f"{reck['params_per_layer'] / 1e6:.2f} M a layer "
          f"({STATE_COPIES * 4 * reck['params_per_layer'] / 2**30:.2f} GiB), "
          f"{reck['act_gib']:.2f} GiB of activations (measured, the routing tensors in them) "
          f"and {FREE_GIB:g} GiB kept free on a {reck['card_gib']:.1f} GiB card: "
          f"{reck['room_gib']:.1f} GiB for the blocks; {reck['reckoned_full_gib']:.1f} GiB at "
          f"full depth")
    log = pm._BUILD_DIR / f"moe_train-{os.getpid()}.csv"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30
    cfg = dataclasses.replace(_meta_model(torch, QWEN2MOE).cfg, n_layers=depth,
                              dtype=torch.float32)
    model = TransformerLM(cfg, device=DEVICE)
    session = api.build_session(arch=model, algo="dfa", hardware="offchip_bpd", backend="cuda",
                                seed=seed, log_every=1, log_path=str(log), device=DEVICE)
    check(model.head["out"].weight.dtype == torch.float32
          and model.blocks[0].ffn.experts.gate.weight.shape == (60, 1408, 2048),
          "not the full f32 width")
    per_step = cfg.n_layers + 1
    n_params = sum(p.numel() for p in model.parameters())
    gen = tokens.MarkovTokens(cfg.vocab_size, LM_SEQ, LM_BATCH, seed)
    fit = _fit_logged(torch, pm, session, gen, MOE_STEPS, log)
    launches, losses, aux = fit["launches"], fit["losses"], fit["log"]["aux_loss"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 - base_gib
    free_gib = reck["card_gib"] - torch.cuda.max_memory_reserved() / 2**30
    print(f"[{tag}] {cfg.n_layers} layers, full width, f32 ({n_params / 1e9:.3f} B parameters), "
          f"offchip_bpd, cuda backend, batch {LM_BATCH} x seq {LM_SEQ} (capacity "
          f"{model.blocks[0].ffn.capacity(rows)} a expert): {MOE_STEPS} fit steps in "
          f"{fit['wall']:.2f}s; loss per step {', '.join(f'{x:.4f}' for x in losses)}; aux_loss "
          f"per step {', '.join(f'{x:.5f}' for x in aux)}; photonic_matmul launches {launches} = "
          f"{launches / MOE_STEPS:g} per step; peak device memory {peak_gib:.2f} GiB above the "
          f"{base_gib:.2f} GiB resident before the session, {free_gib:.2f} GiB of the card never "
          f"reserved")
    _check_fit(fit, MOE_STEPS, per_step)
    check(all(math.isfinite(x) and x > 0 for x in aux), f"aux losses {aux}")

    # one step: its aux terms per MoE call, its own operands against plain
    routed = []
    forward = moe_lib.MoE.forward

    def recording(self, x, with_aux=True):
        y, terms = forward(self, x, with_aux)
        routed.append({k: float(v.detach()) for k, v in terms.items()})
        return y, terms

    moe_lib.MoE.forward = recording
    try:
        calls, errs, step, out = _step_projections(torch, pm, session, fit["state"], gen, seed,
                                                   per_step, rows, tag)
    finally:
        moe_lib.MoE.forward = forward
    check(len(routed) == 2 * cfg.n_layers, f"{len(routed)} MoE calls in one dfa step")
    print(f"[{tag}] one step's routing, layer by layer (forward; the recompute gives the same): "
          + "; ".join(f"layer {i} lb {r['lb_loss']:.4f} z {r['z_loss']:.3f} dropped "
                      f"{r['dropped_frac']:.4f}" for i, r in enumerate(routed[:cfg.n_layers])))
    check(all(0.0 <= r["dropped_frac"] < 1.0 for r in routed), "dropped fraction out of range")
    del calls, out
    ideal = _ideal_cuda_vs_ref(torch, session, fit["state"], step, tag,
                               watch=("blocks.0.ffn.router.weight",
                                      "blocks.0.ffn.experts.gate.weight"))
    del step
    gc.collect()
    torch.cuda.empty_cache()

    batches = [to_device_batch(gen.batch(i)) for i in range(MOE_STEPS, MOE_STEPS + 2)]
    prof = _step_timing(torch, session, fit, batches, 1, 1, tag, card)
    prof.update(layers=cfg.n_layers, peak_gib=peak_gib, free_gib=free_gib, losses=losses,
                aux_losses=aux, dropped_frac=[r["dropped_frac"] for r in routed[:cfg.n_layers]])
    del batches, fit, session, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "per_step": per_step, "max_abs_err": max(errs.values()),
            "ideal_max_rel": ideal[0], "profile": prof, "n_params": n_params}


def _moe_row(torch, pm, a, b, kw, peaks, noise, tag, label, reps=None):
    """``_bank_row`` for a batched launch: the kernel, its plain version and
    ``torch.bmm`` on (a, b), beside the bound of E products."""
    e, t, k = a.shape
    m = b.shape[-2]
    dtype_name = "bfloat16" if a.dtype == torch.bfloat16 else "float32"
    fns = {"ms": lambda: pm.photonic_matmul_cuda(a, b, **kw),
           "plain_ms": lambda: pm.photonic_matmul_plain(a, b, **kw),
           "library_ms": lambda: torch.bmm(a, b.mT)}
    row = dict(e=e, t=t, k=k, m=m, dtype=dtype_name, noise=noise,
               **_time_row(torch, fns, bound_ms(t, m, k, dtype_name, peaks, noise=noise, e=e),
                           reps=reps),
               variant=pm._plan(t, m, k, a.dtype, (a.data_ptr(), b.data_ptr()), e=e).name)
    short = "bf16" if dtype_name == "bfloat16" else "f32"
    _print_row(tag, f"{label}{e:4d} {t:4d} {k:6d} {m:6d} {short:>5s}", row)
    return row


def _moe_timing(torch, pm, model, peaks, gen, label):
    """Every shape of ``model``'s decode forward (T = 4) timed, the sums over
    the forward's launches; and the experts' prefill shapes (4 x 16 rows:
    capacity 5 for qwen2-moe)."""
    decode = _moe_shapes(model, 4)
    print(f"[moe_timing] {label} decode forward (E = 0: a 2-D launch; rows are the experts' "
          f"capacity)     E    T      K      M  dtype {TIMING_HEAD}")
    rows = []
    reps = {"ms": 10, "plain_ms": 5, "library_ms": 10}
    for (e, t, k, m), count in sorted(decode.items()):
        if e:
            a = (torch.rand((e, t, k), generator=gen, device=DEVICE) * 2 - 1).to(torch.bfloat16)
            b = (torch.rand((e, m, k), generator=gen, device=DEVICE) * 2 - 1).to(torch.bfloat16)
            row = _moe_row(torch, pm, a, b, {}, peaks, "none", "moe_timing", f"{label} ")
        else:
            a, b = _operands(torch, t, k, m, torch.bfloat16, gen)
            row = _bank_row(torch, pm, a, b, {}, peaks, "none", "moe_timing", f"{label}    0 ")
        rows.append({**row, "e": e, "count": count})
        del a, b
    keys = ("ms", "dev_ms", "plain_ms", "plain_dev_ms", "library_ms", "library_dev_ms",
            "bound_ms")
    forward = {key: sum(r[key] * r["count"] for r in rows) for key in keys}
    forward.update(launches=sum(r["count"] for r in rows), bound_by="bytes" if all(
        r["bound_by"] == "bytes" for r in rows) else "operations")
    print(f"[moe_timing] {label}: one decode forward at T = 4 ({forward['launches']} launches), "
          "ms: " + ", ".join(f"{key} {forward[key]:.4f}" for key in keys))
    prefill = []
    for (e, t, k, m), _ in sorted(_moe_shapes(model, 64).items()):
        if e:
            a = (torch.rand((e, t, k), generator=gen, device=DEVICE) * 2 - 1).to(torch.bfloat16)
            b = (torch.rand((e, m, k), generator=gen, device=DEVICE) * 2 - 1).to(torch.bfloat16)
            prefill.append(_moe_row(torch, pm, a, b, {}, peaks, "none", "moe_timing",
                                    f"{label} prefill "))
            del a, b
    torch.cuda.empty_cache()
    return rows, forward, prefill


def _kimi(torch, pm, peaks, gen):
    """kimi-k2 at full width: its full() on the meta device (1.04 T
    parameters, the stacked (384, M, K) expert weights), and the batched
    kernel against its plain version at its decode expert shapes (384
    experts, 1 row each: gate / up 7168 -> 2048 and down 2048 -> 7168,
    bf16; B is 11.3 GB), the plain version in slices of KIMI_SLICE experts;
    each shape timed beside ``torch.bmm`` and its bound."""
    from repro_torch import configs

    tag = "moe_kimi"
    meta = configs.get(KIMI).make_model(torch.bfloat16, device="meta")
    cfg, mo = meta.cfg, meta.cfg.moe
    n_params = sum(p.numel() for p in meta.parameters())
    gate = tuple(meta.blocks[0].ffn.experts.gate.weight.shape)
    down = tuple(meta.blocks[0].ffn.experts.down.weight.shape)
    check((cfg.n_layers, cfg.d_model, mo.n_experts, mo.top_k, mo.d_ff_expert,
           mo.n_shared_experts * mo.d_ff_shared, cfg.vocab_size) == MOE_FULL[KIMI]
          and gate == (384, 2048, 7168) and down == (384, 7168, 2048),
          f"not kimi-k2's full config: {gate}, {down}")
    print(f"[{tag}] full() on the meta device: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{mo.n_experts} experts top-{mo.top_k}, {n_params / 1e12:.4f} T parameters "
          f"({2 * n_params / 1e12:.2f} TB in bf16); experts gate/up {gate}, down {down}; "
          f"{_moe_launches(cfg)} bank launches a forward")
    del meta
    rows, max_err = [], 0.0
    tol = TOL["bfloat16"]
    for k, m in ((7168, 2048), (2048, 7168)):
        b = torch.empty((384, m, k), device=DEVICE, dtype=torch.bfloat16).uniform_(
            -1, 1, generator=gen)
        a = torch.empty((384, 1, k), device=DEVICE, dtype=torch.bfloat16).uniform_(
            -1, 1, generator=gen)
        noise = 0.05 * torch.randn((1, m), generator=gen, device=DEVICE)
        got = pm.photonic_matmul_cuda(a, b, noise=noise)
        worst = scale = 0.0
        for e0 in range(0, 384, KIMI_SLICE):
            part = slice(e0, e0 + KIMI_SLICE)
            expect = pm.photonic_matmul_plain(a[part], b[part], noise=noise)
            worst = max(worst, (got[part] - expect).abs().max().item())
            scale = max(scale, expect.abs().max().item())
            del expect
        err = worst / scale
        check(err <= tol, f"kimi expert shape (384, 1, {k}) -> {m}: {err:.3e} of max|plain|")
        max_err = max(max_err, err)
        print(f"[{tag}] batched kernel vs plain at (E, T, K, M) = (384, 1, {k}, {m}) bf16, input "
              f"noise (plain in slices of {KIMI_SLICE} experts): max |kernel - plain| / "
              f"max|plain| = {err:.3e} (tol {tol})")
        del got
        torch.cuda.empty_cache()
        row = _moe_row(torch, pm, a, b, {}, peaks, "none", "moe_timing", "kimi-k2 decode ",
                       reps={"ms": 10, "plain_ms": 3, "library_ms": 10})
        rows.append(row)
        del a, b, noise
        torch.cuda.empty_cache()
    return {"n_params": n_params, "max_rel_err": max_err, "rows": rows}


def phase_moe(torch, np, api, pm, em, seed, card, draws):
    """The mixture-of-experts family at full width, random weights from
    ``seed``: qwen2-moe-a2.7b (24 layers, d 2048, 60 experts top-4 with
    d_ff 1408, 4 shared, vocab 151936; 14.32 B parameters) served in bf16
    through the bank kernel (241 launches a forward, the experts' three
    products one batched launch each; the kernel against its plain version
    at every (E, T, K, M) of the path; the batched launches against their
    2-D launches bit for bit) with a profiled prefill tick and two decode
    ticks; f32 ideal cuda-vs-ref parity (57.3 GB of f32 weights, alone on
    the card); emu serving at MOE_EMU_LAYERS layers (21 launches a forward,
    each expert product one batched launch) with the emu kernel bit for
    bit and each batched launch = its 2-D launches, timed beside the loop
    of 60 it replaces; f32 dfa training at the depth the card holds (printed);
    kimi-k2's layout on the meta device and its expert products at full
    width; the bank kernel timed at every decode shape and the experts'
    prefill shapes."""
    kind, peaks = card_peaks(card)
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"serve": _moe_serve(torch, np, api, pm, seed)}
    out["parity"] = phase_parity(torch, np, api, seed, arch=QWEN2MOE, tag="moe_parity")
    gc.collect()
    torch.cuda.empty_cache()
    out["emu"] = _moe_emu_serve(torch, np, api, em, seed, card, draws)
    out["train"] = _moe_train(torch, api, pm, seed, card)
    gen = torch.Generator(device=DEVICE).manual_seed(20)
    print(f"[moe_timing] {kind} peaks; card: {card}")
    rows, forward, prefill = _moe_timing(torch, pm, _meta_model(torch, QWEN2MOE), peaks, gen,
                                         "qwen2-moe")
    out["decode"] = {"shapes": rows, "forward": forward, "prefill_experts": prefill}
    out["kimi"] = _kimi(torch, pm, peaks, gen)
    out["seconds"] = time.perf_counter() - t0
    print(f"[moe] done in {out['seconds']:.1f}s")
    return out


def moe_summary(res):
    """qwen2-moe's numbers for its own output line."""
    serve, tick = res["serve"], res["serve"]["profile"]
    prof = res["train"]["profile"]
    return {"arch": QWEN2MOE, "tok_s": serve["tok_s"], "ttft_p50_ms": serve["ttft_ms"],
            "decode_tick_wall_ms": tick["decode_tick"]["wall_ms"],
            "decode_tick_busy_ms": tick["decode_tick"].get("busy_ms"),
            "prefill_tick_wall_ms": tick["prefill_tick"]["wall_ms"],
            "prefill_tick_busy_ms": tick["prefill_tick"].get("busy_ms"),
            "serve_launches": serve["launches"], "parity_max_rel": res["parity"]["max_rel"],
            "emu_layers": res["emu"]["layers"], "emu_launches": res["emu"]["launches"],
            "train_layers": prof["layers"], "step_ms": prof["step_ms"],
            "tflop_s": prof["tflop_s"], "peak_gib": prof["peak_gib"],
            "idle_share": prof.get("idle_share"), "train_launches": res["train"]["launches"],
            "aux_losses": prof["aux_losses"], "dropped_frac": prof["dropped_frac"],
            "decode_forward_dev_ms": res["decode"]["forward"]["dev_ms"],
            "kimi_params": res["kimi"]["n_params"], "seconds": res["seconds"]}


# ---------------------------------------------------------------------------
# the recurrentgemma family (phase_recurrentgemma)
# ---------------------------------------------------------------------------
RG = "recurrentgemma-9b"
# (n_layers, d_model, n_heads, n_kv_heads, d_ff, vocab, d_rnn, window) of its full()
RG_FULL = (38, 4096, 16, 1, 12288, 256000, 4096, 2048)
# bank products a token: 26 recurrent layers x 8 (in_x, w_a, w_i, in_gate,
# out, the MLP's 3), 12 attention layers x 7 (q, k, v, o, the MLP's 3), the head
RG_FORWARD = 26 * 8 + 12 * 7 + 1  # 293
RG_DEPTH = 4  # training: one (rec, rec, attn) group and one tail layer
RG_STEPS = 2  # f32 dfa fit steps
RG_BATCHES = (64, 32, 16)  # x LM_SEQ: the largest that leaves FREE_GIB free
# the memory probe's steps: the allocator's reserve above the allocated peak
# grows after the first step (seen on the card)
RG_PROBE_STEPS = 2
RG_EMU_LAYERS = 4
RG_RING_TOKENS = 2100  # past the 2048-slot ring


def _rg_cfg(torch, depth=None, dtype=None):
    """recurrentgemma-9b's full config in ``dtype`` (f32 by default), cut to
    ``depth`` layers."""
    import dataclasses

    cfg = _meta_model(torch, RG, dtype or torch.float32).cfg
    return dataclasses.replace(cfg, n_layers=depth or cfg.n_layers)


def _rg_serve(torch, np, api, pm, seed):
    """recurrentgemma-9b's full() in bf16 on offchip_bpd, ``cuda`` backend,
    4 slots: 4 requests of 32-token prompts and 16 new tokens, prefill
    chunk 16 by the masked decode-scan; 293 launches a forward; the kernel
    against its plain version on the path's own operands at every (T, K,
    M) (the first call of each), the K = 12288 down projection by both
    skinny variants; a prefill tick and two decode ticks under the
    profiler."""
    tag = "rg_serve"
    session = api.build_session(arch=RG, algo="bp", smoke=False, hardware="offchip_bpd",
                                backend="cuda", dtype=torch.bfloat16, seed=seed, device=DEVICE)
    model = session.model
    c = model.cfg
    check((c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab_size, c.d_rnn,
           c.window) == RG_FULL and not model.supports_parallel_prefill,
          "not recurrentgemma-9b's full config")
    check(len(model.forward_gemm_specs()) == RG_FORWARD, f"not {RG_FORWARD} bank products")
    run = _serve_captured(torch, np, pm, session, seed,
                          lambda a, b: (a.shape[0], a.shape[1], b.shape[0]), RG_FORWARD, tag,
                          scan=True, n_requests=4)
    captured = run.pop("captured")
    decode = _dense_decode_shapes(model)
    check(set(captured) == set(decode), f"the path's (T, K, M) {sorted(captured)}, not "
                                        f"{sorted(decode)}")
    max_err = _captured_vs_plain(torch, pm, captured, "(T, K, M)")
    modes = sorted({"input" if "noise" in kw else "none" for _, _, kw, _ in captured.values()})
    print(f"[{tag}] kernel vs plain on the path's own bf16 operands (first call of each of "
          f"{len(captured)} (T, K, M): {', '.join(str(x) for x in sorted(captured))}; "
          f"{'/'.join(modes)} noise): max |kernel - plain| / max|plain| = {max_err:.3e} "
          f"(tol {TOL['bfloat16']})")
    a, b, kw, _ = captured[(4, c.d_ff, c.d_model)]
    skinny = _skinny_variants(torch, pm, a, b, kw, tag)
    del captured, a, b, kw
    profile = phase_profile_ticks(torch, np, api, seed, tag=tag, session=session)
    del session, model
    gc.collect()
    torch.cuda.empty_cache()
    return {**run, "max_rel_err": max_err, "skinny_k12288": skinny, "profile": profile}


def _rg_parity(torch, np, api, seed):
    """full() in f32 (41.8 GB of weights, one model for both backends) on
    the ideal preset: the ``cuda`` backend against the ``ref`` backend,
    teacher-forced (one prefill chunk of 16 by the decode-scan, then 8
    decode steps)."""
    from repro_torch.core import photonics as ph
    from repro_torch.serve.decode import make_prefill_step

    model = api.build_model(RG, dtype=torch.float32, device=DEVICE, seed=seed)
    tokens = torch.tensor(_prompts(np.random.default_rng(seed + 12), 4, 16, RG_FULL[5]),
                          device=DEVICE)
    prefill, n_decode = make_prefill_step(model), 8

    def run(backend, forced=None):
        caches = model.init_caches(4, 128)
        cache_len = torch.zeros(4, dtype=torch.long, device=DEVICE)
        full = torch.full((4,), tokens.shape[1], dtype=torch.long, device=DEVICE)
        logits_seq, chosen = [], []
        with torch.no_grad(), ph.forward_execution(ph.PRESETS["ideal"], backend):
            last, caches, cache_len = prefill(tokens, full, caches, cache_len)
            logits_seq.append(last)
            tok = last.argmax(-1)
            for s in range(n_decode):
                tok = forced[s] if forced is not None else tok
                chosen.append(tok)
                logits, caches = model.decode_step(tok[:, None], caches, cache_len)
                cache_len = cache_len + 1
                logits_seq.append(logits[:, -1].float())
                tok = logits[:, -1].argmax(-1)
        return logits_seq, chosen

    ref_logits, ref_tokens = run("ref")
    cuda_logits, _ = run("cuda", forced=ref_tokens)
    worst, gated, agree = _logit_agreement(ref_logits, cuda_logits)
    print(f"[rg_parity] f32 ideal, cuda vs ref over {len(ref_logits)} forwards' last logits (a "
          f"decode-scan prefill of 16 positions + {n_decode} decode steps): max |Δlogit| / "
          f"max|logit| = {worst:.3e} (limit 1e-4); greedy tokens agree at {agree}/{gated} "
          f"positions with a top-2 gap > 1e-3·max|logit|")
    check(worst <= 1e-4, f"cuda vs ref logits differ by {worst:.3e} of max|logit|")
    check(agree == gated, "greedy tokens differ where the top-2 gap is clear")
    del model, ref_logits, cuda_logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_rel": worst, "clear_positions": gated, "agree": agree}


def _rg_attention(torch, seed):
    """One full-width local attention layer (d 4096, 16 heads, kv 1, head
    dim 256, window 2048) in f32: RG_RING_TOKENS decode steps through its
    2048-slot ring buffer against its windowed full forward on the same
    tokens (tests/test_layers.py's bound); then ``flash_attention`` at
    batch 2 x seq 4096 with window 2048 against the windowed
    ``reference_attention`` within FLASH_TOL."""
    from repro_torch.nn import attention

    tag = "rg_attention"
    c = _rg_cfg(torch)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 21)
    layer = attention.Attention(c.d_model, c.n_heads, c.n_kv_heads, window=c.window,
                                rope_theta=c.rope_theta, device=DEVICE).init(seed)
    x = torch.randn((2, RG_RING_TOKENS, c.d_model), generator=gen, device=DEVICE)
    with torch.no_grad():
        full = layer(x, q_chunk=c.q_chunk, k_chunk=c.k_chunk)
        cache = layer.init_cache(2, 4096)
        slots = cache["k"].shape[1]
        check(slots == c.window, f"a {slots}-slot cache, not the window's {c.window}")
        t0 = time.perf_counter()
        outs = []
        for t in range(RG_RING_TOKENS):
            y, cache = layer.decode(x[:, t:t + 1], cache,
                                    torch.full((2,), t, dtype=torch.long, device=DEVICE))
            outs.append(y)
        dec = torch.cat(outs, dim=1)
        sync(torch)
        wall = time.perf_counter() - t0
    excess = ((dec - full).abs() - (2e-5 + 1e-4 * full.abs())).max().item()
    ring_err = (dec - full).abs().max().item()
    wrapped = (dec[:, c.window:] - full[:, c.window:]).abs().max().item()
    print(f"[{tag}] ring buffer: {RG_RING_TOKENS} decode steps of 2 rows through {slots} slots "
          f"(the ring wraps at token {c.window}) in {wall:.2f}s against the windowed full "
          f"forward (seq {RG_RING_TOKENS}, f32): max |Δ| {ring_err:.3e} (past the wrap "
          f"{wrapped:.3e}; max|y| {full.abs().max().item():.3f}; tol 2e-5 + 1e-4·|y|)")
    check(excess <= 0, f"the ring-buffer decode differs from the windowed forward by {ring_err}")
    del layer, x, full, cache, outs, dec

    shape = (LONG_BATCH, LONG_SEQ)
    q = torch.randn((*shape, c.n_heads, c.d_model // c.n_heads), generator=gen, device=DEVICE)
    k = torch.randn((*shape, c.n_kv_heads, c.d_model // c.n_heads), generator=gen,
                    device=DEVICE)
    v = torch.randn_like(k)
    pos = torch.arange(LONG_SEQ, device=DEVICE)[None, :].expand(*shape)
    kw = dict(q_pos=pos, kv_pos=pos, causal=True, window=c.window)
    got = attention.flash_attention(q, k, v, q_chunk=c.q_chunk, k_chunk=c.k_chunk, **kw)
    expect = attention.reference_attention(q, k, v, **kw)
    excess = ((got - expect).abs() - FLASH_TOL * (1 + expect.abs())).max().item()
    flash_err = (got - expect).abs().max().item()
    print(f"[{tag}] flash_attention vs reference_attention, window {c.window}, q "
          f"{tuple(q.shape)}, k/v {tuple(k.shape)} f32 (q_chunk {c.q_chunk}, k_chunk "
          f"{c.k_chunk}): max |Δ| {flash_err:.3e} (max|ref| {expect.abs().max().item():.3f}; "
          f"tol {FLASH_TOL} abs + rel)")
    check(excess <= 0, f"windowed flash_attention differs from the oracle by {flash_err:.3e}")
    del q, k, v, got, expect
    torch.cuda.empty_cache()
    return {"ring_max_abs_err": ring_err, "ring_wall_s": wall, "flash_max_abs_err": flash_err}


def _rg_train(torch, api, pm, seed, card):
    """recurrentgemma at full width in f32, cut to RG_DEPTH layers (one
    (rec, rec, attn) group and one tail layer, so every segment trains):
    RG_PROBE_STEPS dfa steps at batch 16 measure the activations and what
    the allocator reserves above them, the largest batch of RG_BATCHES x
    seq 64 that leaves FREE_GIB free by that measure is taken (printed);
    RG_STEPS dfa fit steps on offchip_bpd (``cuda``), one
    launch a block and the embedding's; block 0's and the embedding's δ
    against the plain version; ideal cuda = ref gradients; step ms, a
    profile, step_cost and peak memory."""
    from repro_torch.data import tokens
    from repro_torch.models.recurrentgemma import RecurrentGemmaLM

    tag = "rg_train"
    kind, peaks = card_peaks(card)
    total = torch.cuda.get_device_properties(0).total_memory
    log = pm._BUILD_DIR / f"rg_train-{os.getpid()}.csv"
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    cfg = _rg_cfg(torch, RG_DEPTH)
    model = RecurrentGemmaLM(cfg, device=DEVICE)
    check(cfg.n_groups == 1 and cfg.n_tail == 1
          and [s.n_layers for s in model.segment_specs()] == [1, 1, 1, 1],
          "not one layer in each of the four segments")
    session = api.build_session(arch=model, algo="dfa", hardware="offchip_bpd", backend="cuda",
                                seed=seed, log_every=1, log_path=str(log), device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    segments, rest = _segment_params(model)
    states = STATE_COPIES * 4 * n_params

    # steps at batch 16: their activations and the allocator's reserve
    # above their allocated peak, measured
    small = 16 * LM_SEQ
    probe_gen = tokens.MarkovTokens(cfg.vocab_size, LM_SEQ, 16, seed + 1)
    torch.cuda.reset_peak_memory_stats()
    state = session.init_state()
    for i in range(RG_PROBE_STEPS):
        state, _ = session.step(state, probe_gen.batch(i))
    sync(torch)
    peak = torch.cuda.max_memory_allocated() - base
    reserve = torch.cuda.max_memory_reserved() - torch.cuda.max_memory_allocated()
    del state
    gc.collect()
    torch.cuda.empty_cache()
    act_row = max(0, peak - states) / small
    fits = [b for b in RG_BATCHES
            if base + states + act_row * b * LM_SEQ + reserve + FREE_GIB * 2**30 <= total]
    batch = fits[0] if fits else RG_BATCHES[-1]
    rows = batch * LM_SEQ
    print(f"[{tag}] depth {cfg.n_layers} of {RG_FULL[0]} layers at full width (one group: "
          + ", ".join(f"{n} {p / 1e6:.1f} M" for n, p in segments.items())
          + f" parameters a layer; {rest / 1e9:.3f} B in the embedding, head and norms): "
          f"{n_params / 1e9:.3f} B parameters, {STATE_COPIES} f32 copies "
          f"{states / 2**30:.2f} GiB; {RG_PROBE_STEPS} steps at batch 16 x seq {LM_SEQ} peaked "
          f"{peak / 2**30:.2f} GiB above resident: activations {act_row * small / 2**30:.2f} "
          f"GiB, {act_row / 2**20:.3f} MiB a row, and the allocator reserved "
          f"{reserve / 2**30:.2f} GiB above the peak; batch {batch} x seq {LM_SEQ} ({rows} "
          f"rows) is the largest of {', '.join(map(str, RG_BATCHES))} that leaves "
          f"{FREE_GIB:g} GiB of the {total / 2**30:.1f} GiB card free")

    torch.cuda.reset_peak_memory_stats()
    per_step = cfg.n_layers + 1
    gen = tokens.MarkovTokens(cfg.vocab_size, LM_SEQ, batch, seed)
    fit = _fit_logged(torch, pm, session, gen, RG_STEPS, log)
    launches, losses = fit["launches"], fit["losses"]
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    free_gib = (total - torch.cuda.max_memory_reserved()) / 2**30
    print(f"[{tag}] {cfg.n_layers} layers, full width, f32, offchip_bpd, cuda backend, batch "
          f"{batch} x seq {LM_SEQ}: {RG_STEPS} fit steps in {fit['wall']:.2f}s; loss per step "
          f"{', '.join(f'{x:.4f}' for x in losses)}; photonic_matmul launches {launches} = "
          f"{launches / RG_STEPS:g} per step; peak device memory {peak_gib:.2f} GiB above the "
          f"{base / 2**30:.2f} GiB resident before the session, {free_gib:.2f} GiB of the card "
          f"never reserved")
    _check_fit(fit, RG_STEPS, per_step)
    check(free_gib >= FREE_GIB, f"the run left {free_gib:.2f} GiB free, under {FREE_GIB} GiB")

    calls, errs, step, out = _step_projections(torch, pm, session, fit["state"], gen, seed,
                                               per_step, rows, tag)
    (a, b), kw, _ = calls[0]
    operands = (a, b, kw["noise"])
    del calls, out, a, b, kw
    ideal = _ideal_cuda_vs_ref(torch, session, fit["state"], step, tag,
                               watch=("grp_rec1.0.mixer.lambda", "grp_rec1.0.mixer.conv_w",
                                      "grp_attn.0.mixer.q.weight", "embed.tok.table"))
    del step
    gc.collect()
    torch.cuda.empty_cache()

    batches = [to_device_batch(gen.batch(i)) for i in range(RG_STEPS, RG_STEPS + 2)]
    prof = _step_timing(torch, session, fit, batches, 1, 1, tag, card)
    prof.update(layers=cfg.n_layers, batch=batch, peak_gib=peak_gib, free_gib=free_gib,
                losses=losses, act_gib=act_row * rows / 2**30, reserve_gib=reserve / 2**30)
    del batches, fit, session, model
    gc.collect()
    torch.cuda.empty_cache()

    a, b, noise = operands
    print(f"[rg_timing] recurrentgemma training shape, input mode      T      K      M  dtype "
          f"{TIMING_HEAD}")
    row = _bank_row(torch, pm, a, b, {"noise": noise}, peaks, "input", "rg_timing",
                    "recurrentgemma training shape, input mode ",
                    reps={"ms": 25, "plain_ms": 10, "library_ms": 25})
    row["launches_per_step"] = per_step
    print(f"[rg_timing] the path's {per_step} launches a dfa step: "
          f"{row['dev_ms'] * per_step:.3f} ms device of the step's {prof['step_ms']:.1f} ms")
    del a, b, noise, operands
    torch.cuda.empty_cache()
    return {"launches": launches, "per_step": per_step, "max_abs_err": max(errs.values()),
            "ideal_max_rel": ideal[0], "profile": prof, "train_shape": row,
            "n_params": n_params}


def _rg_emu_serve(torch, np, api, em, seed):
    """recurrentgemma at full width cut to RG_EMU_LAYERS layers (3
    recurrent, 1 attention), bf16, on emu_offchip: 2 requests (8-token
    prompts, 4 new tokens) on 2 slots, prefill chunk 8 by the decode-scan,
    one emu launch a bank product; the emu kernel against its plain
    version on the path's own operands (the first call of each shape), bit
    for bit under every plan of the forced grid."""
    from repro_torch.models.recurrentgemma import RecurrentGemmaLM
    from repro_torch.serve import Request

    tag = "rg_emu"
    cfg = _rg_cfg(torch, RG_EMU_LAYERS, torch.bfloat16)
    model = RecurrentGemmaLM(cfg, device=DEVICE).init(seed)
    session = api.build_session(arch=model, algo="bp", hardware="emu_offchip", backend="emu",
                                seed=seed, device=DEVICE)
    eng = session.engine(batch_slots=2, max_len=64, prefill_chunk=8, seed=seed)
    check(eng.hw_state is not None and eng._backend.name == "emu", "no drift state / backend")
    finite = _finite_outputs(torch, eng)
    reqs = [Request(prompt=p, max_new=4)
            for p in _prompts(np.random.default_rng(seed + 13), 2, 8, cfg.vocab_size)]
    per_forward = len(model.forward_gemm_specs())
    check(per_forward == 3 * 8 + 7 + 1, f"{per_forward} bank products a forward")
    captured, launches, wall = _emu_run_captured(torch, em, eng, reqs)
    forwards = _mamba_forwards(eng, 8)
    tokens = sum(len(r.out) for r in reqs)
    print(f"[{tag}] {cfg.n_layers} of {RG_FULL[0]} layers at full width, bf16, emu_offchip: "
          f"{len(reqs)} requests, {tokens} tokens in {wall:.3f}s ({forwards} forwards, the "
          f"prefill by the decode-scan); emu_bank_product launches {launches} = {per_forward} x "
          f"{forwards}: {launches == per_forward * forwards}")
    check(all(r.done and len(r.out) == 4 for r in reqs), "requests unfinished")
    check(launches == per_forward * forwards,
          f"launches {launches} != {per_forward} x {forwards}")
    check(finite(), "non-finite logits")
    max_err, n_plans = _emu_path_exact(torch, em, captured, "recurrentgemma")
    print(f"[{tag}] kernel vs plain on the path's own operands (bf16 a_t, f32 δ; "
          f"{len(captured)} shapes: {', '.join(str(a) for a, _ in captured)}), {n_plans} plans "
          f"in all: equal bit for bit (max |kernel - plain| {max_err:.3e})")
    check(len(captured) == len({(m, k) for _, m, k in model.forward_gemm_specs()}),
          f"{len(captured)} shapes captured")
    del eng, session, model, captured
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": max_err, "wall_s": wall, "forwards": forwards,
            "layers": cfg.n_layers}


def phase_recurrentgemma(torch, np, api, pm, em, seed, card, draws):
    """The recurrentgemma family at full width, random weights from
    ``seed``: recurrentgemma-9b (38 layers = 12 x (rec, rec, local attn) +
    2 rec, d 4096, 16 heads, kv 1, d_ff 12288, vocab 256000, window 2048;
    10.44 B parameters) served in bf16 through the bank kernel (293
    launches a forward, the prefill by the masked decode-scan; the kernel
    against its plain version at every (T, K, M) of the path) with a
    profiled prefill tick and two decode ticks; f32 ideal cuda-vs-ref
    parity; one full-width local attention layer decoding past its
    2048-slot ring against its windowed forward, and the windowed
    ``flash_attention`` at seq 4096 against its oracle; f32 dfa training
    at RG_DEPTH layers (every segment) at the largest batch the card
    holds; emu serving at RG_EMU_LAYERS layers with the emu kernel bit for
    bit; the bank kernel timed at every decode shape."""
    del draws
    kind, peaks = card_peaks(card)
    t0 = time.perf_counter()
    # grow the allocator's segments in place, as phase_dense sets it (also
    # when this phase runs alone): the f32 training run is sized to the card
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    print(f"[rg] seed {seed}; {RG}: {RG_FULL[0]} layers, d {RG_FULL[1]}, {RG_FULL[2]} heads, "
          f"kv {RG_FULL[3]}, d_ff {RG_FULL[4]}, vocab {RG_FULL[5]}, d_rnn {RG_FULL[6]}, window "
          f"{RG_FULL[7]}; {RG_FORWARD} bank products a token; training depth {RG_DEPTH}, "
          f"{RG_STEPS} steps; emu serve depth {RG_EMU_LAYERS}")
    gc.collect()
    torch.cuda.empty_cache()
    out = {"serve": _rg_serve(torch, np, api, pm, seed)}
    out["parity"] = _rg_parity(torch, np, api, seed)
    out["attention"] = _rg_attention(torch, seed)
    out["train"] = _rg_train(torch, api, pm, seed, card)
    out["emu"] = _rg_emu_serve(torch, np, api, em, seed)
    shapes = _dense_decode_shapes(_meta_model(torch, RG))
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    print(f"[rg_timing] {kind} peaks; card: {card}")
    rows, forward = _decode_rows(torch, pm, dict(sorted(shapes.items())), peaks, gen,
                                 "rg_timing", "recurrentgemma decode shapes ",
                                 reps={"ms": 10, "plain_ms": 10, "library_ms": 10})
    check(forward["launches"] == RG_FORWARD, f"{forward['launches']} launches timed")
    out["decode"] = {"shapes": rows, "forward": forward}
    out["seconds"] = time.perf_counter() - t0
    print(f"[rg] done in {out['seconds']:.1f}s")
    return out


def rg_summary(res):
    """recurrentgemma's numbers for its own output line."""
    serve, tick = res["serve"], res["serve"]["profile"]
    prof = res["train"]["profile"]
    return {"arch": RG, "tok_s": serve["tok_s"], "ttft_p50_ms": serve["ttft_ms"],
            "decode_tick_wall_ms": tick["decode_tick"]["wall_ms"],
            "decode_tick_busy_ms": tick["decode_tick"].get("busy_ms"),
            "decode_tick_idle_share": tick["decode_tick"].get("idle_share"),
            "prefill_tick_wall_ms": tick["prefill_tick"]["wall_ms"],
            "prefill_tick_busy_ms": tick["prefill_tick"].get("busy_ms"),
            "serve_launches": serve["launches"], "parity_max_rel": res["parity"]["max_rel"],
            "ring_max_abs_err": res["attention"]["ring_max_abs_err"],
            "flash_max_abs_err": res["attention"]["flash_max_abs_err"],
            "emu_layers": res["emu"]["layers"], "emu_launches": res["emu"]["launches"],
            "train_layers": prof["layers"], "train_batch": prof["batch"],
            "step_ms": prof["step_ms"], "tflop_s": prof["tflop_s"], "peak_gib": prof["peak_gib"],
            "idle_share": prof.get("idle_share"), "train_launches": res["train"]["launches"],
            "decode_forward_dev_ms": res["decode"]["forward"]["dev_ms"],
            "seconds": res["seconds"]}


# ---------------------------------------------------------------------------
# whisper-small and internvl2-2b (phase_whisper, phase_internvl2)
# ---------------------------------------------------------------------------
WHISPER, INTERNVL2 = "whisper-small", "internvl2-2b"
# (enc layers, dec layers, d_model, heads, d_ff, vocab, frames, max_target) of its full()
WHISPER_FULL = (12, 12, 768, 12, 3072, 51865, 1500, 448)
# bank products of an encode or a decode forward: q, k, v, o, fc1 and fc2 in
# each of 12 layers; the cross attention and the head are digital
WHISPER_FORWARD = 6 * 12  # 72
WHISPER_CLIPS, WHISPER_PROMPT, WHISPER_NEW = 4, 4, 16  # served: 4 clips, 4 + 16 decode steps
WHISPER_BATCH, WHISPER_STEPS, WHISPER_EMU_STEPS = 8, 4, 2  # f32 dfa: batch 8 x seq 64
# a dfa step's projections: 12 encoder blocks (the pooled error, one row a
# clip), 12 decoder blocks and the embedding (every target position)
WHISPER_LAUNCHES = 25
# (n_layers, d_model, heads, kv heads, d_ff, vocab, patches, d_vision) of its full()
INTERNVL2_FULL = (24, 2048, 16, 8, 8192, 92553, 256, 1024)
INTERNVL2_FORWARD = 7 * 24 + 1  # 169: q, k, v, o and the MLP's 3 a layer, the head
INTERNVL2_STEPS = 2  # f32 dfa fit steps, 256 patches + seq 64
# the largest that leaves FREE_GIB free; the card holds 64, and 16 keeps
# the script's wall near 700 s
INTERNVL2_BATCHES = (16,)
INTERNVL2_PROBE_BATCH = 16


def _whisper_inputs(torch, np, cfg, seed):
    """WHISPER_CLIPS clips of frame embeddings (0.1 x normal, as the
    training launcher draws them) and WHISPER_PROMPT-token prompts."""
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(WHISPER_CLIPS, cfg.n_frames, cfg.d_model)).astype("float32") * 0.1
    prompt = rng.integers(0, cfg.vocab_size, (WHISPER_CLIPS, WHISPER_PROMPT))
    return torch.tensor(frames, device=DEVICE), torch.tensor(prompt, device=DEVICE)


def _whisper_serve(torch, np, api, pm, seed, card):
    """whisper-small full() in bf16 on offchip_bpd, ``cuda`` backend: 4
    clips of 1500 frames encoded once (72 launches at T = 6000), then a
    4-token prompt fed a token at a time and 16 greedy tokens through
    ``make_serve_step(whisper_enc=True)`` (72 launches a step, T = 4); the
    kernel against its plain version on the path's own operands at every
    (T, K, M) (the first call of each); one encode and two decode steps
    under the profiler."""
    import types

    from repro_torch.core import photonics as ph
    from repro_torch.kernels import ops as kops
    from repro_torch.serve.decode import make_serve_step
    from repro_torch.utils import prng

    tag = "whisper_serve"
    model = api.build_model(WHISPER, dtype=torch.bfloat16, device=DEVICE, seed=seed)
    c = model.cfg
    check((c.n_enc_layers, c.n_dec_layers, c.d_model, c.n_heads, c.d_ff, c.vocab_size,
           c.n_frames, c.max_target) == WHISPER_FULL, "not whisper-small's full config")
    n_params = sum(p.numel() for p in model.parameters())
    frames, prompt = _whisper_inputs(torch, np, c, seed + 30)
    serve_step = make_serve_step(model, whisper_enc=True)
    hw = ph.PRESETS["offchip_bpd"]
    n = WHISPER_CLIPS
    max_len = 32

    def encode(key):
        with torch.no_grad(), ph.forward_execution(hw, "cuda", key):
            return model.encode(frames)

    def decode(tok, caches, pos, enc, key):
        with torch.no_grad(), ph.forward_execution(hw, "cuda", key):
            return serve_step(tok, caches, torch.full((n,), pos, device=DEVICE), enc)

    # warm-up: one encode and one decode step (allocator, first launches)
    enc = encode(prng.fold(seed, "warm"))
    decode(prompt[:, :1], model.init_caches(n, max_len), 0, enc, prng.fold(seed, "warm"))
    sync(torch)
    del enc
    captured = []
    restore = _wrap(kops, "photonic_matmul_cuda", captured,
                    key=lambda a, b: (a.shape[0], a.shape[1], b.shape[0]))
    finite = torch.ones((), dtype=torch.bool, device=DEVICE)
    steps = WHISPER_PROMPT + WHISPER_NEW
    try:
        sync(torch)
        pm.launches = 0
        t0 = time.perf_counter()
        enc = encode(prng.fold(seed, "encode"))
        sync(torch)
        encode_wall = time.perf_counter() - t0
        encode_launches = pm.launches
        caches, out, step_s = model.init_caches(n, max_len), [], []
        tok = prompt[:, :1]
        for t in range(steps):
            tok = prompt[:, t:t + 1] if t < WHISPER_PROMPT else tok
            t1 = time.perf_counter()
            tok, logits, caches = decode(tok, caches, t, enc, prng.fold(seed, t))
            finite &= torch.isfinite(logits).all()
            sync(torch)
            step_s.append(time.perf_counter() - t1)
            if t >= WHISPER_PROMPT - 1:
                out.append(tok)
        launches = pm.launches
    finally:
        restore()
    forwards = 1 + steps
    new_tokens = n * (len(out) - 1)
    decode_wall = sum(step_s)
    print(f"[{tag}] full() ({n_params / 1e6:.1f} M parameters) bf16, offchip_bpd, cuda backend: "
          f"encode of {n} clips x {c.n_frames} frames in {encode_wall * 1e3:.2f} ms; {steps} "
          f"decode steps ({WHISPER_PROMPT} prompt tokens fed one at a time, then "
          f"{WHISPER_NEW} greedy) in {decode_wall:.3f}s: step wall median "
          f"{statistics.median(step_s) * 1e3:.2f} ms, {new_tokens / decode_wall:.1f} tok/s "
          f"over the steps")
    print(f"[{tag}] photonic_matmul launches: encode {encode_launches}, all {launches} = "
          f"{WHISPER_FORWARD} x {forwards} forwards (1 encode + {steps} decode steps): "
          f"{launches == WHISPER_FORWARD * forwards}")
    check(encode_launches == WHISPER_FORWARD, f"{encode_launches} launches in the encode")
    check(launches == WHISPER_FORWARD * forwards,
          f"launches {launches} != {WHISPER_FORWARD} x {forwards}")
    check(bool(finite.item()), "non-finite logits")
    check(len(out) == WHISPER_NEW + 1, "greedy tokens missing")
    captured = {(a.shape[0], a.shape[1], b.shape[0]): (a, b, kw, got)
                for (a, b), kw, got in captured}
    t_enc = n * c.n_frames
    layer = {(c.d_model, c.d_model), (c.d_model, c.d_ff), (c.d_ff, c.d_model)}
    expect_shapes = {(t, k, m) for t in (t_enc, n) for k, m in layer}
    check(set(captured) == expect_shapes,
          f"the path's (T, K, M) {sorted(captured)}, not {sorted(expect_shapes)}")
    max_err = _captured_vs_plain(torch, pm, captured, "(T, K, M)")
    enc_err = _captured_vs_plain(torch, pm, {s: v for s, v in captured.items() if s[0] == t_enc},
                                 "(T, K, M)")
    modes = sorted({"input" if "noise" in kw else "none" for _, _, kw, _ in captured.values()})
    print(f"[{tag}] kernel vs plain on the path's own bf16 operands (first call of each of "
          f"{len(captured)} (T, K, M): {', '.join(str(x) for x in sorted(captured))}; "
          f"{'/'.join(modes)} noise): max |kernel - plain| / max|plain| = {max_err:.3e}, at T = "
          f"{t_enc} {enc_err:.3e} (tol {TOL['bfloat16']}); variants at T = {t_enc}: "
          + ", ".join(f"{k}x{m} {pm._plan(t_enc, m, k, torch.bfloat16, (0, 0)).name}"
                      for (_, k, m) in sorted(s for s in captured if s[0] == t_enc)))
    del captured
    # one encode and two decode steps under the profiler
    keys = iter(range(10**6, 10**6 + 3))
    profile = {"encode": _profile_ticks(
        torch, types.SimpleNamespace(tick=lambda: encode(next(keys))), 1, tag,
        f"encode ({n} clips x {c.n_frames} frames, bf16, offchip_bpd)", "photonic_matmul")}
    state = {"tok": tok, "caches": caches, "t": steps}

    def tick():
        state["tok"], _, state["caches"] = decode(state["tok"], state["caches"], state["t"], enc,
                                                  next(keys))
        state["t"] += 1

    profile["decode_step"] = _profile_ticks(torch, types.SimpleNamespace(tick=tick), 2, tag,
                                            f"decode step ({n} clips, bf16, offchip_bpd)",
                                            "photonic_matmul")
    print(f"[{tag}] card: {card}")
    del model, enc, caches, state, frames
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "encode_launches": encode_launches, "forwards": forwards,
            "encode_ms": encode_wall * 1e3, "step_ms": statistics.median(step_s) * 1e3,
            "tok_s": new_tokens / decode_wall, "n_params": n_params, "max_rel_err": max_err,
            "encode_max_rel_err": enc_err, "profile": profile}


def _whisper_parity(torch, np, api, seed):
    """full() in f32 on the ideal preset: the ``cuda`` backend against the
    ``ref`` backend, teacher-forced: the encode, the 4-token prompt and 8
    greedy steps; the encoder output and each step's logits."""
    from repro_torch.core import photonics as ph

    model = api.build_model(WHISPER, dtype=torch.float32, device=DEVICE, seed=seed)
    frames, prompt = _whisper_inputs(torch, np, model.cfg, seed + 31)
    n, n_decode = WHISPER_CLIPS, 8

    def run(backend, forced=None):
        logits_seq, chosen = [], []
        with torch.no_grad(), ph.forward_execution(ph.PRESETS["ideal"], backend):
            enc = model.encode(frames)
            caches = model.init_caches(n, 32)
            tok = prompt[:, :1]
            for t in range(WHISPER_PROMPT + n_decode):
                if t < WHISPER_PROMPT:
                    tok = prompt[:, t:t + 1]
                else:
                    tok = forced[t - WHISPER_PROMPT] if forced is not None else tok
                    chosen.append(tok)
                logits, caches = model.decode_step(tok, enc, caches,
                                                   torch.full((n,), t, device=DEVICE))
                logits_seq.append(logits[:, -1].float())
                tok = logits[:, -1].argmax(-1)[:, None]
        return enc, logits_seq, chosen

    ref_enc, ref_logits, ref_tokens = run("ref")
    cuda_enc, cuda_logits, _ = run("cuda", forced=ref_tokens)
    enc_rel = _max_rel(cuda_enc, ref_enc)
    worst, gated, agree = _logit_agreement(ref_logits, cuda_logits)
    print(f"[whisper_parity] f32 ideal, cuda vs ref: encoder output max |Δ| / max|ref| = "
          f"{enc_rel:.3e}; {len(ref_logits)} decode steps' logits ({WHISPER_PROMPT} prompt + "
          f"{n_decode} teacher-forced): max |Δlogit| / max|logit| = {worst:.3e} (limit 1e-4); "
          f"greedy tokens agree at {agree}/{gated} positions with a top-2 gap > "
          f"1e-3·max|logit|")
    check(worst <= 1e-4, f"cuda vs ref logits differ by {worst:.3e} of max|logit|")
    check(enc_rel <= 1e-4, f"cuda vs ref encoder outputs differ by {enc_rel:.3e}")
    check(agree == gated, "greedy tokens differ where the top-2 gap is clear")
    del model, ref_logits, cuda_logits, ref_enc, cuda_enc
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_rel": worst, "encode_max_rel": enc_rel, "clear_positions": gated,
            "agree": agree}


def _qk_scale(name):
    """The gradient whose max |value| scales ``name``'s in whisper's ideal
    cuda-vs-ref check: for the rope-less self-attention's q and k
    parameters, the attention's v parameter of the same kind.  Their
    gradients act only through the softmax's departure from uniform, small
    at random init: the key bias's is zero in exact arithmetic (it shifts
    every score of a query alike) and q.weight's lies orders of magnitude
    below v.weight's (``_whisper_train`` prints both), so the f32 rounding
    of δ shows there amplified.  Every other gradient is held to its own
    max."""
    for attn in (".attn.", ".self."):
        for proj in ("q.", "k."):
            if attn + proj in name:
                return name.replace(attn + proj, attn + "v.")
    return name


def _whisper_train(torch, np, api, pm, em, seed, card, draws):
    """full() in f32, batch 8 x seq 64 with 1500 frames a clip: WHISPER_STEPS
    dfa fit steps on offchip_bpd (``cuda``), 25 launches a step; the
    encoder's, the decoder's and the embedding's first δ against the plain
    version; the serving-only ``head.ln_enc`` with an exactly zero
    gradient; ideal cuda = ref gradients; step ms, a profile, step_cost
    and peak memory; WHISPER_EMU_STEPS steps on emu_offchip with the emu
    kernel bit for bit at both of its shapes."""
    import types

    from repro_torch.launch.train import lm_batches

    tag = "whisper_train"
    log = pm._BUILD_DIR / f"whisper_train-{os.getpid()}.csv"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    session = api.build_session(arch=WHISPER, smoke=False, dtype=torch.float32, seed=seed,
                                algo="dfa", hardware="offchip_bpd", backend="cuda", log_every=1,
                                log_path=str(log), device=DEVICE)
    model, cfg = session.model, session.model.cfg
    check((cfg.n_enc_layers, cfg.n_dec_layers, cfg.d_model, cfg.vocab_size) == (
        12, 12, 768, 51865) and model.head["out"].weight.dtype == torch.float32,
        "not the full f32 model")
    n_params = sum(p.numel() for p in model.parameters())
    gen = types.SimpleNamespace(batch=lm_batches(WHISPER, cfg, LM_SEQ, WHISPER_BATCH, seed))
    fit = _fit_logged(torch, pm, session, gen, WHISPER_STEPS, log)
    launches, losses = fit["launches"], fit["losses"]
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    free_gib = (total - torch.cuda.max_memory_reserved()) / 2**30
    print(f"[{tag}] whisper-small full width f32 ({n_params / 1e6:.1f} M parameters), "
          f"offchip_bpd, cuda backend, batch {WHISPER_BATCH} x seq {LM_SEQ} with "
          f"{cfg.n_frames} frames a clip: {WHISPER_STEPS} fit steps in {fit['wall']:.2f}s; loss "
          f"per step {', '.join(f'{x:.4f}' for x in losses)}; photonic_matmul launches "
          f"{launches} = {launches / WHISPER_STEPS:g} per step; peak device memory "
          f"{peak_gib:.2f} GiB above the {base / 2**30:.2f} GiB resident, {free_gib:.2f} GiB of "
          f"the card never reserved")
    _check_fit(fit, WHISPER_STEPS, WHISPER_LAUNCHES)

    rows = WHISPER_BATCH * LM_SEQ
    calls, errs, step, out = _step_projections(
        torch, pm, session, fit["state"], gen, seed, WHISPER_LAUNCHES, rows, tag,
        picks=(("encoder block 0", 0, WHISPER_BATCH), ("decoder block 0", cfg.n_enc_layers, rows),
               ("embedding", -1, rows)))
    grads = out[1]
    ln_enc = max(grads[k].abs().max().item() for k in ("head.ln_enc.scale", "head.ln_enc.bias"))
    trained = min(grads[k].abs().max().item() for k in ("embed.audio.pos", "embed.audio.ln.scale",
                                                        "dec.0.cross.k.weight"))
    qkv = {p: max(grads[k].abs().max().item() for k in grads
                  if k.startswith("dec.") and f".self.{p}.weight" in k) for p in "qkv"}
    print(f"[{tag}] head.ln_enc's gradient max |g| = {ln_enc:.1e} (serving alone reads it, as "
          f"in the reference); the audio stub's and the cross attention's are live (min of "
          f"their max |g| {trained:.3e}); the decoder self-attention's q / k / v weights' max "
          f"|g| {qkv['q']:.3e} / {qkv['k']:.3e} / {qkv['v']:.3e}")
    check(ln_enc == 0.0, f"head.ln_enc has a gradient ({ln_enc})")
    check(trained > 0, "a frontend or cross-attention gradient is zero")
    operands = {label: (a, b, kw["noise"]) for label, i in (("encoder", 0),
                                                           ("decoder", cfg.n_enc_layers))
                for (a, b), kw, _ in [calls[i]]}
    del calls, out, grads
    ideal = _ideal_cuda_vs_ref(torch, session, fit["state"], step, tag,
                               watch=("embed.audio.pos", "enc.0.attn.q.weight",
                                      "dec.0.cross.k.weight", "enc.0.attn.k.bias"),
                               scale_of=_qk_scale)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    batches = [to_device_batch(gen.batch(i)) for i in range(WHISPER_STEPS, WHISPER_STEPS + 4)]
    prof = _step_timing(torch, session, fit, batches, 1, 2, tag, card)
    prof.update(batch=WHISPER_BATCH, peak_gib=peak_gib, free_gib=free_gib, losses=losses)
    del batches, fit, session, model
    gc.collect()
    torch.cuda.empty_cache()
    emu = _emu_fit(torch, em, lambda: api.build_session(
        arch=WHISPER, smoke=False, dtype=torch.float32, seed=seed, algo="dfa",
        hardware="emu_offchip", backend="emu", log_every=10**9, device=DEVICE),
        gen, WHISPER_EMU_STEPS, WHISPER_LAUNCHES, "whisper_emu", "whisper_timing", card, draws,
        "whisper", per_shape=True)
    check(emu["other_shape_plans"] > 0, "the emu path gave one shape only")
    return {"launches": launches, "per_step": WHISPER_LAUNCHES,
            "max_abs_err": max(errs.values()), "ideal_max_rel": ideal[0], "profile": prof,
            "operands": operands, "emu": emu, "n_params": n_params}


def _timing_rows(torch, pm, operands, peaks, tag, label, per_step, step_ms):
    """The bank kernel at a dfa step's training shapes (input mode, f32):
    {name: row}, each with its launches a step."""
    print(f"[{tag}] {label} training shapes, input mode      T      K      M  dtype "
          f"{TIMING_HEAD}")
    rows = {}
    for name, (a, b, noise) in operands.items():
        rows[name] = _bank_row(torch, pm, a, b, {"noise": noise}, peaks, "input", tag,
                               f"{label} {name:>12s}, input mode ",
                               reps={"ms": 25, "plain_ms": 10, "library_ms": 25})
        rows[name]["launches_per_step"] = per_step[name]
    dev = sum(r["dev_ms"] * r["launches_per_step"] for r in rows.values())
    print(f"[{tag}] {label}: the path's {sum(per_step.values())} launches a dfa step: "
          f"{dev:.3f} ms device of the step's {step_ms:.1f} ms")
    return rows


def phase_whisper(torch, np, api, pm, em, seed, card, draws):
    """whisper-small at full width, random weights from ``seed`` (12 + 12
    layers, d 768, 12 heads, d_ff 3072, vocab 51865, 1500 frames; 279.6 M
    parameters): served in bf16 through the bank kernel (72 launches an
    encode at T = 6000 and a decode step at T = 4; cross attention and the
    head digital; the kernel against its plain version at every path
    shape) with a profiled encode and two decode steps; f32 ideal cuda vs
    ref (encoder output and logits); f32 dfa training at full depth (25
    launches a step: the encoder's blocks take the pooled error), ideal
    cuda = ref gradients, the zero ``ln_enc`` gradient; 2 steps on emulated
    banks with the emu kernel bit for bit; the bank kernel timed at the
    encode, decode and training shapes."""
    kind, peaks = card_peaks(card)
    t0 = time.perf_counter()
    print(f"[whisper] seed {seed}; {WHISPER}: {WHISPER_FULL[0]} + {WHISPER_FULL[1]} layers, d "
          f"{WHISPER_FULL[2]}, {WHISPER_FULL[3]} heads, d_ff {WHISPER_FULL[4]}, vocab "
          f"{WHISPER_FULL[5]}, {WHISPER_FULL[6]} frames, max_target {WHISPER_FULL[7]}; "
          f"{WHISPER_FORWARD} bank products a forward; training batch {WHISPER_BATCH} x seq "
          f"{LM_SEQ}, {WHISPER_STEPS} steps, {WHISPER_EMU_STEPS} on emu")
    gc.collect()
    torch.cuda.empty_cache()
    out = {"serve": _whisper_serve(torch, np, api, pm, seed, card)}
    out["parity"] = _whisper_parity(torch, np, api, seed)
    out["train"] = _whisper_train(torch, np, api, pm, em, seed, card, draws)
    c = _meta_model(torch, WHISPER).cfg
    layer = {(c.d_model, c.d_model): 4, (c.d_model, c.d_ff): 1, (c.d_ff, c.d_model): 1}
    gen = torch.Generator(device=DEVICE).manual_seed(22)
    print(f"[whisper_timing] {kind} peaks; card: {card}")
    t_enc = WHISPER_CLIPS * c.n_frames
    forwards = {}
    for t, what in ((t_enc, "encode"), (WHISPER_CLIPS, "decode")):
        shapes = {(t, k, m): n * c.n_enc_layers for (k, m), n in sorted(layer.items())}
        rows, fwd = _decode_rows(torch, pm, shapes, peaks, gen, "whisper_timing",
                                 f"whisper {what} shapes ",
                                 reps={"ms": 10, "plain_ms": 10, "library_ms": 10},
                                 what=f"one {what} forward at T={t}")
        check(fwd["launches"] == WHISPER_FORWARD, f"{fwd['launches']} launches timed")
        forwards[what] = {"shapes": rows, "forward": fwd}
    out["timing"] = forwards
    train = out["train"]
    out["train_shapes"] = _timing_rows(
        torch, pm, train.pop("operands"), peaks, "whisper_timing", "whisper",
        {"encoder": c.n_enc_layers, "decoder": c.n_dec_layers + 1},
        train["profile"]["step_ms"])
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"[whisper] done in {out['seconds']:.1f}s")
    return out


def whisper_summary(res):
    """whisper's numbers for its own output line."""
    serve, prof = res["serve"], res["train"]["profile"]
    dec = serve["profile"]["decode_step"]
    return {"arch": WHISPER, "encode_ms": serve["encode_ms"], "step_ms_wall": serve["step_ms"],
            "tok_s": serve["tok_s"], "decode_step_busy_ms": dec.get("busy_ms"),
            "decode_step_idle_share": dec.get("idle_share"),
            "encode_busy_ms": serve["profile"]["encode"].get("busy_ms"),
            "serve_launches": serve["launches"], "parity_max_rel": res["parity"]["max_rel"],
            "train_step_ms": prof["step_ms"], "tflop_s": prof["tflop_s"],
            "peak_gib": prof["peak_gib"], "train_idle_share": prof.get("idle_share"),
            "train_launches": res["train"]["launches"],
            "emu_launches": res["train"]["emu"]["launches"],
            "encode_forward_dev_ms": res["timing"]["encode"]["forward"]["dev_ms"],
            "decode_forward_dev_ms": res["timing"]["decode"]["forward"]["dev_ms"],
            "seconds": res["seconds"]}


def _internvl2_serve(torch, np, api, pm, seed):
    """internvl2-2b full() in bf16 on offchip_bpd, ``cuda`` backend, text
    only, as the reference serves it: 8 requests of 32-token prompts and
    16 new tokens on 4 slots, prefill chunk 16; 169 launches a forward; the
    kernel against its plain version at every (T, K, M) of the path, the
    92553-row head at T = 4 and 64 among them; a prefill tick and two
    decode ticks under the profiler."""
    tag = "internvl2_serve"
    session = api.build_session(arch=INTERNVL2, algo="bp", smoke=False, hardware="offchip_bpd",
                                backend="cuda", dtype=torch.bfloat16, seed=seed, device=DEVICE)
    model = session.model
    c = model.cfg
    check((c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab_size,
           c.vision.n_patches, c.vision.d_vision) == INTERNVL2_FULL,
          "not internvl2-2b's full config")
    check(len(model.forward_gemm_specs()) == INTERNVL2_FORWARD,
          f"not {INTERNVL2_FORWARD} bank products a token")
    run = _serve_captured(torch, np, pm, session, seed,
                          lambda a, b: (a.shape[0], a.shape[1], b.shape[0]), INTERNVL2_FORWARD,
                          tag)
    captured = run.pop("captured")
    decode = _dense_decode_shapes(model)
    shapes = set(captured)
    check({s for s in shapes if s[0] == 4} == set(decode)
          and {s for s in shapes if s[0] != 4} == {(64, k, m) for _, k, m in decode},
          f"the path's (T, K, M) {sorted(shapes)}")
    max_err = _captured_vs_plain(torch, pm, captured, "(T, K, M)")
    heads = {s: v for s, v in captured.items() if s[2] == c.vocab_size}
    head_err = _captured_vs_plain(torch, pm, heads, "the head's (T, K, M)")
    print(f"[{tag}] kernel vs plain on the path's own bf16 operands (first call of each of "
          f"{len(captured)} (T, K, M): {', '.join(str(s) for s in sorted(shapes))}): max "
          f"|kernel - plain| / max|plain| = {max_err:.3e}; the head (M = {c.vocab_size}, odd) "
          + ", ".join(f"T = {s[0]} {pm._plan(s[0], s[2], s[1], torch.bfloat16, (0, 0)).name}"
                      for s in sorted(heads))
          + f": {head_err:.3e} (tol {TOL['bfloat16']})")
    del captured, heads
    profile = phase_profile_ticks(torch, np, api, seed, tag=tag, session=session)
    del session, model
    gc.collect()
    torch.cuda.empty_cache()
    return {**run, "max_rel_err": max_err, "head_max_rel_err": head_err, "profile": profile}


def _internvl2_train(torch, np, api, pm, seed, card):
    """internvl2-2b at full depth and width in f32 with the 256-patch
    prefix and seq 64 (320 positions a row): RG_PROBE_STEPS steps at
    batch INTERNVL2_PROBE_BATCH measure the activations and the allocator's reserve, the
    largest batch of INTERNVL2_BATCHES that leaves FREE_GIB free by that
    measure is taken (printed); INTERNVL2_STEPS dfa fit steps on
    offchip_bpd (``cuda``), 25 launches a step; block 0's and the
    embedding's δ against the plain version; ideal cuda = ref gradients;
    step ms, a profile, step_cost and peak memory."""
    import types

    from repro_torch.launch.train import lm_batches

    tag = "internvl2_train"
    total = torch.cuda.get_device_properties(0).total_memory
    log = pm._BUILD_DIR / f"internvl2_train-{os.getpid()}.csv"
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    session = api.build_session(arch=INTERNVL2, smoke=False, dtype=torch.float32, seed=seed,
                                algo="dfa", hardware="offchip_bpd", backend="cuda", log_every=1,
                                log_path=str(log), device=DEVICE)
    model, cfg = session.model, session.model.cfg
    check(model.head["out"].weight.dtype == torch.float32 and cfg.n_layers == INTERNVL2_FULL[0],
          "not the full f32 model")
    n_params = sum(p.numel() for p in model.parameters())
    states = STATE_COPIES * 4 * n_params
    width = cfg.vision.n_patches + LM_SEQ

    def batches_of(batch):
        return types.SimpleNamespace(batch=lm_batches(INTERNVL2, cfg, LM_SEQ, batch, seed))

    small = INTERNVL2_PROBE_BATCH * width
    probe = batches_of(INTERNVL2_PROBE_BATCH)
    torch.cuda.reset_peak_memory_stats()
    state = session.init_state()
    for i in range(RG_PROBE_STEPS):
        state, _ = session.step(state, probe.batch(i))
    sync(torch)
    peak = torch.cuda.max_memory_allocated() - base
    reserve = torch.cuda.max_memory_reserved() - torch.cuda.max_memory_allocated()
    del state
    gc.collect()
    torch.cuda.empty_cache()
    act_row = max(0, peak - states) / small
    fits = [b for b in INTERNVL2_BATCHES
            if base + states + act_row * b * width + reserve + FREE_GIB * 2**30 <= total]
    batch = fits[0] if fits else INTERNVL2_BATCHES[-1]
    rows = batch * width
    print(f"[{tag}] full depth and width, f32: {n_params / 1e9:.3f} B parameters, "
          f"{STATE_COPIES} f32 copies {states / 2**30:.2f} GiB; {RG_PROBE_STEPS} steps at batch "
          f"{INTERNVL2_PROBE_BATCH} x ({cfg.vision.n_patches} patches + {LM_SEQ} tokens) peaked "
          f"{peak / 2**30:.2f} GiB above resident: activations {act_row * small / 2**30:.2f} "
          f"GiB, {act_row / 2**20:.3f} MiB a row, the allocator reserved {reserve / 2**30:.2f} "
          f"GiB above the peak; batch {batch} ({rows} rows) is the largest of "
          f"{', '.join(map(str, INTERNVL2_BATCHES))} that leaves {FREE_GIB:g} GiB of the "
          f"{total / 2**30:.1f} GiB card free")

    torch.cuda.reset_peak_memory_stats()
    per_step = cfg.n_layers + 1
    gen = batches_of(batch)
    fit = _fit_logged(torch, pm, session, gen, INTERNVL2_STEPS, log)
    launches, losses = fit["launches"], fit["losses"]
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    free_gib = (total - torch.cuda.max_memory_reserved()) / 2**30
    print(f"[{tag}] {cfg.n_layers} layers, full width, f32, offchip_bpd, cuda backend, batch "
          f"{batch} x ({cfg.vision.n_patches} + {LM_SEQ}): {INTERNVL2_STEPS} fit steps in "
          f"{fit['wall']:.2f}s; loss per step {', '.join(f'{x:.4f}' for x in losses)}; "
          f"photonic_matmul launches {launches} = {launches / INTERNVL2_STEPS:g} per step; peak "
          f"device memory {peak_gib:.2f} GiB above the {base / 2**30:.2f} GiB resident, "
          f"{free_gib:.2f} GiB of the card never reserved")
    _check_fit(fit, INTERNVL2_STEPS, per_step)
    check(free_gib >= FREE_GIB, f"the run left {free_gib:.2f} GiB free, under {FREE_GIB} GiB")

    calls, errs, step, out = _step_projections(torch, pm, session, fit["state"], gen, seed,
                                               per_step, rows, tag)
    (a, b), kw, _ = calls[0]
    operands = {"blocks": (a, b, kw["noise"])}
    del calls, out, a, b, kw
    ideal = _ideal_cuda_vs_ref(torch, session, fit["state"], step, tag,
                               watch=("blocks.0.attn.q.weight", "embed.tok.table"))
    del step
    gc.collect()
    torch.cuda.empty_cache()
    # one timed step: the fit's steps, the projections' and the ideal
    # gradients' have run the same shapes before it
    batches = [to_device_batch(gen.batch(INTERNVL2_STEPS))]
    prof = _step_timing(torch, session, fit, batches, 0, 1, tag, card)
    prof.update(batch=batch, peak_gib=peak_gib, free_gib=free_gib, losses=losses,
                act_gib=act_row * rows / 2**30, reserve_gib=reserve / 2**30)
    del batches, fit, session, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "per_step": per_step, "max_abs_err": max(errs.values()),
            "ideal_max_rel": ideal[0], "profile": prof, "operands": operands,
            "n_params": n_params}


def phase_internvl2(torch, np, api, pm, em, seed, card, draws):
    """internvl2-2b at full width, random weights from ``seed`` (24
    layers, d 2048, 16 / 8 heads, d_ff 8192, vocab 92553, a 256-patch
    vision prefix; 1.891 B parameters): served text-only in bf16 through
    the bank kernel (169 launches a forward, the kernel against its plain
    version at every shape, the odd 92553-row head among them) with a
    profiled prefill tick and two decode ticks; f32 ideal cuda-vs-ref
    parity; f32 dfa training at full depth with the patch prefix at the
    largest batch the card holds, ideal cuda = ref gradients; the bank
    kernel timed at every decode shape and the training shape."""
    del em, draws
    kind, peaks = card_peaks(card)
    t0 = time.perf_counter()
    print(f"[internvl2] seed {seed}; {INTERNVL2}: {INTERNVL2_FULL[0]} layers, d "
          f"{INTERNVL2_FULL[1]}, {INTERNVL2_FULL[2]} / {INTERNVL2_FULL[3]} heads, d_ff "
          f"{INTERNVL2_FULL[4]}, vocab {INTERNVL2_FULL[5]}, {INTERNVL2_FULL[6]} patches x "
          f"{INTERNVL2_FULL[7]}; {INTERNVL2_FORWARD} bank products a token; training "
          f"{INTERNVL2_STEPS} steps")
    gc.collect()
    torch.cuda.empty_cache()
    out = {"serve": _internvl2_serve(torch, np, api, pm, seed)}
    out["parity"] = phase_parity(torch, np, api, seed, arch=INTERNVL2, tag="internvl2_parity")
    out["train"] = _internvl2_train(torch, np, api, pm, seed, card)
    shapes = _dense_decode_shapes(_meta_model(torch, INTERNVL2))
    gen = torch.Generator(device=DEVICE).manual_seed(23)
    print(f"[internvl2_timing] {kind} peaks; card: {card}")
    rows, forward = _decode_rows(torch, pm, dict(sorted(shapes.items())), peaks, gen,
                                 "internvl2_timing", "internvl2 decode shapes ",
                                 reps={"ms": 10, "plain_ms": 10, "library_ms": 10})
    check(forward["launches"] == INTERNVL2_FORWARD, f"{forward['launches']} launches timed")
    out["decode"] = {"shapes": rows, "forward": forward}
    train = out["train"]
    out["train_shapes"] = _timing_rows(torch, pm, train.pop("operands"), peaks,
                                       "internvl2_timing", "internvl2",
                                       {"blocks": train["per_step"]},
                                       train["profile"]["step_ms"])
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"[internvl2] done in {out['seconds']:.1f}s")
    return out


def internvl2_summary(res):
    """internvl2's numbers for its own output line."""
    serve, tick = res["serve"], res["serve"]["profile"]
    prof = res["train"]["profile"]
    return {"arch": INTERNVL2, "tok_s": serve["tok_s"], "ttft_p50_ms": serve["ttft_ms"],
            "decode_tick_wall_ms": tick["decode_tick"]["wall_ms"],
            "decode_tick_busy_ms": tick["decode_tick"].get("busy_ms"),
            "decode_tick_idle_share": tick["decode_tick"].get("idle_share"),
            "prefill_tick_wall_ms": tick["prefill_tick"]["wall_ms"],
            "prefill_tick_busy_ms": tick["prefill_tick"].get("busy_ms"),
            "serve_launches": serve["launches"], "parity_max_rel": res["parity"]["max_rel"],
            "train_batch": prof["batch"], "step_ms": prof["step_ms"],
            "tflop_s": prof["tflop_s"], "peak_gib": prof["peak_gib"],
            "idle_share": prof.get("idle_share"), "train_launches": res["train"]["launches"],
            "decode_forward_dev_ms": res["decode"]["forward"]["dev_ms"],
            "seconds": res["seconds"]}


# ---------------------------------------------------------------------------
# Sharded serving and the dry-run against the card
# ---------------------------------------------------------------------------

SS_WORLD = 2  # ranks on the one card, over gloo
SS_MESHES = {"data": (2, 1), "model": (1, 2)}  # (data, model)
SS_BATCH, SS_PROMPT, SS_STEPS = 4, 32, 8  # the prefill batch and the greedy decode steps
SS_MAX_LEN = 64  # cache slots of the qwen1.5 runs
SS_FORWARD = 169  # bank launches a qwen1.5 forward: 24 x 7 + the head
SS_TOL = 1e-4  # serving logits (ROADMAP)
SS_SPLIT_LAYERS = 4  # recurrentgemma-9b and minicpm3-4b for the head_dim and sequence rules
SS_SPLIT_SLOTS = {RG: 64, MINICPM3: 1024}  # cache slots: minicpm3's latent caches split at 1024
SS_TIMEOUT_S = 600.0
SS_EXPERTS = 60  # qwen2-moe's routed experts: 30 a rank on a model axis of 2
SS_EXPERT_T = (1, 5)  # its decode and prefill-chunk expert buffers' rows
DRYRUN_CELLS = {"train": (256, 8), "decode": (1024, 8)}  # (seq_len, global_batch), full width
DRYRUN_PEAK_TOL = 0.10


def _spawned(work, rank, world, port, args, queue):
    """One rank of a spawned run: ``work(rank, world, *args)`` in a gloo group
    on localhost; its result, or its traceback, goes to ``queue`` (and a
    failure re-raises, so the rank exits nonzero)."""
    import traceback

    try:
        sys.path.insert(0, str(ROOT / "src"))
        import torch
        import torch.distributed as dist

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if world:
            dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                    world_size=world)
        try:
            queue.put((rank, work(rank, world, *args), None))
        finally:
            if world:
                dist.destroy_process_group()
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


def _spawn(torch, work, world, timeout, *args) -> list:
    """``work`` on ``world`` spawned ranks over gloo (0: one spawned process
    without a group) -> their results by rank; any failure fails the phase."""
    import multiprocessing as mp
    import queue as queue_lib
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    gc.collect()
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    n = max(world, 1)
    procs = [ctx.Process(target=_spawned, args=(work, r, world, port, args, queue))
             for r in range(n)]
    t0 = time.perf_counter()
    results = {}
    try:
        for p in procs:
            p.start()
        while len(results) < n:
            if time.perf_counter() - t0 > timeout:
                raise PhaseError(f"{work.__name__} passed {timeout} s")
            try:
                rank, res, err = queue.get(timeout=5.0)
            except queue_lib.Empty:
                dead = [i for i, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead:
                    raise PhaseError(f"{work.__name__}: rank {dead[0]} exited with "
                                     f"{procs[dead[0]].exitcode}")
                continue
            if err is not None:
                raise PhaseError(f"{work.__name__}: rank {rank} failed:\n{err}")
            results[rank] = res
        for p in procs:
            p.join(timeout=60)
        codes = [p.exitcode for p in procs]
        check(codes == [0] * n, f"{work.__name__}: exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [results[r] for r in range(n)]


def _ss_whole(x):
    from repro_torch.dist import sharding

    return sharding.full_tensor(x) if sharding.is_dtensor(x) else x


def _ss_placed(torch, mesh, name, x):
    """``x`` (numpy) on the card, placed by ``make_batch_shardings`` on
    ``mesh`` (as it is where ``mesh`` is None)."""
    from repro_torch.dist import sharding

    x = torch.as_tensor(x).to(DEVICE)
    if mesh is None:
        return x
    return sharding.place_leaf(x, sharding.make_batch_shardings(mesh, {name: x})[name])


@contextlib.contextmanager
def _ss_launch_log(torch, log):
    """Each bank launch in the block logged in ``log``: its (T, K, M) and
    its weight operand's bytes appended to ``log["shapes"]``, and, where
    ``log["first"]`` is a dict, the operands and output of the first
    launch of each (T, K, M) kept there (comparison launches are made
    after the block)."""
    from repro_torch.kernels import ops

    launch = ops.photonic_matmul_cuda

    def logged(a, b, **kw):
        out = launch(a, b, **kw)
        shape = (a.shape[-2], a.shape[-1], b.shape[-2])
        log["shapes"].append((*shape, b.numel() * b.element_size()))
        first = log.get("first")
        if first is not None and shape not in first:
            first[shape] = (a.clone(), b.clone(), {k: v.clone() if torch.is_tensor(v) else v
                                                   for k, v in kw.items()}, out.clone())
        return out

    ops.photonic_matmul_cuda = logged
    try:
        yield log
    finally:
        ops.photonic_matmul_cuda = launch


def _ss_qwen_run(torch, pm, model, prefill, params, mesh, tokens, n_valid, seed, first=None):
    """qwen1.5-0.5b served through the params-taking steps on ``params``
    (placed on ``mesh``, or plain for one process), offchip_bpd through the
    bank kernel, keys folded from ``seed``: build_prefill's forward of the
    (B, C) prompts, a parallel prefill_step of them into caches placed by
    ``cache_shardings``, then SS_STEPS greedy decode steps; the bank
    launches of each forward counted, their (T, K, M, weight bytes) logged
    (``out["launches"]``, a list a forward) and, into ``first`` where
    given, the first launch of each shape kept.  -> numpy outputs and the
    counts."""
    import numpy as np

    from repro_torch.core import photonics as ph
    from repro_torch.dist import sharding
    from repro_torch.serve import decode as sd
    from repro_torch.utils import prng

    cfg = ph.preset("offchip_bpd")
    log = {"shapes": [], "first": first}
    forwards = []

    @contextlib.contextmanager
    def fwd(i):
        log["shapes"] = []
        with ph.forward_execution(cfg, "cuda", key=prng.fold(seed, "serve", i)):
            yield
        forwards.append(log["shapes"])

    caches = {k: torch.zeros(v.shape, dtype=v.dtype, device=DEVICE)
              for k, v in model.init_caches(SS_BATCH, SS_MAX_LEN).items()}
    if mesh is not None:
        caches = sharding.place(caches, sd.cache_shardings(mesh, caches))
    counts, out = [], {"launches": forwards}
    with torch.no_grad(), _ss_launch_log(torch, log):
        pm.launches = 0
        with fwd(0):
            logits = prefill(params, {"tokens": _ss_placed(torch, mesh, "tokens", tokens)})
        counts.append(pm.launches)
        out["prefill_logits"] = _ss_whole(logits).float().cpu().numpy()
        step = sd.make_prefill_step(model, with_params=True)
        clen = _ss_placed(torch, mesh, "len", np.zeros(SS_BATCH, np.int64))
        pm.launches = 0
        with fwd(1):
            last, caches, clen = step(params, _ss_placed(torch, mesh, "tokens", tokens),
                                      _ss_placed(torch, mesh, "n", n_valid), caches, clen)
        counts.append(pm.launches)
        last = _ss_whole(last)
        out["last"] = last.float().cpu().numpy()
        tok = _ss_placed(torch, mesh, "tok", last.argmax(-1)[:, None].cpu().numpy())
        serve = sd.make_serve_step(model, with_params=True)
        logs, toks = [], []
        for i in range(SS_STEPS):
            pm.launches = 0
            with fwd(2 + i):
                tok, lg, caches = serve(params, tok, caches, clen)
            counts.append(pm.launches)
            clen = clen + 1
            logs.append(lg.float().cpu().numpy())
            toks.append(_ss_whole(tok).cpu().numpy())
        out["decode"], out["tokens"] = np.stack(logs), np.stack(toks)
        out["caches"] = {k: _ss_whole(v).float().cpu().numpy() for k, v in caches.items()}
        out["split"] = {k: sharding.model_dim(v) for k, v in caches.items()}
    sync(torch)
    return out, counts


def _ss_inputs(torch, seed):
    """qwen1.5's (B, C) prompts from ``seed`` and their valid lengths."""
    import numpy as np

    vocab = _meta_model(torch, ARCH).cfg.vocab_size
    rng = np.random.default_rng(seed + 29)
    tokens = rng.integers(0, vocab, size=(SS_BATCH, SS_PROMPT)).astype(np.int64)
    return tokens, np.array([SS_PROMPT, SS_PROMPT - 3, SS_PROMPT, SS_PROMPT - 10], np.int64)


def _ss_one_process(torch, pm, seed):
    """qwen1.5-0.5b's one-process run (``_ss_qwen_run`` on its own
    parameters, full width and depth, f32) -> (outputs, launches)."""
    from repro_torch import api
    from repro_torch.serve import decode as sd

    model = api.build_model(ARCH, dtype=torch.float32, device=DEVICE, seed=seed)
    plain = {k: v.detach() for k, v in model.named_parameters()}
    out = _ss_qwen_run(torch, pm, model, sd.make_prefill(model), plain, None,
                       *_ss_inputs(torch, seed), seed)
    del model, plain
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ss_qwen(torch, pm, mesh, seed, one):
    """One mesh's sharded run of qwen1.5-0.5b (full width and depth, f32)
    and, where ``one`` (rank 0: the one process's outputs and launches) is
    given, its distances from the one process."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch import dryrun

    tokens, n_valid = _ss_inputs(torch, seed)
    case = configs.ShapeCase("prefill_32k", "prefill", SS_PROMPT, SS_BATCH)
    t0 = time.perf_counter()
    prefill, (params, _), extra = dryrun.build_prefill(
        ARCH, mesh, shape=case, dtype=torch.float32, device=DEVICE, seed=seed,
        batch={"tokens": torch.as_tensor(tokens)})
    first = {}
    got, counts = _ss_qwen_run(torch, pm, extra["model"], prefill, params, mesh, tokens,
                               n_valid, seed, first)
    res = {"counts": counts, "split": got["split"], "launches": got["launches"],
           "seconds": time.perf_counter() - t0}
    del params, prefill, extra
    if one is not None:
        one, res["one_counts"] = one
        res["dist"] = {k: _max_rel(torch.as_tensor(got[k]), torch.as_tensor(one[k]))
                       for k in ("prefill_logits", "last", "decode")}
        res["dist"]["caches"] = max(float(np.abs(got["caches"][k] - one["caches"][k]).max())
                                    for k in one["caches"])
        res["tokens_equal"] = bool(np.array_equal(got["tokens"], one["tokens"]))
        res["one_launches"] = one["launches"]
    # the first launch of each shape the one process does not launch
    # against the kernel's plain version on its operands
    seen = {tuple(x[:3]) for f in (one["launches"] if one is not None else []) for x in f}
    res["new_shapes"] = []
    for shape, (a, b, kw, out) in first.items():
        if shape not in seen:
            plain = pm.photonic_matmul_plain(a, b, **kw)
            res["new_shapes"].append(
                [*shape, ((out - plain).abs().max() / plain.abs().max()).item()])
    del first
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _ss_split(torch, pm, mesh, arch, seed, rank):
    """``arch`` at full width, SS_SPLIT_LAYERS layers, f32, one decode step
    (offchip_bpd, bank kernel) from random caches of SS_SPLIT_SLOTS[arch]
    slots placed by ``cache_shardings`` on the (1, 2) mesh, against the one
    process on rank 0: the logits' and the caches' distances and the rule
    each cache leaf took."""
    import numpy as np

    import dataclasses

    from repro_torch.core import photonics as ph
    from repro_torch.dist import sharding
    from repro_torch.serve import decode as sd
    from repro_torch.utils import prng

    meta = _meta_model(torch, arch, torch.float32)
    cfg = dataclasses.replace(meta.cfg, n_layers=SS_SPLIT_LAYERS)
    model = type(meta)(cfg, device=DEVICE)
    model.init(seed)
    slots = SS_SPLIT_SLOTS[arch]
    rng = np.random.default_rng(seed + 31)
    whole = {k: (rng.normal(size=tuple(v.shape)) * 0.5).astype(np.float32)
             for k, v in model.init_caches(SS_BATCH, slots).items()}
    clen = np.array([3, slots * 3 // 4, slots - 1, slots // 3], np.int64)
    tok = rng.integers(0, cfg.vocab_size, size=(SS_BATCH, 1)).astype(np.int64)
    hw = ph.preset("offchip_bpd")
    key = prng.fold(seed, "split", arch)
    serve = sd.make_serve_step(model, with_params=True)

    def run(params, m, first=None):
        caches = {k: torch.as_tensor(v).to(DEVICE) for k, v in whole.items()}
        if m is not None:
            caches = sharding.place(caches, sd.cache_shardings(m, caches))
        pm.launches = 0
        log = {"shapes": [], "first": first}
        with torch.no_grad(), ph.forward_execution(hw, "cuda", key=key), \
                _ss_launch_log(torch, log):
            nxt, logits, new = serve(params, _ss_placed(torch, m, "tok", tok), caches,
                                     _ss_placed(torch, m, "len", clen))
        sync(torch)
        return (logits.float().cpu(), {k: _ss_whole(v).float().cpu() for k, v in new.items()},
                {k: sharding.model_dim(v) for k, v in caches.items()}, pm.launches,
                log["shapes"])

    plain = {k: v.detach() for k, v in model.named_parameters()}
    placed = sharding.place(plain, sharding.make_param_shardings(mesh, plain))
    first = {}
    logits, caches, split, launches, shapes = run(placed, mesh, first)
    res = {"split": split, "launches": launches, "shapes": shapes}
    if arch == MINICPM3:
        with sharding.use_mesh(mesh), sharding.serving_call():
            res["kept"] = model.column_fallbacks(placed)
    del placed
    seen = set()
    if rank == 0:
        one_logits, one_caches, _, one_launches, one_shapes = run(plain, None)
        res.update(logits=_max_rel(logits, one_logits), one_launches=one_launches,
                   caches=max(float((caches[k] - one_caches[k]).abs().max()) for k in caches),
                   one_shapes=one_shapes)
        seen = {tuple(x[:3]) for x in one_shapes}
    # the first launch of each shape the one process does not launch
    # against the kernel's plain version on its operands
    res["new_shapes"] = []
    for shape, (a, b, kw, out) in first.items():
        if shape not in seen:
            plain_out = pm.photonic_matmul_plain(a, b, **kw)
            res["new_shapes"].append(
                [*shape, ((out - plain_out).abs().max() / plain_out.abs().max()).item()])
    del model, plain, first
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _ss_rank(rank, world, seed):
    """A rank of the sharded-serving run: qwen1.5-0.5b on each of SS_MESHES,
    then recurrentgemma-9b and minicpm3-4b on (1, 2)."""
    import torch

    from repro_torch.kernels import photonic_matmul as pm
    from repro_torch.launch import mesh as mesh_lib

    out = {"qwen": {}, "split": {}}
    one = _ss_one_process(torch, pm, seed) if rank == 0 else None
    for name, (_, m) in SS_MESHES.items():
        mesh = mesh_lib.make_host_mesh(world, model_axis=m, device_type=DEVICE)
        out["qwen"][name] = _ss_qwen(torch, pm, mesh, seed, one)
    mesh = mesh_lib.make_host_mesh(world, model_axis=SS_WORLD, device_type=DEVICE)
    for arch in SS_SPLIT_SLOTS:
        out["split"][arch] = _ss_split(torch, pm, mesh, arch, seed, rank)
    return out


def _ss_experts(torch, pm, seed):
    """qwen2-moe's batched bank launch of a rank's E/2 = 30 experts against
    the 60-expert launch at its decode shapes (T = 1 and 5: the expert
    buffer's rows at 4 slots and at a 16-token prefill chunk), gate / up
    (2048 -> 1408) and down (1408 -> 2048), f32 and bf16, offchip_bpd: the
    largest distance of either half's outputs from the whole launch's rows
    and the variant the planner picks for each (comparison launches)."""
    from repro_torch.core import photonics as ph
    from repro_torch.kernels import ops as kops

    cfg = ph.preset("offchip_bpd")
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 37)
    half = SS_EXPERTS // 2
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for t in SS_EXPERT_T:
            for m, k in ((1408, 2048), (2048, 1408)):
                a = torch.randn(SS_EXPERTS, t, k, generator=gen, device=DEVICE).to(dtype)
                b = (torch.randn(SS_EXPERTS, m, k, generator=gen, device=DEVICE) * 0.02).to(dtype)
                whole = kops.photonic_matmul(a, b, cfg, key=seed + t)
                worst = 0.0
                for i in (0, 1):
                    part = slice(i * half, (i + 1) * half)
                    got = kops.photonic_matmul(a[part].contiguous(), b[part].contiguous(), cfg,
                                               key=seed + t)
                    worst = max(worst, float((got.float() - whole[part].float()).abs().max()
                                             / whole[part].float().abs().max()))
                ptrs = (a.data_ptr(), b.data_ptr())
                rows.append({"dtype": str(dtype).split(".")[-1], "t": t, "m": m, "k": k,
                             "max_rel": worst,
                             "plan_60": pm._plan(t, m, k, dtype, ptrs, e=SS_EXPERTS).name,
                             "plan_30": pm._plan(t, m, k, dtype, ptrs, e=half).name})
    sync(torch)
    return rows


# the share of one process's bank weight bytes a rank's launches read in
# minicpm3-4b's split decode step at SS_SPLIT_LAYERS layers on (1, 2): half of
# every weight but q_up's, which serving keeps whole (4 x 61,358,080 bank
# weights a layer, 2,949,120 of them q_up's, and the 73448 x 2560 head)
SS_MLA_SHARE = 0.5136
SS_MLA_WHOLE = (768, 3840)  # (K, M) of q_up, served whole


def _ss_mla_rows(r0, r1) -> dict:
    """Print and check minicpm3's split decode launches on (1, 2): each on
    the rank's M/2 rows of the one process's launch (q_up whole), the
    weight bytes a rank reads against one process's, each new launch shape
    against the kernel's plain version, and the parts the model reports
    whole in a serving call."""
    mine, one = r0["shapes"], r0["one_shapes"]
    rows = [(t, k, m, x[2]) for (t, k, m, _), x in zip(mine, one)]
    halves = len(mine) == len(one) and all(
        (t, k) == tuple(x[:2]) and (m == x[2] if (k, x[2]) == SS_MLA_WHOLE else 2 * m == x[2])
        for (t, k, m, _), x in zip(mine, one))
    share = sum(x[3] for x in mine) / sum(x[3] for x in one)
    new = r0["new_shapes"] + r1["new_shapes"]
    worst_new = max((x[3] for x in new), default=0.0)
    print(f"[shard_serve] {MINICPM3} on (1, 2): every launch (T, K, M rank / one process): "
          + ", ".join(f"({t}, {k}, {m} / {w})" for t, k, m, w in rows[:8])
          + f", ... ({len(rows)} launches); each on the rank's M/2 rows, q_up "
          f"{SS_MLA_WHOLE} whole: {halves} (rank 1's the same: "
          f"{[x[:3] for x in r1['shapes']] == [x[:3] for x in mine]}); the weight bytes a "
          f"rank's launches read {share:.4f} of one process's (expected {SS_MLA_SHARE}); "
          f"kept whole in a serving call: {r0['kept']}; the new shapes vs the kernel's plain "
          f"version, (T, K, M) max rel: "
          + ", ".join(f"({t}, {k}, {m}) {e:.3e}" for t, k, m, e in r0["new_shapes"])
          + f" (rank 1's worst {max((x[3] for x in r1['new_shapes']), default=0.0):.3e})")
    check(halves and [x[:3] for x in r1["shapes"]] == [x[:3] for x in mine]
          and abs(share - SS_MLA_SHARE) <= 1e-3,
          f"{MINICPM3}'s split launches: halves {halves}, weight bytes {share}")
    check(set(r0["kept"]) == {"heads"}, f"{MINICPM3}'s serving parts kept whole {r0['kept']}")
    check(r0["new_shapes"] and worst_new <= TOL["float32"],
          f"a new {MINICPM3} launch shape differs from its plain version: {new}")
    return {"rows": rows, "weight_bytes_share": share, "new_shapes": r0["new_shapes"],
            "kept": r0["kept"]}


def phase_shard_serve(torch, np_, api, pm, seed, card):
    """qwen1.5-0.5b served sharded at full width and depth, f32, offchip_bpd
    through the bank kernel, on two ranks over gloo, on (2, 1) and (1, 2):
    build_prefill's logits of a (4, 32) batch, a parallel prefill_step into
    caches placed by ``cache_shardings`` (the kv heads split on (1, 2)) and
    8 greedy decode steps, each against one process (the distances
    printed), 169 bank launches a rank a forward; on (1, 2) the blocks' and
    the head's products column-parallel: every launch on the rank's M/2 rows
    of the one process's, the weight bytes a rank reads 0.50 of its, and the
    first launch of each new shape against the kernel's plain version; on
    (1, 2) recurrentgemma-9b (kv 1: the head_dim rule) and minicpm3-4b (its
    latent caches at 1024 slots: the sequence rule) at 4 layers, one decode
    step each within 1e-4; qwen2-moe's 30-expert batched launch against its
    60-expert launch."""
    del np_, api
    t0 = time.perf_counter()
    print(f"[shard_serve] card: {card}")
    r0, r1 = _spawn(torch, _ss_rank, SS_WORLD, SS_TIMEOUT_S, seed)
    out = {"meshes": {}, "split": {}}
    launches = 0
    for name, shape in SS_MESHES.items():
        a, b = r0["qwen"][name], r1["qwen"][name]
        d = a["dist"]
        print(f"[shard_serve] qwen1.5-0.5b on {shape} (data, model), two ranks over gloo: "
              f"max |sharded - one process| / max |one process|: build_prefill logits "
              f"{d['prefill_logits']:.3e}, prefill_step last logits {d['last']:.3e}, "
              f"{SS_STEPS} decode steps {d['decode']:.3e}; caches max abs {d['caches']:.3e}; "
              f"greedy tokens equal {a['tokens_equal']}; cache split dims {a['split']}; bank "
              f"launches a forward rank 0 {a['counts']}, rank 1 {b['counts']}, one process "
              f"{a['one_counts']}; {a['seconds']:.1f}s")
        expect = [SS_FORWARD] * (2 + SS_STEPS)
        check(a["counts"] == b["counts"] == a["one_counts"] == expect,
              f"bank launches a forward {a['counts']} / {b['counts']}, expected {SS_FORWARD}")
        check(max(d[k] for k in ("prefill_logits", "last", "decode")) <= SS_TOL
              and a["tokens_equal"], f"sharded serving on {shape} differs from one process: {d}")
        check(d["caches"] <= SS_TOL, f"caches on {shape}: {d['caches']}")
        # the kv heads on ``model``: split over 2 ranks on (1, 2), whole on
        # (2, 1)'s axis of 1, as the reference's spec places them
        check(a["split"] == {"k": 3, "v": 3}, f"cache split {a['split']} on {shape}")
        new = a["new_shapes"] + b["new_shapes"]
        worst_new = max((x[3] for x in new), default=0.0)
        print(f"[shard_serve] {shape}: the first launch of each shape one process does not "
              f"launch vs the kernel's plain version on its operands, (T, K, M) max rel: "
              + ", ".join(f"({t}, {k}, {m}) {e:.3e}" for t, k, m, e in a["new_shapes"])
              + f" (rank 1's worst {max((x[3] for x in b['new_shapes']), default=0.0):.3e})")
        check(worst_new <= TOL["float32"], f"a new launch shape differs from its plain "
                                           f"version: {new}")
        share = None
        if shape[1] > 1:  # the blocks' and the head's products split over ``model``
            mine, one_l = a["launches"], a["one_launches"]
            halves = all(len(f) == len(g) and all((t, k, 2 * m) == tuple(x[:3])
                                                  for (t, k, m, _), x in zip(f, g))
                         for f, g in zip(mine, one_l))
            share = (sum(x[3] for f in mine for x in f)
                     / sum(x[3] for f in one_l for x in f))
            print(f"[shard_serve] {shape}: every bank launch of every forward on the rank's "
                  f"M/2 rows of the one process's launch: {halves} (rank 1's launches the "
                  f"same: {a['launches'] == b['launches']}); the weight bytes a rank's launches "
                  f"read {share:.4f} of one process's")
            check(halves and a["launches"] == b["launches"] and share == 0.5,
                  f"the split launches on {shape}: halves {halves}, weight bytes {share}")
        out["meshes"][name] = {"dist": d, "tokens_equal": a["tokens_equal"],
                               "launches_a_forward": a["counts"][0], "split": a["split"],
                               "weight_bytes_share": share, "new_shapes": a["new_shapes"]}
        launches += sum(a["counts"])
    rules = {RG: {"grp_attn.k": 4, "grp_attn.v": 4}, MINICPM3: {"c_kv": 2, "k_rope": 2}}
    for arch, res in r0["split"].items():
        print(f"[shard_serve] {arch}, {SS_SPLIT_LAYERS} layers at full width, f32, on (1, 2): "
              f"one decode step from {SS_SPLIT_SLOTS[arch]}-slot caches, logits "
              f"{res['logits']:.3e} from one process, caches max abs {res['caches']:.3e}, "
              f"split {res['split']}, bank launches {res['launches']} (one process "
              f"{res['one_launches']})")
        check(res["logits"] <= SS_TOL and res["caches"] <= SS_TOL,
              f"{arch}'s split cache misses one process: {res}")
        check(all(res["split"].get(k) == d for k, d in rules[arch].items()),
              f"{arch}'s cache split {res['split']}")
        check(res["launches"] == res["one_launches"] > 0, f"{arch}'s launches {res}")
        out["split"][arch] = {k: res[k] for k in ("logits", "caches", "split", "launches")}
        launches += res["launches"]
        if arch == MINICPM3:
            out["split"][arch].update(_ss_mla_rows(res, r1["split"][arch]))
    rows = _ss_experts(torch, pm, seed)
    for row in rows:
        print(f"[shard_serve] qwen2-moe experts {row['dtype']} T={row['t']} ({row['k']} -> "
              f"{row['m']}): 30-expert launch vs the 60-expert launch's rows max rel "
              f"{row['max_rel']:.3e}; plan at 60 {row['plan_60']}, at 30 {row['plan_30']}")
    out["experts"] = rows
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    print(f"[shard_serve] done in {out['seconds']:.1f}s")
    return out


def _dryrun_cells(rank, world, seed):
    """qwen1.5-0.5b at full width, bf16, on reduced shapes: each of
    DRYRUN_CELLS on a fake world of one, then on a real NCCL world of one
    (this process's card) -> the records."""
    del rank, world, seed
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib

    cases = {kind: configs.ShapeCase(f"{kind}_reduced", kind, s, b)
             for kind, (s, b) in DRYRUN_CELLS.items()}
    out = {kind: {"fake": dryrun.run_cell(ARCH, c.name, "1x1", shape=c)}
           for kind, c in cases.items()}
    mesh_lib.init_process_group("cuda")
    try:
        mesh = mesh_lib.make_host_mesh(1, device_type="cuda")
        for kind, c in cases.items():
            gc.collect()
            out[kind]["real"] = dryrun.run_cell(ARCH, c.name, "1x1", mesh=mesh, shape=c)
    finally:
        dist.destroy_process_group()
    return out


def phase_dryrun(torch, seed):
    """The dry-run's fake world against the card: ``run_cell`` for
    qwen1.5-0.5b at full width in bf16 on a train and a decode cell at
    reduced shapes (DRYRUN_CELLS), on a fake world of one and on a real NCCL
    world of one, in a fresh process: FLOPs, bytes and collective bytes
    equal, the fake world's peak (``MemTracker``) within 10% of
    ``torch.cuda.max_memory_allocated``."""
    t0 = time.perf_counter()
    (cells,) = _spawn(torch, _dryrun_cells, 0, SS_TIMEOUT_S, seed)
    out = {}
    for kind, pair in cells.items():
        fake, real = pair["fake"], pair["real"]
        for what, rec in pair.items():
            check(rec["status"] == "ok", f"{kind} on the {what} world: {rec.get('traceback')}")
        ratio = fake["memory"]["total_hbm_bytes"] / real["memory"]["total_hbm_bytes"]
        seq, batch = DRYRUN_CELLS[kind]
        print(f"[dryrun] {ARCH} {kind} at batch {batch} x seq {seq}, full width, bf16, world of "
              f"one: FLOPs fake {fake['cost']['flops']:.6g} real {real['cost']['flops']:.6g}; "
              f"bytes fake {fake['cost']['bytes accessed']:.6g} real "
              f"{real['cost']['bytes accessed']:.6g}; collectives fake "
              f"{fake['collectives']['bytes_by_kind']} real "
              f"{real['collectives']['bytes_by_kind']} (agree with step_cost: "
              f"{fake['collectives_agree']} / {real['collectives_agree']}); peak fake "
              f"{fake['memory']['total_hbm_bytes'] / 2**30:.4f} GiB (MemTracker) vs the "
              f"allocator's {real['memory']['total_hbm_bytes'] / 2**30:.4f} GiB: ratio "
              f"{ratio:.4f}; arguments {real['argument_bytes'] / 2**30:.4f} GiB; host seconds "
              f"fake {fake['seconds']} real {real['seconds']}")
        check(fake["cost"] == real["cost"], f"{kind}: FLOPs / bytes differ {fake['cost']} "
              f"{real['cost']}")
        check(fake["collectives"] == real["collectives"]
              and fake["hlo_cost"]["coll_bytes_by_kind"] == real["hlo_cost"]["coll_bytes_by_kind"]
              and fake["collectives_agree"] and real["collectives_agree"],
              f"{kind}: collectives differ")
        check(abs(ratio - 1.0) <= DRYRUN_PEAK_TOL, f"{kind}: peak ratio {ratio:.4f}")
        out[kind] = {"flops": real["cost"]["flops"], "bytes": real["cost"]["bytes accessed"],
                     "collectives": real["collectives"]["bytes_by_kind"],
                     "peak_fake": fake["memory"]["total_hbm_bytes"],
                     "peak_real": real["memory"]["total_hbm_bytes"], "peak_ratio": ratio}
    out["seconds"] = time.perf_counter() - t0
    print(f"[dryrun] done in {out['seconds']:.1f}s")
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
    def timed(phase, *args):
        """Run one phase and print its wall time (the script's limit is 1200 s)."""
        t0 = time.perf_counter()
        result = phase(*args)
        print(f"[phase] {phase.__name__} done in {time.perf_counter() - t0:.1f}s, "
              f"{time.perf_counter() - t_start:.1f}s in all")
        return result

    card, draws = timed(phase_build, torch, pm)
    timed(phase_lint, torch)
    max_err = timed(phase_kernel_vs_plain, torch, pm)
    max_err_b = timed(phase_dfa_kernel_vs_plain, torch, pm, dg)
    serve_launches = timed(phase_serve, torch, np, pm, api, args.seed)
    timed(phase_profile_ticks, torch, np, api, args.seed)
    timed(phase_parity, torch, np, api, args.seed)
    train_launches = timed(phase_train, torch, np, api, pm, dg, args.seed)
    masked_launches = timed(phase_masked_projection, torch, api, dg, args.seed)
    per_step, per_prefill = timed(phase_timing, torch, pm, card)
    timed(phase_seam, torch, pm, card)
    train_rows = timed(phase_timing_train, torch, pm, dg, card)
    max_err_c = timed(phase_emu_kernel_vs_plain, torch, em, ph, ch, mrr)
    emu_train_launches = timed(phase_emu_train, torch, np, api, em, args.seed)
    timed(phase_drift, torch, api, args.seed)
    emu_serve_launches, max_err_serve = timed(phase_emu_serve, torch, np, api, em, args.seed)
    emu_rows = timed(phase_emu_timing, torch, em, ph, ch, mrr, card, draws["emu"])
    lm = timed(phase_lm_train, torch, np, api, pm, em, args.seed, card, draws)
    observed = timed(phase_observe, torch, np, api, pm, em, args.seed, card)
    sched = timed(phase_schedule, torch, np, api, pm, em, args.seed, card, draws)
    dp = timed(phase_data_parallel, torch, np, api, pm, em, args.seed, card)
    ss = timed(phase_shard_serve, torch, np, api, pm, args.seed, card)
    dry = timed(phase_dryrun, torch, args.seed)
    mamba = timed(phase_mamba, torch, np, api, pm, em, args.seed, card, draws)
    dense = timed(phase_dense, torch, np, api, pm, em, args.seed, card, draws)
    moe = timed(phase_moe, torch, np, api, pm, em, args.seed, card, draws)
    rg = timed(phase_recurrentgemma, torch, np, api, pm, em, args.seed, card, draws)
    whisper = timed(phase_whisper, torch, np, api, pm, em, args.seed, card, draws)
    internvl2 = timed(phase_internvl2, torch, np, api, pm, em, args.seed, card, draws)
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    for arch, res in dense.items():
        print(json.dumps({"dense_model": dense_summary(arch, res)}))
    print(json.dumps({"moe_model": moe_summary(moe)}))
    print(json.dumps({"rg_model": rg_summary(rg)}))
    print(json.dumps({"whisper_model": whisper_summary(whisper)}))
    print(json.dumps({"internvl2_model": internvl2_summary(internvl2)}))
    print(json.dumps({"schedule": {k: sched[k] for k in ("energy", "tuned", "overlap",
                                                         "serving", "step_ms", "losses")}}))
    print(json.dumps({"data_parallel": {k: dp[k] for k in ("world1", "two_ranks", "fsdp",
                                                            "tp", "seconds")}}))
    print(json.dumps({"shard_serve": ss}))
    print(json.dumps({"dryrun": dry}))
    dense_bank = {f"{arch.split('-')[0]}_{path}": res[path]["launches"]
                  for arch, res in dense.items() for path in ("serve", "train") if path in res}
    dense_bank["qwen3_seq4096"] = dense[QWEN3]["train"]["long"]["launches"]
    dense_emu = {"qwen3_train": dense[QWEN3]["emu"]["launches"]}
    moe_bank = {"moe_serve": moe["serve"]["launches"], "moe_train": moe["train"]["launches"]}
    rg_bank = {"rg_serve": rg["serve"]["launches"], "rg_train": rg["train"]["launches"]}
    slice12_bank = {"whisper_serve": whisper["serve"]["launches"],
                    "whisper_train": whisper["train"]["launches"],
                    "internvl2_serve": internvl2["serve"]["launches"],
                    "internvl2_train": internvl2["train"]["launches"]}
    whisper_emu = whisper["train"]["emu"]
    row_b = train_rows["dfa_gradient"]
    records = [
        {"name": "photonic_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/photonic_matmul.cu",
         "replaces": "src/repro/kernels/photonic_matmul.py:95",
         "launches": (serve_launches + train_launches + lm["launches"]
                      + observed["probe_launches"]["photonic_matmul"]
                      + mamba["serve_launches"] + mamba["train_launches"]
                      + sum(dense_bank.values()) + sum(moe_bank.values())
                      + sum(rg_bank.values()) + sum(slice12_bank.values())
                      + dp["world1"]["launches"] + dp["two_ranks"]["bank_launches"]
                      + dp["world1"]["fsdp_launches"] + dp["fsdp"]["bank_launches"]
                      + dp["tp"]["bank_launches"] + dp["tp"]["moe"]["bank_launches"]
                      + ss["launches"]),
         "launches_by_path": {"serve": serve_launches, "train": train_launches,
                              "lm_train": lm["launches"],
                              "probe": observed["probe_launches"]["photonic_matmul"],
                              "mamba_serve": mamba["serve_launches"],
                              "mamba_train": mamba["train_launches"], **dense_bank,
                              **moe_bank, **rg_bank, **slice12_bank,
                              "dp_world1": dp["world1"]["launches"],
                              "dp_rank0": dp["two_ranks"]["bank_launches"],
                              "fsdp_world1": dp["world1"]["fsdp_launches"],
                              "fsdp_rank0": dp["fsdp"]["bank_launches"],
                              "tp_rank0": dp["tp"]["bank_launches"],
                              "tp_moe_rank0": dp["tp"]["moe"]["bank_launches"],
                              "shard_serve_rank0": ss["launches"]},
         "max_abs_err": max(max_err, lm["max_abs_err"], mamba["max_abs_err"],
                            dp["tp"]["kernel_err"],
                            *(res["train"]["max_abs_err"] for res in dense.values()
                              if "train" in res), moe["train"]["max_abs_err"],
                            rg["train"]["max_abs_err"], whisper["train"]["max_abs_err"],
                            internvl2["train"]["max_abs_err"]),
         "ms": per_step["ms"], "plain_ms": per_step["plain_ms"],
         "bound_ms": per_step["bound_ms"], "bound_by": per_step["bound_by"],
         "library_ms": per_step["library_ms"],
         "decode_step": per_step, "prefill_forward": per_prefill,
         "lm_train_shape": lm["bank"], "lm_step": lm["profile"], "draw_sass": draws["bank"],
         "tp_rank_shape": dp["tp"]["timing"],
         "shard_serve": {"meshes": ss["meshes"], "split": ss["split"],
                         "experts_30_vs_60": ss["experts"]},
         "observe": {k: observed[k] for k in ("lm", "mlp", "step_cost")},
         "mamba": {k: mamba[k] for k in ("serve", "profile", "parity", "decode_forward",
                                         "decode_shapes", "train_shape", "train")},
         "dense": {arch: {"decode_forward": res["decode"]["forward"],
                          "decode_shapes": res["decode"]["shapes"],
                          "serve_max_rel_err": res["serve"]["max_rel_err"],
                          "skinny_k14336": res["serve"]["skinny_k14336"],
                          **({"train_shape": res["train"]["train_shape"]}
                             if "train" in res else {})}
                   for arch, res in dense.items()},
         "moe": {"decode_forward": moe["decode"]["forward"],
                 "decode_shapes": moe["decode"]["shapes"],
                 "prefill_experts": moe["decode"]["prefill_experts"],
                 "kimi_experts": moe["kimi"]["rows"],
                 "serve_max_rel_err": moe["serve"]["max_rel_err"],
                 "kimi_max_rel_err": moe["kimi"]["max_rel_err"],
                 "batched_vs_single": moe["serve"]["batched_vs_single"],
                 "train": moe["train"]["profile"]},
         "recurrentgemma": {"decode_forward": rg["decode"]["forward"],
                            "decode_shapes": rg["decode"]["shapes"],
                            "serve_max_rel_err": rg["serve"]["max_rel_err"],
                            "skinny_k12288": rg["serve"]["skinny_k12288"],
                            "train_shape": rg["train"]["train_shape"],
                            "train": rg["train"]["profile"]},
         "whisper": {"encode_forward": whisper["timing"]["encode"]["forward"],
                     "encode_shapes": whisper["timing"]["encode"]["shapes"],
                     "decode_forward": whisper["timing"]["decode"]["forward"],
                     "decode_shapes": whisper["timing"]["decode"]["shapes"],
                     "serve_max_rel_err": whisper["serve"]["max_rel_err"],
                     "train_shapes": whisper["train_shapes"],
                     "train": whisper["train"]["profile"]},
         "internvl2": {"decode_forward": internvl2["decode"]["forward"],
                       "decode_shapes": internvl2["decode"]["shapes"],
                       "serve_max_rel_err": internvl2["serve"]["max_rel_err"],
                       "head_max_rel_err": internvl2["serve"]["head_max_rel_err"],
                       "train_shapes": internvl2["train_shapes"],
                       "train": internvl2["train"]["profile"]}},
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
                      + observed["probe_launches"]["emu_bank_product"]
                      + mamba["emu_serve_launches"] + mamba["emu_train_launches"]
                      + sum(dense_emu.values()) + moe["emu"]["launches"]
                      + rg["emu"]["launches"] + whisper_emu["launches"]
                      + sum(sched["launches"].values()) + dp["two_ranks"]["emu_launches"]
                      + dp["fsdp"]["emu_launches"] + dp["tp"]["emu_launches"]),
         "launches_by_path": {"train": emu_train_launches, "serve": emu_serve_launches,
                              "lm_train": lm["emu_launches"],
                              "probe": observed["probe_launches"]["emu_bank_product"],
                              "mamba_serve": mamba["emu_serve_launches"],
                              "mamba_train": mamba["emu_train_launches"], **dense_emu,
                              "moe_emu_serve": moe["emu"]["launches"],
                              "rg_emu_serve": rg["emu"]["launches"],
                              "whisper_emu_train": whisper_emu["launches"],
                              "schedule_train": sched["launches"]["q2"],
                              "schedule_q8": sched["launches"]["q8"],
                              "dp_rank0": dp["two_ranks"]["emu_launches"],
                              "fsdp_rank0": dp["fsdp"]["emu_launches"],
                              "tp_rank0": dp["tp"]["emu_launches"]},
         "row_base": {"check": "rows [r, T) launched with row_base = r = the plain version "
                               "and rows [r, T) of a row_base = 0 launch, bit for bit, under "
                               "every candidate plan", "shapes": dp["row_base"]},
         "col_base": {"check": "panels [p, nm) launched with col_base = p·rows (and rows [r, "
                               "T) with row_base = r) = the plain version and those columns "
                               "of a col_base = 0 launch, bit for bit, under every candidate "
                               "plan", "shapes": dp["col_base"]},
         "max_abs_err": max(max_err_c, max_err_serve, lm["emu_max_abs_err"],
                            mamba["emu_max_abs_err"], dense[QWEN3]["emu"]["max_abs_err"],
                            moe["emu"]["max_abs_err"], rg["emu"]["max_abs_err"],
                            whisper_emu["max_abs_err"], sched["max_abs_err"]),
         "ms": emu_rows["path_a"]["ms"], "plain_ms": emu_rows["path_a"]["plain_ms"],
         "bound_ms": emu_rows["path_a"]["bound_ms"], "bound_by": emu_rows["path_a"]["bound_by"],
         "library_ms": None, "library": "none: no single PyTorch call computes it",
         "draw_sass": draws["emu"], "timing": {**emu_rows, "lm_train_shape": lm["emu"],
                                               "mamba_train_shape": mamba["emu_train_shape"],
                                               "qwen3_train_shape": dense[QWEN3]["emu"]["row"],
                                               "whisper_train_shape": whisper_emu["row"],
                                               "schedule_q2": sched["rows"]["q2"],
                                               "schedule_q8": sched["rows"]["q8"],
                                               "moe_stacks": moe["emu"]["stack_rows"]}},
    ]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
