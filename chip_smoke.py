#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root of a checkout; it needs one CUDA card and
builds the port's CUDA kernel from the sources in the checkout.  Phases:

1. card and build: the card's name and power limit, the kernel's build time;
2. kernel vs plain version at every shape the serving path gives it
   (T = 4 and 64 rows) plus the ragged 200×300×257 and the paper's
   64×10×800, in f32 and bf16, noise modes none / input / prng;
3. full-width serve: qwen1.5-0.5b (24 layers, random weights from --seed)
   in bf16 on the ``cuda`` backend with the offchip_bpd preset, counting
   the kernel's launches; then two decode ticks under the profiler (wall,
   device busy time, idle share, the kernels that take the time);
4. full-width parity: the same model in f32 on the ideal preset, the
   ``cuda`` backend against the ``ref`` backend with teacher forcing;
5. timing: device time of the kernel, the plain version and
   ``torch.matmul`` (profiler, cold L2) and the card's bound at each path
   shape.

Every phase that fails raises and the script exits non-zero.  The line
before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import math
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


def bound_ms(t, m, k, dtype_name, peaks):
    """Least time for C = A·Bᵀ: each input read once, the f32 output
    written once, 2·T·M·K operations at the peak rate of the input type."""
    itemsize = 2 if dtype_name == "bfloat16" else 4
    nbytes = (t * k + m * k) * itemsize + t * m * 4
    ops = 2 * t * m * k
    by_bytes, by_ops = nbytes / peaks["bw"], ops / peaks[dtype_name]
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops else "operations")


def phase_build(torch, pm):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    lib = pm.build()
    pm._library()
    print(f"[build] {lib.name} ready in {time.perf_counter() - t0:.1f}s "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    return card


def _operands(torch, t, k, m, dtype, gen):
    # normalised operands, as the wrapper hands them to the kernel
    a = (torch.rand((t, k), generator=gen, device=DEVICE) * 2 - 1).to(dtype)
    b = (torch.rand((m, k), generator=gen, device=DEVICE) * 2 - 1).to(dtype)
    return a, b


def phase_kernel_vs_plain(torch, pm):
    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    cases = [(t, k, m) for (m, k) in PATH_SHAPES for t in (4, 64)] + EXTRA_SHAPES
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        tol = TOL[dname]
        pooled, pairs = [], []
        for t, k, m in cases:
            a, b = _operands(torch, t, k, m, dtype, gen)
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
        print(f"[kernel] {dname}: {len(cases)} shapes x none/input/prng agree with the plain "
              f"version (tol {tol})")
    print(f"[kernel] max |kernel - plain| over none/input: {max_err:.3e}")
    return max_err


def _prompts(rng, n, length, vocab):
    return [rng.integers(0, vocab, length).tolist() for _ in range(n)]


def phase_serve(torch, np, pm, api, seed):
    from repro_torch.serve import Request

    session = api.build_session(arch=ARCH, smoke=False, hardware="offchip_bpd",
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


def _device_ms(torch, fn, reps=25):
    """Device time of one call of ``fn``: the median over ``reps`` calls of
    the summed durations of the device kernels it ran, read from the
    profiler (CUPTI), so the host's launch overhead is not counted.  Before
    each call a 64 MiB bitwise_not evicts the operands from the 50 MB L2,
    as a decode step finds its weights, and marks where the call starts."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=DEVICE)
    for _ in range(3):
        fn()
    sync(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
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
    if not per_call:
        return None  # the profiler traced no device kernels: not measured
    check(len(per_call) == reps, f"profiler saw {len(per_call)} of {reps} calls")
    return statistics.median(per_call) / 1e3


def phase_profile_decode(torch, np, api, seed):
    """One steady decode tick (4 active slots) under the profiler: wall
    time, device busy time and idle share, and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import DECODE, Request

    session = api.build_session(arch=ARCH, smoke=False, hardware="offchip_bpd",
                                backend="cuda", dtype=torch.bfloat16, seed=seed,
                                device=DEVICE)
    eng = session.engine(batch_slots=4, max_len=128, prefill_chunk=16, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for p in _prompts(rng, 4, 32, session.model.cfg.vocab_size):
        eng.submit(Request(prompt=p, max_new=8))
    eng.tick()
    eng.tick()  # two prefill chunks: every slot now decodes
    eng.tick()  # one unprofiled decode tick
    check(all(r is not None and r.state == DECODE for r in eng._requests), "slots not decoding")
    sync(torch)
    ticks = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.tick()
        sync(torch)
        wall = (time.perf_counter() - t0) / ticks * 1e3
    by_name = {}
    for e in _device_kernels(torch, prof):
        name = "photonic_matmul (bank kernel)" if "photonic_matmul" in e.name else e.name[:70]
        by_name[name] = by_name.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    busy = sum(by_name.values()) / ticks
    if not by_name:
        print(f"[profile] decode tick wall {wall:.2f} ms; device time not measured "
              "(the profiler traced no device kernels)")
        return
    print(f"[profile] decode tick (4 slots, bf16, offchip_bpd): wall {wall:.2f} ms, device busy "
          f"{busy:.2f} ms, idle share {1 - busy / wall:.3f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[profile]   {ms / ticks:8.3f} ms/tick  {ms / ticks / wall:6.1%} of wall  {name}")
    del eng, session
    torch.cuda.empty_cache()


def _fmt(x):
    return f"{x:10.4f}" if x is not None else "       n/a"


def phase_timing(torch, pm, card):
    kind, peaks = card_peaks(card)
    gen = torch.Generator(device=DEVICE).manual_seed(99)
    rows = []
    print(f"[timing] bf16 operands, {kind} peaks: {peaks['bw'] / 1e12:.2f} TB/s, "
          f"{peaks['bfloat16'] / 1e12:.0f} TFLOP/s bf16; card: {card}")
    print("[timing] ms: CUDA events around one call (median of 25, cold L2); dev: the "
          "call's device kernels only (profiler, median of 25)")
    print("[timing]      T      M      K  count  kernel_ms kernel_dev   plain_ms  plain_dev  "
          "matmul_ms matmul_dev   bound_ms  bound_by")
    for t in (4, 64):
        for (m, k), count in PATH_SHAPES.items():
            a, b = _operands(torch, t, k, m, torch.bfloat16, gen)
            fns = {"ms": lambda: pm.photonic_matmul_cuda(a, b),
                   "plain_ms": lambda: pm.photonic_matmul_plain(a, b),
                   "library_ms": lambda: torch.matmul(a, b.T)}
            row = dict(t=t, m=m, k=k, count=count)
            for key, fn in fns.items():
                row[key] = _event_ms(torch, fn)
                row[key.replace("ms", "dev_ms")] = _device_ms(torch, fn)
            row["bound_ms"], row["bound_by"] = bound_ms(t, m, k, "bfloat16", peaks)
            rows.append(row)
            cells = " ".join(_fmt(row[key]) for key in (
                "ms", "dev_ms", "plain_ms", "plain_dev_ms", "library_ms", "library_dev_ms",
                "bound_ms"))
            print(f"[timing] {t:6d} {m:6d} {k:6d} {count:6d} {cells}  {row['bound_by']}")
    step = [r for r in rows if r["t"] == 4]
    keys = ("ms", "dev_ms", "plain_ms", "plain_dev_ms", "library_ms", "library_dev_ms",
            "bound_ms")
    per_step = {key: (None if any(r[key] is None for r in step)
                      else sum(r[key] * r["count"] for r in step)) for key in keys}
    print("[timing] one decode step at T=4 (169 launches), ms: "
          + ", ".join(f"{key} {_fmt(per_step[key]).strip()}" for key in keys))
    per_step["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in step)
                            else "operations")
    return per_step


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
    from repro_torch.kernels import photonic_matmul as pm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase_build(torch, pm)
    max_err = phase_kernel_vs_plain(torch, pm)
    launches = phase_serve(torch, np, pm, api, args.seed)
    phase_profile_decode(torch, np, api, args.seed)
    phase_parity(torch, np, api, args.seed)
    per_step = phase_timing(torch, pm, card)
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    record = {"name": "photonic_matmul", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/photonic_matmul.cu",
              "replaces": "src/repro/kernels/photonic_matmul.py:95",
              "launches": launches, "max_abs_err": max_err,
              "ms": per_step["ms"], "plain_ms": per_step["plain_ms"],
              "bound_ms": per_step["bound_ms"], "bound_by": per_step["bound_by"],
              "library_ms": per_step["library_ms"]}
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
