"""Serving launcher: continuous batching with prefill/decode split on the
digital or photonic forward.  Counterpart of ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --no-smoke --backend cuda --hardware offchip_bpd
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --no-smoke --backend emu --hardware emu_offchip

Runs on the card; ``--device cpu`` runs on the CPU (the ``cuda`` backend
then runs its kernel's plain version, the ``emu`` backend its unfused
chain).  ``--backend emu`` serves through the emulated MRR banks.
``--smoke`` (default on) builds the shrunk smoke config; ``--no-smoke``
serves the full-size model (in f32, the facade's default, as the reference
launcher does).  ``--bench-json DIR`` writes the measured latency
distribution as ``BENCH_serve_live.json``; ``--trace-out PATH`` a
Perfetto-loadable trace with one track per request and a span per tick;
``--metrics-out PATH`` a metrics JSONL.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import api, configs
from repro_torch.serve import Request


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ASSIGNED))
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True,
                    help="shrunk smoke config (default); --no-smoke for full size")
    ap.add_argument("--backend", default="auto", choices=["auto", "ref", "cuda", "emu"],
                    help="forward execution: auto = exact digital; ref / cuda run "
                         "projections through the photonic bank model, emu through "
                         "the MRR device emulation")
    ap.add_argument("--hardware", default=None,
                    help="photonics preset for a photonic backend "
                         "(default: digital for auto, emu_ideal otherwise)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="Poisson arrivals at this rate (req/s); default: "
                         "submit all requests up front")
    ap.add_argument("--bench-json", default=None, metavar="DIR",
                    help="write BENCH_serve_live.json with the measured latency "
                         "distribution to DIR")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto-loadable Chrome trace of the request "
                         "lifecycles and engine ticks to PATH")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="append obs metrics rows (JSONL) to PATH")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    args = ap.parse_args(argv)

    photonic = args.backend != "auto"
    hardware = args.hardware or ("emu_ideal" if photonic else "digital")
    session = api.build_session(arch=args.arch, smoke=args.smoke, algo="bp",
                                hardware=hardware, backend=args.backend,
                                seed=args.seed, device=args.device)
    observer = None
    if args.trace_out or args.metrics_out:
        observer = session.observe(metrics_path=args.metrics_out, trace_path=args.trace_out)
    vocab = session.model.cfg.vocab_size
    eng = session.engine(batch_slots=args.slots, max_len=args.max_len,
                         prefill_chunk=args.prefill_chunk, seed=args.seed)
    reqs = [Request(prompt=[(7 * i + 3 + 13 * j) % vocab
                            for j in range(max(1, args.prompt_len))],
                    max_new=args.max_new) for i in range(args.requests)]
    t0 = time.monotonic()
    if args.arrival_rate:
        rng = np.random.default_rng(args.seed)
        arrivals = np.cumsum(rng.exponential(1.0 / args.arrival_rate, size=len(reqs)))
        done, ticks = eng.run_arrivals(reqs, arrivals.tolist())
    else:
        done, ticks = eng.run(reqs)
    dt = time.monotonic() - t0

    total_tokens = sum(len(r.out) for r in done)
    ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
    lats = [r.latency_s for r in done if r.latency_s is not None]
    print(f"[serve] {len(done)} requests, {total_tokens} tokens, "
          f"{ticks} ticks, {dt:.2f}s ({total_tokens / max(dt, 1e-9):.1f} tok/s) "
          f"backend={args.backend}")
    print(f"[serve] ttft p50 {_pct(ttfts, 50) * 1e3:.1f}ms "
          f"p99 {_pct(ttfts, 99) * 1e3:.1f}ms | latency "
          f"p50 {_pct(lats, 50) * 1e3:.1f}ms p99 {_pct(lats, 99) * 1e3:.1f}ms")
    print(f"[serve] engine stats: {eng.stats}")
    for r in done[:4]:
        print(f"  prompt={r.prompt[:4]}{'...' if len(r.prompt) > 4 else ''} "
              f"-> {r.out}")

    if args.bench_json:
        from repro_torch.bench import write_bench

        metrics = {
            "requests": float(len(done)),
            "tokens": float(total_tokens),
            "wall_s": dt,
            "tok_per_s": total_tokens / max(dt, 1e-9),
            "ttft_p50_ms": _pct(ttfts, 50) * 1e3,
            "ttft_p99_ms": _pct(ttfts, 99) * 1e3,
            "latency_p50_ms": _pct(lats, 50) * 1e3,
            "latency_p99_ms": _pct(lats, 99) * 1e3,
            "prefill_steps": float(eng.stats["prefill_steps"]),
            "decode_steps": float(eng.stats["decode_steps"]),
        }
        meta = {"arch": args.arch, "backend": args.backend, "hardware": hardware,
                "smoke": args.smoke, "slots": args.slots,
                "prefill_chunk": args.prefill_chunk, "arrival_rate": args.arrival_rate or 0.0}
        path = write_bench("serve_live", metrics, meta, args.bench_json)
        print(f"[serve] wrote {path}")

    if observer is not None:
        trace_path = observer.close()
        if trace_path:
            print(f"[obs] wrote trace {trace_path}")
        if args.metrics_out:
            print(f"[obs] wrote metrics {args.metrics_out}")


if __name__ == "__main__":
    main()
