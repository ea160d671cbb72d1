"""Training launcher — a thin CLI over ``repro_torch.api.build_session``.
Counterpart of ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mnist_mlp \\
      --algo dfa --preset offchip_bpd --backend cuda --steps 500
  PYTHONPATH=src python -m repro_torch.launch.train --arch mnist_mlp \\
      --backend emu --preset emu_onchip --recal-every 500
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --algo dfa --backend cuda --preset offchip_bpd --ckpt-dir runs/qwen

Runs on the card; ``--device cpu`` runs on the CPU (the ``cuda`` backend
then runs its kernels' plain versions, the ``emu`` backend its unfused
chain).  ``--backend emu`` trains through the emulated MRR banks, which
drift on the default device and are recalibrated every ``--recal-every``
steps (default 500 when the device drifts).  ``--smoke`` trains the reduced
64×32×32×10 MLP on the first 64 pixels of each image, as the reference
launcher does.  Data: MNIST from ``$REPRO_MNIST_DIR`` if the IDX files are
there, else the procedural digits.

A language model (``--arch qwen1.5-0.5b``) trains on the synthetic
``MarkovTokens`` stream, ``--batch`` sequences of ``--seq`` tokens, and
always in its reduced smoke config, as the reference launcher does (full
width: ``api.build_session(smoke=False)``); the final metrics are printed.
``--ckpt-dir``: resume from the newest snapshot there, save one every 500
steps and at the end.  whisper-small's batches also carry frame embeddings
(B, n_frames, d_model) and internvl2-2b's patch embeddings (B, n_patches,
d_vision), 0.1 × normal draws from ``np.random.default_rng((seed, step,
7))`` and ``(seed, step, 8)``, the reference launcher's batches.

Observability: ``--trace-out PATH`` writes a Perfetto-loadable Chrome
trace (step, probe and drain spans, recalibration events, hwmon
counters), ``--metrics-out PATH`` appends the logged rows as JSONL
(render with ``python -m repro_torch.obs.summarize PATH``),
``--probe-every N`` logs DFA-vs-BP alignment (and on emu presets the
noise budget) every N steps, and ``--bench-json DIR`` times every step and
writes ``BENCH_train_throughput.json`` into DIR.

``--n-buses`` sets the chip's WDM bus count; ``--autotune`` picks the
fastest (n_buses, f_s) for the model's DFA backward on the modelled chip
(``sim.autotune``) under ``--power-budget-w``, prints ``[sim] autotuned
schedule: ...`` and trains on it::

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --preset emu_onchip --backend emu --autotune --power-budget-w 78

``--data-parallel {auto,on,off}``: under ``torchrun`` (one rank per card)
each step splits its batch over the ranks and averages the gradients
(``train.Trainer``); "auto" turns it on when the launcher started more than
one rank, "on" without a launcher runs a world of one.  Only rank 0
prints, logs and writes::

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --backend cuda --preset offchip_bpd --data-parallel on
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch.distributed as dist

from repro_torch import algos, api, configs
from repro_torch.core import photonics
from repro_torch.data import mnist, pipeline, tokens
from repro_torch.train import SGDM


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--algo", choices=algos.list_algos(), default="dfa")
    ap.add_argument("--preset", choices=list(photonics.PRESETS), default="ideal")
    ap.add_argument("--backend", choices=["auto", *photonics.BACKENDS], default="auto")
    ap.add_argument("--error-compress", choices=["none", "ternary", "int8"], default="none")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=64, help="LM sequence length")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log", default=None, help="CSV of the logged steps' metrics")
    ap.add_argument("--data-parallel", choices=["auto", "on", "off"], default="auto",
                    help="split each batch over the launcher's ranks, one per card (auto: "
                         "when torchrun started more than one)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batches kept on the device ahead of the step (0 disables)")
    ap.add_argument("--recal-every", type=int, default=None,
                    help="in-situ recalibration cadence (steps) for stateful emu "
                         "hardware; default: 500 when the device drifts")
    ap.add_argument("--ckpt-dir", default=None,
                    help="resume from and save snapshots to this directory")
    ap.add_argument("--n-buses", type=int, default=None,
                    help="parallel WDM buses (multi-wavelength scale-out); default: the "
                         "preset's bus count (1)")
    ap.add_argument("--autotune", action="store_true",
                    help="sim schedule autotuning: pick the fastest (n_buses, f_s) for this "
                         "model's DFA backward under --power-budget-w")
    ap.add_argument("--power-budget-w", type=float, default=None,
                    help="wall-plug power budget [W] of the modelled chip for --autotune "
                         "(default: unconstrained)")
    ap.add_argument("--bench-json", default=None, metavar="DIR",
                    help="measure throughput and write BENCH_train_throughput.json into DIR")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto-loadable Chrome trace of the run (step spans, "
                         "recal events, hwmon gauges) to PATH")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="append obs metrics rows (JSONL) to PATH; render with "
                         "python -m repro_torch.obs.summarize")
    ap.add_argument("--probe-every", type=int, default=None, metavar="N",
                    help="every N steps log DFA-vs-BP alignment per layer (and the emu "
                         "noise budget) as observer rows")
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    args = ap.parse_args(argv)
    if args.power_budget_w is not None and not args.autotune:
        ap.error("--power-budget-w only steers --autotune")

    # the language models always train their reduced config here
    smoke = args.smoke or args.arch != "mnist_mlp"
    owned = not dist.is_initialized()
    session = api.build_session(
        arch=args.arch, smoke=smoke, algo=args.algo, hardware=args.preset,
        backend=args.backend, error_compress=args.error_compress,
        optimizer=SGDM(lr=args.lr, momentum=args.momentum), seed=args.seed,
        log_path=args.log, log_every=max(1, args.steps // 20), prefetch=args.prefetch,
        recalibrate_every=args.recal_every, ckpt_dir=args.ckpt_dir, n_buses=args.n_buses,
        schedule="auto" if args.autotune else None, power_budget_w=args.power_budget_w,
        schedule_batch=args.batch if args.autotune else None,
        data_parallel={"auto": "auto", "on": True, "off": False}[args.data_parallel],
        probe_every=args.probe_every, device=args.device)
    with _process_group(session, owned):
        return _run(args, session)


@contextlib.contextmanager
def _process_group(session, owned: bool):
    """Tear down, when the run ends, the process group the session started."""
    try:
        yield
    finally:
        if owned and session.mesh is not None:
            dist.destroy_process_group()


def _run(args, session):
    chief = session.trainer.is_chief
    say = print if chief else (lambda *a, **k: None)
    model = session.model
    observer = None
    if chief and (args.trace_out or args.metrics_out):
        observer = session.observe(metrics_path=args.metrics_out, trace_path=args.trace_out)
    if session.mesh is not None:
        say(f"[dist] data-parallel over {session.mesh.size()} ranks")
    if session.schedule is not None:
        say(f"[sim] autotuned schedule: {session.schedule.describe()}")
    timer = None
    if args.bench_json is not None:
        from repro_torch.bench import StepTimer, clamped_warmup

        timer = StepTimer(warmup=clamped_warmup(args.steps, 4))

    if args.arch != "mnist_mlp":
        batch_fn = lm_batches(args.arch, model.cfg, args.seq, args.batch, args.seed)
        state, metrics = session.fit(batch_fn, total_steps=args.steps, timer=timer)
        _report_bench(args, session, state, batch_fn(0), timer)
        result = session.trainer.to_host(metrics)
        say(f"[final] {result}")
    else:
        data = mnist.load(seed=args.seed)
        say(f"[data] source={data['source']}")
        xtr, ytr = data["train"]
        xte, yte = data["test"]
        if xtr.shape[1] != model.in_dim:  # --smoke shrinks in_dim
            xtr, xte = xtr[:, :model.in_dim], xte[:, :model.in_dim]
        pipe = pipeline.ArrayClassification(xtr, ytr, args.batch, args.seed)
        state, _ = session.fit(pipe.batch, total_steps=args.steps, timer=timer)
        _report_bench(args, session, state, pipe.batch(0), timer)
        result = session.evaluate(state, pipe.eval_batches(xte, yte, 256))
        say(f"[eval] {result}")

    if observer is not None:
        trace_path = observer.close()
        if trace_path:
            print(f"[obs] wrote trace {trace_path}")
        if args.metrics_out:
            print(f"[obs] wrote metrics {args.metrics_out}")
        if observer.alerts:
            print(f"[obs] {len(observer.alerts)} alert(s) (hwmon + anomaly); first: "
                  f"{observer.alerts[0].message}")
    return result


def lm_batches(arch: str, cfg, seq: int, batch: int, seed: int):
    """step -> the language model's host batch: ``MarkovTokens``, plus the
    frontend stubs' inputs for whisper-small (frames) and internvl2-2b
    (patch embeddings)."""
    gen = tokens.MarkovTokens(cfg.vocab_size, seq, batch, seed)

    def batch_fn(step):
        b = gen.batch(step)
        if arch == "whisper-small":
            rng = np.random.default_rng((seed, step, 7))
            b["frames"] = rng.normal(size=(batch, cfg.n_frames,
                                           cfg.d_model)).astype("float32") * 0.1
        if arch == "internvl2-2b":
            rng = np.random.default_rng((seed, step, 8))
            v = cfg.vision
            b["patch_embeds"] = rng.normal(size=(batch, v.n_patches,
                                                 v.d_vision)).astype("float32") * 0.1
        return b

    return batch_fn


def _report_bench(args, session, state, batch, timer):
    if timer is None:
        return
    if timer.recorded_steps == 0:
        # e.g. a checkpoint-restored fit that had nothing left to run
        print("[bench] no steps executed — skipping throughput report", flush=True)
        return
    from repro_torch.bench import report_throughput

    report_throughput(session, state, batch, timer,
                      meta={"arch": args.arch, "algo": args.algo, "preset": args.preset,
                            "batch": args.batch, "steps": args.steps},
                      out_dir=args.bench_json)


if __name__ == "__main__":
    main()
