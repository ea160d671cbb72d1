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
steps and at the end.

The reference's whisper and internvl2 branches, ``--data-parallel``,
``--n-buses``, ``--autotune``, ``--bench-json``, ``--trace-out``,
``--metrics-out`` and ``--probe-every`` are ported in later slices.
"""

from __future__ import annotations

import argparse

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
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batches kept on the device ahead of the step (0 disables)")
    ap.add_argument("--recal-every", type=int, default=None,
                    help="in-situ recalibration cadence (steps) for stateful emu "
                         "hardware; default: 500 when the device drifts")
    ap.add_argument("--ckpt-dir", default=None,
                    help="resume from and save snapshots to this directory")
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    args = ap.parse_args(argv)

    # the language models always train their reduced config here
    smoke = args.smoke or args.arch != "mnist_mlp"
    session = api.build_session(
        arch=args.arch, smoke=smoke, algo=args.algo, hardware=args.preset,
        backend=args.backend, error_compress=args.error_compress,
        optimizer=SGDM(lr=args.lr, momentum=args.momentum), seed=args.seed,
        log_path=args.log, log_every=max(1, args.steps // 20), prefetch=args.prefetch,
        recalibrate_every=args.recal_every, ckpt_dir=args.ckpt_dir, device=args.device)
    model = session.model
    if args.arch != "mnist_mlp":
        gen = tokens.MarkovTokens(model.cfg.vocab_size, args.seq, args.batch, args.seed)
        state, metrics = session.fit(gen.batch, total_steps=args.steps)
        final = session.trainer.to_host(metrics)
        print(f"[final] {final}")
        return final
    data = mnist.load(seed=args.seed)
    print(f"[data] source={data['source']}")
    xtr, ytr = data["train"]
    xte, yte = data["test"]
    if xtr.shape[1] != model.in_dim:  # --smoke shrinks in_dim
        xtr, xte = xtr[:, :model.in_dim], xte[:, :model.in_dim]
    pipe = pipeline.ArrayClassification(xtr, ytr, args.batch, args.seed)
    state, _ = session.fit(pipe.batch, total_steps=args.steps)
    ev = session.evaluate(state, pipe.eval_batches(xte, yte, 256))
    print(f"[eval] {ev}")
    return ev


if __name__ == "__main__":
    main()
