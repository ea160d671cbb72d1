#!/usr/bin/env python3
"""The JAX reference's own accuracy for the training run of
``chip_smoke.py``'s DFA-training phase, on the host's CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/reference_training_bands.py

The run is tests/test_train.py's protocol at the full width of the
paper's MLP (784×800×800×10): the procedural digits (2048 train, 512 test,
seed 0), 96 steps of DFA at batch 64 with SGD momentum 0.01 / 0.9, for each
of the ideal, offchip_bpd and onchip_bpd presets on the ``ref`` backend,
and for the emu_offchip and emu_onchip presets on the ``emu`` backend
(device emulation with drift on and recalibration every 500 steps, the
fused panel loop through its compiled twin, ``emu_kernel="xla"``), as
``chip_smoke.py``'s emu training phase runs them.  It prints the test
accuracy per preset, to set beside the port's on the card.  It imports the reference package (``repro``) and JAX; the port
(``repro_torch``) needs neither.
"""

from __future__ import annotations

import json
import time

from repro.algos.dfa import DFAConfig
from repro.core import photonics
from repro.core.photonics import EmulatedMRRBackend
from repro.data import mnist, pipeline
from repro.models.mlp import MLPClassifier
from repro.train import SGDM, Trainer, TrainerConfig

PRESETS = ("ideal", "offchip_bpd", "onchip_bpd")
EMU_PRESETS = ("emu_offchip", "emu_onchip")


def main():
    xtr, ytr = mnist.procedural_digits(2048, seed=0)
    xte, yte = mnist.procedural_digits(512, seed=10_000)
    pipe = pipeline.ArrayClassification(xtr, ytr, batch_size=64, seed=0)
    accs = {}
    for preset in PRESETS + EMU_PRESETS:
        t0 = time.perf_counter()
        emu = preset in EMU_PRESETS
        backend = EmulatedMRRBackend(emu_kernel="xla") if emu else "ref"
        tr = Trainer(MLPClassifier(), TrainerConfig(
            algo="dfa", dfa=DFAConfig(photonics=photonics.preset(preset), backend=backend),
            optimizer=SGDM(lr=0.01, momentum=0.9), recalibrate_every=500 if emu else 0,
            log_every=10**9))
        state, _ = tr.fit(pipe.batch, total_steps=96, verbose=False)
        accs[preset] = tr.evaluate(state, pipe.eval_batches(xte, yte, 256))["accuracy"]
        print(f"[reference] {preset}: accuracy {accs[preset]:.4f} "
              f"({time.perf_counter() - t0:.1f}s on the CPU)", flush=True)
    print(json.dumps({"reference_accuracy": accs}))


if __name__ == "__main__":
    main()
