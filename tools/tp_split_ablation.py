#!/usr/bin/env python3
"""Which column-parallel parts of the decoder blocks and the head keep a
tensor-parallel DFA step within the 1e-5 gate against one process, on the
card.

The port computes the decoder blocks' products and the LM head
column-parallel on a ``model`` axis (``nn/linear.py``; the parts are
``dist.sharding.COLUMN_SPLIT``): each rank computes its columns of a
product on its rows of the weight, and the rest of the step runs on the
gathered columns.  The columns of a narrower f32 product are not the whole
product's bits (``tools/gemm_width_probe.py``), and a noisy DFA step
amplifies the shift in the bias gradients its rows cancel.  This tool
takes a full-width ``dfa`` step (f32, offchip_bpd through the bank kernel,
64 x 64 rows, seed 0) on a (1, 2) (data, model) mesh, two ranks on one
card over gloo, through ``launch/dryrun.build_train``, and overrides the
parts a training step splits (the blocks' ``DecoderBlock.column_parts``,
the head's ``TransformerLM.head_logits``) with one variant at a time:

- port:   the port as it is;
- none:   every product on its gathered weight (the control: 0);
- a part: that part of the blocks alone, each the arch's block names
          (qwen1.5: attn, o, ffn, down; minicpm3: latent, heads, o, ffn,
          down; qwen2-moe: attn, o, shared, shared_down), e.g. attn: q,
          k and v on this rank's heads, attention on them, the heads
          gathered before ``o``;
- head:   the head on its rows of the vocabulary, the logits gathered;
- blocks: every part of the blocks;
- all:    the blocks and the head.

Each variant prints step 1's loss and each gradient leaf's max |diff| /
max |one process| (the worst leaf and the worst of each kind), against the
one process's ``Trainer._grads`` on the same batch and key, and the worst
leaf of the parameters after two steps (SGD momentum, the trainer's keys)
against the one process's ``Session.step``.  The one process and every
variant draw the same global noise; the one process's gradients and
parameters wait on the host.

    python3 tools/tp_split_ablation.py [--arch A] [--layers N] [variant ...]

``--arch`` is qwen1.5-0.5b (default, all 24 layers), minicpm3-4b or
qwen2-moe-a2.7b; ``--layers`` cuts the depth (default: minicpm3 2 layers,
qwen2-moe 4, the depths ``chip_smoke.py``'s ``[tp]`` checks run).  Run
from the repository root on a machine with one CUDA card and nvcc; it
builds the kernel library first, then spawns the two ranks.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import pathlib
import queue as queue_lib
import socket
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED, SEQ, BATCH = 0, 64, 64
GATE = 1e-5
# arch -> (its block parts on a model axis of 2, the default depth: None
# the full depth)
ARCHS = {"qwen1.5-0.5b": (("attn", "o", "ffn", "down"), None),
         "minicpm3-4b": (("latent", "heads", "o", "ffn", "down"), 2),
         "qwen2-moe-a2.7b": (("attn", "o", "shared", "shared_down"), 4)}


def _variants(blocks) -> dict:
    """variant -> the parts a training step splits; None: the port as it
    is."""
    return {"port": None, "none": (), **{p: (p,) for p in blocks}, "head": ("head",),
            "blocks": blocks, "all": blocks + ("head",)}


def _arch(name, layers):
    """The arch ``name`` at full width, cut to ``layers`` layers (None: its
    whole depth), as an ``Arch`` that ``build_train`` and a session take."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.transformer import TransformerLM

    arch = configs.get(name)
    if layers is None:
        return arch
    cfg = dataclasses.replace(arch.make_model(device="meta").cfg, n_layers=layers)
    return dataclasses.replace(
        arch, make_model=lambda dtype=None, device=None: TransformerLM(
            dataclasses.replace(cfg, dtype=dtype or cfg.dtype), device=device))


@contextlib.contextmanager
def _patched(parts):
    """The training step splitting ``parts`` (the port itself for None):
    the blocks' parts (``DecoderBlock.column_parts``) cut to them, and with
    "head" the training head read as serving reads it (vocabulary-split),
    for the duration of the block."""
    from unittest import mock

    from torch.func import functional_call

    from repro_torch.models import base, transformer

    if parts is None:
        yield
        return
    block_parts = transformer.DecoderBlock.column_parts

    def column_parts(self):
        mine, kept = block_parts(self)
        return {k: v for k, v in mine.items() if k in parts}, kept

    def head_logits(self, params, x_final, batch):
        p = base.gathered(params, "head.", transformer.SERVING_HEAD)
        h = functional_call(self.head["norm"], base.subtree(p, "norm."), (x_final,))
        return self._head(h, p["out.weight"])

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(transformer.DecoderBlock, "column_parts",
                                              column_parts))
        if "head" in parts:
            stack.enter_context(mock.patch.object(transformer.TransformerLM, "head_logits",
                                                  head_logits))
        yield


def _kind(name: str) -> str:
    parts = name.split(".")
    return ".".join(parts[2:]) if parts[0] == "blocks" else name


def _errors(tree: dict, one, rank) -> dict | None:
    """Each leaf of a sharded tree gathered whole a leaf at a time (every
    rank calls it) against the one process's on the host: {leaf: max |diff|
    / max |one|} on rank 0, None elsewhere."""
    import torch

    from repro_torch.dist import sharding

    out = {}
    for k, v in tree.items():
        whole = sharding.full_tensor(v)
        if rank == 0:
            e = one[k].to(whole.device, torch.float64)
            out[k] = float((whole.double() - e).abs().max() / max(float(e.abs().max()), 1e-30))
            del e
        del whole
    return out if rank == 0 else None


def _rank(rank, port, name, layers, variants, queue):
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the two ranks share the card: grow segments rather than strand blocks
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    from repro_torch import api, configs
    from repro_torch.algos.dfa import DFAConfig
    from repro_torch.core import photonics
    from repro_torch.data import tokens
    from repro_torch.dist import sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.utils import prng

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    try:
        keys = [prng.step_key(SEED, i, "noise") for i in range(2)]
        arch = _arch(name, layers)
        vocab = configs.get(name).make_model(device="meta").cfg.vocab_size
        gen = tokens.MarkovTokens(vocab, SEQ, BATCH, SEED)
        one = one2 = None
        if rank == 0:
            model = arch.make_model(torch.float32, device="cuda")
            s = api.build_session(arch=model, dtype=torch.float32, seed=SEED,
                                  algo="dfa", hardware="offchip_bpd", backend="cuda",
                                  data_parallel=False, log_every=10**9, device="cuda")
            state = s.init_state()
            model.release_parameters()  # the training methods read the state's parameters
            (one_loss, _), one = s.trainer._grads(state["params"], state["fb"],
                                                  s.trainer.put(gen.batch(0)), keys[0])
            one_loss = float(one_loss)
            one = {k: v.cpu() for k, v in one.items()}
            for i in range(2):
                state, _ = s.step(state, gen.batch(i))
            one2 = {k: v.cpu() for k, v in state["params"].items()}
            del s, state, model
            torch.cuda.empty_cache()
        dist.barrier()
        mesh = mesh_lib.make_host_mesh(2, model_axis=2, device_type="cuda")
        dfa = DFAConfig(photonics=photonics.preset("offchip_bpd"), backend="cuda")
        fn, (p, fb, o, b0, _), extra = dryrun.build_train(
            arch, mesh, dfa=dfa, dtype=torch.float32, device="cuda", seed=SEED,
            batch={k: torch.as_tensor(v) for k, v in gen.batch(0).items()})
        b1 = sharding.place({k: torch.as_tensor(v) for k, v in gen.batch(1).items()},
                            extra["in_shardings"][3])
        out = []
        for variant, parts in variants:
            t0 = time.perf_counter()
            with _patched(parts):
                (loss, _), grads = extra["value_and_grad"](p, fb, b0, keys[0])
                seconds = time.perf_counter() - t0
                errs = _errors(grads, one, rank)
                del grads
                p2, o2 = p, o
                for i, b in enumerate((b0, b1)):
                    p2, o2, _ = fn(p2, fb, o2, b, keys[i])
                errs2 = _errors(p2, one2, rank)
            if rank == 0:
                out.append((variant, float(loss), one_loss, errs, errs2, seconds))
            del p2, o2
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    queue.put((rank, out))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list(ARCHS))
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args()
    blocks, depth = ARCHS[args.arch]
    layers = args.layers or depth
    known = _variants(blocks)
    names = args.variants or list(known)
    unknown = [v for v in names if v not in known]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; choose from {list(known)}")
    variants = [(v, known[v]) for v in names]
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    from repro_torch.kernels import photonic_matmul as pm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    t0 = time.perf_counter()
    pm.build()
    pm._library()
    print(f"[ablation] kernels built in {time.perf_counter() - t0:.1f}s; {args.arch} full "
          f"width, {layers or 'all'} layers, f32, offchip_bpd, dfa, {BATCH} x {SEQ} rows, (1, 2) "
          f"mesh, two ranks over gloo", flush=True)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, args.arch, layers, variants, queue))
             for r in range(2)]
    for proc in procs:
        proc.start()
    results = {}
    try:
        while len(results) < len(procs):
            try:
                rank, out = queue.get(timeout=5)
            except queue_lib.Empty:
                if any(proc.exitcode not in (None, 0) for proc in procs):
                    break  # a rank died: stop waiting on it
                continue
            results[rank] = out
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    failed = [proc.exitcode for proc in procs if proc.exitcode]
    if failed:
        raise SystemExit(f"a rank failed: exit codes {failed}")
    for variant, loss, one_loss, errs, errs2, seconds in results[0]:
        worst = max(errs, key=errs.get)
        worst2 = max(errs2, key=errs2.get)
        kinds: dict = {}
        for k, e in errs.items():
            kinds[_kind(k)] = max(kinds.get(_kind(k), 0.0), e)
        top = sorted(kinds.items(), key=lambda kv: -kv[1])[:5]
        print(f"[ablation] {args.arch} {variant:11s} loss {loss:.6f} (one process "
              f"{one_loss:.6f}); worst "
              f"gradient {errs[worst]:.3e} ({worst}) = {errs[worst] / GATE:.3f} of the gate; "
              f"after 2 steps {errs2[worst2]:.3e} ({worst2}) = {errs2[worst2] / GATE:.3f}; "
              f"by kind " + ", ".join(f"{k} {e:.3e}" for k, e in top)
              + f"; {seconds:.1f}s")


if __name__ == "__main__":
    main()
