#!/usr/bin/env python3
"""Which FLOPs of a model-split product could run split and keep a
tensor-parallel step within the 1e-5 gate against one process, on the card.

The port computes every model-split product on its gathered weight
(``nn/linear.py``): each rank does the one process's product FLOPs.  This
tool takes the full-width qwen1.5-0.5b ``dfa`` step (f32, offchip_bpd
through the bank kernel, 64 x 64 rows, seed 0) on a (1, 2) (data, model)
mesh, two ranks on one card over gloo, through
``launch/dryrun.build_train``, and splits one part of every model-split
product at a time:

- port:  the port as it is (the control: 0 from one process);
- none:  this tool's product with nothing split (a second control: 0);
- fwd:   the forward on this rank's rows of the weight, a narrower GEMM,
         its columns gathered;
- dx:    the input gradient as the SUM all-reduce of the ranks' partial
         products (this rank's columns of the output gradient times its
         rows of the weight);
- dw:    the weight gradient from this rank's columns of the output
         gradient, a narrower GEMM;
- fwd+dx+dw: all three (column-parallel, as Megatron's);
- head:  all three on the head's vocabulary-split product, none on the
         blocks';
- all:   all three on the blocks and the head.

Each variant prints step 1's loss and each gradient leaf's max |diff| /
max |one process| (the worst leaf and the worst of each kind), against the
one process's ``Trainer._grads`` on the same batch and key.  The one
process and every variant draw the same global noise.

    python3 tools/tp_split_ablation.py [variant ...]

Run from the repository root on a machine with one CUDA card and nvcc; it
builds the kernel library first, then spawns the two ranks.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import pathlib
import socket
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH, SEED, SEQ, BATCH = "qwen1.5-0.5b", 0, 64, 64
GATE = 1e-5
SPLIT = ("fwd", "dx", "dw")
# variant -> (what the blocks' products split, what the head's splits);
# None: the port unpatched
VARIANTS = {"port": None, "none": ((), ()), "fwd": (("fwd",), ()), "dx": (("dx",), ()),
            "dw": (("dw",), ()), "fwd+dx+dw": (SPLIT, ()), "head": ((), SPLIT),
            "all": (SPLIT, SPLIT)}


def _product_fn(torch, sharding):
    """The autograd function of x2 @ wᵀ for this rank's rows ``w`` of a
    model-split weight, each of the forward, the input gradient and the
    weight gradient split or computed whole as ``flags`` say.  A part
    computed whole runs the GEMM autograd runs on the gathered weight."""
    import torch.distributed as dist

    class Product(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x2, w, flags, group, index, size):
            ctx.save_for_backward(x2, w)
            ctx.flags, ctx.group, ctx.index, ctx.size = flags, group, index, size
            if "fwd" in flags:
                return sharding._all_gather(x2 @ w.mT, 1, group, size)
            return x2 @ sharding._all_gather(w, 0, group, size).mT

        @staticmethod
        def backward(ctx, g):
            x2, w = ctx.saved_tensors
            n, flags = w.shape[0], ctx.flags
            g_local = g[:, ctx.index * n:(ctx.index + 1) * n].contiguous()
            whole = None if {"dx", "dw"} <= set(flags) else sharding._all_gather(
                w, 0, ctx.group, ctx.size)
            if "dx" in flags:
                dx = g_local.mm(w)
                dist.all_reduce(dx, op=dist.ReduceOp.SUM, group=ctx.group)
            else:
                dx = g.mm(whole)
            # autograd's weight gradient of x2 @ wᵀ: gᵀ·x2 (w.mT is column-major)
            if "dw" in flags:
                dw = g_local.t().mm(x2)
            else:
                dw = g.t().mm(x2).narrow(0, ctx.index * n, n).contiguous()
            return dx, dw, None, None, None, None

    def product(x, w, flags):
        group, index, size = sharding._tp_group()
        y = Product.apply(x.reshape(-1, x.shape[-1]), w, flags, group, index, size)
        return y.reshape(*x.shape[:-1], y.shape[-1])

    return product


@contextlib.contextmanager
def _patched(torch, variant):
    """The blocks' ``Linear.forward`` and the LM head running the variant's
    split product on a model-split weight (the port itself for "port")."""
    from repro_torch.dist import sharding
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.nn.linear import Linear

    flags = VARIANTS[variant]
    if flags is None:
        yield
        return
    blocks, head = flags
    product = _product_fn(torch, sharding)
    linear_forward, lm_head = Linear.forward, TransformerLM._head

    def forward(self, x):
        w, b = self.weight, self.bias
        if w.shape[-2] == self.out_dim:
            return linear_forward(self, x)
        y = product(x, w, blocks)
        if b is not None:
            y = y + (b if b.shape[0] == self.out_dim else sharding.gather_from_model(b, 0))
        return y

    def head_fn(self, h, weight=None):
        w = self.head["out"].weight if weight is None else weight
        if w.shape[0] == self.cfg.v_padded:
            return lm_head(self, h, weight)
        logits = product(h, w, head)
        if self.cfg.pad_vocab_to:
            pad = torch.arange(self.cfg.v_padded, device=logits.device) >= self.cfg.vocab_size
            logits = torch.where(pad, torch.tensor(-1e30, dtype=logits.dtype,
                                                   device=logits.device), logits)
        return logits

    Linear.forward, TransformerLM._head = forward, head_fn
    try:
        yield
    finally:
        Linear.forward, TransformerLM._head = linear_forward, lm_head


def _kind(name: str) -> str:
    parts = name.split(".")
    return ".".join(parts[2:]) if parts[0] == "blocks" else name


def _errors(got: dict, one: dict) -> dict:
    return {k: float((got[k].double() - e.double()).abs().max()
                     / max(float(e.abs().max()), 1e-30)) for k, e in one.items()}


def _rank(rank, port, variants, queue):
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
        key = prng.step_key(SEED, 0, "noise")
        vocab = configs.get(ARCH).make_model(device="meta").cfg.vocab_size
        batch = tokens.MarkovTokens(vocab, SEQ, BATCH, SEED).batch(0)
        one = None
        if rank == 0:
            s = api.build_session(arch=ARCH, smoke=False, dtype=torch.float32, seed=SEED,
                                  algo="dfa", hardware="offchip_bpd", backend="cuda",
                                  data_parallel=False, log_every=10**9, device="cuda")
            state = s.init_state()
            (one_loss, _), one = s.trainer._grads(state["params"], state["fb"],
                                                  s.trainer.put(batch), key)
            one_loss = float(one_loss)
            del s, state
            torch.cuda.empty_cache()
        dist.barrier()
        mesh = mesh_lib.make_host_mesh(2, model_axis=2, device_type="cuda")
        dfa = DFAConfig(photonics=photonics.preset("offchip_bpd"), backend="cuda")
        _, (p, fb, _, b0, _), extra = dryrun.build_train(
            ARCH, mesh, dfa=dfa, dtype=torch.float32, device="cuda", seed=SEED,
            batch={k: torch.as_tensor(v) for k, v in batch.items()})
        out = []
        for variant in variants:
            t0 = time.perf_counter()
            with _patched(torch, variant):
                (loss, _), grads = extra["value_and_grad"](p, fb, b0, key)
            grads = {k: sharding.full_tensor(g) for k, g in grads.items()}
            seconds = time.perf_counter() - t0
            if rank == 0:
                errs = _errors(grads, one)
                out.append((variant, float(loss), one_loss, errs, seconds))
            del grads
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    queue.put((rank, out))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> None:
    variants = sys.argv[1:] or list(VARIANTS)
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; choose from {list(VARIANTS)}")
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
    print(f"[ablation] kernels built in {time.perf_counter() - t0:.1f}s; {ARCH} full width, "
          f"f32, offchip_bpd, dfa, {BATCH} x {SEQ} rows, (1, 2) mesh, two ranks over gloo",
          flush=True)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, variants, queue)) for r in range(2)]
    for proc in procs:
        proc.start()
    results = {}
    try:
        for _ in procs:
            rank, out = queue.get(timeout=1800)
            results[rank] = out
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    failed = [proc.exitcode for proc in procs if proc.exitcode]
    if failed:
        raise SystemExit(f"a rank failed: exit codes {failed}")
    for variant, loss, one_loss, errs, seconds in results[0]:
        worst = max(errs, key=errs.get)
        kinds: dict = {}
        for k, e in errs.items():
            kinds[_kind(k)] = max(kinds.get(_kind(k), 0.0), e)
        top = sorted(kinds.items(), key=lambda kv: -kv[1])[:5]
        print(f"[ablation] {variant:10s} loss {loss:.6f} (one process {one_loss:.6f}); worst "
              f"gradient {errs[worst]:.3e} ({worst}) = {errs[worst] / GATE:.3f} of the gate; "
              f"by kind " + ", ".join(f"{k} {e:.3e}" for k, e in top)
              + f"; {seconds:.1f}s")


if __name__ == "__main__":
    main()
