"""Whether the card's f32 GEMMs give a product's columns the same bits at
another width: why a column-parallel product (``nn/linear.py``) is within
rounding of the one process's rather than on its bits, and so why each
split part is held to the 1e-5 training gate (``tools/tp_split_ablation.py``).

For the products of a qwen1.5-0.5b block at 64 x 64 rows (T = 4096; K and
N of q / o, gate / up, down and the head) it compares, on the card, the
columns a rank computes from its half of the weight's rows with the same
columns of the whole product: the narrow GEMM (``x @ w[half].mT``), the
narrow product batched over the 64 examples of 64 rows (a candidate for
splitting the FLOPs without leaving the whole product's sums), the
whole-width GEMM of the half placed in a zero weight, the input gradient
summed from two halves against the whole GEMM, the weight gradient's rows
from the half (plain and batched) against the whole, and how far the
whole f32 input gradient lies from f64.  Each line: bit for bit or not, and max |difference| /
max |whole|.  TF32 off.

The batch count: for qwen2-moe-a2.7b's expert products at 64 x 64 rows
(60 experts, capacity 341, d 2048, d_ff_expert 1408) it compares each
expert's result of the (30, C, K) batched f32 product an expert-parallel
rank runs on its half of the experts with the same expert's of the (60,
C, K) product one process runs: the forward ``a @ w.mT`` of gate / up and
of down, and their input and weight gradients.

    python3 tools/gemm_width_probe.py
"""

import torch


def rel(a, b) -> str:
    same = "bit for bit" if torch.equal(a, b) else "differs"
    return f"{same} ({float((a.double() - b.double()).abs().max() / b.double().abs().max()):.3e})"


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = 4096
    print("[gemm] " + torch.cuda.get_device_name(0))
    for k, n in ((1024, 1024), (1024, 2816), (2816, 1024), (1024, 151936)):
        x = torch.randn(t, k, generator=gen, device="cuda")
        w = torch.randn(n, k, generator=gen, device="cuda") * 0.03
        dy = torch.randn(t, n, generator=gen, device="cuda")
        h = n // 2
        whole = x @ w.mT
        pad = torch.zeros_like(w)
        pad[h:] = w[h:]
        wh = w[h:].contiguous()
        batched = torch.bmm(x.view(64, t // 64, k), wh.mT.expand(64, k, n - h)).reshape(t, -1)
        print(f"[gemm] (T {t}, K {k}) x N {n}, rows [{h}, {n}) of w: narrow GEMM "
              f"{rel(x @ wh.mT, whole[:, h:])}; batched over 64 examples {rel(batched, whole[:, h:])}; "
              f"whole-width GEMM of the padded half {rel((x @ pad.mT)[:, h:], whole[:, h:])}")
        dx = dy.mm(w)
        halves = dy[:, :h].mm(w[:h]) + dy[:, h:].mm(wh)
        dw = dy.t().mm(x)
        dyh = dy[:, h:].contiguous()
        # the batched weight gradient's (64, N/2, K) partials: the head's would take 20 GB
        dw_batched = (torch.bmm(dyh.view(64, t // 64, -1).mT, x.view(64, t // 64, k)).sum(0)
                      if n <= 4096 else None)
        print(f"[gemm]   input gradient from two halves {rel(halves, dx)}; the whole f32 one "
              f"against f64 {rel(dx, (dy.double() @ w.double()).float())}; weight gradient "
              f"rows from the half {rel(dyh.t().mm(x), dw[h:])}, batched "
              f"{'not run' if dw_batched is None else rel(dw_batched, dw[h:])}")
        del x, w, wh, dy, dyh, whole, batched, pad, dx, halves, dw, dw_batched
        torch.cuda.empty_cache()
    experts(gen)


def experts(gen) -> None:
    """Each expert's bits in a batched product of 30 experts against 60."""
    e, c = 60, 341
    for name, k, n in (("gate / up", 2048, 1408), ("down", 1408, 2048)):
        a = torch.randn(e, c, k, generator=gen, device="cuda")
        w = torch.randn(e, n, k, generator=gen, device="cuda") * 0.03
        dy = torch.randn(e, c, n, generator=gen, device="cuda")
        parts = []
        for label, fn in (("forward", lambda a, w, dy: a @ w.mT),
                          ("input gradient", lambda a, w, dy: dy @ w),
                          ("weight gradient", lambda a, w, dy: dy.mT @ a)):
            whole = fn(a, w, dy)
            lo, hi = (fn(a[sl].contiguous(), w[sl].contiguous(), dy[sl].contiguous())
                      for sl in (slice(0, e // 2), slice(e // 2, e)))
            parts.append(f"{label} experts [0, 30) {rel(lo, whole[:e // 2])}, [30, 60) "
                         f"{rel(hi, whole[e // 2:])}")
        print(f"[gemm] experts ({e}, {c}, {k}) x ({e}, {n}, {k}) ({name}), 30 a rank against "
              f"60: " + "; ".join(parts))
        del a, w, dy
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
