"""Mixture-of-Experts FFN (qwen2-moe, kimi-k2).  Counterpart of
``repro/nn/moe.py``.

Dispatch is the GShard one-hot capacity formulation: a (T, E, C) dispatch
tensor scatters each token into its experts' capacity slots, the experts
run as one stacked FFN over (E, C, d), and a (T, E, C) combine tensor
gathers their outputs weighted by the router's top-k probabilities.
Tokens beyond an expert's capacity are dropped in position-in-expert
order; the top k breaks ties toward the lower expert index, as the
reference's ``jax.lax.top_k`` (``top_k``); shared experts run densely on every token.  ``dispatch="gather"``
reaches the same result through slot indices, with no routing products.

The router is a digital ``x @ Wᵀ``, as in the reference.  The expert FFN's
three products run through ``forward_matmul`` on the stacked (E, M, K)
weights, the counterpart of the reference's ``jax.vmap(expert)``: under a
photonic forward each is one batched bank product with one key.  Token
groups longer than ``group_size`` are cut along the sequence axis and
routed one group at a time; the reference scans them, tracing the body
once, so every group reuses the same three expert keys, and the port
rewinds the key counter per group (``photonics.scanned_layers``).

Aux losses: the load-balancing loss (Switch) and the router z-loss, with
the dropped fraction, returned for the trainer to weight.  Serving asks
for none (``with_aux=False``) and the layer skips computing them.

A batch split over data-parallel ranks (a row window: a training step's,
or a sharded serving call's) is routed as the reference's global batch:
each rank routes its own rows, but the capacity is the global group's and
each (token, slot)'s position in its expert's queue counts the tokens of
the ranks before it in the batch's order (``_ranks_before``: one
all-reduce of the per-expert counts), so every token keeps or drops as in
one process; the load-balancing loss reads the whole batch's means
(``_batch_mean``).  The rank's dispatch fills only its tokens' slots of
the whole (E, C, d) buffer; the ranks' buffers are summed over the data
group (each slot comes from one rank: the sum is exact) and every rank
runs the experts on its 1/n of the slots (a reduce-scatter along C, padded
to a multiple of the ranks), the outputs all-gathered for each rank's
combine.  The reference's placement (``expert_ecd``) holds the whole C on
every data rank; splitting the slots does 1/n of its expert work a rank.
Under a photonic forward the experts run on the whole summed buffer
instead (``photonics.whole_rows``): their operand scales and noise are the
whole buffer's, as one process's.

Expert parallelism (``dist.sharding``): under a ``model`` axis the
``experts`` rule splits the stacked expert weights along E, so a rank
holds E/m experts (the divisibility fallback leaves them whole where m
does not divide E; the layer reads the split from its weights).  The
routing, the capacity, the aux losses and the dispatch run whole and alike
on every model rank; each rank runs its experts on its slice of the
(E, C, d) buffer, the reference's ``expert_ecd`` placement, and the
outputs are all-gathered along E in rank order.  The backward all-gathers
the slices' input gradients, so the scatter back to the tokens runs on the
whole (E, C, d) gradient, as in one process (a SUM all-reduce of partial
token gradients would reorder the top-k sums).

The shared experts split column-parallel, as the reference's GSPMD
computes them (``column_parts``): a ``GatedMLP`` on its columns of gate·up
(``nn/linear.py``), their products counted under ``shared.*``.  The router
(a digital product, counted under ``router``) stays whole on every rank:
a routing decision is discrete, and a narrower product's rounding (a GEMM
picks its kernel by width) can flip a token's top k, which moves its whole
expert output.
"""

from __future__ import annotations

import torch

from repro_torch.core import photonics
from repro_torch.dist import sharding
from repro_torch.nn.linear import GatedMLP, Linear
from repro_torch.nn.module import Module
from repro_torch.utils import flop_cost


def top_k(x, k: int):
    """The k largest values along the last axis and their indices, equal
    values in index order (the lower index first), as ``jax.lax.top_k``
    orders them.  ``torch.topk`` leaves the order of ties unspecified (its
    CPU build picks higher indices), so a stable descending sort takes its
    place; it breaks ties alike on the CPU and on CUDA."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _data_split():
    """The active row window where it splits the batch over data-parallel
    ranks, else None."""
    window = photonics.active_window()
    return None if window is None or window.count == window.total else window


def _ranks(window) -> int:
    return 1 if window is None else window.total // window.count


def _batch_mean(x, window):
    """The mean of ``x`` (T, ...) over the tokens of the step's whole batch:
    on a split batch the ranks' sums are all-reduced over the window's group
    (``sharding.sum_over``), as the reference's global batch statistic."""
    if window is None:
        return x.mean(dim=0)
    return sharding.sum_over(x.sum(dim=0), window.group) / (x.shape[0] * _ranks(window))


def _ranks_before(counts, window):
    """(E,) the slots the ranks before this one in the batch's order take
    in each expert's queue: the exclusive prefix of the data group's
    per-expert ``counts`` (one all-reduce of a (ranks, E) table; whole
    numbers, exact in f32)."""
    index = window.start // window.count
    table = counts.new_zeros((_ranks(window), counts.shape[-1]))
    table[index] = counts
    return sharding.sum_over(table, window.group)[:index].sum(dim=0)


def _one_hot(index, n: int):
    """``one_hot(index, n)`` in f32 from the shapes alone: eager
    ``torch.nn.functional.one_hot`` reads the indices' range back to the
    host, which a fake tensor (the dry-run's) has not."""
    return (index[..., None] == torch.arange(n, device=index.device)).float()


class MoE(Module):
    def __init__(self, d_model: int, d_ff_expert: int, n_experts: int, top_k: int,
                 n_shared_experts: int = 0, d_ff_shared: int | None = None,
                 capacity_factor: float = 1.25, norm_topk_prob: bool = True,
                 group_size: int = 4096, dispatch: str = "einsum", dtype=torch.float32,
                 device=None):
        super().__init__()
        if dispatch not in ("einsum", "gather"):
            raise ValueError(f"unknown dispatch {dispatch!r}")
        self.d_model, self.n_experts, self.top_k = d_model, n_experts, top_k
        self.capacity_factor, self.norm_topk_prob = capacity_factor, norm_topk_prob
        self.group_size, self.dispatch = group_size, dispatch
        self.router = Linear(d_model, n_experts, dtype=dtype, device=device, region="router")
        self.experts = GatedMLP(d_model, d_ff_expert, dtype=dtype, device=device,
                                stack=n_experts)
        self.shared = (GatedMLP(d_model, (d_ff_shared or d_ff_expert) * n_shared_experts,
                                dtype=dtype, device=device, region="shared",
                                parts=("shared", "shared_down"))
                       if n_shared_experts else None)

    def column_parts(self, size: int, serving: bool) -> tuple[list, dict]:
        """(the ``COLUMN_SPLIT`` parts this layer computes column-parallel
        on a model axis of ``size``, the parts it keeps whole -> why): the
        shared experts'; the router runs whole (the module docstring).  The
        stacked experts split along E by their own rule."""
        parts, kept = ([], {}) if self.shared is None else self.shared.column_parts(size,
                                                                                   serving)
        return parts, {**kept, "router": "a routing decision is discrete: a narrower "
                                         "product's rounding can flip a token's top k"}

    def capacity(self, t: int) -> int:
        """Slots per expert for a group of ``t`` tokens."""
        return max(1, int(self.capacity_factor * self.top_k * t / self.n_experts))

    def _route_topk(self, x_flat, with_aux=True):
        """The routing prelude: (topv (T, K), topi (T, K), keep (T, K, E),
        pos (T, K), cap, aux); aux is None unless ``with_aux``."""
        t, e = x_flat.shape[0], self.n_experts
        window = _data_split()
        cap = self.capacity(t * _ranks(window))  # the global group's
        router = lambda x: x @ self.router.weight.T
        logits = flop_cost.region(self.router.region, router, x_flat).float()  # (T, E)
        probs = torch.softmax(logits, dim=-1)
        topv, topi = top_k(probs, self.top_k)
        if self.norm_topk_prob:
            topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
        # one-hot expert assignment per k-slot, and each (token, slot)'s
        # position in its expert's queue
        assign = _one_hot(topi, e)  # (T, K, E)
        flat = assign.reshape(t * self.top_k, e)
        pos_in_expert = torch.cumsum(flat, dim=0) - flat
        if window is not None:
            pos_in_expert = pos_in_expert + _ranks_before(flat.sum(dim=0), window)
        pos_in_expert = pos_in_expert.reshape(t, self.top_k, e)
        keep = (pos_in_expert < cap).float() * assign
        pos = torch.einsum("tke,tke->tk", pos_in_expert, keep).long()
        if not with_aux:
            return topv, topi, keep, pos, cap, None
        me = _batch_mean(probs, window)  # (E,)
        ce = _batch_mean(assign.sum(dim=1), window)  # the fraction routed to each expert
        aux = {"lb_loss": e * torch.sum(me * ce),
               "z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
               "dropped_frac": 1.0 - keep.sum() / (t * self.top_k)}
        return topv, topi, keep, pos, cap, aux

    def _route(self, x_flat, with_aux=True):
        """x_flat (T, d) -> (combine (T, E, C), dispatch (T, E, C), aux)."""
        topv, _, keep, pos, cap, aux = self._route_topk(x_flat, with_aux)
        pos_oh = _one_hot(pos, cap)  # (T, K, C)
        dispatch = torch.einsum("tke,tkc->tec", keep, pos_oh)  # in {0, 1}
        combine = torch.einsum("tk,tke,tkc->tec", topv, keep, pos_oh)
        return combine, dispatch, aux

    def _run_experts(self, expert_in):
        """The stacked experts on the (E, C, d) buffer -> (E, C, d).  Where
        this rank holds E/m of them, it runs them on its slice of the
        buffer and the outputs are gathered along E.  On a split batch
        ``expert_in`` holds this rank's tokens' slots alone, and the ranks'
        buffers are summed (the module docstring)."""

        def run(x):  # step_cost counts the expert products under "experts"
            return flop_cost.region("experts", self.experts, x)

        local = self.experts.gate.weight.shape[0] != self.n_experts
        x = sharding.split_to_model(expert_in, 0) if local else expert_in
        window, ctx = _data_split(), photonics.active_forward()
        if window is None:
            y = run(x)
        elif ctx is not None and ctx.cfg.enabled:
            with photonics.whole_rows():
                y = run(sharding.sum_over(x, window.group))
        else:
            n, c = _ranks(window), x.shape[1]
            x = torch.nn.functional.pad(x, (0, 0, 0, -c % n))
            mine = sharding.scatter_sum(x, 1, window.group, n)
            y = sharding.gather_over(run(mine), 1, window.group, n)[:, :c]
        return sharding.gather_from_model(y, 0) if local else y

    def _group_forward(self, x_flat, with_aux=True):
        """Route and compute one token group: x_flat (Tg, d) -> (y, aux)."""
        if self.dispatch == "gather":
            return self._group_forward_gather(x_flat, with_aux)
        combine, dispatch, aux = self._route(x_flat, with_aux)
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(x_flat.dtype), x_flat)
        expert_out = self._run_experts(expert_in)  # (E, C, d)
        y = torch.einsum("tec,ecd->td", combine.to(x_flat.dtype), expert_out)
        return y, aux

    def _group_forward_gather(self, x_flat, with_aux=True):
        """Slot-indexed dispatch: token ids scattered into E·C slots (plus
        one overflow slot that takes every dropped (token, k)), token rows
        gathered, the experts run, and each (token, k)'s slot output
        gathered back.  The routing and capacity of the einsum path with
        no routing products."""
        t, d = x_flat.shape
        e = self.n_experts
        topv, topi, keep, pos, cap, aux = self._route_topk(x_flat, with_aux)
        kept = keep.sum(-1) > 0  # (T, K): this (token, k) was admitted
        n_slots = e * cap
        slot = torch.where(kept, topi * cap + pos, torch.full_like(topi, n_slots))
        tok_ids = torch.arange(t, device=x_flat.device)[:, None].expand_as(slot)
        slot_tok = torch.zeros(n_slots + 1, dtype=torch.long, device=x_flat.device)
        slot_tok[slot.reshape(-1)] = tok_ids.reshape(-1)  # kept slots are unique
        slot_valid = torch.zeros(n_slots + 1, dtype=x_flat.dtype, device=x_flat.device)
        slot_valid[slot.reshape(-1)] = 1.0
        expert_in = x_flat[slot_tok[:n_slots]] * slot_valid[:n_slots, None]
        expert_out = self._run_experts(expert_in.reshape(e, cap, d))  # (E, C, d)
        out_flat = torch.cat([expert_out.reshape(n_slots, d),
                              expert_out.new_zeros((1, d))], dim=0)
        per_k = out_flat[slot]  # (T, K, d); the overflow row is zeros
        y = torch.einsum("tk,tkd->td", topv.to(per_k.dtype), per_k)
        return y, aux

    def forward(self, x, with_aux=True):
        """x (B, S, d) -> (y (B, S, d), aux), aux None unless ``with_aux``.

        Above ``group_size`` tokens the groups are cut along the sequence
        axis, (B, chunk) tokens each, and the aux terms are their means; on
        a split batch B and the tokens are the global batch's."""
        b, s, d = x.shape
        t, ranks = b * s, _ranks(_data_split())
        chunk = max(1, self.group_size // (b * ranks))
        if t * ranks <= self.group_size or s % chunk != 0:
            y, aux = self._group_forward(x.reshape(t, d), with_aux)
        else:
            xg = x.reshape(b, s // chunk, chunk, d).transpose(0, 1)  # (G, B, chunk, d)
            ys, auxes = [], []
            for xt in photonics.scanned_layers(xg):  # every group: the same expert keys
                yt, auxt = self._group_forward(xt.reshape(b * chunk, d), with_aux)
                ys.append(yt.reshape(b, chunk, d))
                auxes.append(auxt)
            y = torch.stack(ys).transpose(0, 1).reshape(t, d)
            aux = ({k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}
                   if with_aux else None)
        if self.shared is not None:
            y = y + self.shared(x.reshape(t, d))
        return y.reshape(b, s, d), aux
