"""Distributed decode: the cache placement policy and the serve-step
builders.  Counterpart of ``repro/serve/decode.py``.

Cache placement (``cache_shardings``, the reference's rules, by each
stacked leaf's rank and shape, alike for every family):

* rank-5 attention caches (L, B, S, KVH, D): the kv heads on ``model``
  where they divide; else head_dim; else the sequence;
* rank-4 leaves (L, B, S, R): an MLA latent cache's sequence on ``model``
  where it divides and holds at least 1024 slots (a conv window's 3 slots
  never do);
* recurrent states: the batch only (a rank-5 SSM state (L, B, H, N, P)
  takes the attention rule: N on ``model`` where it divides);
* the batch on (pod, data) where it divides (decode_32k: 128 over 16 or
  32; long_500k's batch of 1 stays whole).

The builders come in two forms.  The module-owned one (``serve.Engine``'s):
``make_serve_step(model)`` returns step(token, caches, cache_len[, enc])
running the model's own parameters.  The reference's params-taking one:
``make_serve_step(model, with_params=True)`` returns step(params, token,
caches, cache_len[, enc]), ``make_prefill(model)`` prefill(params, batch)
and ``make_prefill_step(model, with_params=True)`` step(params, tokens,
n_valid, caches, cache_len).  Given ``DTensor``s (the parameters placed
by ``make_param_shardings``, the caches by ``cache_shardings``, the
tokens by ``make_batch_shardings``) the step runs sharded: each block
gathers its parameters a layer at a time (``models.base.serving_params``)
but for its column-parallel parts, which run on this rank's rows of each
weight through the bank (a column window: s_b the whole weight's MAX, the
noise its columns of the global draw; ``nn/linear.py``), the attention on
this rank's kv heads, which are its piece of the kv-heads cache; each rank
runs its rows of the batch (a photonic forward in a row window: s_a the
global rows' MAX, the input noise its rows of the global draw) against its
piece of each cache (``nn/attention.py``, ``nn/ssm.py``), and the outputs
come back placed as their inputs; the head computes this rank's columns of
the vocabulary and the logits are gathered, so those of a decode step come
back whole on every rank, as the reference's replicated ``out_shardings``
give them.
"""

from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.core import photonics
from repro_torch.dist import sharding
from repro_torch.dist.sharding import MODEL, P, batch_axes
from repro_torch.models.base import no_tape
from repro_torch.utils.tree import leaves, path_map


def _size(mesh, axes) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return math.prod(sizes[a] for a in axes)


def cache_spec(mesh, shape) -> P:
    """The reference's spec of one stacked (L, B, ...) cache leaf."""
    b = batch_axes(mesh)
    m = dict(zip(mesh.mesh_dim_names, mesh.shape))[MODEL]
    spec = [None] * len(shape)
    if len(shape) >= 2 and shape[1] % _size(mesh, b) == 0:
        spec[1] = b
    if len(shape) == 5:  # (L, B, S, KVH, D) attention cache
        if shape[3] % m == 0:
            spec[3] = MODEL
        elif shape[4] % m == 0:
            spec[4] = MODEL  # head_dim
        elif shape[2] % m == 0:
            spec[2] = MODEL
    elif len(shape) == 4:  # (L, B, S, R) MLA latent cache
        if shape[2] % m == 0 and shape[2] >= 1024:  # sequence-like dim
            spec[2] = MODEL
    return P(*spec)


def cache_shardings(mesh, caches):
    """A ``Sharding`` for every leaf of a stacked (L leading axis) cache
    tree (``model.init_caches``'s; meta tensors will do)."""
    return path_map(lambda path, leaf: sharding.named(mesh, cache_spec(mesh, tuple(leaf.shape))),
                    caches)


# ---------------------------------------------------------------------------
# sharded calls
# ---------------------------------------------------------------------------


def _mesh_of(*trees):
    for tree in trees:
        for x in leaves(tree):
            if sharding.is_dtensor(x):
                return x.device_mesh
    return None


def _row_window(mesh, rows):
    """The row window of a batch ``rows`` splits over the batch axes (None
    where it is whole on every rank, or one rank holds it all)."""
    if not sharding.is_dtensor(rows) or not any(p.is_shard(0) for p in rows.placements):
        return None
    index, world = sharding.data_index(mesh)
    if world == 1:
        return None
    count = rows.to_local().shape[0]
    return photonics.RowWindow(index * count, count, rows.shape[0], sharding.batch_group(mesh))


@contextlib.contextmanager
def serving(mesh, rows, caches=None):
    """The context of a sharded serving call (``sharding.serving_call``):
    ``mesh`` active, the row window of the batch ``rows`` (a placed tensor
    whose dim 0 is the batch), and each cache leaf's ``model`` split (its
    per-layer dim)."""
    dims = {n: (d - 1 if d is not None else None)
            for n, d in ((n, sharding.model_dim(t)) for n, t in (caches or {}).items())}
    with sharding.use_mesh(mesh), photonics.row_window(_row_window(mesh, rows)), \
            sharding.split_caches(dims), sharding.serving_call():
        yield


def _placed_rows(ref, x):
    """``x``, this rank's rows of a batch placed as ``ref`` (dim 0 the
    batch), as a ``DTensor`` of the whole batch."""
    from torch.distributed.tensor import DTensor

    shape = (ref.shape[0], *x.shape[1:])
    stride = [1] * len(shape)  # contiguous
    for d in reversed(range(len(shape) - 1)):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(x, ref.device_mesh, ref.placements, run_check=False, shape=shape,
                              stride=tuple(stride))


def _sharded_call(call, rows, caches, params, *args):
    """``call(params, *local args)`` under ``serving`` where any argument
    is a ``DTensor`` -> (its outputs, the mesh or None).  The parameters
    stay placed: the model gathers them a block at a time."""
    mesh = _mesh_of(rows, caches, params, args)
    if mesh is None:
        return call(params, *args), None
    with serving(mesh, rows, caches):
        return call(params, *(sharding.to_local(a) for a in args)), mesh


def make_serve_step(model, *, sample: str = "greedy", whisper_enc: bool = False,
                    with_params: bool = False):
    """Returns step(token, caches, cache_len[, enc]) -> (next_token, logits,
    new_caches) on the model's own parameters; ``with_params``: the
    reference's step(params, token, caches, cache_len[, enc]), sharded
    where its arguments are ``DTensor``s (the next token and the caches
    placed as given, the logits whole on every rank).  ``whisper_enc``: the
    model decodes against an encoder output ``enc`` (whisper's
    ``decode_step(token, enc, caches, cache_len)``), the step's last
    argument."""
    if sample != "greedy":
        raise ValueError(sample)

    def decode(params, token, caches, cache_len, extra):
        kw = {} if params is None else {"params": params}
        if whisper_enc:
            return model.decode_step(token, extra[0], caches, cache_len, **kw)
        return model.decode_step(token, caches, cache_len, **kw)

    def greedy(logits):
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]

    if not with_params:
        def step(token, caches, cache_len, *extra):
            logits, new_caches = decode(None, token, caches, cache_len, extra)
            return greedy(logits), logits, new_caches

        return step

    def sharded_step(params, token, caches, cache_len, *extra):
        (logits, new), mesh = _sharded_call(decode, token, caches, params, token, caches,
                                            cache_len, extra)
        nxt = greedy(logits)
        if mesh is None:
            return nxt, logits, new
        with sharding.use_mesh(mesh):
            rows = sharding.is_dtensor(token) and any(p.is_shard(0) for p in token.placements)
            if rows:
                nxt = _placed_rows(token, nxt)
                logits = sharding.full_tensor(_placed_rows(token, logits))
            new = {n: sharding.like(caches[n], t) for n, t in new.items()}
        return nxt, logits, new

    return sharded_step


def select_slots(active, new, old):
    """Per-slot cache select over stacked (L, B, ...) caches: slot i takes
    ``new`` where ``active[i]``, else keeps ``old`` — the mask that stops
    finished or empty slots from changing state in a batched step."""

    def sel(n, o):
        m = active.reshape((1, -1) + (1,) * (n.ndim - 2))
        return torch.where(m, n, o)

    return {name: sel(new[name], old[name]) for name in new}


def make_prefill(model):
    """Forward over the prompt: prefill(params, batch) -> logits (B, S, V)
    through the training forward (``embed`` → ``run_segments`` →
    ``head_logits``), keeping no tape.  Given a placed batch (``DTensor``s)
    each rank runs its rows in a row window and the logits come back placed
    as the batch's rows.  The engine fills caches with
    ``make_prefill_step``."""

    def forward(params, batch):
        with no_tape():
            x0 = model.embed(params, batch)
            x_final, _, _ = model.run_segments(params, x0)
            return model.head_logits(params, x_final, batch)

    def prefill(params, batch):
        rows = next(iter(batch.values()))
        logits, mesh = _sharded_call(forward, rows, None, params, batch)
        if mesh is None or not sharding.is_dtensor(rows):
            return logits
        with sharding.use_mesh(mesh):
            return _placed_rows(rows, logits)

    return prefill


def make_prefill_step(model, *, with_params: bool = False):
    """Chunked-prefill builder: step(tokens (B, C), n_valid (B,), caches,
    cache_len) -> (last_logits (B, V), new_caches, new_cache_len);
    ``with_params``: step(params, tokens, n_valid, caches, cache_len),
    sharded where its arguments are ``DTensor``s (the outputs placed as the
    caches and the tokens' rows).

    Fills each slot's cache with its next <= C prompt tokens.
    ``last_logits[i]`` are the logits after slot i's last valid token
    (f32 zeros for a slot with ``n_valid == 0``, whose cache is untouched).

    A model with ``supports_parallel_prefill`` (global attention) runs one
    batched forward over the chunk.  A recurrent model runs the masked
    decode-scan: ``decode_step`` on every slot at each token position t,
    slot i keeping the new state where t < n_valid[i].  The reference scans
    that loop under ``jit``, which traces ``decode_step`` once, so every
    position draws the same bank-noise keys; the port iterates the positions
    through ``photonics.scanned_layers`` to keep that numbering."""
    parallel = getattr(model, "supports_parallel_prefill", False)
    vocab = model.cfg.v_padded

    def parallel_step(params, tokens, n_valid, caches, cache_len):
        c = tokens.shape[1]
        kw = {} if params is None else {"params": params}
        logits, new_caches = model.prefill_step(tokens, caches, cache_len, n_valid, **kw)
        idx = torch.clamp(n_valid - 1, 0, c - 1)
        last = torch.take_along_dim(logits, idx[:, None, None], dim=1)[:, 0]
        new_caches = select_slots(n_valid > 0, new_caches, caches)
        return last, new_caches, cache_len + n_valid

    def scan_step(params, tokens, n_valid, caches, cache_len):
        b, c = tokens.shape
        kw = {} if params is None else {"params": params}
        clen = cache_len
        last = torch.zeros((b, vocab), dtype=torch.float32, device=tokens.device)
        for t in photonics.scanned_layers(range(c)):
            valid = t < n_valid
            logits, upd = model.decode_step(tokens[:, t:t + 1], caches, clen, **kw)
            caches = select_slots(valid, upd, caches)
            clen = clen + valid.to(clen.dtype)
            last = torch.where(valid[:, None], logits[:, -1, :].float(), last)
        return last, caches, cache_len + n_valid

    run = parallel_step if parallel else scan_step
    if not with_params:
        return lambda tokens, n_valid, caches, cache_len: run(None, tokens, n_valid, caches,
                                                               cache_len)

    def sharded_step(params, tokens, n_valid, caches, cache_len):
        (last, new, clen), mesh = _sharded_call(run, tokens, caches, params, tokens, n_valid,
                                                caches, cache_len)
        if mesh is None:
            return last, new, clen
        with sharding.use_mesh(mesh):
            if sharding.is_dtensor(tokens):
                last, clen = _placed_rows(tokens, last), _placed_rows(tokens, clen)
            new = {n: sharding.like(caches[n], t) for n, t in new.items()}
        return last, new, clen

    return sharded_step
