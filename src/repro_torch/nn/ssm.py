"""Mamba-2 SSD (state-space duality) block — arXiv:2405.21060.
Counterpart of ``repro/nn/ssm.py``.

The chunked SSD algorithm: within a chunk the quadratic (attention-like)
form, across chunks a linear recurrence over per-chunk states (a loop over
the chunks, the reference's ``lax.scan``).  Decode is a constant-size state
update: no KV cache.  Scalar decay A per head, grouped B/C, a depthwise
causal conv on (x‖B‖C) and a gated RMSNorm before the output projection.
Inside the block everything is f32; the result is cast back to the input
dtype before ``out_proj``.

Parameter names follow the reference's tree (``in_proj.weight``,
``conv_w`` (K, C), ``conv_b``, ``A_log``, ``D``, ``dt_bias``,
``norm_scale``, ``out_proj.weight``; with ``split_proj`` ``in_z``,
``in_xbc`` and ``in_dt`` in place of ``in_proj``), so ``convert.py`` maps
one onto the other unchanged.
"""

from __future__ import annotations

import torch

from repro_torch.core.photonics import forward_matmul
from repro_torch.dist import sharding
from repro_torch.nn.activations import silu
from repro_torch.nn.linear import Linear
from repro_torch.nn.module import Module, empty_param, init_children
from repro_torch.utils import prng


def softplus(x):
    """``jax.nn.softplus``: log(1 + eˣ) as logaddexp(x, 0) everywhere
    (``F.softplus`` turns linear above 20, a different function)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def causal_conv1d(x, w, b):
    """Depthwise causal conv. x: (B, S, C), w: (K, C), b: (C,)."""
    k = w.shape[0]
    pad = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return out + b


def _gated_rmsnorm(y, z, scale):
    """y ⊙ silu(z), RMS-normalised (ε 1e-6) and scaled, in f32."""
    y = y * silu(z.float())
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    return y * (var + 1e-6) ** -0.5 * scale.float()


class Mamba2Block(Module):
    def __init__(self, d_model: int, d_state: int = 128, head_dim: int = 64,
                 expand: int = 2, n_groups: int = 1, conv_width: int = 4,
                 chunk: int = 128, split_proj: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.d_model, self.d_state, self.head_dim = d_model, d_state, head_dim
        self.expand, self.n_groups, self.conv_width = expand, n_groups, conv_width
        self.chunk, self.split_proj, self.dtype = chunk, split_proj, dtype
        h = self.n_heads
        lin = dict(dtype=dtype, device=device)
        if split_proj:
            # three projections in place of the fused one (the reference's
            # shard-aligned layout)
            self.in_z = Linear(d_model, self.d_inner, **lin)
            self.in_xbc = Linear(d_model, self.conv_dim, **lin)
            self.in_dt = Linear(d_model, h, **lin)
        else:
            self.in_proj = Linear(d_model, 2 * self.d_inner + 2 * n_groups * d_state + h, **lin)
        self.conv_w = empty_param((conv_width, self.conv_dim), dtype, device)
        self.conv_b = empty_param((self.conv_dim,), dtype, device)
        self.A_log = empty_param((h,), dtype, device)
        self.D = empty_param((h,), dtype, device)
        self.dt_bias = empty_param((h,), dtype, device)
        self.norm_scale = empty_param((self.d_inner,), dtype, device)
        self.out_proj = Linear(self.d_inner, d_model, **lin)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    def init(self, seed: int):
        init_children(self, seed)
        dev = self.conv_w.device
        with torch.no_grad():
            g = prng.generator(prng.fold(seed, "conv_w"), dev)
            self.conv_w.copy_(0.1 * torch.randn(self.conv_w.shape, generator=g, device=dev))
            self.conv_b.zero_()
            self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, self.n_heads, device=dev)))
            self.D.fill_(1.0)
            self.dt_bias.zero_()
            self.norm_scale.fill_(1.0)
        return self

    def _project_in(self, u):
        """-> (z, xBC before the conv, dt_raw)."""
        if self.split_proj:
            return (forward_matmul(u, self.in_z.weight), forward_matmul(u, self.in_xbc.weight),
                    forward_matmul(u, self.in_dt.weight))
        proj = forward_matmul(u, self.in_proj.weight)
        return torch.split(proj, [self.d_inner, self.conv_dim, self.n_heads], dim=-1)

    def _dt(self, dt_raw):
        return softplus(dt_raw.float() + self.dt_bias.float())

    def _heads(self, bmat, lead):
        """(…, G·N) -> (…, H, N) f32: groups broadcast to heads."""
        g = bmat.reshape(*lead, self.n_groups, self.d_state)
        return g.repeat_interleave(self.n_heads // self.n_groups, dim=len(lead)).float()

    def forward(self, u):
        """u: (B, S, d_model) -> (B, S, d_model).  The chunk is ``chunk``
        when it divides S, else the whole sequence."""
        bsz, seq, _ = u.shape
        hn, pd = self.n_heads, self.head_dim
        z, xbc, dt_raw = self._project_in(u)
        xbc = silu(causal_conv1d(xbc, self.conv_w, self.conv_b))
        x, bmat, cmat = torch.split(
            xbc, [self.d_inner, self.n_groups * self.d_state, self.n_groups * self.d_state],
            dim=-1)
        dt = self._dt(dt_raw)  # (B, S, H)
        x = x.reshape(bsz, seq, hn, pd).float()
        bh, ch = self._heads(bmat, (bsz, seq)), self._heads(cmat, (bsz, seq))
        a_neg = -torch.exp(self.A_log.float())  # (H,) negative
        log_decay = dt * a_neg  # (B, S, H) per-step log decay (< 0)
        dtx = dt[..., None] * x  # (B, S, H, P)

        q = self.chunk if seq % self.chunk == 0 else seq
        nc = seq // q

        def chunks(t):
            return t.reshape((bsz, nc, q) + t.shape[2:])

        lc, dtxc, bc, cc = chunks(log_decay), chunks(dtx), chunks(bh), chunks(ch)
        cum = torch.cumsum(lc, dim=2)  # (B, nc, q, H) cumulative log decay
        # intra-chunk: decay(t, i) = exp(cum_t - cum_i) for i <= t.  The exp
        # runs on masked-safe values only: above the diagonal diff > 0 can
        # overflow, and where(tri, exp(diff), 0)'s gradient would then be
        # 0 · inf = NaN in every upstream parameter
        diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, t, i, H)
        tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=u.device))[
            None, None, :, :, None]
        zero = torch.zeros((), dtype=diff.dtype, device=u.device)
        dec = torch.where(tri, torch.exp(torch.where(tri, diff, zero)), zero)
        scores = torch.einsum("bcthn,bcihn->bctih", cc, bc) * dec
        y_intra = torch.einsum("bctih,bcihp->bcthp", scores, dtxc)
        # chunk states
        last = cum[:, :, -1:, :]  # (B, nc, 1, H)
        w_state = torch.exp(last - cum)  # decay from position i to the chunk's end
        s_chunk = torch.einsum("bcihn,bcihp->bchnp", bc * w_state[..., None], dtxc)
        chunk_decay = torch.exp(last[:, :, 0, :])  # (B, nc, H)
        # the inter-chunk recurrence: the state at each chunk's start
        s = torch.zeros((bsz, hn, self.d_state, pd), dtype=torch.float32, device=u.device)
        before = []
        for c in range(nc):
            before.append(s)
            s = s * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
        s_before = torch.stack(before, dim=1)  # (B, nc, H, N, P)
        y_inter = torch.einsum("bcthn,bchnp->bcthp", cc * torch.exp(cum)[..., None], s_before)
        y = (y_intra + y_inter).reshape(bsz, seq, hn, pd)
        y = y + self.D.float()[None, None, :, None] * x
        y = _gated_rmsnorm(y.reshape(bsz, seq, self.d_inner), z, self.norm_scale)
        return forward_matmul(y.to(u.dtype), self.out_proj.weight)

    # ---- decode -----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int = 0, dtype=None):
        """The SSM state in f32 and the conv window's last K-1 inputs in the
        model dtype; ``max_len`` is not used (the state is O(1))."""
        del max_len
        dev = self.conv_w.device
        return {
            "ssm": torch.zeros((batch, self.n_heads, self.d_state, self.head_dim),
                               dtype=torch.float32, device=dev),
            "conv": torch.zeros((batch, self.conv_width - 1, self.conv_dim),
                                dtype=dtype or self.dtype, device=dev),
        }

    def decode(self, u, cache, cache_len):
        """u: (B, 1, d_model).  One O(1) state update."""
        del cache_len
        bsz = u.shape[0]
        hn, pd = self.n_heads, self.head_dim
        z, xbc_new, dt_raw = self._project_in(u)
        win = torch.cat([cache["conv"], xbc_new], dim=1)  # (B, K, C)
        xbc = silu(torch.einsum("bkc,kc->bc", win, self.conv_w) + self.conv_b)
        x, bmat, cmat = torch.split(
            xbc, [self.d_inner, self.n_groups * self.d_state, self.n_groups * self.d_state],
            dim=-1)
        dt = self._dt(dt_raw)[:, 0]  # (B, H)
        x = x.reshape(bsz, hn, pd).float()
        bh, ch = self._heads(bmat, (bsz,)), self._heads(cmat, (bsz,))
        dec = torch.exp(dt * -torch.exp(self.A_log.float()))  # (B, H)
        d_skip = self.D.float()[None, :, None] * x
        split = sharding.cache_split("ssm")
        if split is not None:
            # the state (B, H, N, P) split over ``model`` (the reference's
            # rank-5 cache rule): this rank updates its piece; the output's
            # sum over N is all-reduced, a split H or P gathered
            dim, index, size = split

            def piece(t, d):
                n = t.shape[d] // size
                return t.narrow(d, index * n, n)

            if dim == 1:  # heads
                bh, ch, dt, dec, x = (piece(t, 1) for t in (bh, ch, dt, dec, x))
            elif dim == 2:  # d_state
                bh, ch = piece(bh, 2), piece(ch, 2)
            else:  # head_dim
                x = piece(x, 2)
        s_new = (cache["ssm"] * dec[:, :, None, None]
                 + torch.einsum("bhn,bhp->bhnp", bh * dt[..., None], x))
        y = torch.einsum("bhn,bhnp->bhp", ch, s_new)
        if split is not None:
            y = (sharding.reduce_from_model(y) if split[0] == 2
                 else sharding.gather_from_model(y, 1 if split[0] == 1 else 2))
        y = y + d_skip
        y = _gated_rmsnorm(y.reshape(bsz, 1, self.d_inner), z, self.norm_scale)
        y = forward_matmul(y.to(u.dtype), self.out_proj.weight)
        return y, {"ssm": s_new, "conv": win[:, 1:, :].to(cache["conv"].dtype)}

