"""Continuous-batching serving engine with a prefill/decode split.

Counterpart of ``repro/serve/engine.py``.  A fixed pool of
``batch_slots`` cache slots (KV caches, or a recurrent model's states) is fed from an admission queue; each
request walks QUEUED → PREFILL → DECODE → DONE:

* **prefill** — the prompt is consumed in chunks of ``prefill_chunk``
  tokens, each chunk one batched forward that writes straight into the
  slot's cache (a recurrent model runs the masked decode-scan over the
  chunk, ``serve.decode.make_prefill_step``).  The logits after the last prompt token give the first
  output token.
* **decode** — one greedy step per tick across all slots.  Every slot runs
  (empty and finished ones included, with the token they hold), as in the
  reference: the per-tensor operand scales of the photonic bank span the
  whole batch.  Inactive slots keep their cache and token.

With a photonic backend (``"ref"``, ``"cuda"`` or ``"emu"``) every
``forward_matmul`` inside a step runs through ``photonics.forward_execution``;
``None`` (or ``"auto"``) keeps the exact digital forward.  A drifting
emulated device serves under ``drift.use_state(hw_state)``; serving never
advances the drift.  The model's device is the engine's device; steps run
under ``torch.no_grad``.

With an ``observer`` every request gets one async trace track (QUEUED →
PREFILL → DECODE → DONE with a FIRST_TOKEN instant), each prefill/decode
tick a span, and slot occupancy / queue depth an ``engine`` counter
series; the sinks are flushed when a run ends.  ``debug_checks`` runs the
prefill and decode steps under the ``lint.runtime`` sanitizers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs as obs_lib
from repro_torch.core import photonics as ph
from repro_torch.hardware import drift
from repro_torch.lint import runtime as lint_runtime
from repro_torch.serve.decode import make_prefill_step, make_serve_step, select_slots
from repro_torch.utils import prng

QUEUED = "QUEUED"
PREFILL = "PREFILL"
DECODE = "DECODE"
DONE = "DONE"


@dataclasses.dataclass
class Request:
    prompt: list
    max_new: int = 32
    out: list = dataclasses.field(default_factory=list)
    state: str = QUEUED
    submit_s: float | None = None
    first_token_s: float | None = None
    finish_s: float | None = None

    @property
    def done(self) -> bool:
        return self.state == DONE

    @property
    def ttft_s(self) -> float | None:
        if self.submit_s is None or self.first_token_s is None:
            return None
        return self.first_token_s - self.submit_s

    @property
    def latency_s(self) -> float | None:
        if self.submit_s is None or self.finish_s is None:
            return None
        return self.finish_s - self.submit_s


class Engine:
    """Continuous-batching engine over ``model.decode_step`` caches.

    ``backend``: None | "auto" (exact digital) | "ref" | "cuda" | "emu" | a
    ``PhotonicBackend``.  ``photonics``: the hardware config for a photonic
    backend; defaults to the "digital" preset switched on, and a backend
    that emulates stateful hardware gets ``MRRConfig()`` attached when the
    config has no device.  ``hw_state``: the drift state of a drifting
    device (default: a freshly calibrated chip, ``drift.init_state``).
    ``seed`` roots the bank-noise seeds: tick n draws from
    ``prng.fold(seed, n)``.  ``observer``: an ``obs.Observer`` (or True for
    a fresh one); None resolves to the shared null observer, which costs a
    few attribute lookups.  ``debug_checks``: every step's photonic
    products and outputs are checked finite (``lint.runtime``).
    """

    def __init__(self, model, *, batch_slots: int = 8, max_len: int = 512,
                 eos_id: int | None = None, prefill_chunk: int = 16,
                 backend=None, photonics=None, hw_state=None, seed: int = 0,
                 observer=None, debug_checks: bool = False):
        self.model = model
        self.observer = obs_lib.resolve(observer)
        self._req_seq = 0
        self._track_ids: dict[int, int] = {}  # id(request) -> async track id
        if self.observer.enabled:
            from repro_torch.obs.trace import HOST_PID, HOST_TID

            self.observer.trace.name_thread(HOST_PID, HOST_TID, "serve.Engine")
        self.device = model.device
        self.slots = batch_slots
        self.max_len = max_len
        self.eos = eos_id
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.caches = model.init_caches(batch_slots, max_len)
        self._cache_len = np.zeros((batch_slots,), np.int64)
        self._tokens = np.zeros((batch_slots, 1), np.int64)
        self._requests: list[Request | None] = [None] * batch_slots
        self._prompt_pos = [0] * batch_slots
        self._pending: list[Request] = []
        self._tick_no = 0
        self.stats = {"ticks": 0, "prefill_steps": 0, "prefill_tokens": 0,
                      "decode_steps": 0, "decode_tokens": 0}

        self._photonic = backend not in (None, "auto")
        self._key = None
        self.photonics = None
        self._backend = None
        self.hw_state = None
        if self._photonic:
            cfg = photonics if photonics is not None else dataclasses.replace(
                ph.PRESETS["digital"], enabled=True)
            if not cfg.enabled:
                cfg = dataclasses.replace(cfg, enabled=True)
            self._backend = ph.get_backend(backend)
            if self._backend.stateful_hardware and cfg.mrr is None:
                from repro_torch.hardware.mrr import MRRConfig

                cfg = dataclasses.replace(cfg, mrr=MRRConfig())
            self.photonics = cfg
            if cfg.mrr is not None and cfg.mrr.stateful:
                self.hw_state = (hw_state if hw_state is not None
                                 else drift.init_state(cfg, device=self.device))
            self._key = seed

        self._prefill_step = make_prefill_step(model)
        self._serve_step = make_serve_step(model)
        if debug_checks:
            self._prefill = lint_runtime.checked(self._prefill, "Engine.prefill")
            self._decode = lint_runtime.checked(self._decode, "Engine.decode")

    @contextlib.contextmanager
    def _execution(self, key):
        if not self._photonic:
            yield
            return
        hw = (drift.use_state(self.hw_state) if self.hw_state is not None
              else contextlib.nullcontext())
        with hw, ph.forward_execution(self.photonics, self._backend, key):
            yield

    def _tensor(self, x):
        return torch.as_tensor(x, device=self.device)

    def _prefill(self, tokens, n_valid, cache_len, key):
        with torch.no_grad(), self._execution(key):
            return self._prefill_step(tokens, n_valid, self.caches, cache_len)

    def _decode(self, token, cache_len, active, key):
        with torch.no_grad():
            with self._execution(key):
                nxt, logits, upd = self._serve_step(token, self.caches, cache_len)
            new_caches = select_slots(active, upd, self.caches)
            nxt = torch.where(active[:, None], nxt, token.to(nxt.dtype))
        return nxt, logits[:, -1, :], new_caches

    # ------------------------------------------------------------------ admin
    def submit(self, req: Request):
        if len(req.prompt) == 0:
            raise ValueError("empty prompt: a request must carry >= 1 prompt token")
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens does not fit max_len={self.max_len}")
        if req.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {req.max_new}")
        req.state = QUEUED
        req.submit_s = time.monotonic()
        self._pending.append(req)
        if self.observer.enabled:
            rid = self._req_seq
            self._req_seq += 1
            self._track_ids[id(req)] = rid
            tr = self.observer.trace
            tr.async_begin(f"request-{rid}", rid, cat="serve",
                           prompt_len=len(req.prompt), max_new=req.max_new)
            tr.async_begin(QUEUED, rid, cat="serve")

    def _admit(self):
        for i in range(self.slots):
            if self._requests[i] is None and self._pending:
                req = self._pending.pop(0)
                req.state = PREFILL
                if self.observer.enabled:
                    rid = self._track_ids.get(id(req))
                    if rid is not None:
                        tr = self.observer.trace
                        tr.async_end(QUEUED, rid, cat="serve")
                        tr.async_begin(PREFILL, rid, cat="serve", slot=i)
                self._requests[i] = req
                self._prompt_pos[i] = 0
                self._cache_len[i] = 0
                self._tokens[i, 0] = 0
                # reset this slot's cache in place: the engine owns the
                # tensors (zeros are fine: the length mask guards a KV
                # cache, and zero is a recurrent state's start)
                for c in self.caches.values():
                    c[:, i] = 0

    def _finish(self, i: int):
        req = self._requests[i]
        if self.observer.enabled:
            rid = self._track_ids.pop(id(req), None)
            if rid is not None:
                tr = self.observer.trace
                tr.async_end(req.state, rid, cat="serve")
                tr.async_end(f"request-{rid}", rid, cat="serve", new_tokens=len(req.out))
        req.state = DONE
        req.finish_s = time.monotonic()
        self._requests[i] = None

    def _next_key(self):
        if self._key is None:
            return None
        self._tick_no += 1
        return prng.fold(self._key, self._tick_no)

    # ------------------------------------------------------------------ phases
    def _prefill_tick(self):
        slots = [i for i, r in enumerate(self._requests)
                 if r is not None and r.state == PREFILL]
        if not slots:
            return False
        c = self.prefill_chunk
        chunk = np.zeros((self.slots, c), np.int64)
        n_valid = np.zeros((self.slots,), np.int64)
        for i in slots:
            req = self._requests[i]
            pos = self._prompt_pos[i]
            take = min(c, len(req.prompt) - pos)
            chunk[i, :take] = req.prompt[pos:pos + take]
            n_valid[i] = take
        with self.observer.span("prefill_tick", cat="serve", slots=len(slots),
                                tokens=int(n_valid.sum())):
            last, self.caches, _ = self._prefill(
                self._tensor(chunk), self._tensor(n_valid), self._tensor(self._cache_len),
                self._next_key())
        self.stats["prefill_steps"] += 1
        self.stats["prefill_tokens"] += int(n_valid.sum())
        self._cache_len[slots] += n_valid[slots]
        completed = [i for i in slots
                     if self._prompt_pos[i] + int(n_valid[i]) == len(self._requests[i].prompt)]
        for i in slots:
            self._prompt_pos[i] += int(n_valid[i])
        if completed:
            # intentional sync: finished prompts surface their first token
            first = torch.argmax(last, dim=-1).cpu().numpy()  # lint: disable=RL002 once a tick
            now = time.monotonic()
            for i in completed:
                req = self._requests[i]
                tok = int(first[i])
                req.out.append(tok)
                req.first_token_s = now
                req.state = DECODE
                if self.observer.enabled:
                    rid = self._track_ids.get(id(req))
                    if rid is not None:
                        tr = self.observer.trace
                        tr.async_end(PREFILL, rid, cat="serve")
                        tr.async_instant("FIRST_TOKEN", rid, cat="serve", token=tok)
                        tr.async_begin(DECODE, rid, cat="serve")
                self._tokens[i, 0] = tok
                if ((self.eos is not None and tok == self.eos)
                        or len(req.out) >= req.max_new
                        or self._cache_len[i] >= self.max_len):
                    self._finish(i)
        return True

    def _decode_tick(self):
        slots = [i for i, r in enumerate(self._requests)
                 if r is not None and r.state == DECODE]
        if not slots:
            return False
        active = np.zeros((self.slots,), bool)
        active[slots] = True
        with self.observer.span("decode_tick", cat="serve", slots=len(slots)):
            nxt, _, self.caches = self._decode(
                self._tensor(self._tokens), self._tensor(self._cache_len),
                self._tensor(active), self._next_key())
        # intentional sync: sampled tokens feed the host-side stop logic
        nxt = nxt.cpu().numpy()  # lint: disable=RL002 tokens leave the card once a tick
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += len(slots)
        self._cache_len[slots] += 1
        for i in slots:
            req = self._requests[i]
            tok = int(nxt[i, 0])
            req.out.append(tok)
            self._tokens[i, 0] = tok
            if ((self.eos is not None and tok == self.eos)
                    or len(req.out) >= req.max_new
                    or self._cache_len[i] >= self.max_len):
                self._finish(i)
        return True

    # ------------------------------------------------------------------ loop
    def tick(self):
        """One engine step: admit, one chunked-prefill forward over all
        prefilling slots, one batched decode step over all decoding slots."""
        self._admit()
        did_prefill = self._prefill_tick()
        did_decode = self._decode_tick()
        if self.observer.enabled:
            self.observer.counter("engine", {
                "active_slots": sum(r is not None for r in self._requests),
                "queued": len(self._pending)})
        if did_prefill or did_decode:
            self.stats["ticks"] += 1
            return True
        return False

    def run(self, requests: list[Request], max_ticks: int = 10_000):
        for r in requests:
            self.submit(r)
        ticks = 0
        try:
            while (self._pending or any(r is not None for r in self._requests)) and ticks < max_ticks:
                if not self.tick():
                    break
                ticks += 1
        finally:
            # interrupted or not, buffered observer JSONL reaches disk
            self.observer.flush()
        return requests, ticks

    def run_arrivals(self, requests: list[Request], arrivals, max_ticks: int = 1_000_000):
        """Serve ``requests`` submitted at wall-clock offsets ``arrivals``
        (seconds from start, sorted or not).  Returns (requests, ticks)."""
        order = sorted(range(len(requests)), key=lambda i: arrivals[i])
        t0 = time.monotonic()
        idx, ticks = 0, 0
        try:
            while ticks < max_ticks:
                now = time.monotonic() - t0
                while idx < len(order) and arrivals[order[idx]] <= now:
                    self.submit(requests[order[idx]])
                    idx += 1
                if self.tick():
                    ticks += 1
                elif idx < len(order):
                    time.sleep(min(1e-3, max(0.0,
                                             arrivals[order[idx]] - (time.monotonic() - t0))))
                else:
                    break
        finally:
            self.observer.flush()
        return requests, ticks
