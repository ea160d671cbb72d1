"""Request-level serving simulation on the photonic pipeline.
Counterpart of ``repro/sim/serving.py``; every time, power and energy here
is the modelled photonic chip's.

``sim.pipeline.simulate`` prices one batched forward; this module lifts
it to request *timelines*: Poisson (or trace) arrivals enter an
admission queue, are placed into a fixed pool of batch slots, and walk
the same prefill/decode rounds the real ``serve.Engine`` runs — chunked
prompt prefill, then one greedy token per decode round — with each
round's duration read from the pipeline simulator on the model's
``forward_workload``.

The per-round cost uses an exact affine collapse of the pipeline
timeline: with panel tiling, every bus streams ``T`` vectors through its
slot list back-to-back, so ``wall(T) = a·T + b`` where ``a`` is the
max-loaded bus's slot count times the cycle time and ``b`` is the
pipeline fill paid once per round (weight updates do not occur while
serving).  ``ServiceModel`` fits (a, b) from two simulator calls and the
DES then prices millions of rounds in O(1) each — the fit is exact, not
a regression (``wall(7) == a·7 + b`` against the full simulator).

Reports per offered load: p50/p99 TTFT and end-to-end latency,
requests/s, bank utilisation, and J/request (Eq. 4 wall-plug power
integrated over the makespan).  ``autotune_serving`` (sim.autotune)
searches (n_buses, f_s, batch_slots) under an SLO + power budget.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import photonics
from repro_torch.sim import pipeline


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One simulated request: arrival offset + token counts."""

    arrival_s: float
    prompt_len: int
    decode_len: int  # generated tokens incl. the prefill-emitted first one


def poisson_requests(rate: float, n: int, *, prompt_len: int = 64,
                     decode_len: int = 32, seed: int = 0) -> list[RequestSpec]:
    """``n`` requests with Poisson arrivals at ``rate`` req/s."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    return [RequestSpec(arrival_s=float(a), prompt_len=prompt_len,
                        decode_len=decode_len) for a in arrivals]


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Exact affine round-cost model: ``round_s(T) = a·T + b`` (T > 0)."""

    a: float  # seconds per streamed token
    b: float  # pipeline fill per round
    macs_per_token: float
    power_w: float
    peak_macs_per_s: float
    n_buses: int
    f_s: float

    def round_s(self, tokens: int) -> float:
        if tokens <= 0:
            return 0.0
        return self.a * tokens + self.b


def service_model(model, pcfg: photonics.PhotonicConfig, ecfg=None, *,
                  f_s: float | None = None, tiling: str = "panel") -> ServiceModel:
    """Fit the affine model from two pipeline simulations of the model's
    forward workload (T=1, T=2); exact because the panel timeline is
    affine in the streamed-vector count."""
    w1 = pipeline.forward_workload(model, 1)
    w2 = pipeline.forward_workload(model, 2)
    r1 = pipeline.simulate(w1, pcfg, ecfg, f_s=f_s, tiling=tiling,
                           include_weight_update=False)
    r2 = pipeline.simulate(w2, pcfg, ecfg, f_s=f_s, tiling=tiling,
                           include_weight_update=False)
    a = r2.wall_clock_s - r1.wall_clock_s
    b = r1.wall_clock_s - a
    return ServiceModel(a=a, b=b,
                        macs_per_token=float(sum(g.macs for g in w1)),
                        power_w=r1.power_w,
                        peak_macs_per_s=r1.peak_macs_per_s,
                        n_buses=r1.n_buses, f_s=r1.f_s)


@dataclasses.dataclass
class _Active:
    spec: RequestSpec
    prompt_left: int
    decode_left: int
    admit_s: float
    first_token_s: float | None = None
    record: dict | None = None  # trace-export lifecycle record (trace= only)


@dataclasses.dataclass
class ServingReport:
    """Request-level timeline summary at one offered load."""

    n_requests: int
    offered_rate: float  # n / last arrival (req/s offered)
    makespan_s: float
    requests_per_s: float  # achieved: n / makespan
    ttft_p50_s: float
    ttft_p99_s: float
    latency_p50_s: float
    latency_p99_s: float
    queue_p50_s: float  # admission wait (arrival -> slot)
    queue_p99_s: float
    prefill_tokens: int
    decode_tokens: int
    rounds: int
    utilisation: float  # useful MACs / (peak · makespan)
    busy_frac: float  # fraction of the makespan a round was streaming
    power_w: float
    energy_j: float
    j_per_request: float
    batch_slots: int
    prefill_chunk: int

    def as_metrics(self, prefix: str = "") -> dict:
        return {
            f"{prefix}offered_rate": self.offered_rate,
            f"{prefix}requests_per_s": self.requests_per_s,
            f"{prefix}ttft_p50_ms": self.ttft_p50_s * 1e3,
            f"{prefix}ttft_p99_ms": self.ttft_p99_s * 1e3,
            f"{prefix}latency_p50_ms": self.latency_p50_s * 1e3,
            f"{prefix}latency_p99_ms": self.latency_p99_s * 1e3,
            f"{prefix}queue_p99_ms": self.queue_p99_s * 1e3,
            f"{prefix}utilisation": self.utilisation,
            f"{prefix}power_w": self.power_w,
            f"{prefix}j_per_request": self.j_per_request,
        }


def simulate_serving(requests, svc: ServiceModel, *, batch_slots: int = 8,
                     prefill_chunk: int = 16,
                     trace=None) -> ServingReport:
    """Replay the engine's tick loop over simulated time.

    Each tick: admit arrived requests into free slots, run one chunked
    prefill round over all prefilling slots (duration =
    ``svc.round_s(total chunk tokens)``), then one decode round over all
    decoding slots (one token each).  A request's prompt completion emits
    its first token at the end of the prefill round (TTFT); remaining
    ``decode_len - 1`` tokens come one per decode round.  When the pool
    is idle, time jumps to the next arrival — queueing delay is the
    arrival→slot wait when it is not.

    ``trace`` exports the simulated timeline as Chrome-trace tracks
    (round spans + one async lifecycle track per request): pass an
    ``obs.TraceRecorder`` to accumulate into, or a path to write a
    standalone trace JSON.  ``None`` (the default) collects nothing.
    """
    if batch_slots < 1:
        raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
    prefill_chunk = max(1, int(prefill_chunk))
    pending = sorted(requests, key=lambda r: r.arrival_s)
    n = len(pending)
    if n == 0:
        raise ValueError("no requests")
    for r in pending:
        if r.prompt_len < 1 or r.decode_len < 1:
            raise ValueError(f"degenerate request {r}")
    idx = 0
    slots: list[_Active] = []
    t = 0.0
    busy_s = 0.0
    rounds = 0
    prefill_tokens = 0
    decode_tokens = 0
    ttft, latency, queue = [], [], []
    collect = trace is not None
    round_ev: list = []  # (kind, start_s, end_s, tokens, n_slots)
    req_ev: list = []  # lifecycle records for export.serving_to_trace

    def finish(s: _Active, now: float):
        latency.append(now - s.spec.arrival_s)
        ttft.append(s.first_token_s - s.spec.arrival_s)
        queue.append(s.admit_s - s.spec.arrival_s)
        if s.record is not None:
            s.record["first_token_s"] = s.first_token_s
            s.record["finish_s"] = now
        slots.remove(s)

    while idx < n or slots:
        if not slots and (idx < n and pending[idx].arrival_s > t):
            t = pending[idx].arrival_s  # idle pool: jump to next arrival
        while idx < n and pending[idx].arrival_s <= t and len(slots) < batch_slots:
            r = pending[idx]
            idx += 1
            rec = None
            if collect:
                rec = {"id": len(req_ev), "arrival_s": r.arrival_s,
                       "admit_s": t, "first_token_s": None, "finish_s": t,
                       "prompt_len": r.prompt_len, "decode_len": r.decode_len}
                req_ev.append(rec)
            slots.append(_Active(spec=r, prompt_left=r.prompt_len,
                                 decode_left=r.decode_len, admit_s=t,
                                 record=rec))
        # --- prefill round ---
        pf = [s for s in slots if s.prompt_left > 0]
        if pf:
            tok = sum(min(prefill_chunk, s.prompt_left) for s in pf)
            dur = svc.round_s(tok)
            if collect:
                round_ev.append(("prefill", t, t + dur, tok, len(pf)))
            t += dur
            busy_s += dur
            rounds += 1
            prefill_tokens += tok
            for s in pf:
                s.prompt_left -= min(prefill_chunk, s.prompt_left)
                if s.prompt_left == 0:
                    # the first output token falls out of the prefill
                    # forward itself — no extra decode-round MACs
                    s.first_token_s = t
                    s.decode_left -= 1
                    if s.decode_left == 0:
                        finish(s, t)
        # --- decode round ---
        dc = [s for s in slots if s.prompt_left == 0]
        if dc:
            dur = svc.round_s(len(dc))
            if collect:
                round_ev.append(("decode", t, t + dur, len(dc), len(dc)))
            t += dur
            busy_s += dur
            rounds += 1
            decode_tokens += len(dc)
            for s in dc:
                s.decode_left -= 1
                if s.decode_left == 0:
                    finish(s, t)

    makespan = t
    if collect:
        from repro_torch.obs import export  # lazy: obs is optional at sim time

        rec_, path = export.resolve_recorder(trace)
        export.serving_to_trace(round_ev, req_ev, rec_)
        if path is not None:
            export.write(rec_, path)
    useful_macs = svc.macs_per_token * (prefill_tokens + decode_tokens)
    energy = svc.power_w * makespan
    last_arrival = max(pending[-1].arrival_s, 1e-12)
    pct = lambda xs, q: float(np.percentile(np.asarray(xs), q))
    return ServingReport(
        n_requests=n,
        offered_rate=n / last_arrival,
        makespan_s=makespan,
        requests_per_s=n / makespan if makespan > 0 else 0.0,
        ttft_p50_s=pct(ttft, 50), ttft_p99_s=pct(ttft, 99),
        latency_p50_s=pct(latency, 50), latency_p99_s=pct(latency, 99),
        queue_p50_s=pct(queue, 50), queue_p99_s=pct(queue, 99),
        prefill_tokens=prefill_tokens,
        decode_tokens=decode_tokens,
        rounds=rounds,
        utilisation=(useful_macs / (svc.peak_macs_per_s * makespan)
                     if makespan > 0 else 0.0),
        busy_frac=busy_s / makespan if makespan > 0 else 0.0,
        power_w=svc.power_w,
        energy_j=energy,
        j_per_request=energy / n,
        batch_slots=batch_slots,
        prefill_chunk=prefill_chunk,
    )
