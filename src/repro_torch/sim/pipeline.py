"""Timing-accurate replay of the photonic training pipeline.
Counterpart of ``repro/sim/pipeline.py``; every time, power and energy here
is the modelled photonic chip's, never a time of the card.

``simulate`` takes the *same* panel schedule the emulator executes — the
bus-tiled layout of ``hardware.channel.tile_operands``, read shape-only
by running it on ``meta`` tensors (nothing allocated) so simulator and
emulator can never disagree about what runs when — and expands it into
per-bus event timelines over the component stages of ``sim.components``:

* every (row-block i, bus-cycle j) panel slot on a bus streams the
  GEMM's T input vectors through the 5-stage chain at one vector per
  operational cycle (the paper's Fig. 3 pipelining);
* DFA's backward has no inter-layer dependency, so buses roll straight
  from one layer's panels into the next with the pipeline still full —
  the fill latency is paid once per bus, not once per GEMM;
* panel slots padded onto idle buses (indivisible panel counts) occupy
  schedule time but do no useful MACs — exactly the occupancy loss
  ``photonics.n_bank_passes``'s ceiling division implies;
* the optional weight-update epilogue prices the once-per-training-step
  heater write of the forward banks (thermal settling, µs — the one
  activity that is NOT hidden by pipelining).

Two panel→bus assignment policies ("bank tiling"):

* ``"panel"`` — the emulator's schedule: each GEMM's contraction panels
  round-robin across the alive buses (cycle identity with
  ``photonics.gemm_cycles`` / ``n_bank_passes`` holds per GEMM);
* ``"layer"`` — whole GEMMs (DFA's independent per-layer projections,
  Fig. 3) are placed greedily on the least-loaded bus; no per-GEMM bus
  quantization, but a layer never spans buses.  The numerics are
  identical either way (scheduling does not change the math) — only the
  timeline differs, which is why the autotuner may pick it.

Energy integrates Eq. 4 wall-plug power (``core.energy.total_power``,
single source of truth) over the simulated makespan; for pipelined
schedules this lands within <1% of ``energy.dfa_backward_cost``'s static
cycles/f_s pricing.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import energy as energy_lib
from repro_torch.core import photonics
from repro_torch.sim import components

# cap on the per-stage event records kept in a report (the timeline is
# aggregated exactly either way; events are for introspection/plots)
MAX_EVENTS = 4096


@dataclasses.dataclass(frozen=True)
class Gemm:
    """One weight-bank product of the training step: (T, K) · (M, K)ᵀ —
    T streamed vectors against an inscribed M×K matrix panel-set."""

    name: str
    t: int  # streamed input vectors (batch × tokens)
    m: int  # output dim (rows of the inscribed matrix)
    k: int  # contraction dim (the error-tap width for DFA feedback)

    @property
    def macs(self) -> int:
        return self.t * self.m * self.k


def dfa_backward_workload(model, t: int) -> list[Gemm]:
    """The paper's unit of work: every hidden layer's feedback projection
    e·B(k)ᵀ for one training step of ``t`` examples (tokens), read from
    the model's segment specs — the same structure the DFA engine runs."""
    d_tap = model.d_tap
    work = []
    for spec in model.segment_specs():
        for i in range(spec.n_layers):
            work.append(Gemm(name=f"{spec.name}[{i}]", t=t,
                             m=spec.d_inject, k=d_tap))
    return work


def forward_workload(model, t: int) -> list[Gemm]:
    """The serving unit of work: every weight-stationary forward projection
    of ``t`` streamed tokens, read from the model's forward GEMM specs —
    the projections the engine routes through ``photonics.forward_matmul``
    when serving on a photonic backend."""
    return [Gemm(name=name, t=t, m=m, k=k)
            for name, m, k in model.forward_gemm_specs()]


@functools.lru_cache(maxsize=4096)
def _panel_layout(m: int, k: int, pcfg: photonics.PhotonicConfig):
    """T-independent part of ``panel_schedule`` — memoised: serving sims
    replay the same per-layer layout at thousands of (candidate, round)
    points, and re-tiling would dominate the DES."""
    from repro_torch.hardware import channel  # lazy: channel imports photonics

    a = torch.empty((1, k), device="meta")
    b = torch.empty((m, k), device="meta")
    a_t, b_t, _ = channel.tile_operands(a, b, pcfg)
    nm, n_alive, _rows, nj, _cols = b_t.shape
    assert a_t.shape[1:3] == (n_alive, nj)
    n_panels = photonics.n_contraction_panels(k, pcfg)
    assert nj == -(-n_panels // n_alive)  # the emulator's own ceiling
    return nm, n_alive, nj, n_panels


def panel_schedule(gemm: Gemm, pcfg: photonics.PhotonicConfig):
    """The GEMM's bus-tiled panel layout, straight from the emulator.

    Shape-only (``channel.tile_operands`` on ``meta`` tensors — no
    allocation at any T).  Returns (nm, n_alive, nj, n_panels): row
    blocks, alive buses, bus-cycles, and real contraction panels; slot
    (i, j) on alive bus q is real iff j·n_alive + q < n_panels.
    """
    return _panel_layout(gemm.m, gemm.k, pcfg)


@dataclasses.dataclass
class PipelineReport:
    """One simulated training-step timeline and its headline numbers."""

    wall_clock_s: float  # makespan incl. the weight-update epilogue
    compute_s: float  # streaming makespan (panels through the pipeline)
    weight_update_s: float  # heater epilogue (0 when disabled)
    cycles: int  # schedule length in operational cycles (max over buses)
    cycles_per_gemm: dict  # name -> per-bus slot count (panel tiling)
    macs: int  # useful MACs (real panels only)
    macs_per_s: float  # sustained: macs / wall_clock_s
    peak_macs_per_s: float  # f_s · rows · cols · alive buses
    utilisation: float  # sustained / peak
    occupancy: dict  # stage -> busy fraction of (alive buses × wall)
    bus_busy_s: list  # per alive bus: useful streaming time
    power_w: float  # Eq. 4 wall-plug power of the modelled chip
    energy_j: float  # power × wall_clock_s
    energy_compute_j: float  # power × compute_s (Eq. 2/4 cross-check)
    pj_per_mac: float
    n_buses: int  # alive buses the schedule ran on
    f_s: float
    tiling: str
    events: list  # (bus, stage, start_s, end_s, gemm) — capped sample
    # measured-feedback overlap model (defaults keep positional callers
    # working): the host's digital step time runs concurrently with the
    # photonic stream, and in-situ recalibration amortises a heater sweep
    digital_s: float = 0.0  # measured digital-side step time (overlapped)
    recal_s: float = 0.0  # amortised per-step recalibration epilogue
    recalibrate_every: int = 0  # cadence the recal_s amortisation assumes

    def as_metrics(self, prefix: str = "") -> dict:
        """Flat numeric view for BENCH_*.json emission."""
        out = {
            f"{prefix}wall_clock_us": self.wall_clock_s * 1e6,
            f"{prefix}compute_us": self.compute_s * 1e6,
            f"{prefix}cycles": float(self.cycles),
            f"{prefix}macs_per_s": self.macs_per_s,
            f"{prefix}utilisation": self.utilisation,
            f"{prefix}pj_per_mac": self.pj_per_mac,
            f"{prefix}power_w": self.power_w,
            f"{prefix}digital_us": self.digital_s * 1e6,
            f"{prefix}recal_us": self.recal_s * 1e6,
        }
        for stage, occ in self.occupancy.items():
            out[f"{prefix}occ_{stage}"] = occ
        return out


def _assign_slots(workload, pcfg, tiling: str):
    """Per-bus ordered slot lists: (gemm, n_slots, n_real_slots) runs.

    "panel": every GEMM spreads its panels over all alive buses (the
    emulator's layout).  "layer": whole GEMMs go to the least-loaded bus.
    Returns (per_bus_runs, cycles_per_gemm, n_alive).
    """
    n_alive = photonics.active_buses(pcfg)
    per_bus: list[list] = [[] for _ in range(n_alive)]
    cycles_per_gemm: dict[str, int] = {}
    if tiling == "panel":
        for g in workload:
            nm, nb, nj, n_panels = panel_schedule(g, pcfg)
            cycles_per_gemm[g.name] = nm * nj
            for q in range(nb):
                real = sum(1 for j in range(nj) if j * nb + q < n_panels)
                per_bus[q].append((g, nm * nj, nm * real))
    elif tiling == "layer":
        # greedy longest-processing-time: heaviest layers placed first on
        # the least-loaded bus; each layer runs single-bus (nm × n_panels
        # slots, no idle-bus padding)
        load = [0.0] * n_alive
        single = dataclasses.replace(pcfg, n_buses=1, failed_buses=())
        sized = []
        for g in workload:
            nm, _nb, nj, n_panels = panel_schedule(g, single)
            assert nj == n_panels
            sized.append((g, nm * n_panels))
            cycles_per_gemm[g.name] = nm * n_panels
        for g, slots in sorted(sized, key=lambda s: -s[1] * s[0].t):
            q = min(range(n_alive), key=lambda i: load[i])
            per_bus[q].append((g, slots, slots))
            load[q] += slots * g.t
    else:
        raise ValueError(f"unknown tiling {tiling!r} (panel | layer)")
    return per_bus, cycles_per_gemm, n_alive


def simulate(workload, pcfg: photonics.PhotonicConfig, ecfg=None, *,
             f_s: float | None = None, tiling: str = "panel",
             include_weight_update: bool = True,
             digital_s: float = 0.0,
             recalibrate_every: int = 0,
             trace=None) -> PipelineReport:
    """Replay one training step's panel schedule as per-bus event
    timelines; see the module docstring for the event model.

    ``digital_s`` is the measured host-side (digital) step time — quant
    prep, optimizer, bookkeeping — which runs concurrently with the
    photonic stream, so the step's front half is max(compute, digital)
    (feed it from ``BENCH_emu_kernel``'s fused-step measurement).
    ``recalibrate_every`` > 0 amortises one in-situ recalibration heater
    sweep (``st.heater``) over that many steps as a per-step epilogue —
    the sim-time cost the autotuner weighs against drift accuracy.

    ``trace`` exports the event timeline as Chrome-trace tracks (one per
    bus × stage, viewable in Perfetto): pass an ``obs.TraceRecorder`` to
    accumulate into, or a path to write a standalone trace JSON."""
    if not workload:
        raise ValueError("empty workload")
    st = components.stage_times(pcfg, f_s=f_s)
    ecfg = ecfg or energy_lib.EnergyConfig()
    per_bus, cycles_per_gemm, n_alive = _assign_slots(workload, pcfg, tiling)

    events = []
    bus_end = [0.0] * n_alive
    bus_busy = [0.0] * n_alive
    stage_busy = {s: 0.0 for s in components.STAGES}
    stage_busy["heater"] = 0.0
    for q in range(n_alive):
        now = 0.0
        for g, n_slots, n_real in per_bus[q]:
            # contiguous stream: n_slots panel slots × T samples each, one
            # sample per cycle — the pipeline never drains between slots
            # (fixed feedback weights; panel select is a routing choice,
            # not a thermal re-inscription)
            dur = n_slots * g.t * st.ii
            offset = 0.0
            for stage in components.STAGES:
                if len(events) < MAX_EVENTS:
                    events.append((q, stage, now + offset,
                                   now + offset + dur, g.name))
                stage_busy[stage] += dur
                offset += st.latency(stage)
            bus_busy[q] += n_real * g.t * st.ii
            now += dur
        if per_bus[q]:
            # the last sample's contribution clears the ADC one fill after
            # its cycle started — paid once per bus, the pipeline depth
            now += st.fill - st.ii
        bus_end[q] = now

    compute_s = max(bus_end)
    weight_update_s = 0.0
    if include_weight_update:
        # per-step epilogue: the forward banks take their weight update
        # through the heater DACs — thermal settling, in parallel across
        # buses but unhidden by the sample pipeline
        weight_update_s = st.heater
        for q in range(n_alive):
            if len(events) < MAX_EVENTS:
                events.append((q, "heater", compute_s,
                               compute_s + st.heater, "weight-update"))
            stage_busy["heater"] += st.heater
    recal_s = st.heater / recalibrate_every if recalibrate_every > 0 else 0.0
    wall = max(compute_s, digital_s) + weight_update_s + recal_s

    total_cycles = max(
        sum(n_slots for _g, n_slots, _r in per_bus[q]) for q in range(n_alive))
    macs = sum(g.macs for g in workload)
    f = 1.0 / st.ii
    peak = f * pcfg.bank_rows * pcfg.bank_cols * n_alive
    power = components.bank_power_w(pcfg, ecfg, f_s=f, n_buses=n_alive)
    energy_j = power * wall
    occupancy = {s: (b / (n_alive * wall) if wall > 0 else 0.0)
                 for s, b in stage_busy.items()}
    report = PipelineReport(
        wall_clock_s=wall,
        compute_s=compute_s,
        weight_update_s=weight_update_s,
        cycles=total_cycles,
        cycles_per_gemm=cycles_per_gemm,
        macs=macs,
        macs_per_s=macs / wall if wall > 0 else 0.0,
        peak_macs_per_s=peak,
        utilisation=(macs / wall) / peak if wall > 0 and peak > 0 else 0.0,
        occupancy=occupancy,
        bus_busy_s=bus_busy,
        power_w=power,
        energy_j=energy_j,
        energy_compute_j=power * compute_s,
        pj_per_mac=energy_j / macs * 1e12 if macs else float("inf"),
        n_buses=n_alive,
        f_s=f,
        tiling=tiling,
        events=events,
        digital_s=digital_s,
        recal_s=recal_s,
        recalibrate_every=recalibrate_every,
    )
    if trace is not None:
        from repro_torch.obs import export  # lazy: obs is optional at sim time

        rec, path = export.resolve_recorder(trace)
        export.pipeline_to_trace(report, rec)
        if path is not None:
            export.write(rec, path)
    return report
