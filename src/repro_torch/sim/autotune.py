"""Schedule autotuner: the fastest feasible (n_buses, tiling, f_s).
Counterpart of ``repro/sim/autotune.py``; the powers and step times it
weighs are the modelled photonic chip's.

The knobs trade against each other under a wall-plug power budget:

* more buses — near-linear speedup on deep contractions (Eq. 2), but
  every bus adds its Eq. 4 ring/DAC/TIA/ADC stack (and, without a shared
  comb, its own laser stack);
* bank tiling — "panel" (the emulator's round-robin layout, per-GEMM bus
  quantization) vs "layer" (whole DFA layers per bus — coarser, but no
  idle-bus padding inside a GEMM);
* f_s — throughput is linear in the symbol rate, and so is the TIA term;
  under a tight budget, slower symbols can buy a bus that more than pays
  the rate back.

``autotune`` simulates every candidate with ``sim.pipeline.simulate`` on
the caller's actual workload and returns the fastest schedule whose
power fits the budget, with every evaluated candidate attached for
inspection (``TunedSchedule.candidates``).  ``api.build_session``
exposes it as ``schedule="auto"``; ``launch/train.py`` as ``--autotune``.

``autotune_serving`` is the serving-plane dual: it replays a request
trace through ``sim.serving.simulate_serving`` for every
(n_buses, f_s, batch_slots) candidate and returns the *cheapest* one
holding p99 end-to-end latency under an SLO — power is the objective
and latency the constraint, where training tuning is the reverse.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import photonics
from repro_torch.sim import components, pipeline

DEFAULT_BUS_COUNTS = (1, 2, 4, 8)
DEFAULT_TILINGS = ("panel", "layer")
DEFAULT_RECAL_CANDIDATES = (0, 100, 250, 500, 1000)


def expected_drift_sigma(device, recalibrate_every: int) -> float:
    """Expected per-ring detuning residual (OU model) at the end of a
    recalibration window of ``recalibrate_every`` training steps.

    The bank's resonance drift is the OU process of ``hardware.drift``:
    stationary σ = ``drift_sigma``, step time-constant ``drift_tau``.  A
    recalibration measures and cancels the drift up to ``cal_noise``; the
    residual then regrows toward stationary, so just before the next sweep

        σ_resid² = drift_sigma² · (1 − exp(−2·every/τ)) + cal_noise²

    ``recalibrate_every <= 0`` means never: the stationary drift_sigma.
    This is the accuracy proxy the autotuner holds under ``drift_budget``
    while pricing the sweep's sim-time cost (``PipelineReport.recal_s``).
    """
    if device is None or device.drift_sigma <= 0:
        return 0.0
    if recalibrate_every <= 0:
        return float(device.drift_sigma)
    grow = 1.0 - math.exp(-2.0 * recalibrate_every / device.drift_tau)
    return math.sqrt(device.drift_sigma ** 2 * grow + device.cal_noise ** 2)


@dataclasses.dataclass(frozen=True)
class Candidate:
    n_buses: int
    tiling: str
    f_s: float
    power_w: float
    feasible: bool
    wall_clock_s: float | None  # None when skipped on power
    report: pipeline.PipelineReport | None
    # recalibration co-tuning (defaults keep positional callers working)
    recalibrate_every: int = 0
    drift_resid: float = 0.0  # expected_drift_sigma at this cadence


@dataclasses.dataclass(frozen=True)
class TunedSchedule:
    """The winning schedule plus the full search record."""

    n_buses: int
    tiling: str
    f_s: float
    power_w: float
    report: pipeline.PipelineReport
    power_budget_w: float | None
    candidates: tuple
    # recalibration co-tuning (defaulted: pre-existing callers unchanged)
    recalibrate_every: int = 0
    drift_resid: float = 0.0
    drift_budget: float | None = None
    digital_s: float = 0.0

    @property
    def wall_clock_s(self) -> float:
        return self.report.wall_clock_s

    def apply(self, pcfg: photonics.PhotonicConfig) -> photonics.PhotonicConfig:
        """The tuned hardware description: bus count and symbol rate set.
        (Tiling is a scheduling policy, not a device property — the
        emulator always runs the "panel" layout; the math is identical.)
        """
        return dataclasses.replace(pcfg, n_buses=self.n_buses, f_s=self.f_s)

    def describe(self) -> str:
        r = self.report
        recal = (f" recal@{self.recalibrate_every} "
                 f"(σ_resid={self.drift_resid:.3f})"
                 if self.recalibrate_every > 0 else "")
        return (f"n_buses={self.n_buses} tiling={self.tiling} "
                f"f_s={self.f_s / 1e9:.2f}GHz -> "
                f"{r.wall_clock_s * 1e6:.2f}us/step "
                f"{r.macs_per_s / 1e12:.3f}TMAC/s {r.power_w:.1f}W "
                f"{r.pj_per_mac:.2f}pJ/MAC{recal}")


def default_f_s_grid(f_max: float) -> tuple:
    """Symbol-rate candidates: the DAC limit and two halvings of it."""
    return (f_max, f_max / 2.0, f_max / 4.0)


DEFAULT_SLOT_COUNTS = (4, 8, 16)


@dataclasses.dataclass(frozen=True)
class ServingCandidate:
    n_buses: int
    f_s: float
    batch_slots: int
    power_w: float
    feasible: bool  # fits the power budget
    meets_slo: bool
    p99_latency_s: float | None  # None when skipped on power
    requests_per_s: float | None
    report: object | None  # serving.ServingReport


@dataclasses.dataclass(frozen=True)
class TunedServing:
    """The cheapest SLO-meeting serving configuration + search record."""

    n_buses: int
    f_s: float
    batch_slots: int
    power_w: float
    report: object  # serving.ServingReport
    slo_p99_s: float
    power_budget_w: float | None
    candidates: tuple

    def apply(self, pcfg: photonics.PhotonicConfig) -> photonics.PhotonicConfig:
        """The tuned hardware description (batch_slots is an engine knob,
        not a device property — pass it to ``Engine``/``Session.engine``)."""
        return dataclasses.replace(pcfg, n_buses=self.n_buses, f_s=self.f_s)

    def describe(self) -> str:
        r = self.report
        return (f"n_buses={self.n_buses} f_s={self.f_s / 1e9:.2f}GHz "
                f"batch_slots={self.batch_slots} -> "
                f"p99 {r.latency_p99_s * 1e3:.2f}ms "
                f"{r.requests_per_s:.1f}req/s {self.power_w:.1f}W "
                f"{r.j_per_request * 1e3:.2f}mJ/req")


def autotune_serving(model, requests, pcfg: photonics.PhotonicConfig, ecfg=None, *,
                     slo_p99_s: float, power_budget_w: float | None = None,
                     bus_counts: tuple = DEFAULT_BUS_COUNTS,
                     f_s_grid: tuple | None = None,
                     slot_counts: tuple = DEFAULT_SLOT_COUNTS,
                     prefill_chunk: int = 16) -> TunedServing:
    """SLO-constrained serving search over (n_buses, f_s, batch_slots).

    Every candidate replays the *same* request trace through
    ``sim.serving.simulate_serving``; among candidates that fit the power
    budget AND hold p99 end-to-end latency under ``slo_p99_s``, the
    cheapest (lowest wall-plug power) wins, ties broken by higher
    requests/s — the serving dual of ``autotune``'s "fastest under a
    budget".  Raises ValueError when nothing meets the SLO in budget,
    naming the closest miss.
    """
    from repro_torch.sim import serving

    if f_s_grid is None:
        f_s_grid = default_f_s_grid(pcfg.f_s)
    candidates = []
    best = None
    closest = None  # least-bad p99 among in-budget candidates
    for n_buses in sorted(set(bus_counts)):
        cand_cfg = dataclasses.replace(pcfg, n_buses=n_buses)
        n_alive = photonics.active_buses(cand_cfg)
        for f_s in sorted(set(f_s_grid), reverse=True):
            power = components.bank_power_w(cand_cfg, ecfg, f_s=f_s,
                                            n_buses=n_alive)
            in_budget = power_budget_w is None or power <= power_budget_w
            if not in_budget:
                for slots in slot_counts:
                    candidates.append(ServingCandidate(
                        n_buses, f_s, slots, power, False, False,
                        None, None, None))
                continue
            svc = serving.service_model(model, cand_cfg, ecfg, f_s=f_s)
            for slots in sorted(set(slot_counts)):
                report = serving.simulate_serving(
                    requests, svc, batch_slots=slots,
                    prefill_chunk=prefill_chunk)
                meets = report.latency_p99_s <= slo_p99_s
                cand = ServingCandidate(
                    n_buses, f_s, slots, power, True, meets,
                    report.latency_p99_s, report.requests_per_s, report)
                candidates.append(cand)
                if closest is None or report.latency_p99_s < closest.p99_latency_s:
                    closest = cand
                if meets:
                    key = (power, -report.requests_per_s, n_buses)
                    if best is None or key < best[0]:
                        best = (key, cand)
    if best is None:
        if closest is None:
            min_power = min(c.power_w for c in candidates)
            raise ValueError(
                f"no serving candidate fits power_budget_w={power_budget_w:.2f} "
                f"(cheapest needs {min_power:.2f} W)")
        raise ValueError(
            f"no in-budget candidate meets p99 SLO {slo_p99_s * 1e3:.2f} ms "
            f"(closest: n_buses={closest.n_buses} f_s={closest.f_s / 1e9:.2f}GHz "
            f"batch_slots={closest.batch_slots} at "
            f"{closest.p99_latency_s * 1e3:.2f} ms)")
    _, cand = best
    return TunedServing(
        n_buses=cand.n_buses, f_s=cand.f_s, batch_slots=cand.batch_slots,
        power_w=cand.power_w, report=cand.report, slo_p99_s=slo_p99_s,
        power_budget_w=power_budget_w, candidates=tuple(candidates))


def autotune(workload, pcfg: photonics.PhotonicConfig, ecfg=None, *,
             power_budget_w: float | None = None,
             bus_counts: tuple = DEFAULT_BUS_COUNTS,
             f_s_grid: tuple | None = None,
             tilings: tuple = DEFAULT_TILINGS,
             include_weight_update: bool = True,
             digital_s: float = 0.0,
             recal_candidates: tuple = (0,),
             drift_budget: float | None = None) -> TunedSchedule:
    """Exhaustive search of the (small) schedule space on the real
    workload.  Raises ValueError when no candidate fits the budget.

    ``digital_s`` overlaps the measured host-side step time with every
    candidate timeline (``pipeline.simulate``'s max(compute, digital) —
    feed it from the fused-kernel bench).  ``recal_candidates`` widens the
    search over the recalibration cadence: each cadence pays its amortised
    heater sweep in sim time while ``expected_drift_sigma`` prices its
    accuracy; candidates whose expected residual exceeds ``drift_budget``
    are infeasible.  The fastest feasible schedule wins; ties go to lower
    power, fewer buses, then lower drift residual."""
    if f_s_grid is None:
        f_s_grid = default_f_s_grid(pcfg.f_s)
    device = pcfg.mrr
    recal_grid = tuple(sorted(set(int(e) for e in recal_candidates)))
    candidates = []
    best = None
    for n_buses in sorted(set(bus_counts)):
        # the chip's failed buses ride along: a degraded chip is tuned (and
        # its report priced) as the degraded chip it is — dead buses carry
        # no panels and draw no power, exactly as the session will run it
        cand_cfg = dataclasses.replace(pcfg, n_buses=n_buses)
        n_alive = photonics.active_buses(cand_cfg)
        for f_s in sorted(set(f_s_grid), reverse=True):
            power = components.bank_power_w(cand_cfg, ecfg, f_s=f_s,
                                            n_buses=n_alive)
            if power_budget_w is not None and power > power_budget_w:
                for tiling in tilings:
                    for every in recal_grid:
                        candidates.append(Candidate(
                            n_buses, tiling, f_s, power, False, None, None,
                            every, expected_drift_sigma(device, every)))
                continue
            for tiling in tilings:
                for every in recal_grid:
                    resid = expected_drift_sigma(device, every)
                    in_budget = drift_budget is None or resid <= drift_budget
                    report = pipeline.simulate(
                        workload, cand_cfg, ecfg, f_s=f_s, tiling=tiling,
                        include_weight_update=include_weight_update,
                        digital_s=digital_s, recalibrate_every=every)
                    cand = Candidate(n_buses, tiling, f_s, power, in_budget,
                                     report.wall_clock_s, report,
                                     every, resid)
                    candidates.append(cand)
                    if not in_budget:
                        continue
                    # fastest wins; ties go to the lower-power, fewer-bus
                    # chip, then the tighter-calibrated schedule
                    key = (report.wall_clock_s, power, n_buses, resid)
                    if best is None or key < best[0]:
                        best = (key, cand)
    if best is None:
        in_power = [c for c in candidates
                    if power_budget_w is None or c.power_w <= power_budget_w]
        if not in_power:
            min_power = min(c.power_w for c in candidates)
            raise ValueError(
                f"no schedule fits power_budget_w={power_budget_w:.2f} "
                f"(cheapest candidate needs {min_power:.2f} W)")
        min_resid = min(c.drift_resid for c in in_power)
        raise ValueError(
            f"no in-power schedule meets drift_budget={drift_budget:.4f} "
            f"(tightest cadence leaves σ_resid={min_resid:.4f} — add "
            f"smaller recal_candidates or relax the budget)")
    _, cand = best
    return TunedSchedule(
        n_buses=cand.n_buses, tiling=cand.tiling, f_s=cand.f_s,
        power_w=cand.power_w, report=cand.report,
        power_budget_w=power_budget_w, candidates=tuple(candidates),
        recalibrate_every=cand.recalibrate_every,
        drift_resid=cand.drift_resid, drift_budget=drift_budget,
        digital_s=digital_s)
