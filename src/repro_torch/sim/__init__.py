"""``repro_torch.sim`` — discrete-event, component-timed simulation of the
photonic training pipeline (paper Fig. 3, Eqs. 2–4).  Counterpart of
``repro/sim``: pure host code, and every time, power and energy it reports
is the modelled photonic chip's, never a time of the card.

The static layer (``photonics.gemm_cycles``, ``core.energy``) counts
cycles and prices watts; this package answers the *temporal* questions:
what wall-clock speed does a schedule actually reach once DAC settling,
modulation, ring response, BPD/TIA rise, ADC conversion, and heater
updates overlap — and which (n_buses, bank tiling, f_s) schedule is the
fastest one that fits a power budget.

* ``components`` — per-stage timing/power models from
  ``PhotonicConfig``/``MRRConfig``/``EnergyConfig``
* ``pipeline``   — replays the emulator's own panel schedule
  (``hardware.channel.tile_operands``) as per-bus event timelines;
  ``forward_workload`` is the serving-side (inference GEMM) counterpart
  of ``dfa_backward_workload``
* ``serving``    — request-level timelines (arrivals → queueing →
  chunked prefill → decode rounds) with p50/p99 TTFT/latency, req/s and
  J/request per offered load
* ``autotune``   — searches the schedule space under a power budget
  (training) or an SLO + power budget (``autotune_serving``)

Entry points: ``api.build_session(schedule="auto")`` and
``launch/train.py --autotune``.
"""

from repro_torch.sim.autotune import (DEFAULT_BUS_COUNTS, DEFAULT_RECAL_CANDIDATES,
                                DEFAULT_SLOT_COUNTS, Candidate,
                                ServingCandidate, TunedSchedule, TunedServing,
                                autotune, autotune_serving,
                                expected_drift_sigma)
from repro_torch.sim.components import STAGES, StageTimes, bank_power_w, stage_times
from repro_torch.sim.pipeline import (Gemm, PipelineReport, dfa_backward_workload,
                                forward_workload, panel_schedule, simulate)
from repro_torch.sim.serving import (RequestSpec, ServiceModel, ServingReport,
                               poisson_requests, service_model,
                               simulate_serving)

__all__ = [
    "DEFAULT_BUS_COUNTS", "DEFAULT_RECAL_CANDIDATES", "DEFAULT_SLOT_COUNTS",
    "Candidate", "ServingCandidate", "TunedSchedule", "TunedServing",
    "autotune", "autotune_serving", "expected_drift_sigma",
    "STAGES", "StageTimes", "bank_power_w", "stage_times",
    "Gemm", "PipelineReport", "dfa_backward_workload", "forward_workload",
    "panel_schedule", "simulate",
    "RequestSpec", "ServiceModel", "ServingReport", "poisson_requests",
    "service_model", "simulate_serving",
]
