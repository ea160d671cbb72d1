"""Chrome-trace (Perfetto) JSON export, including simulated timelines.
Counterpart of ``repro/obs/export.py``.

Two kinds of timeline meet in one trace file:

* host timelines — whatever a ``TraceRecorder`` collected live (training
  step spans, engine ticks, request lifecycle tracks), stamped on the
  recorder's monotonic clock;
* simulated timelines — ``repro_torch.sim`` discrete-event schedules of
  the modelled photonic chip, stamped in *simulated* seconds from zero.
  ``pipeline_to_trace`` renders a ``PipelineReport``'s per-bus per-stage
  events as one track per (bus, stage) pair; ``serving_to_trace`` renders
  a serving simulation's rounds and per-request lifecycle tracks.

Simulated timelines claim their own pids (process groups) so they never
interleave with host tracks.  ``write`` serializes any recorder to the
JSON object format (``{"traceEvents": [...]}``) that ``chrome://tracing``
and https://ui.perfetto.dev load.
"""

from __future__ import annotations

import json
import os

from repro_torch.obs.trace import TraceRecorder

# process ids for simulated timelines (host events use trace.HOST_PID)
SIM_PIPELINE_PID = 100
SIM_SERVING_PID = 101


def write(recorder: TraceRecorder, path: str) -> str:
    """Serialize the recorder as Perfetto-loadable JSON; returns ``path``."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(recorder.to_chrome(), f)
        f.write("\n")
    return path


def resolve_recorder(trace) -> tuple[TraceRecorder, str | None]:
    """A ``trace=`` argument (recorder | path | None) -> (recorder, path to
    write on completion or None).  ``None`` creates a fresh recorder."""
    if trace is None or isinstance(trace, TraceRecorder):
        return (trace if trace is not None else TraceRecorder()), None
    if isinstance(trace, str):
        return TraceRecorder(), trace
    raise TypeError(f"trace must be a TraceRecorder or a path, got {trace!r}")


def pipeline_to_trace(report, recorder: TraceRecorder | None = None,
                      pid: int = SIM_PIPELINE_PID) -> TraceRecorder:
    """Export a ``sim.pipeline.PipelineReport``'s event timeline as one
    Chrome-trace track per (bus, stage).

    Simulated seconds map to trace microseconds from 0.  Stage tracks are
    ordered in signal order per bus, so the pipeline skew (mod after dac,
    adc last, the off-pipeline heater epilogue) reads top-to-bottom the
    way the paper's Fig. 3 draws it.  Track durations sum to exactly the
    ``stage_busy`` the report's ``occupancy`` was computed from (as long
    as the event sample was not capped — ``sim.pipeline.MAX_EVENTS``).
    """
    rec = recorder if recorder is not None else TraceRecorder()
    stages = _report_stages(report)
    order = {s: i for i, s in enumerate(stages)}
    rec.name_process(pid, f"sim.pipeline ({report.tiling} tiling, "
                          f"{report.n_buses} buses)")
    for bus, stage, start_s, end_s, gemm in report.events:
        tid = bus * len(stages) + order[stage]
        rec.name_thread(pid, tid, f"bus{bus}/{stage}")
        rec.complete(gemm, start_s * 1e6, (end_s - start_s) * 1e6,
                     cat="sim.pipeline", pid=pid, tid=tid, stage=stage,
                     bus=bus)
    for stage, occ in report.occupancy.items():
        rec.counter(f"occupancy/{stage}", {"busy_frac": occ},
                    cat="sim.pipeline", pid=pid, ts_us=0.0)
    rec.instant("pipeline-report", cat="sim.pipeline", pid=pid,
                tid=0, ts_us=report.wall_clock_s * 1e6,
                wall_clock_us=report.wall_clock_s * 1e6,
                macs_per_s=report.macs_per_s,
                utilisation=report.utilisation,
                pj_per_mac=report.pj_per_mac)
    return rec


def _report_stages(report) -> tuple:
    from repro_torch.sim.components import STAGES

    return tuple(STAGES) + ("heater",)


def serving_to_trace(rounds, requests, recorder: TraceRecorder | None = None,
                     pid: int = SIM_SERVING_PID) -> TraceRecorder:
    """Export a serving simulation as round spans + per-request tracks.

    ``rounds``   — (kind, start_s, end_s, tokens, n_slots) tuples
    ``requests`` — dicts with ``id``, ``arrival_s``, ``admit_s``,
                   ``first_token_s``, ``finish_s`` (simulated seconds)
    """
    rec = recorder if recorder is not None else TraceRecorder()
    rec.name_process(pid, "sim.serving")
    rec.name_thread(pid, 1, "rounds")
    for kind, start_s, end_s, tokens, n_slots in rounds:
        rec.complete(kind, start_s * 1e6, (end_s - start_s) * 1e6,
                     cat="sim.serving", pid=pid, tid=1, tokens=tokens,
                     slots=n_slots)
    for r in requests:
        track = f"request-{r['id']}"
        rec.async_begin(track, r["id"], cat="sim.serving", pid=pid,
                        ts_us=r["arrival_s"] * 1e6,
                        prompt_len=r.get("prompt_len", 0),
                        decode_len=r.get("decode_len", 0))
        rec.async_instant("ADMIT", r["id"], cat="sim.serving", pid=pid,
                          ts_us=r["admit_s"] * 1e6)
        if r.get("first_token_s") is not None:
            rec.async_instant("FIRST_TOKEN", r["id"], cat="sim.serving",
                              pid=pid, ts_us=r["first_token_s"] * 1e6)
        rec.async_end(track, r["id"], cat="sim.serving", pid=pid,
                      ts_us=r["finish_s"] * 1e6)
    return rec
