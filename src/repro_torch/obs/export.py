"""Chrome-trace (Perfetto) JSON export.  Counterpart of
``repro/obs/export.py``.

``write`` serializes a ``TraceRecorder`` (training step spans, engine
ticks, request lifecycle tracks, all on the recorder's monotonic clock) to
the JSON object format (``{"traceEvents": [...]}``) that
``chrome://tracing`` and https://ui.perfetto.dev load.  The reference's
renderers of its simulator's timelines (``pipeline_to_trace``,
``serving_to_trace``) wait for the simulator's port.
"""

from __future__ import annotations

import json
import os

from repro_torch.obs.trace import TraceRecorder


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
