"""Span/event tracing in the Chrome-trace (Perfetto) event model.
Counterpart of ``repro/obs/trace.py``; pure host code.

A ``TraceRecorder`` accumulates trace events host-side as plain dicts in
the Chrome Trace Event Format (the JSON `chrome://tracing` / Perfetto
load directly):

* ``span`` — a synchronous "X" (complete) event; nests naturally on one
  track when spans open and close LIFO (the context manager guarantees
  it).  Used for training steps, engine ticks, drain/log intervals.
* ``instant`` — an "i" event (recalibration sweeps, hwmon warnings).
* ``counter`` — a "C" event; Perfetto charts the value series (slot
  occupancy, queue depth, drift gauges).
* ``async_begin/instant/end`` — "b"/"n"/"e" events keyed by ``id``; each
  id renders as its own async track.  The serve engine gives every
  request one id, so a request's QUEUED→PREFILL→DECODE lifecycle is one
  horizontal track per request.
* ``complete`` — an "X" event with *explicit* timestamps, for timelines
  that do not run on this host's clock (the reference's ``repro.sim``
  discrete-event schedules export through this).

Timestamps are microseconds on a monotonic clock, zeroed at recorder
creation, so traces are immune to wall-clock steps and line up with the
engine/trainer ``time.monotonic`` measurements.  ``obs.export``
serializes the recorder to a Perfetto-loadable JSON file.
"""

from __future__ import annotations

import contextlib
import time

# default pid/tid for host-side events; exporters claim other pids for
# simulated timelines so they land in separate process groups
HOST_PID = 1
HOST_TID = 1


class TraceRecorder:
    """Accumulates Chrome-trace events; see the module docstring."""

    def __init__(self):
        self.events: list[dict] = []
        self.t0 = time.monotonic()
        self._names: dict = {}  # (pid, tid|None) -> declared name

    # ---- clock ----
    def now_us(self) -> float:
        return (time.monotonic() - self.t0) * 1e6

    # ---- track naming (metadata events) ----
    def name_process(self, pid: int, name: str) -> None:
        if (pid, None) in self._names:
            return
        self._names[(pid, None)] = name
        self.events.append({"ph": "M", "name": "process_name", "pid": pid,
                            "tid": 0, "args": {"name": name}})

    def name_thread(self, pid: int, tid: int, name: str) -> None:
        if (pid, tid) in self._names:
            return
        self._names[(pid, tid)] = name
        self.events.append({"ph": "M", "name": "thread_name", "pid": pid,
                            "tid": tid, "args": {"name": name}})

    # ---- synchronous spans ----
    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host", pid: int = HOST_PID,
             tid: int = HOST_TID, **args):
        start = self.now_us()
        try:
            yield self
        finally:
            self.complete(name, start, self.now_us() - start, cat=cat,
                          pid=pid, tid=tid, **args)

    def complete(self, name: str, ts_us: float, dur_us: float,
                 cat: str = "host", pid: int = HOST_PID, tid: int = HOST_TID,
                 **args) -> None:
        ev = {"name": name, "cat": cat, "ph": "X", "ts": ts_us,
              "dur": dur_us, "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # ---- instants & counters ----
    def instant(self, name: str, cat: str = "host", pid: int = HOST_PID,
                tid: int = HOST_TID, ts_us: float | None = None,
                **args) -> None:
        ev = {"name": name, "cat": cat, "ph": "i",
              "ts": self.now_us() if ts_us is None else ts_us,
              "pid": pid, "tid": tid, "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, values: dict, cat: str = "host",
                pid: int = HOST_PID, ts_us: float | None = None) -> None:
        self.events.append({
            "name": name, "cat": cat, "ph": "C",
            "ts": self.now_us() if ts_us is None else ts_us,
            "pid": pid, "tid": 0,
            "args": {k: float(v) for k, v in values.items()}})

    # ---- async tracks (one per id) ----
    def _async(self, ph: str, name: str, track_id, cat: str,
               pid: int, ts_us: float | None, args: dict) -> None:
        ev = {"name": name, "cat": cat, "ph": ph, "id": track_id,
              "ts": self.now_us() if ts_us is None else ts_us,
              "pid": pid, "tid": HOST_TID}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def async_begin(self, name: str, track_id, cat: str = "async",
                    pid: int = HOST_PID, ts_us: float | None = None,
                    **args) -> None:
        self._async("b", name, track_id, cat, pid, ts_us, args)

    def async_instant(self, name: str, track_id, cat: str = "async",
                      pid: int = HOST_PID, ts_us: float | None = None,
                      **args) -> None:
        self._async("n", name, track_id, cat, pid, ts_us, args)

    def async_end(self, name: str, track_id, cat: str = "async",
                  pid: int = HOST_PID, ts_us: float | None = None,
                  **args) -> None:
        self._async("e", name, track_id, cat, pid, ts_us, args)

    # ---- serialization (see obs.export) ----
    def to_chrome(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}
