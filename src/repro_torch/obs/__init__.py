"""``repro_torch.obs`` — observability: metrics, tracing, hardware health
monitoring and the diagnostics plane (alignment probe, noise-budget
attribution, anomaly detection) for training and serving.  Counterpart of
``repro/obs/__init__.py``.

One ``Observer`` bundles the planes:

* ``metrics`` (``obs.metrics.Registry``) — counters / gauges /
  histograms fanned out to pluggable sinks (in-memory ring, JSONL file).
  Device metrics are drained with ONE transfer per logging interval
  (``Observer.log_step``), never one blocking ``item()`` per scalar.
* ``trace`` (``obs.trace.TraceRecorder``) — Chrome-trace spans, instants,
  counters and per-request async tracks; ``obs.export`` writes the
  Perfetto-loadable JSON.
* ``hwmon`` (``obs.hwmon.HardwareMonitor``) — planned-vs-observed drift:
  the OU residual prediction for the run's recalibration cadence against
  the measured ``hw_residual_rms``, warn-level alerts when the drift
  budget is crossed, effective-bits and dead-ring gauges.  Attached only
  when the device actually drifts (``MRRConfig.stateful``).
* ``anomaly`` (``obs.anomaly.AnomalyDetector``) — EWMA + MAD bands over
  the drained rows (loss, alignment, ``hw_residual_rms``, throughput)
  firing edge-triggered ``WARN:anomaly:<metric>`` instants.

The in-situ diagnostics live beside this module:
``obs.introspect.AlignmentProbe`` (DFA-vs-BP alignment sampled every
``probe_every`` steps — ``build_session(probe_every=)``,
``launch/train.py --probe-every``) and ``obs.attribution.noise_budget``
(per-physical-source error decomposition on the emu backend, with the
analytic ``noise_sigma_total`` cross-check).

Wiring: ``api.build_session(observe=..., probe_every=...)`` /
``Session.fit(observer=)`` / ``Engine(observer=)``; ``launch/train.py``
and ``launch/serve.py`` expose ``--trace-out`` / ``--metrics-out``;
``python -m repro_torch.obs.summarize`` renders a metrics JSONL back into
tables (alignment and noise-budget tables included).

``NULL`` is the disabled-observer fast path: every method is a no-op and
``span`` returns one shared reusable context manager, so instrumented
code pays a constant few attribute lookups — no allocation — when
observability is off.
"""

from __future__ import annotations

import contextlib

from repro_torch.obs import export
from repro_torch.obs.anomaly import AnomalyAlert, AnomalyDetector
from repro_torch.obs.hwmon import HardwareMonitor, HwAlert
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, JsonlSink,
                               MemorySink, Registry)
from repro_torch.obs.trace import TraceRecorder


class Observer:
    """The bound (metrics, trace, hwmon, anomaly) bundle instrumented
    code talks to.

    All parts are optional; missing ones default to fresh in-memory
    instances (``hwmon`` to None — attach one via ``for_session`` or the
    constructor when the run carries hardware state; ``anomaly`` to a
    default-watch ``AnomalyDetector``).  ``metrics_path`` /
    ``trace_path`` add a JSONL sink / write the trace on ``close()``.
    """

    enabled = True

    def __init__(self, *, metrics: Registry | None = None,
                 trace: TraceRecorder | None = None,
                 hwmon: HardwareMonitor | None = None,
                 anomaly: AnomalyDetector | None = None,
                 metrics_path: str | None = None,
                 trace_path: str | None = None,
                 memory_capacity: int = 4096):
        if metrics is None:
            sinks: list = [MemorySink(memory_capacity)]
            if metrics_path:
                sinks.append(JsonlSink(metrics_path))
            metrics = Registry(sinks)
        elif metrics_path:
            metrics.sinks.append(JsonlSink(metrics_path))
        self.metrics = metrics
        self.trace = trace if trace is not None else TraceRecorder()
        self.hwmon = hwmon
        self.anomaly = anomaly if anomaly is not None else AnomalyDetector()
        self.trace_path = trace_path
        self._alerts_emitted = 0

    # ---- tracing passthrough ----
    def span(self, name: str, **args):
        return self.trace.span(name, **args)

    def event(self, name: str, **args) -> None:
        self.trace.instant(name, **args)

    def counter(self, name: str, values: dict) -> None:
        self.trace.counter(name, values)

    # ---- the per-logging-interval drain ----
    def log_step(self, step, device_metrics) -> dict:
        """Drain one interval's device metrics (one transfer, inside
        ``Registry.drain``), run the hardware
        monitor and the anomaly detector over the host scalars, chart the
        hw gauges as trace counters, and surface any new alert as a warn
        instant.  Returns the host-side scalar dict (hw gauges and
        anomaly flags merged in)."""
        host = self.metrics.drain(device_metrics)
        if self.hwmon is not None:
            gauges = self.hwmon.sample(step, host)
            if gauges:
                self.trace.counter("hwmon", gauges, cat="hwmon")
                host = {**host, **gauges}
            new = self.hwmon.alerts[self._alerts_emitted:]
            for alert in new:
                self.trace.instant(f"WARN:{alert.kind}", cat="hwmon",
                                   step=alert.step, value=alert.value,
                                   budget=alert.budget,
                                   message=alert.message)
                self.metrics.counter("hwmon_alerts").inc()
            self._alerts_emitted = len(self.hwmon.alerts)
        if self.anomaly is not None:
            for alert in self.anomaly.observe(step, host):
                self.trace.instant(f"WARN:anomaly:{alert.metric}",
                                   cat="anomaly", step=alert.step,
                                   value=alert.value, center=alert.center,
                                   band=alert.band, message=alert.message)
                self.metrics.counter("anomaly_alerts").inc()
                host = {**host, f"anomaly_{alert.metric}": 1.0}
        for k, v in host.items():
            self.metrics.gauge(k).set(v)
        self.metrics.emit(step, host)
        return host

    @property
    def alerts(self) -> list:
        """hwmon + anomaly alerts, in emission order per plane."""
        out: list = [] if self.hwmon is None else list(self.hwmon.alerts)
        if self.anomaly is not None:
            out.extend(self.anomaly.alerts)
        return out

    # ---- teardown ----
    def flush(self) -> None:
        """Push buffered sink bytes to disk — the fit/engine loops call
        this on the way out of an exception so an interrupted run still
        leaves parseable JSONL."""
        self.metrics.flush()

    def close(self) -> str | None:
        """Flush the sinks; write the trace when ``trace_path`` was given.
        Returns the trace path written (or None)."""
        self.metrics.close()
        if self.trace_path:
            return export.write(self.trace, self.trace_path)
        return None


class NullObserver:
    """Disabled observability: constant-cost no-ops, zero allocation.

    ``span`` hands back one shared reusable ``nullcontext`` and every
    other method returns immediately, so hot loops can call the observer
    unconditionally.
    """

    enabled = False
    _NULL_CTX = contextlib.nullcontext()

    def span(self, name: str, **args):
        return self._NULL_CTX

    def event(self, name: str, **args) -> None:
        pass

    def counter(self, name: str, values: dict) -> None:
        pass

    def log_step(self, step, device_metrics) -> dict:
        return {}

    @property
    def alerts(self) -> list:
        return []

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL = NullObserver()


def resolve(observer) -> Observer | NullObserver:
    """``observer=`` argument -> something instrumented code can call:
    None/False -> the shared NULL fast path; True -> a fresh in-memory
    Observer; an Observer/NullObserver passes through."""
    if observer is None or observer is False:
        return NULL
    if observer is True:
        return Observer()
    return observer


def for_session(session, *, metrics_path: str | None = None,
                trace_path: str | None = None) -> Observer:
    """An ``Observer`` wired for one ``api.Session``: when the session's
    backend carries stateful hardware AND the device actually drifts
    (``MRRConfig.stateful``), a ``HardwareMonitor`` is attached with the
    session's device description, recalibration cadence and — when the
    schedule autotuner planned one — its ``drift_budget``.  Drift-free
    devices (``emu_ideal``) and the ref/cuda backends get no monitor, so
    their rows carry no vacuous ``hw_*`` gauges."""
    hwmon = None
    cfg = session.config
    device = cfg.dfa.photonics.mrr
    if (getattr(session.trainer, "_hw_stateful", False)
            and device is not None and device.stateful):
        budget = None
        if session.schedule is not None:
            budget = session.schedule.drift_budget
        hwmon = HardwareMonitor(
            device, recalibrate_every=cfg.recalibrate_every, drift_budget=budget,
            n_failed_buses=len(cfg.dfa.photonics.failed_buses))
    return Observer(hwmon=hwmon, metrics_path=metrics_path,
                    trace_path=trace_path)


__all__ = [
    "AnomalyAlert", "AnomalyDetector", "Counter", "Gauge",
    "HardwareMonitor", "Histogram", "HwAlert", "JsonlSink", "MemorySink",
    "NULL", "NullObserver", "Observer", "Registry", "TraceRecorder",
    "export", "for_session", "resolve",
]
