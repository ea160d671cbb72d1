"""Lightweight metrics: counters, gauges, histograms, pluggable sinks.
Counterpart of ``repro/obs/metrics.py``.

The registry is the host-side half of the metrics pipeline.  The contract
with the train step and the serving engine is: metrics computed on the
device are *returned* from the step as 0-d tensors in a dict — never read
inside the step — and the fit loop drains the whole dict with ONE
device-to-host transfer per logging interval (``Registry.drain``: one
``torch.stack`` of the scalars, one ``tolist``), never one blocking
``item()`` per scalar.

Sinks receive one row per ``record``/``emit`` call::

    {"t": <unix seconds>, "step": <int | None>, "metrics": {name: float}}

* ``MemorySink`` — bounded ring (introspection, tests, live dashboards)
* ``JsonlSink``  — one JSON object per line; ``repro_torch.obs.summarize``
  renders the file back into tables

Histograms keep a bounded sample window and compute linear-interpolation
percentiles (the numpy default — tests cross-check against
``np.percentile``).
"""

from __future__ import annotations

import collections
import json
import math
import os
import time

import torch


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-value-wins scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Bounded sample window with numpy-compatible percentiles."""

    __slots__ = ("name", "values")

    def __init__(self, name: str, window: int = 8192):
        self.name = name
        self.values: collections.deque = collections.deque(maxlen=window)

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    def __len__(self) -> int:
        return len(self.values)

    def percentile(self, q: float) -> float:
        """Linear-interpolation percentile (numpy's default method).
        ``q`` in [0, 100]."""
        if not self.values:
            raise ValueError(f"histogram {self.name!r} is empty")
        srt = sorted(self.values)
        rank = (q / 100.0) * (len(srt) - 1)
        lo = math.floor(rank)
        hi = math.ceil(rank)
        if lo == hi:
            return srt[int(rank)]
        frac = rank - lo
        return srt[lo] * (1.0 - frac) + srt[hi] * frac

    def summary(self) -> dict:
        srt = sorted(self.values)
        n = len(srt)
        return {
            "count": float(n),
            "mean": sum(srt) / n if n else float("nan"),
            "p50": self.percentile(50) if n else float("nan"),
            "p99": self.percentile(99) if n else float("nan"),
            "min": srt[0] if n else float("nan"),
            "max": srt[-1] if n else float("nan"),
        }


class MemorySink:
    """In-memory ring of the last ``capacity`` rows."""

    def __init__(self, capacity: int = 4096):
        self.rows: collections.deque = collections.deque(maxlen=capacity)

    def write(self, row: dict) -> None:
        self.rows.append(row)

    def close(self) -> None:
        pass


class JsonlSink:
    """Append-only JSONL file, one row per line (crash-safe: every row is
    flushed, so a killed run keeps everything logged so far, and a
    partial trailing line from a hard kill is truncated away on the next
    append-open — the file is parseable JSONL at every point in its
    life)."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._truncate_partial_tail(path)
        self._f = open(path, "a")

    @staticmethod
    def _truncate_partial_tail(path: str) -> None:
        """Drop an unterminated final line left by a run killed mid-write
        (every complete row ends in a newline, so anything after the last
        one is a torn write)."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return
        if size == 0:
            return
        with open(path, "rb+") as f:
            f.seek(-1, os.SEEK_END)
            if f.read(1) == b"\n":
                return
            f.seek(0)
            data = f.read()
            f.truncate(data.rfind(b"\n") + 1)

    def write(self, row: dict) -> None:
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def flush(self) -> None:
        if not self._f.closed:
            self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class Registry:
    """Named counters/gauges/histograms plus the sink fan-out."""

    def __init__(self, sinks: list | None = None):
        self.sinks = list(sinks or [])
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    # ---- instruments ----
    def counter(self, name: str) -> Counter:
        if name not in self._counters:
            self._counters[name] = Counter(name)
        return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        if name not in self._gauges:
            self._gauges[name] = Gauge(name)
        return self._gauges[name]

    def histogram(self, name: str, window: int = 8192) -> Histogram:
        if name not in self._hists:
            self._hists[name] = Histogram(name, window)
        return self._hists[name]

    # ---- the batched drain ----
    @staticmethod
    def drain(scalars) -> dict:
        """Metrics dict -> host float dict with one transfer per device.

        ``scalars`` may hold 0-d tensors (stacked per device and read with
        a single ``tolist``) or plain host numbers; the order is kept.
        """
        by_device: dict = {}
        for k, v in scalars.items():
            if isinstance(v, torch.Tensor):
                by_device.setdefault(v.device, []).append(k)
        host = {}
        for keys in by_device.values():
            vals = torch.stack([scalars[k].detach().reshape(()).float() for k in keys])
            host.update(zip(keys, vals.tolist()))
        return {k: host[k] if k in host else float(v) for k, v in scalars.items()}

    def record(self, step, scalars) -> dict:
        """Drain one logging interval's device metrics in a single
        transfer and fan the host floats out to gauges + sinks."""
        host = self.drain(scalars)
        for k, v in host.items():
            self.gauge(k).set(v)
        self.emit(step, host)
        return host

    def emit(self, step, metrics: dict) -> None:
        """Write one already-host-side row to every sink."""
        row = {"t": time.time(), "step": None if step is None else int(step),
               "metrics": dict(metrics)}
        for sink in self.sinks:
            sink.write(row)

    # ---- snapshot / teardown ----
    def snapshot(self) -> dict:
        """Flat view of every instrument's current value (histograms as
        their summary stats)."""
        out = {}
        for c in self._counters.values():
            out[c.name] = c.value
        for g in self._gauges.values():
            out[g.name] = g.value
        for h in self._hists.values():
            for stat, v in h.summary().items():
                out[f"{h.name}_{stat}"] = v
        return out

    def flush(self) -> None:
        """Best-effort flush of every sink that buffers (JSONL files) —
        the exception-path half of the crash-safe logging contract."""
        for sink in self.sinks:
            flush = getattr(sink, "flush", None)
            if flush is not None:
                flush()

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()
