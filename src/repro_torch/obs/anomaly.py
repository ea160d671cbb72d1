"""Streaming anomaly detection over metric rows: EWMA center + MAD-proxy
bands, edge-triggered WARN alerts.  Counterpart of ``repro/obs/anomaly.py``.

A drifting chip, a dying bus, or an alignment collapse all show up as a
*step change* in some already-logged scalar (``hw_residual_rms``,
``align_global``, ``loss``, throughput) long before the loss curve is
obviously wrong.  ``AnomalyDetector`` watches a configurable set of row
keys and keeps, per metric, an exponential moving average of the value
and of its absolute deviation (a cheap streaming stand-in for the median
absolute deviation).  A sample outside ``center ± k·band`` fires ONE
alert at the crossing — like ``hwmon``'s drift-budget alerts, the
detector re-arms only after the metric returns inside the band, so a
sustained excursion is one named event, not a page per row.  Non-finite
samples always alert.

Statistics keep updating while out-of-band: a legitimate level shift
(e.g. loss dropping as training works) converges the center onto the new
level instead of alerting forever.  The ``Observer`` feeds every drained
row through ``observe`` and turns alerts into ``WARN:anomaly:<metric>``
trace instants, an ``anomaly_alerts`` counter, and an
``anomaly_<metric>`` flag on the JSONL row.  Pure host-side float
arithmetic on already-drained scalars — zero device work.
"""

from __future__ import annotations

import dataclasses
import math

# Row keys watched by default: the training signal, the probe's global
# alignment, the hardware drift residual, and throughput-ish gauges.
# Keys absent from a row are simply skipped, so one default serves
# ref/pallas/emu sessions alike.
DEFAULT_WATCH: tuple[str, ...] = (
    "loss", "align_global", "hw_residual_rms", "throughput", "steps_per_s")


@dataclasses.dataclass(frozen=True)
class AnomalyAlert:
    """One edge-triggered band crossing (or non-finite sample)."""

    step: int
    metric: str
    value: float
    center: float
    band: float
    message: str


class _Track:
    __slots__ = ("center", "spread", "n", "over")

    def __init__(self):
        self.center = 0.0
        self.spread = 0.0
        self.n = 0
        self.over = False


class AnomalyDetector:
    """EWMA + MAD-band detector over streaming metric rows.

    alpha: EWMA smoothing for both center and spread; k: band half-width
    in spread units (deviation > k·spread alerts); warmup: rows a metric
    must accumulate before it can alert (the bands need an estimate
    first).
    """

    def __init__(self, watch=DEFAULT_WATCH, *, alpha: float = 0.1,
                 k: float = 8.0, warmup: int = 8):
        self.watch = tuple(watch)
        self.alpha = float(alpha)
        self.k = float(k)
        self.warmup = int(warmup)
        self._tracks: dict[str, _Track] = {}
        self._alerts: list[AnomalyAlert] = []

    @property
    def alerts(self) -> tuple[AnomalyAlert, ...]:
        """Every alert fired over the detector's lifetime."""
        return tuple(self._alerts)

    def observe(self, step: int, scalars: dict) -> list[AnomalyAlert]:
        """Feed one drained row; -> alerts that fired on THIS row."""
        fired: list[AnomalyAlert] = []
        for name in self.watch:
            if name not in scalars:
                continue
            value = float(scalars[name])
            track = self._tracks.setdefault(name, _Track())
            alert = self._observe_one(track, step, name, value)
            if alert is not None:
                fired.append(alert)
        self._alerts.extend(fired)
        return fired

    def _observe_one(self, track, step, name, value):
        if not math.isfinite(value):
            alert = None
            if not track.over:
                alert = AnomalyAlert(
                    step=step, metric=name, value=value,
                    center=track.center, band=self.k * track.spread,
                    message=f"step {step}: {name}={value} is non-finite")
            track.over = True
            return alert  # poison the stats with nothing; keep center

        alert = None
        deviation = abs(value - track.center)
        # floor the band so flat-line series don't page on float jitter
        band = self.k * max(track.spread, 1e-3 * abs(track.center), 1e-9)
        if track.n >= self.warmup:
            outside = deviation > band
            if outside and not track.over:
                alert = AnomalyAlert(
                    step=step, metric=name, value=value,
                    center=track.center, band=band,
                    message=(f"step {step}: {name}={value:.6g} outside "
                             f"{track.center:.6g} ± {band:.6g}"))
            track.over = outside
        if track.n == 0:
            track.center = value
        else:
            a = self.alpha
            track.center = (1.0 - a) * track.center + a * value
            track.spread = (1.0 - a) * track.spread + a * deviation
        track.n += 1
        return alert
