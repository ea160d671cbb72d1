"""Step-level throughput telemetry.  Counterpart of
``repro/bench/telemetry.py``.

A ``StepTimer`` threaded through ``Trainer.fit`` records the wall time of
each step *after* synchronising the trainer's CUDA device (the card runs
asynchronously, so per-step timing is otherwise the host's dispatch time;
the reference blocks on ``jax.block_until_ready``), discards the warmup
steps that pay first-call costs (the kernels' build, cuBLAS handles), and
derives

* ``steps_per_s``     — 1 / mean measured step time
* ``examples_per_s``  — steps/s × global batch size
* ``macs_per_s``      — steps/s × per-device MACs (``utils.flop_cost``
                        flops / 2) × device count

``bench.report`` serializes the summary as BENCH_*.json for CI to archive.
"""

from __future__ import annotations

import time

import torch


def _percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile of an already-sorted non-empty list."""
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return float(sorted_vals[idx])


class StepTimer:
    """Wall-time-per-step recorder for ``Trainer.fit(..., timer=...)``.

    Usage::

        timer = StepTimer(warmup=4)
        session.fit(data_fn, total_steps=32, timer=timer)
        timer.set_step_cost(flops_per_device=cost.flops)
        summary = timer.summary()   # steps_per_s, examples_per_s, macs_per_s
    """

    def __init__(self, warmup: int = 2, examples_per_step: int | None = None):
        self.warmup = max(0, int(warmup))
        self.examples_per_step = examples_per_step
        self.times: list[float] = []  # post-warmup step wall times (s)
        self._seen = 0
        self._last: float | None = None
        self._flops_per_device: float | None = None
        self._device_count: int | None = None

    # ---- recording (called by the fit loop) ----
    def start(self) -> None:
        self._last = time.perf_counter()

    def tick(self, sync=None) -> None:
        """Record one step boundary; ``sync`` (a device or a tensor) is
        synchronised first when it is a CUDA device, so the measurement
        covers the device compute, not just dispatch."""
        if sync is not None:
            device = sync.device if isinstance(sync, torch.Tensor) else torch.device(sync)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        now = time.perf_counter()
        if self._last is not None:
            self._seen += 1
            if self._seen > self.warmup:
                self.times.append(now - self._last)
        self._last = now

    # ---- derived cost ----
    def set_step_cost(self, flops_per_device: float,
                      device_count: int | None = None) -> None:
        """Attach the per-device flops of one step (``utils.flop_cost``) so
        summary() can derive model MACs/s (1 MAC = 2 flops).

        ``device_count`` must be the number of devices the step is actually
        split over — 1 until data parallelism is ported."""
        self._flops_per_device = float(flops_per_device)
        self._device_count = device_count

    # ---- results ----
    @property
    def recorded_steps(self) -> int:
        return len(self.times)

    def summary(self) -> dict:
        if not self.times:
            raise ValueError(
                f"StepTimer has no measured steps (saw {self._seen}, "
                f"warmup {self.warmup}) — run more steps or lower warmup")
        srt = sorted(self.times)
        mean = sum(self.times) / len(self.times)
        steps_per_s = 1.0 / mean
        out = {
            "steps_measured": len(self.times),
            "warmup_steps": self.warmup,
            "mean_step_s": mean,
            "p50_step_s": _percentile(srt, 0.50),
            "p90_step_s": _percentile(srt, 0.90),
            "min_step_s": srt[0],
            "steps_per_s": steps_per_s,
        }
        if self.examples_per_step is not None:
            out["examples_per_step"] = int(self.examples_per_step)
            out["examples_per_s"] = steps_per_s * self.examples_per_step
        if self._flops_per_device is not None:
            n_dev = self._device_count or 1
            out["flops_per_step_per_device"] = self._flops_per_device
            out["device_count"] = int(n_dev)
            out["macs_per_s"] = steps_per_s * (self._flops_per_device / 2.0) * n_dev
        return out
