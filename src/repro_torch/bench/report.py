"""BENCH_*.json serialization — the repo's perf trajectory format.
Counterpart of ``repro/bench/report.py``, with the same schema::

    {
      "schema":  "repro.bench/v1",
      "name":    "train_throughput",          # -> BENCH_train_throughput.json
      "created_unix": 1722470400.0,
      "env":     {"torch": "2.11.0+cu128", "cuda": "12.8", "backend": "cuda",
                  "device": "NVIDIA H100 80GB HBM3",
                  "power_limit": "700.00 W", "device_count": 1,
                  "python": "3.12.3"},
      "metrics": {"steps_per_s": 12.5, ...},  # numbers only, all finite
      "meta":    {...}                        # free-form provenance
    }

``validate`` raises ValueError on anything that doesn't round-trip, so a
schema drift breaks tests/CI instead of silently corrupting the trajectory.
"""

from __future__ import annotations

import json
import math
import os
import platform
import subprocess
import time

SCHEMA = "repro.bench/v1"
_PREFIX = "BENCH_"


def _power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` prints it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def environment() -> dict:
    """torch, CUDA, the card's name and power limit, the device count and
    python (no card: backend "cpu", device and power limit None)."""
    import torch

    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device": torch.cuda.get_device_name(0) if cuda else None,
        "power_limit": _power_limit() if cuda else None,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "python": platform.python_version(),
    }


def make_report(name: str, metrics: dict, meta: dict | None = None) -> dict:
    return validate({
        "schema": SCHEMA,
        "name": name,
        "created_unix": time.time(),
        "env": environment(),
        "metrics": dict(metrics),
        "meta": dict(meta or {}),
    })


def validate(report: dict) -> dict:
    """Check the stable schema; returns the report or raises ValueError."""
    if not isinstance(report, dict):
        raise ValueError(f"bench report must be a dict, got {type(report)}")
    if report.get("schema") != SCHEMA:
        raise ValueError(
            f"bench schema mismatch: {report.get('schema')!r} != {SCHEMA!r}")
    name = report.get("name")
    if not isinstance(name, str) or not name:
        raise ValueError(f"bench name must be a non-empty str, got {name!r}")
    if not isinstance(report.get("created_unix"), (int, float)):
        raise ValueError("bench created_unix must be a unix timestamp")
    if not isinstance(report.get("env"), dict):
        raise ValueError("bench env must be a dict")
    metrics = report.get("metrics")
    if not isinstance(metrics, dict) or not metrics:
        raise ValueError("bench metrics must be a non-empty dict")
    for k, v in metrics.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError(f"bench metric {k!r} must be a number, got {v!r}")
        if not math.isfinite(v):
            raise ValueError(f"bench metric {k!r} is not finite: {v!r}")
    if not isinstance(report.get("meta", {}), dict):
        raise ValueError("bench meta must be a dict")
    return report


def bench_path(name: str, out_dir: str = ".") -> str:
    return os.path.join(out_dir, f"{_PREFIX}{name}.json")


def write_bench(name: str, metrics: dict, meta: dict | None = None,
                out_dir: str = ".") -> str:
    """Validate + serialize one report; returns the BENCH_<name>.json path."""
    report = make_report(name, metrics, meta)
    os.makedirs(out_dir, exist_ok=True)
    path = bench_path(name, out_dir)
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_bench(path: str) -> dict:
    with open(path) as f:
        return validate(json.load(f))


def _shard_multiplier(mesh, batch, microbatches: int = 1) -> int:
    """Devices the step's flops are split over: the data group's size only
    when the batch actually splits (``dist.sharding.batch_rows``); the
    replication fallback has every rank compute the full batch, so the
    multiplier is 1 (anything else records a phantom speedup)."""
    if mesh is None:
        return 1
    from repro_torch.dist import sharding

    sizes = {len(v) for v in batch.values()}
    if len(sizes) != 1 or sharding.batch_rows(mesh, sizes.pop(), microbatches) is None:
        return 1
    return sharding.data_index(mesh)[1]


def report_throughput(session, state, batch, timer, meta: dict | None = None,
                      out_dir: str = ".") -> tuple[str, dict]:
    """Finish a timed ``session.fit``: attach the step's flops
    (``session.step_cost``, per rank under a mesh) to ``timer``, with the
    ranks the batch is split over, write BENCH_train_throughput.json (rank
    0 only under a mesh), and print the headline numbers."""
    n_dev = _shard_multiplier(session.mesh, batch, session.config.microbatches)
    timer.set_step_cost(session.step_cost(state, batch).flops, device_count=n_dev)
    summary = timer.summary()
    if not session.trainer.is_chief:
        return None, summary
    base = {"data_parallel": session.mesh is not None, "devices": int(n_dev)}
    base.update(meta or {})
    path = write_bench("train_throughput", summary, meta=base, out_dir=out_dir)
    print(f"[bench] {path}: steps/s={summary['steps_per_s']:.2f} "
          f"examples/s={summary.get('examples_per_s', 0):.0f} "
          f"MACs/s={summary.get('macs_per_s', 0):.3e} devices={n_dev}",
          flush=True)
    return path, summary


def clamped_warmup(total_steps: int, target: int) -> int:
    """Warmup steps for a StepTimer over a ``total_steps`` fit: at least one
    step must remain measured, however short the run."""
    return max(0, min(target, total_steps - 1))
