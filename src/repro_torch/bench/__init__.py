"""``repro_torch.bench`` — throughput telemetry (``StepTimer``) and the
BENCH_*.json perf-trajectory format.  Counterpart of ``repro/bench``."""

from repro_torch.bench.report import (SCHEMA, bench_path, clamped_warmup,
                                load_bench, make_report, report_throughput,
                                validate, write_bench)
from repro_torch.bench.telemetry import StepTimer

__all__ = ["SCHEMA", "StepTimer", "bench_path", "clamped_warmup",
           "load_bench", "make_report", "report_throughput", "validate",
           "write_bench"]
