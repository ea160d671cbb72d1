"""Render an obs metrics JSONL file as a table (and optionally a
BENCH-style report).  Counterpart of ``repro/obs/summarize.py``.

  PYTHONPATH=src python -m repro_torch.obs.summarize run-metrics.jsonl
  PYTHONPATH=src python -m repro_torch.obs.summarize run-metrics.jsonl \
      --bench-json bench-out       # writes BENCH_obs_summary.json

The input is what ``obs.metrics.JsonlSink`` wrote: one JSON object per
line, ``{"t": unix, "step": int|null, "metrics": {name: value}}``.  Every
metric is aggregated over the file (count / mean / p50 / p99 / min / max
/ last) with the same linear-interpolation percentiles the registry's
histograms use.  Runs probed with ``--probe-every`` additionally get an
**alignment table** (per-layer DFA-vs-BP cosine: first / last / Δ over
the run) and a **noise-budget table** (per-source share of the emu
backend's observed error power, the Σ/total closure, and the
thermal-vs-analytic cross-check).  ``--bench-json`` serializes the
aggregate through ``repro_torch.bench.write_bench`` — the reference's
``repro.bench/v1`` schema — so a metrics log can join the perf
trajectory.
"""

from __future__ import annotations

import argparse
import json
import math

from repro_torch.obs.metrics import Histogram


def read_rows(path: str) -> list[dict]:
    """Parse a metrics JSONL file, tolerating a torn trailing line (a run
    killed mid-write): corrupt lines at the end are dropped, a corrupt
    line with valid rows after it raises (that file is truly damaged)."""
    rows = []
    bad_at = None
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                if bad_at is None:
                    bad_at = i
                continue
            if bad_at is not None:
                raise ValueError(
                    f"{path}: corrupt JSONL at line {bad_at + 1} "
                    "followed by valid rows")
            rows.append(row)
    return rows


def aggregate(rows: list[dict]) -> dict[str, dict]:
    """metric name -> {count, mean, p50, p99, min, max, last} over the
    file, insertion-ordered by first appearance."""
    hists: dict[str, Histogram] = {}
    last: dict[str, float] = {}
    for row in rows:
        for name, v in row.get("metrics", {}).items():
            v = float(v)
            if not math.isfinite(v):
                continue
            if name not in hists:
                hists[name] = Histogram(name, window=1 << 20)
            hists[name].observe(v)
            last[name] = v
    out = {}
    for name, h in hists.items():
        s = h.summary()
        s["last"] = last[name]
        out[name] = s
    return out


def render(table: dict[str, dict], steps: int, out=print) -> None:
    cols = ("count", "mean", "p50", "p99", "min", "max", "last")
    width = max((len(n) for n in table), default=6)
    out(f"{'metric':<{width}}  " + "  ".join(f"{c:>12}" for c in cols))
    for name, stats in table.items():
        cells = []
        for c in cols:
            v = stats[c]
            cells.append(f"{int(v):>12d}" if c == "count"
                         else f"{v:>12.6g}")
        out(f"{name:<{width}}  " + "  ".join(cells))
    out(f"({steps} logged rows)")


def alignment_table(rows: list[dict]) -> dict[str, dict]:
    """Per ``align_*`` series: first / last / Δ over the run — the probe's
    headline "is DFA aligning" view.  Empty for unprobed runs."""
    series: dict[str, list[float]] = {}
    for row in rows:
        for name, v in row.get("metrics", {}).items():
            if name.startswith("align_") and math.isfinite(float(v)):
                series.setdefault(name, []).append(float(v))
    return {name: {"first": vals[0], "last": vals[-1],
                   "delta": vals[-1] - vals[0], "samples": len(vals)}
            for name, vals in series.items()}


def render_alignment(table: dict[str, dict], out=print) -> None:
    width = max(len(n) for n in table)
    out("")
    out("alignment (DFA-vs-BP cosine)")
    out(f"{'series':<{width}}  " + "  ".join(
        f"{c:>10}" for c in ("first", "last", "delta", "samples")))
    for name, s in table.items():
        out(f"{name:<{width}}  {s['first']:>10.4f}  {s['last']:>10.4f}  "
            f"{s['delta']:>+10.4f}  {s['samples']:>10d}")


def noise_budget_table(rows: list[dict]) -> dict:
    """Last ``nb_*`` row -> per-source share of the observed error power,
    plus the Σ/total closure and the thermal-vs-analytic cross-check.
    Empty for runs without attribution rows (non-emu backends)."""
    last: dict = {}
    for row in rows:
        m = row.get("metrics", {})
        if "nb_total_var" in m:
            last = m
    if not last:
        return {}
    total = float(last["nb_total_var"])
    sources = {}
    for k, v in last.items():
        if (k.startswith("nb_") and k.endswith("_var")
                and k not in ("nb_total_var", "nb_sum_var")):
            v = float(v)
            sources[k[3:-4]] = {
                "var": v, "share": v / total if total > 0 else float("nan")}
    return {"sources": sources, "total_var": total,
            "closure": float(last.get("nb_closure", float("nan"))),
            "thermal_vs_analytic": float(
                last.get("nb_thermal_vs_analytic", float("nan")))}


def render_noise_budget(nb: dict, out=print) -> None:
    out("")
    out("noise budget (emu backend, error power vs ideal twin)")
    width = max(len(n) for n in nb["sources"])
    out(f"{'source':<{width}}  {'var':>12}  {'share':>8}")
    ordered = sorted(nb["sources"].items(),
                     key=lambda kv: -kv[1]["var"])
    for name, s in ordered:
        out(f"{name:<{width}}  {s['var']:>12.6g}  {s['share']:>7.1%}")
    out(f"{'total':<{width}}  {nb['total_var']:>12.6g}  "
        f"closure(Σ/total)={nb['closure']:.3f}")
    if math.isfinite(nb["thermal_vs_analytic"]):
        out(f"thermal measured/analytic sigma ratio: "
            f"{nb['thermal_vs_analytic']:.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="metrics JSONL written by obs.JsonlSink")
    ap.add_argument("--bench-json", default=None, metavar="DIR",
                    help="also write the aggregate as "
                         "BENCH_obs_summary.json to DIR")
    args = ap.parse_args(argv)

    rows = read_rows(args.path)
    if not rows:
        print(f"{args.path}: no metric rows")
        return 1
    table = aggregate(rows)
    render(table, len(rows))
    align = alignment_table(rows)
    if align:
        render_alignment(align)
    nb = noise_budget_table(rows)
    if nb:
        render_noise_budget(nb)
    if args.bench_json:
        from repro_torch.bench import write_bench

        flat = {}
        for name, stats in table.items():
            for stat in ("mean", "p50", "p99", "last"):
                flat[f"{name}_{stat}"] = stats[stat]
        path = write_bench("obs_summary", flat,
                           meta={"source": args.path, "rows": len(rows)},
                           out_dir=args.bench_json)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
