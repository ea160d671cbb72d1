#!/usr/bin/env python3
"""The dry-run sweep: every arch of ``configs.ASSIGNED`` × ``SHAPES`` × both
production meshes, for the baseline and the ``opt`` variant, on the fake
world (no card is used).

    python3 tools/dryrun_sweep.py [--out-dir DIR] [--jobs N] [--arch A ...]
                                  [--shape S ...] [--variant baseline opt]
    python3 tools/dryrun_sweep.py --table RECORDS.json [MORE.json ...]

Each (arch, variant) runs as its own ``python -m repro_torch.launch.dryrun
--mesh both --arch A --variant V --out DIR/cells/A__V.json --hlo-dir
DIR/hlo`` process, ``--jobs`` at a time (the fake process group is one a
process).  The records are merged into ``DIR/dryrun.json`` and printed as
one Markdown table, a row an (arch, shape) and a column a mesh and
variant: each cell's status or its per-rank argument and peak bytes,
FLOPs, all-gather / all-reduce / reduce-scatter bytes and host seconds.  Exits 1 if any cell is
in error.  ``--table`` prints the table of record files instead, a later
file's record of a cell replacing an earlier one's (a rerun of some cells).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
KINDS = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS", "all-to-all": "A2A"}


def _cells(archs, shapes, variants, out_dir, jobs):
    cells = out_dir / "cells"
    cells.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                       os.environ.get("PYTHONPATH", "")]))
    todo = [(a, v) for v in variants for a in archs]
    running, done = [], []
    while todo or running:
        while todo and len(running) < jobs:
            arch, variant = todo.pop(0)
            log = open(cells / f"{arch}__{variant}.log", "w")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "both",
                   "--arch", arch, "--shape", *shapes, "--variant", variant, "--out",
                   str(cells / f"{arch}__{variant}.json"), "--hlo-dir", str(out_dir / "hlo")]
            running.append((arch, variant, subprocess.Popen(cmd, env=env, stdout=log,
                                                            stderr=subprocess.STDOUT), log,
                            time.monotonic()))
        for item in list(running):
            arch, variant, proc, log, t0 = item
            if proc.poll() is not None:
                log.close()
                running.remove(item)
                done.append((arch, variant, proc.returncode, time.monotonic() - t0))
                print(f"[sweep] {arch} {variant}: exit {proc.returncode} in "
                      f"{time.monotonic() - t0:.1f}s", flush=True)
        time.sleep(0.5)
    records = []
    for arch, variant, _, _ in done:
        path = cells / f"{arch}__{variant}.json"
        if path.exists():
            records += json.loads(path.read_text())
    return records


def _cell(r) -> str:
    """One record as "arg / peak GB · TFLOP · AG / AR / RS GB · host s"."""
    if r is None:
        return "-"
    if r["status"] != "ok":
        return r["status"]
    kinds = r["collectives"]["bytes_by_kind"]
    coll = " / ".join(f"{kinds.get(k, 0) / 1e9:.3f}"
                      for k in ("all-gather", "all-reduce", "reduce-scatter"))
    return (f"{r['argument_bytes'] / 1e9:.3f} / {r['memory']['total_hbm_bytes'] / 1e9:.3f} · "
            f"{r['cost']['flops'] / 1e12:.3f} · {coll} · {r['seconds']}")


def table(records, archs) -> list:
    """One Markdown row an (arch, shape), ``archs`` in order: each mesh and
    variant's cell (``_cell``); a shape every variant and mesh skipped is
    listed after."""
    by = {(r["arch"], r["shape"], r["mesh"], r["variant"]): r for r in records}
    shapes = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    cols = [(m, v) for v in ("baseline", "opt") for m in ("single", "multi")]
    rows = ["| arch | shape | " + " | ".join(f"{m} {v}" for m, v in cols) + " |",
            "|---|---|" + "---|" * len(cols)]
    skipped = []
    for arch in archs:
        for shape in shapes:
            cells = [by.get((arch, shape, m, v)) for m, v in cols]
            if all(c is None for c in cells):
                continue
            if all(c is None or c["status"] == "skip" for c in cells):
                skipped.append(f"{arch} {shape}")
                continue
            rows.append(f"| {arch} | {shape} | " + " | ".join(_cell(c) for c in cells) + " |")
    if skipped:
        rows.append(f"skipped on every mesh and variant: {', '.join(skipped)}")
    return rows


def main(argv=None):
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=str(ROOT / "results" / "dryrun"))
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--arch", nargs="*", default=list(configs.ASSIGNED))
    ap.add_argument("--shape", nargs="*", default=list(configs.SHAPES))
    ap.add_argument("--variant", nargs="*", default=["baseline", "opt"])
    ap.add_argument("--table", nargs="*", default=None, metavar="RECORDS")
    args = ap.parse_args(argv)
    t0 = time.monotonic()
    if args.table is not None:
        merged = {}
        for path in args.table:
            for r in json.loads(pathlib.Path(path).read_text()):
                merged[r["arch"], r["shape"], r["mesh"], r["variant"]] = r
        records = list(merged.values())
    else:
        out_dir = pathlib.Path(args.out_dir)
        records = _cells(args.arch, args.shape, args.variant, out_dir, args.jobs)
        (out_dir / "dryrun.json").write_text(json.dumps(records, indent=1))
    for row in table(records, [a for a in configs.ASSIGNED
                               if any(r["arch"] == a for r in records)]):
        print(row)
    status = [r["status"] for r in records]
    disagree = [f"{r['arch']}/{r['shape']}/{r['mesh']}/{r['variant']}" for r in records
                if r["status"] == "ok" and not r["collectives_agree"]]
    print(f"[sweep] {len(records)} cells: {status.count('ok')} ok, {status.count('skip')} skip, "
          f"{status.count('error')} error; utils/hlo = step_cost on every ok cell: "
          f"{not disagree} {disagree}; {time.monotonic() - t0:.1f}s")
    return 1 if "error" in status or disagree else 0


if __name__ == "__main__":
    raise SystemExit(main())
