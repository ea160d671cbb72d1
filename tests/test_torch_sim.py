"""The port's simulator (``repro_torch.sim``), its trace exporters and the
tuned session against ``repro``: the panel schedule the emulator runs, the
pipeline and serving reports, both autotuners' winners and candidate lists,
``build_session(schedule="auto")`` and the launcher's ``--autotune``.
Integers, names and the candidate order must be equal, floats within a
relative 1e-12 (the modules are copies; they are equal in practice).  Every
time, power and energy here is the modelled photonic chip's.  Full-width
models are built on the meta device: nothing is allocated."""

from __future__ import annotations

import dataclasses
import itertools
import json
import math

import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro import sim as jsim  # noqa: E402
from repro.core import photonics as jph  # noqa: E402
from repro.hardware import mrr as jmrr  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import sim as tsim  # noqa: E402
from repro_torch.core import photonics as tph  # noqa: E402
from repro_torch.hardware import mrr as tmrr  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.obs import export as texport  # noqa: E402

QWEN = "qwen1.5-0.5b"
REL = 1e-12


def _same(got, expect, where="report"):
    """Equal structure; ints, strings, bools exactly; floats within REL."""
    if dataclasses.is_dataclass(expect):
        assert dataclasses.is_dataclass(got), where
        names = [f.name for f in dataclasses.fields(expect)]
        assert [f.name for f in dataclasses.fields(got)] == names, where
        for name in names:
            _same(getattr(got, name), getattr(expect, name), f"{where}.{name}")
    elif isinstance(expect, dict):
        assert list(got) == list(expect), where
        for k in expect:
            _same(got[k], expect[k], f"{where}[{k!r}]")
    elif isinstance(expect, (list, tuple)):
        assert type(got) is type(expect) and len(got) == len(expect), where
        for i, (g, e) in enumerate(zip(got, expect)):
            _same(g, e, f"{where}[{i}]")
    elif isinstance(expect, float):
        assert isinstance(got, float), where
        assert got == expect or math.isclose(got, expect, rel_tol=REL), (where, got, expect)
    else:
        assert type(got) is type(expect) and got == expect, (where, got, expect)


def _pcfg(mrr=False, **kw):
    """The same PhotonicConfig in both packages (with the default device)."""
    return (jph.PhotonicConfig(mrr=jmrr.MRRConfig() if mrr else None, **kw),
            tph.PhotonicConfig(mrr=tmrr.MRRConfig() if mrr else None, **kw))


def _models(arch, smoke):
    """(reference model, port model on the meta device): shapes only."""
    return japi.build_model(arch, smoke=smoke), tapi.build_model(arch, smoke=smoke,
                                                                 device="meta")


def _gemms(work):
    return [(g.name, g.t, g.m, g.k) for g in work]


# ---------------------------------------------------------------------------
# the panel schedule and the pipeline report
# ---------------------------------------------------------------------------

BANKS = [(50, 20), (16, 40), (7, 13)]
LAYOUTS = [(1, ()), (2, ()), (5, ()), (3, (1,)), (8, (0, 5, 7))]
GEMMS = [(50, 20), (73, 61), (800, 10), (1024, 1024), (1, 1), (151936, 1024)]


@pytest.mark.parametrize("rows,cols", BANKS)
def test_panel_schedule_equals_the_reference(rows, cols):
    """(nm, alive buses, bus-cycles, real panels) from ``tile_operands`` on
    meta tensors = the reference's from ``jax.eval_shape``, over the GEMMs x
    bus layouts (failed buses included)."""
    for (m, k), (n_buses, failed) in itertools.product(GEMMS, LAYOUTS):
        jc, tc = _pcfg(bank_rows=rows, bank_cols=cols, n_buses=n_buses, failed_buses=failed)
        got = tsim.panel_schedule(tsim.Gemm("g", t=3, m=m, k=k), tc)
        assert got == jsim.panel_schedule(jsim.Gemm("g", t=3, m=m, k=k), jc), (m, k, n_buses)
        assert all(type(v) is int for v in got)
        nm, n_alive, nj, n_panels = got
        assert nm * nj == tph.gemm_cycles(m, k, tc)


@pytest.mark.parametrize("arch,smoke", [("mnist_mlp", False), (QWEN, True), (QWEN, False),
                                        ("qwen2-moe-a2.7b", True), ("whisper-small", True)])
def test_workloads_equal_the_reference(arch, smoke):
    jm, tm = _models(arch, smoke)
    assert _gemms(tsim.dfa_backward_workload(tm, 7)) == _gemms(jsim.dfa_backward_workload(jm, 7))
    if arch != "whisper-small":  # the reference's whisper declares no forward workload
        assert _gemms(tsim.forward_workload(tm, 3)) == _gemms(jsim.forward_workload(jm, 3))


@pytest.mark.parametrize("tiling", ["panel", "layer"])
@pytest.mark.parametrize("update", [True, False])
def test_simulate_equals_the_reference(tiling, update):
    """Every report field, events included, on the smoke LM's and the
    MLP's backward and a ragged workload, over bus layouts, an f_s
    override, the digital overlap and a recalibration cadence."""
    works = [(jsim.dfa_backward_workload(jm, t), tsim.dfa_backward_workload(tm, t))
             for (jm, tm), t in ((_models(QWEN, True), 64), (_models("mnist_mlp", False), 8))]
    ragged = [("a", 5, 73, 61), ("b", 9, 800, 10), ("c", 1, 1024, 1024)]
    works.append(([jsim.Gemm(*g) for g in ragged], [tsim.Gemm(*g) for g in ragged]))
    for (jw, tw), (n_buses, failed) in itertools.product(works, LAYOUTS):
        jc, tc = _pcfg(mrr=True, n_buses=n_buses, failed_buses=failed)
        for kw in ({}, {"f_s": 2.5e9, "digital_s": 3e-6}, {"digital_s": 1e-3},
                   {"recalibrate_every": 100}):
            kw = dict(kw, tiling=tiling, include_weight_update=update)
            _same(tsim.simulate(tw, tc, **kw), jsim.simulate(jw, jc, **kw), f"{kw}")
    with pytest.raises(ValueError, match="empty workload"):
        tsim.simulate([], tc)
    with pytest.raises(ValueError, match="unknown tiling"):
        tsim.simulate(tw, tc, tiling="column")


def test_stage_times_and_power_equal_the_reference():
    for n_buses, f_s in ((1, None), (4, 5e9), (8, 2.5e9)):
        jc, tc = _pcfg(mrr=True, n_buses=n_buses)
        _same(tsim.stage_times(tc, f_s), jsim.stage_times(jc, f_s))
        assert tsim.bank_power_w(tc, f_s=f_s) == jsim.bank_power_w(jc, f_s=f_s)
    assert tsim.STAGES == jsim.STAGES
    with pytest.raises(ValueError, match="must be positive"):
        tsim.stage_times(tc, 0.0)


# ---------------------------------------------------------------------------
# the autotuners
# ---------------------------------------------------------------------------

def _workloads(arch, smoke, t):
    jm, tm = _models(arch, smoke)
    return jsim.dfa_backward_workload(jm, t), tsim.dfa_backward_workload(tm, t)


@pytest.mark.parametrize("case", ["default", "budget", "recal", "degraded", "digital"])
def test_autotune_equals_the_reference(case):
    """The same winner and the same candidate list (every report), on the
    smoke LM's backward: unconstrained, under a budget of two buses, with
    the cadence co-tuned under a drift budget, on a chip with a failed bus,
    and with a digital step overlapped."""
    jw, tw = _workloads(QWEN, True, 64)
    failed = (1,) if case == "degraded" else ()
    jc, tc = _pcfg(mrr=True, failed_buses=failed)
    kw = {}
    if case == "budget":
        kw["power_budget_w"] = jsim.bank_power_w(jc, n_buses=2)
    if case == "recal":
        kw.update(recal_candidates=jsim.DEFAULT_RECAL_CANDIDATES, drift_budget=0.025,
                  tilings=("panel",))
    if case == "digital":
        kw["digital_s"] = 2e-5
    _same(tsim.autotune(tw, tc, **kw), jsim.autotune(jw, jc, **kw), case)


@pytest.mark.parametrize("budget", [78.0, None])
def test_tuned_qwen_schedule_equals_the_reference(budget):
    """qwen1.5-0.5b's full-width DFA backward at 4096 vectors on
    emu_onchip with the cadence co-tuned (``build_session``'s search, the
    model on the meta device): at 78 W 2 buses at 10 GHz, recalibration
    every 100 steps under a drift budget of 0.025; unconstrained 8 buses;
    both equal to the reference's search, every candidate included."""
    jw, tw = _workloads(QWEN, False, 4096)
    jc, tc = jph.preset("emu_onchip"), tph.preset("emu_onchip")
    kw = dict(power_budget_w=budget, tilings=("panel",),
              recal_candidates=jsim.DEFAULT_RECAL_CANDIDATES, drift_budget=0.025)
    got = tsim.autotune(tw, tc, **kw)
    _same(got, jsim.autotune(jw, jc, **kw))
    want = (2, 10e9, 100) if budget else (8, 10e9, 100)
    assert (got.n_buses, got.f_s, got.recalibrate_every) == want
    assert got.drift_budget == 0.025 and got.power_w <= (budget or math.inf)
    session = tapi.build_session(arch=QWEN, smoke=False, hardware="emu_onchip", backend="emu",
                                 schedule="auto", power_budget_w=budget,
                                 recalibrate_every="auto", schedule_batch=4096,
                                 device="meta")
    _same(session.schedule, got)
    assert session.config.recalibrate_every == 100
    assert (session.photonics.n_buses, session.photonics.f_s) == want[:2]


def test_autotune_raises_as_the_reference():
    jw, tw = [jsim.Gemm("g", 1, 50, 20)], [tsim.Gemm("g", 1, 50, 20)]
    jc, tc = _pcfg(mrr=True)
    for kw in ({"power_budget_w": 0.1},
               {"recal_candidates": (0, 1000), "drift_budget": 1e-6, "tilings": ("panel",)}):
        with pytest.raises(ValueError) as jerr:
            jsim.autotune(jw, jc, **kw)
        with pytest.raises(ValueError) as terr:
            tsim.autotune(tw, tc, **kw)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("case", ["mlp", "qwen_100w"])
def test_autotune_serving_equals_the_reference(case):
    """The same winner and candidate list (every serving report): the MLP
    at twice a single bus's capacity with a budget of four buses, and
    qwen1.5-0.5b at full width on a 200 req/s trace of 256 requests (32-
    token prompts, 16 decode tokens) under a 50 ms p99 SLO and 100 W, where
    the reference picks 1 bus at 5 GHz with 4 slots."""
    jc, tc = _pcfg()
    if case == "mlp":
        jm, tm = _models("mnist_mlp", False)
        cap = 1.0 / jsim.service_model(jm, jc).round_s(1)
        args = dict(rate=2.0 * cap, n=64, prompt_len=16, decode_len=8, seed=5)
        kw = dict(power_budget_w=jsim.bank_power_w(jc, n_buses=4), bus_counts=(1, 2, 4))
        slo = 0.5 * jsim.simulate_serving(jsim.poisson_requests(**args),
                                          jsim.service_model(jm, jc),
                                          batch_slots=8).latency_p99_s
    else:
        jm, tm = _models(QWEN, False)
        args = dict(rate=200.0, n=256, prompt_len=32, decode_len=16, seed=0)
        kw, slo = dict(power_budget_w=100.0), 0.05
    jr, tr = jsim.poisson_requests(**args), tsim.poisson_requests(**args)
    _same(tr, jr, "requests")
    got = tsim.autotune_serving(tm, tr, tc, slo_p99_s=slo, **kw)
    _same(got, jsim.autotune_serving(jm, jr, jc, slo_p99_s=slo, **kw))
    if case == "qwen_100w":
        assert (got.n_buses, got.f_s, got.batch_slots) == (1, 5e9, 4)
    for kw in ({"slo_p99_s": 1e-15, "bus_counts": (1, 2)},
               {"slo_p99_s": 10.0, "power_budget_w": 1e-3, "bus_counts": (1, 2)}):
        with pytest.raises(ValueError) as jerr:
            jsim.autotune_serving(jm, jr[:16], jc, **kw)
        with pytest.raises(ValueError) as terr:
            tsim.autotune_serving(tm, tr[:16], tc, **kw)
        assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# serving reports and the trace exporters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,smoke", [("mnist_mlp", False), (QWEN, True)])
def test_simulate_serving_and_traces_equal_the_reference(arch, smoke):
    """The service model (exact: wall(7) = a·7 + b), the serving report at
    three loads and slot counts, and both exporters' Chrome-trace events."""
    jm, tm = _models(arch, smoke)
    jc, tc = _pcfg(n_buses=2)
    jsvc, tsvc = jsim.service_model(jm, jc), tsim.service_model(tm, tc)
    _same(tsvc, jsvc, "service model")
    full = tsim.simulate(tsim.forward_workload(tm, 7), tc, include_weight_update=False)
    assert math.isclose(full.wall_clock_s, tsvc.round_s(7), rel_tol=REL)
    for rate, slots in ((0.2, 4), (1.0, 8), (4.0, 16)):
        args = dict(rate=rate / tsvc.round_s(1), n=40, prompt_len=20, decode_len=6, seed=3)
        jrec, trec = jexport.TraceRecorder(), texport.TraceRecorder()
        jrep = jsim.simulate_serving(jsim.poisson_requests(**args), jsvc, batch_slots=slots,
                                     prefill_chunk=8, trace=jrec)
        trep = tsim.simulate_serving(tsim.poisson_requests(**args), tsvc, batch_slots=slots,
                                     prefill_chunk=8, trace=trec)
        _same(trep, jrep, f"serving at {rate}")
        _same(trec.to_chrome(), jrec.to_chrome(), "serving trace")
    jw, tw = jsim.dfa_backward_workload(jm, 16), tsim.dfa_backward_workload(tm, 16)
    for tiling in ("panel", "layer"):
        jrep = jsim.simulate(jw, jc, tiling=tiling)
        trep = tsim.simulate(tw, tc, tiling=tiling)
        _same(texport.pipeline_to_trace(trep).to_chrome(),
              jexport.pipeline_to_trace(jrep).to_chrome(), f"pipeline trace {tiling}")


def test_trace_paths_write_loadable_json(tmp_path):
    """``trace=`` a path writes the simulated timeline as JSON that loads,
    with one track per (bus, stage) and the serving rounds."""
    _, tm = _models(QWEN, True)
    tc = tph.PhotonicConfig(n_buses=2)
    path = tmp_path / "pipeline.json"
    report = tsim.simulate(tsim.dfa_backward_workload(tm, 8), tc, trace=str(path))
    events = json.loads(path.read_text())["traceEvents"]
    tracks = {(e["pid"], e["tid"]) for e in events if e["ph"] == "X"}
    assert len(tracks) == report.n_buses * (len(tsim.STAGES) + 1)
    assert all(e["pid"] == texport.SIM_PIPELINE_PID for e in events)
    path = tmp_path / "serving.json"
    tsim.simulate_serving(tsim.poisson_requests(50.0, 8, prompt_len=8, decode_len=4),
                          tsim.service_model(tm, tc), trace=str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert {e["name"] for e in events if e["ph"] == "X"} == {"prefill", "decode"}
    assert sum(e["ph"] == "b" for e in events) == 8


# ---------------------------------------------------------------------------
# the tuned session and the launcher
# ---------------------------------------------------------------------------

def _hw(cfg):
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if cfg.mrr is not None:
        out["mrr"] = {f.name: getattr(cfg.mrr, f.name) for f in dataclasses.fields(cfg.mrr)}
    return out


@pytest.mark.parametrize("arch,kw", [
    ("mnist_mlp", dict(backend="emu", hardware="emu_onchip", recalibrate_every="auto",
                       digital_step_s=1e-5)),
    ("mnist_mlp", dict(n_buses=2)),
    (QWEN, dict(backend="emu", hardware="emu_onchip", recalibrate_every="auto",
                power_budget_w=40.0, schedule_batch=32)),
    (QWEN, dict(hardware="offchip_bpd")),
])
def test_build_session_schedule_auto_equals_the_reference(arch, kw):
    """The smoke MLP and smoke LM: the tuned PhotonicConfig, the cadence and
    the schedule equal the reference's; a pinned bus count narrows the
    search; the monitor carries the schedule's drift budget."""
    j = japi.build_session(arch=arch, smoke=True, schedule="auto", log_every=10**9, **kw)
    t = tapi.build_session(arch=arch, smoke=True, schedule="auto", log_every=10**9,
                           device="cpu", **kw)
    assert _hw(t.photonics) == _hw(j.config.dfa.photonics)
    assert t.config.recalibrate_every == j.config.recalibrate_every
    _same(t.schedule, j.schedule)
    if "n_buses" in kw:
        assert t.photonics.n_buses == kw["n_buses"]
    if kw.get("recalibrate_every") == "auto":
        assert t.config.recalibrate_every == t.schedule.recalibrate_every > 0
        assert t.observe().hwmon.drift_budget == t.schedule.drift_budget


def test_build_session_raises_as_the_reference():
    bad = [dict(schedule="fastest"), dict(power_budget_w=50.0), dict(schedule_batch=8),
           dict(digital_step_s=1e-5), dict(recalibrate_every="auto")]
    for kw in bad:
        with pytest.raises(ValueError) as jerr:
            japi.build_session(arch="mnist_mlp", smoke=True, **kw)
        with pytest.raises(ValueError) as terr:
            tapi.build_session(arch="mnist_mlp", smoke=True, device="cpu", **kw)
        assert str(terr.value) == str(jerr.value)
    plain = tapi.build_session(arch="mnist_mlp", smoke=True, device="cpu", n_buses=3)
    assert plain.schedule is None and plain.photonics.n_buses == 3


def test_launcher_autotune_on_the_cpu(capsys):
    result = tlaunch.main(["--arch", QWEN, "--backend", "emu", "--preset", "emu_onchip",
                           "--device", "cpu", "--autotune", "--power-budget-w", "78",
                           "--steps", "2", "--batch", "2", "--seq", "8"])
    out = capsys.readouterr().out
    assert "[sim] autotuned schedule: n_buses=2 tiling=panel f_s=10.00GHz" in out
    assert math.isfinite(result["loss"])
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", QWEN, "--device", "cpu", "--power-budget-w", "78"])
    assert "--power-budget-w only steers --autotune" in capsys.readouterr().err
