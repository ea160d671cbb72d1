"""The port's observability plane against the reference on the CPU:
metrics (histograms, sinks, the one-transfer drain), the Chrome trace,
the hardware monitor and the anomaly detector on the same scalars, the
null observer, the observer wired into fit and the serving engine, the
runtime sanitizers, ``summarize``, the bench report, ``step_cost`` and the
launchers' observability flags."""

import json
import math
import tracemalloc

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.hardware.mrr import MRRConfig as JMRRConfig  # noqa: E402
from repro.obs.anomaly import AnomalyDetector as JAnomaly  # noqa: E402
from repro.obs.hwmon import HardwareMonitor as JHwmon  # noqa: E402
from repro.obs.metrics import Histogram as JHistogram  # noqa: E402
from repro_torch import api, bench, obs  # noqa: E402
from repro_torch.hardware.mrr import MRRConfig  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.lint import runtime  # noqa: E402
from repro_torch.obs import summarize  # noqa: E402
from repro_torch.obs.anomaly import AnomalyDetector  # noqa: E402
from repro_torch.obs.hwmon import DEAD_RING_FACTOR, HardwareMonitor  # noqa: E402
from repro_torch.obs.metrics import Histogram, JsonlSink, MemorySink, Registry  # noqa: E402
from repro_torch.obs.trace import TraceRecorder  # noqa: E402
from repro_torch.serve import Request  # noqa: E402

ARCH = "qwen1.5-0.5b"


def _mlp_batch(in_dim, n=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(n, in_dim)).astype(np.float32),
            "y": rng.integers(0, 10, n).astype(np.int32)}


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 7, 100, 999])
def test_histogram_percentiles_match_numpy_and_reference(n):
    xs = np.random.default_rng(n).normal(size=n)
    h, jh = Histogram("h", window=2048), JHistogram("h", window=2048)
    for x in xs:
        h.observe(float(x))
        jh.observe(float(x))
    for q in (0, 25, 50, 90, 99, 100):
        assert h.percentile(q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12,
                                                abs=1e-12)
        assert h.percentile(q) == jh.percentile(q)
    assert h.summary() == jh.summary()
    with pytest.raises(ValueError):
        Histogram("empty").percentile(50)


def test_memory_sink_is_a_bounded_ring():
    reg = Registry([MemorySink(3)])
    for s in range(10):
        reg.emit(s, {"x": float(s)})
    assert [r["step"] for r in reg.sinks[0].rows] == [7, 8, 9]
    h = Histogram("h", window=8)
    for i in range(100):
        h.observe(float(i))
    assert len(h) == 8 and h.percentile(0) == 92.0


def test_registry_drain_is_one_transfer_and_fans_out(tmp_path, monkeypatch):
    """0-d tensors are stacked and read with one ``tolist``, never one
    ``item()`` per scalar; host numbers pass through; every sink gets the
    row the reference's registry writes."""
    items = []
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: items.append(self) or pytest.fail("item() called"))
    scalars = {"loss": torch.tensor(0.25), "acc": torch.tensor(0.5, dtype=torch.float64),
               "lr": 1e-3, "n": np.float64(3.0)}
    host = Registry.drain(scalars)
    assert host == {"loss": 0.25, "acc": 0.5, "lr": 1e-3, "n": 3.0}
    assert list(host) == list(scalars) and all(type(v) is float for v in host.values())
    monkeypatch.undo()

    path = str(tmp_path / "m.jsonl")
    reg = Registry([MemorySink(4), JsonlSink(path)])
    reg.record(3, {"loss": torch.tensor(0.25), "lr": 1e-3})
    reg.counter("steps").inc()
    reg.close()
    jreg = jobs.Registry([jobs.MemorySink(4)])
    jreg.record(3, {"loss": jnp.float32(0.25), "lr": 1e-3})
    jreg.counter("steps").inc()
    mem = reg.sinks[0].rows
    assert len(mem) == 1 and mem[0]["step"] == 3
    assert mem[0]["metrics"] == jreg.sinks[0].rows[0]["metrics"]
    rows = [json.loads(line) for line in open(path)]
    assert rows[0]["metrics"] == mem[0]["metrics"]
    assert reg.snapshot() == jreg.snapshot()


@pytest.mark.parametrize("tail", ["torn", "clean", "empty", "missing"])
def test_jsonl_sink_repairs_a_torn_tail(tmp_path, tail):
    path = tmp_path / "m.jsonl"
    first = json.dumps({"t": 1.0, "step": 1, "metrics": {"a": 1.0}}) + "\n"
    if tail != "missing":
        path.write_text({"torn": first + '{"t": 2.0, "step"', "clean": first,
                         "empty": ""}[tail])
    sink = JsonlSink(str(path))
    sink.write({"t": 3.0, "step": 2, "metrics": {"a": 2.0}})
    sink.close()
    steps = [r["step"] for r in summarize.read_rows(str(path))]
    assert steps == ([2] if tail in ("empty", "missing") else [1, 2])


def test_read_rows_rejects_mid_file_corruption(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text('{"t": 1.0, "step": 1, "metrics": {}}\n{torn\n'
                    '{"t": 2.0, "step": 2, "metrics": {}}\n')
    with pytest.raises(ValueError, match="corrupt JSONL"):
        summarize.read_rows(str(path))


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

def _record(rec):
    with rec.span("outer", step=1):
        with rec.span("inner"):
            pass
        rec.instant("mark", note="hi")
    rec.counter("load", {"q": 3})
    rec.async_begin("a", 7, slot=0)
    rec.async_instant("m", 7)
    rec.async_end("a", 7)
    rec.name_process(5, "p")
    rec.name_thread(5, 1, "t")
    rec.name_process(5, "p")  # metadata is deduplicated
    rec.complete("sim", 10.0, 5.0, pid=5, tid=1)


def test_trace_chrome_fields_match_reference(tmp_path):
    rec, jrec = TraceRecorder(), jobs.TraceRecorder()
    _record(rec)
    _record(jrec)
    path = obs.export.write(rec, str(tmp_path / "t.json"))
    doc = json.load(open(path))
    assert doc["displayTimeUnit"] == "ms"

    def shape(events):
        return [{k: v for k, v in ev.items() if k not in ("ts", "dur")} for ev in events]

    assert shape(doc["traceEvents"]) == shape(jrec.to_chrome()["traceEvents"])
    by_name = {e["name"]: e for e in doc["traceEvents"]}
    inner, outer = by_name["inner"], by_name["outer"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    for ev in doc["traceEvents"]:
        assert {"ph", "name", "pid"} <= set(ev)
        assert ev["ph"] == "M" or "ts" in ev
    assert obs.export.resolve_recorder("x.json")[1] == "x.json"
    assert obs.export.resolve_recorder(rec) == (rec, None)
    with pytest.raises(TypeError):
        obs.export.resolve_recorder(3)


# ---------------------------------------------------------------------------
# hwmon and anomaly: the same scalars give the reference's gauges and alerts
# ---------------------------------------------------------------------------

HW_SEQUENCES = {
    "crossings": [0.01, 0.02, 0.05, 0.06, 0.07, 0.02, 0.01, 0.04],
    "steady": [0.004, 0.005, 0.006, 0.005],
    "zero": [0.0, 0.0, 0.03],
}


@pytest.mark.parametrize("budget", [None, 0.03])
@pytest.mark.parametrize("seq", sorted(HW_SEQUENCES))
def test_hwmon_matches_reference(seq, budget):
    kw = dict(recalibrate_every=16, drift_budget=budget, n_failed_buses=1)
    mon, jmon = HardwareMonitor(MRRConfig(), **kw), JHwmon(JMRRConfig(), **kw)
    assert mon.drift_budget == pytest.approx(budget or 0.5 * MRRConfig().drift_sigma)
    assert mon.dead_ring_threshold == DEAD_RING_FACTOR * MRRConfig().drift_sigma
    for step, resid in enumerate(HW_SEQUENCES[seq]):
        row = {"hw_residual_rms": resid, "hw_drift_rms": 2 * resid, "hw_dead_rings": 1.0}
        assert mon.sample(step, row) == jmon.sample(step, row)
    assert mon.sample(99, {"loss": 1.0}) == {}
    assert ([dataclasses_tuple(a) for a in mon.alerts]
            == [dataclasses_tuple(a) for a in jmon.alerts])


def dataclasses_tuple(alert):
    return (alert.step, alert.kind, alert.value, alert.budget, alert.message)


def test_anomaly_detector_edge_triggered_nonfinite_and_reference():
    seq = ([1.0 + 0.01 * (i % 2) for i in range(10)] + [50.0, 50.0] + [1.0] * 28 + [50.0]
           + [float("nan"), float("nan"), 1.0, float("inf")])
    det = AnomalyDetector(watch=("loss",), warmup=4, k=6.0)
    jdet = JAnomaly(watch=("loss",), warmup=4, k=6.0)
    fired = []
    for i, v in enumerate(seq):
        got = det.observe(i, {"loss": v, "other": v})
        assert [(a.step, a.metric, a.message) for a in got] == [
            (a.step, a.metric, a.message) for a in jdet.observe(i, {"loss": v})]
        fired.append(len(got))
    assert fired[10] == 1 and fired[11] == 0  # one alert while the spike persists
    # the spike, the second spike (the NaNs after it find the detector
    # still out of band) and the infinity after 1.0 re-armed it
    assert sum(fired) == len(det.alerts) == 3
    assert [a.step for a in det.alerts] == [10, 40, 44]
    assert "non-finite" in det.alerts[-1].message
    assert det.observe(99, {}) == []


# ---------------------------------------------------------------------------
# the observer
# ---------------------------------------------------------------------------

def test_null_observer_allocates_nothing():
    null = obs.resolve(None)
    assert null is obs.NULL and not null.enabled and obs.resolve(False) is obs.NULL
    assert isinstance(obs.resolve(True), obs.Observer)
    o = obs.Observer()
    assert obs.resolve(o) is o
    assert null.span("a") is null.span("b", x=1) is obs.NullObserver._NULL_CTX
    args = {"loss": 1.0}
    for _ in range(10):  # warm every path once
        with null.span("step", step=1):
            null.event("e")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for i in range(1000):
            with null.span("step"):
                null.event("e")
                null.counter("c", args)
            null.log_step(i, args)
            null.flush()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = sum(s.size_diff for s in after.compare_to(before, "filename")
                if s.traceback[0].filename == obs.__file__)
    assert grown <= 0
    assert null.log_step(0, args) == {} and null.alerts == []


def test_observer_log_step_merges_hwmon_and_alerts_once():
    o = obs.Observer(hwmon=HardwareMonitor(MRRConfig(), recalibrate_every=16,
                                           drift_budget=0.03))
    host = o.log_step(1, {"loss": torch.tensor(0.5), "hw_residual_rms": 0.05})
    assert host["loss"] == 0.5 and "hw_effective_bits" in host
    assert "hw_effective_bits" in o.metrics.sinks[0].rows[-1]["metrics"]
    o.log_step(2, {"hw_residual_rms": torch.tensor(0.06)})
    warns = [e for e in o.trace.events if e["ph"] == "i" and e["name"].startswith("WARN:")]
    assert len(warns) == 1 and warns[0]["args"]["budget"] == 0.03
    assert o.metrics.counter("hwmon_alerts").value == 1.0
    a = obs.Observer(anomaly=AnomalyDetector(watch=("loss",), warmup=2, k=6.0))
    for i in range(8):
        a.log_step(i, {"loss": 1.0})
    assert a.log_step(8, {"loss": 99.0}).get("anomaly_loss") == 1.0
    assert a.metrics.snapshot()["anomaly_alerts"] == 1.0
    assert any(isinstance(x, obs.AnomalyAlert) for x in a.alerts)


@pytest.mark.parametrize("hardware,backend", [("emu_offchip", "emu"),
                                              ("onchip_bpd", "ref"), ("emu_ideal", "emu")])
def test_fit_with_observer_trace_rows_and_hw_gauges(tmp_path, hardware, backend):
    session = api.build_session(arch="mnist_mlp", smoke=True, hardware=hardware,
                                backend=backend, recalibrate_every=4, log_every=2,
                                device="cpu")
    observer = session.observe(metrics_path=str(tmp_path / "m.jsonl"),
                               trace_path=str(tmp_path / "t.json"))
    drifting = hardware == "emu_offchip"
    assert (observer.hwmon is not None) == drifting
    batch = _mlp_batch(session.model.in_dim)
    session.fit(lambda s: batch, total_steps=8, verbose=False)
    doc = json.load(open(observer.close()))
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [e["args"]["step"] for e in spans if e["name"] == "step"] == list(range(8))
    assert [e["args"]["step"] for e in spans if e["name"] == "drain"] == [2, 4, 6, 8]
    recals = {e["args"]["step"] for e in doc["traceEvents"] if e["name"] == "recalibration"}
    assert recals == ({4} if backend == "emu" else set())
    rows = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert [r["step"] for r in rows] == [2, 4, 6, 8]
    assert all("loss" in r["metrics"] for r in rows)
    assert all(("hw_effective_bits" in r["metrics"]) == drifting for r in rows)


def test_fit_without_observer_unchanged_and_interrupted_fit_leaves_jsonl(tmp_path):
    def run(observer):
        s = api.build_session(arch="mnist_mlp", smoke=True, log_every=4, device="cpu")
        batch = _mlp_batch(s.model.in_dim, seed=1)
        state, metrics = s.fit(lambda i: batch, total_steps=4, verbose=False,
                               observer=observer)
        return state, Registry.drain(metrics)

    (sa, a), (sb, b) = run(None), run(obs.Observer())
    assert a == b
    assert all(torch.equal(sa["params"][k], sb["params"][k]) for k in sa["params"])

    path = str(tmp_path / "run.jsonl")
    s = api.build_session(arch="mnist_mlp", smoke=True, hardware="emu_offchip",
                          backend="emu", log_every=1, prefetch=0, device="cpu")
    ob = s.observe(metrics_path=path)
    batch = _mlp_batch(s.model.in_dim)

    def data_fn(step):
        if step == 3:
            raise RuntimeError("boom")
        return batch

    with pytest.raises(RuntimeError, match="boom"):
        s.fit(data_fn, total_steps=10, verbose=False, observer=ob)
    assert [r["step"] for r in summarize.read_rows(path)] == [1, 2, 3]


def _serve(observer=None, debug_checks=False):
    session = api.build_session(arch=ARCH, smoke=True, algo="bp", hardware="offchip_bpd",
                                backend="cuda", debug_checks=debug_checks, device="cpu")
    eng = session.engine(batch_slots=2, max_len=32, seed=0, observer=observer)
    reqs = [Request(prompt=[i + 1, 2 * i + 3], max_new=3) for i in range(3)]
    eng.run(reqs)
    return eng, [r.out for r in reqs]


def test_engine_observer_request_tracks_and_tokens_unchanged():
    o = obs.Observer()
    eng, tokens = _serve(o)
    plain, tokens_plain = _serve(None)
    assert tokens == tokens_plain and eng.stats == plain.stats
    evs = o.trace.events
    begins = [e for e in evs if e["ph"] == "b"]
    ends = [e for e in evs if e["ph"] == "e"]
    # per request: the request track and QUEUED, PREFILL, DECODE, all closed
    assert len(begins) == len(ends) == 3 * 4
    assert len({e["id"] for e in begins if e["name"].startswith("request-")}) == 3
    assert len([e for e in evs if e["ph"] == "n" and e["name"] == "FIRST_TOKEN"]) == 3
    rid = begins[0]["id"]
    names = [e["name"] for e in evs if e.get("id") == rid and e["ph"] in "bne"]
    assert names.index("QUEUED") < names.index("PREFILL") < names.index("DECODE")
    ticks = [e for e in evs if e["ph"] == "X" and e["name"] in ("prefill_tick", "decode_tick")]
    assert len(ticks) == eng.stats["prefill_steps"] + eng.stats["decode_steps"]
    assert len([e for e in evs if e["ph"] == "C" and e["name"] == "engine"]) >= eng.stats["ticks"]


# ---------------------------------------------------------------------------
# runtime sanitizers
# ---------------------------------------------------------------------------

def test_check_finite_is_identity_outside_the_context():
    x = torch.tensor([1.0, float("nan")])
    assert runtime.check_finite(x, "x") is x and not runtime.debug_checks_enabled()
    with runtime.debug_checks():
        assert runtime.debug_checks_enabled()
        with pytest.raises(runtime.NonFiniteError, match="x"):
            runtime.check_finite(x, "x")
    assert runtime.checked(lambda: {"a": torch.ones(2), "i": torch.tensor([1])})()["i"][0] == 1
    with pytest.raises(runtime.NonFiniteError, match="b"):
        runtime.checked(lambda: {"b": torch.tensor(float("inf"))})()


@pytest.mark.parametrize("arch,backend", [("mnist_mlp", "cuda"), (ARCH, "cuda"),
                                          ("mnist_mlp", "emu")])
def test_debug_checks_pass_a_clean_step_and_raise_on_a_nan(arch, backend):
    hardware = "emu_offchip" if backend == "emu" else "offchip_bpd"
    session = api.build_session(arch=arch, smoke=True, hardware=hardware, backend=backend,
                                debug_checks=True, device="cpu")
    if arch == ARCH:
        batch = jtokens.MarkovTokens(session.model.cfg.vocab_size, 8, 2, 0).batch(0)
    else:
        batch = _mlp_batch(session.model.in_dim)
    state = session.init_state()
    new, metrics = session.step(state, batch)
    assert math.isfinite(float(metrics["loss"]))
    name = next(k for k in state["params"] if k.startswith(("h0.", "blocks.0.")))
    bad = dict(state, params={**state["params"]})
    bad["params"][name] = bad["params"][name].clone()
    bad["params"][name].view(-1)[0] = float("nan")
    with pytest.raises(runtime.NonFiniteError):
        session.step(bad, batch)
    _serve(debug_checks=True)  # a clean serve passes


# ---------------------------------------------------------------------------
# summarize, bench report, step cost
# ---------------------------------------------------------------------------

def test_summarize_roundtrip(tmp_path, capsys):
    path = str(tmp_path / "m.jsonl")
    reg = Registry([JsonlSink(path)])
    for s in range(10):
        reg.emit(s, {"loss": 1.0 / (s + 1), "steps_per_s": 100.0 + s,
                     "align_h0": 0.01 * s, "align_global": 0.02 * s})
    reg.emit(10, {"nb_total_var": 2.0, "nb_thermal_var": 1.5, "nb_adc_var": 0.5,
                  "nb_sum_var": 2.0, "nb_closure": 1.0, "nb_thermal_vs_analytic": 1.01})
    reg.close()
    rows = summarize.read_rows(path)
    table = summarize.aggregate(rows)
    assert table["loss"]["count"] == 10 and table["loss"]["last"] == pytest.approx(0.1)
    align = summarize.alignment_table(rows)
    assert align["align_h0"]["delta"] == pytest.approx(0.09) and align["align_h0"]["samples"] == 10
    nb = summarize.noise_budget_table(rows)
    assert nb["sources"]["thermal"]["share"] == 0.75 and nb["closure"] == 1.0
    assert summarize.main([path, "--bench-json", str(tmp_path / "b")]) == 0
    out = capsys.readouterr().out
    assert "alignment (DFA-vs-BP cosine)" in out and "noise budget" in out
    report = bench.load_bench(str(tmp_path / "b" / "BENCH_obs_summary.json"))
    assert report["metrics"]["loss_last"] == pytest.approx(0.1)


def test_bench_report_schema_environment_and_step_timer(tmp_path):
    env = bench.report.environment()
    assert "jax" not in env and env["torch"] == torch.__version__
    assert env["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    for bad in ({"schema": "x"}, {**bench.make_report("n", {"a": 1.0}), "metrics": {"a": True}},
                {**bench.make_report("n", {"a": 1.0}), "metrics": {"a": float("nan")}}):
        with pytest.raises(ValueError):
            bench.validate(bad)
    timer = bench.StepTimer(warmup=1, examples_per_step=4)
    timer.start()
    for _ in range(4):
        timer.tick(torch.device("cpu"))
    timer.set_step_cost(2e6)
    summary = timer.summary()
    assert summary["steps_measured"] == 3 and summary["macs_per_s"] > 0
    assert bench.clamped_warmup(3, 4) == 2
    path = bench.write_bench("t", summary, out_dir=str(tmp_path))
    assert bench.load_bench(path)["env"] == env


def _jax_step_cost(arch, batch):
    s = japi.build_session(arch=arch, smoke=arch != "mnist_mlp", algo="dfa", hardware="ideal",
                           backend="ref", data_parallel=False)
    return s.step_cost(s.init_state(), {k: jnp.asarray(v) for k, v in batch.items()}).flops


@pytest.mark.parametrize("arch", ["mnist_mlp", ARCH])
def test_step_cost_matches_reference(arch):
    """The MLP at batch 64 on ideal / ref: the reference's HLO count
    exactly (328,499,200).  The smoke LM: the port runs each block's last
    product (the MLP's down projection) again in the recompute, whose value
    the gradient never reads and XLA drops as dead code, so it counts
    exactly n_layers · 2·T·d_ff·d more: 48,758,784 against 46,661,632, a
    ratio of 1.0449."""
    session = api.build_session(arch=arch, smoke=arch != "mnist_mlp", hardware="ideal",
                                backend="ref", device="cpu")
    if arch == "mnist_mlp":
        batch = _mlp_batch(784, n=64)
        extra = 0
    else:
        cfg = session.model.cfg
        batch = jtokens.MarkovTokens(cfg.vocab_size, 16, 4, 0).batch(0)
        extra = cfg.n_layers * 2 * 64 * cfg.d_ff * cfg.d_model
    state = session.init_state()
    before = {k: v.clone() for k, v in state["params"].items()}
    cost = session.step_cost(state, batch)
    expect = _jax_step_cost(arch, batch)
    assert cost.flops == expect + extra and cost.kernel_launches == 0
    assert all(torch.equal(before[k], state["params"][k]) for k in before)
    if arch == "mnist_mlp":
        assert cost.flops == 328_499_200
    else:
        assert cost.flops / expect == pytest.approx(1.0449, abs=1e-4)


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["train", "serve"])
def test_launchers_write_trace_metrics_and_bench(tmp_path, which, capsys):
    trace, metrics = str(tmp_path / "t.json"), str(tmp_path / "m.jsonl")
    flags = ["--trace-out", trace, "--metrics-out", metrics, "--bench-json", str(tmp_path),
             "--device", "cpu"]
    if which == "serve":
        serve_launch.main(["--arch", ARCH, "--backend", "cuda", "--hardware", "offchip_bpd",
                           "--requests", "3", "--max-new", "3", *flags])
        bench_name = "BENCH_serve_live.json"
    else:
        # the LM branch: the MLP's spends its time making the digits
        train_launch.main(["--arch", ARCH, "--batch", "2", "--seq", "8", "--algo", "dfa",
                           "--backend", "emu", "--preset", "emu_onchip", "--steps", "5",
                           "--probe-every", "2", *flags])
        bench_name = "BENCH_train_throughput.json"
    out = capsys.readouterr().out
    assert f"[obs] wrote trace {trace}" in out
    doc = json.load(open(trace))
    events = doc["traceEvents"]
    report = bench.load_bench(str(tmp_path / bench_name))
    if which == "serve":
        tracks = {e["id"] for e in events if e["ph"] == "b" and e["name"].startswith("request-")}
        assert len(tracks) == 3 and report["metrics"]["requests"] == 3.0
        return
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert {"step", "probe", "drain"} <= names
    rows = summarize.read_rows(metrics)
    probe_rows = [r for r in rows if "align_global" in r["metrics"]]
    assert [r["step"] for r in probe_rows] == [0, 2, 4]
    assert "nb_closure" in probe_rows[0]["metrics"]
    assert report["metrics"]["macs_per_s"] > 0 and report["meta"]["devices"] == 1
    assert summarize.main([metrics]) == 0
    assert "alignment (DFA-vs-BP cosine)" in capsys.readouterr().out
