"""The port's static linter (``repro_torch.lint``) on the CPU: the
findings plumbing against the reference's on the same inputs, the
reference's RL004 fixtures through both linters, a positive and a negative
torch fixture for every RL001–RL003 pattern, the CLI's exit codes, the
port's own tree linting clean, and the static layer loading no torch."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.lint import findings as jfindings
from repro.lint import lint_source as jlint_source
from repro_torch import lint
from repro_torch.lint import __main__ as cli
from repro_torch.lint import findings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")


def rules_of(source, path="fixture.py"):
    return {f.rule for f in lint.lint_source(textwrap.dedent(source), path)}


def findings_of(source, rule):
    return [(f.rule, f.line) for f in lint.lint_source(textwrap.dedent(source))
            if f.rule == rule]


# ---------------------------------------------------------------------------
# findings, suppressions, baseline: the same results as the reference's
# ---------------------------------------------------------------------------

SUPPRESSION_LINES = [
    "x = 1",
    "y = f(x)  # lint: disable=RL002",
    "z = g(y)  # lint: disable",
    "w = h(z)  # lint: disable=RL001, RL004",
    "# lint: disable-file=RL003",
    "v = k(w)  # lint:disable=RL002,RL001",
]


@pytest.mark.parametrize("rule", ["RL001", "RL002", "RL003", "RL004"])
def test_suppressions_match_the_reference(rule):
    ours, ref = findings.Suppressions(SUPPRESSION_LINES), jfindings.Suppressions(SUPPRESSION_LINES)
    assert ours.line_rules == ref.line_rules and ours.file_rules == ref.file_rules
    for line in range(0, len(SUPPRESSION_LINES) + 2):
        assert ours.covers(rule, line, line + 1) == ref.covers(rule, line, line + 1)
        assert ours.covers(rule, None, line) == ref.covers(rule, None, line)


def test_baseline_round_trip_and_new_findings_match_the_reference(tmp_path):
    made = [("RL002", "a.py", 3, "m", "x.item()"), ("RL001", "b.py", 9, "m", "g(key)"),
            ("RL002", "a.py", 7, "m", "x.item()"), ("RL004", "a.py", 1, "m", "cfg.lr = 1")]
    ours = [findings.Finding(*f) for f in made]
    ref = [jfindings.Finding(*f) for f in made]
    findings.write_baseline(str(tmp_path / "ours.json"), ours[:3])
    jfindings.write_baseline(str(tmp_path / "ref.json"), ref[:3])
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "ref.json").read_text()
    base = findings.load_baseline(str(tmp_path / "ours.json"))
    assert base == jfindings.load_baseline(str(tmp_path / "ref.json"))
    assert findings.load_baseline(None) == jfindings.load_baseline(None)
    assert findings.load_baseline(str(tmp_path / "absent.json")) == {}
    extra = [("RL002", "a.py", 11, "m", "x.item()"), ("RL003", "c.py", 2, "m", "if x.any():")]
    fresh = findings.new_findings(ours + [findings.Finding(*f) for f in extra], base)
    jfresh = jfindings.new_findings(ref + [jfindings.Finding(*f) for f in extra], base)
    assert [vars(f) for f in fresh] == [vars(f) for f in jfresh]
    assert [f.line for f in fresh] == [1, 11, 2]
    assert [f.render() for f in fresh] == [f.render() for f in jfresh]


# ---------------------------------------------------------------------------
# RL004: the reference's fixtures through both linters
# ---------------------------------------------------------------------------

RL004_FIXTURES = {
    "frozen_mutation": """
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class Cfg:
            lr: float = 0.1

        def tune(cfg: Cfg):
            cfg.lr = 0.2
            return cfg
    """,
    "frozen_replace": """
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class Cfg:
            lr: float = 0.1

        def tune(cfg: Cfg):
            cfg = dataclasses.replace(cfg, lr=0.2)
            return cfg
    """,
    "state_mutation": """
        import jax

        @jax.jit
        def step(state, batch):
            state["x"] = state["x"] + batch
            return state
    """,
    "state_rebuilt": """
        import jax

        @jax.jit
        def step(state, batch):
            return {**state, "x": state["x"] + batch}
    """,
}


@pytest.mark.parametrize("name", sorted(RL004_FIXTURES))
def test_rl004_reference_fixtures_give_the_same_findings(name):
    """The port's hot root in place of ``jax.jit`` (``torch.compile``, on
    the same line), every other line as the reference's fixture."""
    source = textwrap.dedent(RL004_FIXTURES[name])
    ported = source.replace("import jax", "import torch").replace("@jax.jit", "@torch.compile")
    ref = [(f.rule, f.line) for f in jlint_source(source) if f.rule == "RL004"]
    ours = [(f.rule, f.line) for f in lint.lint_source(ported) if f.rule == "RL004"]
    assert ours == ref
    assert bool(ours) == (name in ("frozen_mutation", "state_mutation"))


# ---------------------------------------------------------------------------
# RL001: seed discipline
# ---------------------------------------------------------------------------

RL001_CASES = {
    "two_generators": ("""
        from repro_torch.utils import prng

        def f(key, device):
            a = prng.generator(key, device)
            b = prng.generator(key, device)
            return a, b
    """, """
        from repro_torch.utils import prng

        def f(key, device):
            a = prng.generator(prng.fold(key, 0), device)
            b = prng.generator(prng.fold(key, 1), device)
            return a, b
    """),
    "manual_seed_twice": ("""
        import torch

        def f(seed):
            a = torch.Generator().manual_seed(int(seed))
            b = torch.Generator().manual_seed(int(seed) & 0xFFFFFFFF)
            return a, b
    """, """
        import torch
        from repro_torch.utils import prng

        def f(seed):
            a = torch.Generator().manual_seed(int(prng.fold(seed, "a")))
            b = torch.Generator().manual_seed(int(prng.fold(seed, "b")))
            return a, b
    """),
    "seeded_launches": ("""
        from repro_torch.kernels import photonic_matmul as pm

        def f(a, b, key):
            x = pm.photonic_matmul_cuda(a, b, seed=key)
            y = pm.photonic_matmul_cuda(b, a, seed=key)
            return x, y
    """, """
        from repro_torch.kernels import photonic_matmul as pm
        from repro_torch.utils import prng

        def f(a, b, key):
            x = pm.photonic_matmul_cuda(a, b, seed=prng.fold(key, 0))
            y = pm.photonic_matmul_cuda(b, a, seed=prng.fold(key, 1))
            return x, y
    """),
    "unknown_consumer": ("""
        from repro_torch.utils import prng

        def f(key, helper, device):
            a = helper(key)
            b = prng.generator(key, device)
            return a, b
    """, """
        from repro_torch.utils import prng

        def f(key, helper, device):
            a = helper(prng.fold(key, "helper"))
            b = prng.generator(prng.fold(key, "gen"), device)
            return a, b
    """),
    "use_after_consume": ("""
        from repro_torch.utils import prng

        def f(key, device):
            a = prng.generator(prng.consume(key), device)
            b = prng.fold(key, 1)
            return a, b
    """, """
        from repro_torch.utils import prng

        def f(key, device):
            b = prng.fold(key, 1)
            a = prng.generator(prng.consume(key), device)
            return a, b
    """),
    "loop_invariant": ("""
        from repro_torch.utils import prng

        def f(key, device):
            out = []
            for _ in range(3):
                out.append(prng.generator(key, device))
            return out
    """, """
        from repro_torch.utils import prng

        def f(key, device):
            out = []
            for i in range(3):
                out.append(prng.generator(prng.fold(key, i), device))
            return out
    """),
}


@pytest.mark.parametrize("case", sorted(RL001_CASES))
def test_rl001_flags_the_pattern_and_not_its_fix(case):
    bad, good = RL001_CASES[case]
    assert "RL001" in rules_of(bad)
    assert "RL001" not in rules_of(good)


def test_rl001_exclusive_branches_and_derive_only_callees():
    assert "RL001" not in rules_of("""
        from repro_torch.utils import prng

        def seg(x, key):
            return prng.fold(key, x)

        def f(key, device, fast):
            a = seg(1, key)
            b = seg(2, key)
            if fast:
                return prng.generator(key, device)
            return prng.generator(key, device), a, b
    """)


# ---------------------------------------------------------------------------
# RL002: host syncs in hot paths
# ---------------------------------------------------------------------------

SYNCS = {
    "item": "x.sum().item()",
    "tolist": "x.tolist()",
    "cpu": "x.cpu()",
    "numpy": "x.detach().numpy()",
    "to_cpu": 'x.to("cpu")',
    "to_device_cpu": "x.to(device=torch.device('cpu'))",
    "float": "float(x.sum())",
    "int": "int(torch.argmax(x))",
    "bool": "bool((x > 0).all())",
    "np_asarray": "np.asarray(x.abs())",
    "cuda_synchronize": "torch.cuda.synchronize()",
    "event_synchronize": "ev.synchronize()",
    "event_elapsed": "ev.elapsed_time(ev)",
}
HOST_TWINS = {
    "item": "len(x)",
    "tolist": "list(range(3))",
    "cpu": "x.to(self.device)",
    "numpy": "x.detach()",
    "to_cpu": "x.to(self.device)",
    "to_device_cpu": "x.to(device=self.device)",
    "float": "float(self.lr)",
    "int": "int(self.steps)",
    "bool": "bool(self.flag)",
    "np_asarray": "np.asarray([1, 2])",
    "cuda_synchronize": "torch.cuda.is_available()",
    "event_synchronize": "ev.record()",
    "event_elapsed": "ev.query()",
}


def _trainer_fixture(expr):
    return f"""
        import numpy as np
        import torch

        class Trainer:
            def step(self, state, batch, ev):
                x = self._forward(state, batch)
                y = {expr}
                return x, y

            def _forward(self, state, batch):
                return state["w"] @ batch
    """


@pytest.mark.parametrize("kind", sorted(SYNCS))
def test_rl002_flags_each_sync_in_the_hot_path_and_not_its_host_twin(kind):
    hits = findings_of(_trainer_fixture(SYNCS[kind]), "RL002")
    assert hits == [("RL002", 8)], hits
    assert "RL002" not in rules_of(_trainer_fixture(HOST_TWINS[kind]))


def test_rl002_reaches_through_calls_and_suppresses_inline():
    src = """
        class Engine:
            def tick(self):
                return self._decode()

            def _decode(self):
                return self.logits.argmax(-1).tolist()
    """
    assert findings_of(src, "RL002") == [("RL002", 7)]
    assert "RL002" not in rules_of(src.replace(".tolist()", ".tolist()  # lint: disable=RL002"))
    # outside any hot path the same read is how results leave the card
    assert "RL002" not in rules_of(src.replace("class Engine", "class Report"))


def test_rl002_driver_loops_flag_per_iteration_syncs_only():
    bad = """
        def run(trainer, state, batches):
            out = []
            for b in batches:
                state, m = trainer.step(state, b)
                out.append(m["loss"].item())
            return out
    """
    good = """
        import torch

        def run(trainer, state, batches):
            losses = []
            for b in batches:
                state, m = trainer.step(state, b)
                losses.append(m["loss"])
            return torch.stack(losses).tolist()
    """
    assert findings_of(bad, "RL002") == [("RL002", 6)]
    assert "RL002" not in rules_of(good)


def test_rl002_compiled_and_marked_roots():
    compiled = """
        import torch

        @torch.compile
        def f(x):
            return x.sum().item()
    """
    marked = """
        def f(x):  # lint: hot-root
            return x.sum().item()
    """
    assigned = """
        import torch

        def g(x):
            return x.sum().item()

        h = torch.compile(g)
    """
    for src in (compiled, marked, assigned):
        assert "RL002" in rules_of(src)
    assert "RL002" not in rules_of(marked.replace("  # lint: hot-root", ""))


# ---------------------------------------------------------------------------
# RL003: Python control flow on tensor values in hot code
# ---------------------------------------------------------------------------

RL003_CASES = {
    "if_any": ("if x.any():", "if x.shape[0] > 1:"),
    "if_torch": ("if torch.isfinite(x).all():", "if torch.is_floating_point(x):"),
    "if_compare": ("if (x > 0).sum() > 3:", "if x.dtype == torch.float32:"),
    "while_local": ("while loss > 1.0:", "while steps > 1:"),
}


@pytest.mark.parametrize("case", sorted(RL003_CASES))
def test_rl003_flags_tensor_tests_and_not_reflection(case):
    tmpl = """
        import torch

        class Trainer:
            def step(self, x, steps):
                loss = x.square().mean()
                {test}
                    x = x * 0.5
                    loss = loss * 0.5
                return x
    """
    bad, good = RL003_CASES[case]
    assert findings_of(tmpl.format(test=bad), "RL003") == [("RL003", 7)]
    assert "RL003" not in rules_of(tmpl.format(test=good))


# ---------------------------------------------------------------------------
# the CLI, the port's own tree, the engine, the import
# ---------------------------------------------------------------------------

def test_cli_exit_codes_and_json(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("def f(x):\n    return x\n")
    dirty = tmp_path / "dirty.py"
    dirty.write_text(textwrap.dedent(_trainer_fixture(SYNCS["item"])))
    assert cli.main([str(clean)]) == 0
    assert cli.main([str(dirty)]) == 1
    capsys.readouterr()
    assert cli.main([str(dirty), "--format", "json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in out["findings"]] == ["RL002"] and out["suppressed"] == 0
    base = tmp_path / "base.json"
    assert cli.main([str(dirty), "--baseline", str(base), "--write-baseline"]) == 0
    assert cli.main([str(dirty), "--baseline", str(base)]) == 0
    for argv in (["--rules", "RL005"], ["--rules", "RL009"], ["--write-baseline"]):
        with pytest.raises(SystemExit) as err:
            cli.main([str(clean), *argv])
        assert err.value.code == 2
    assert "eager PyTorch donates no buffer" in capsys.readouterr().err


def test_the_port_lints_clean_with_no_baseline_and_loads_no_torch():
    """``python -m repro_torch.lint src/repro_torch``: exit 0, and neither
    the package nor the run loads torch."""
    env = {**os.environ, "PYTHONPATH": SRC}
    code = ("import sys, runpy\n"
            "sys.argv = ['repro_torch.lint', 'src/repro_torch']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.lint', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "print('RC', rc, 'TORCH', 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert "RC 0 TORCH False" in out.stdout, out.stdout + out.stderr
    assert "0 new finding(s), 0 baselined" in out.stdout


def test_a_sync_inserted_in_an_engine_tick_flags_at_that_line(tmp_path):
    with open(os.path.join(PORT, "serve", "engine.py"), encoding="utf-8") as f:
        lines = f.read().splitlines()
    start = next(i for i, line in enumerate(lines) if line.strip() == "def _decode_tick(self):")
    at = start + 1  # the tick's first statement
    lines.insert(at, "        _ = self._tokens_on_card.sum().item()")
    copy = tmp_path / "engine.py"
    copy.write_text("\n".join(lines) + "\n")
    found, _ = lint.lint_paths([str(copy)])
    assert [(f.rule, f.line) for f in found] == [("RL002", at + 1)]
    assert "Engine._decode_tick" in found[0].message
