"""``repro_torch.lint`` — static analysis for eager PyTorch and the runtime
sanitizers.  Counterpart of ``repro/lint``.

Static rules (``python -m repro_torch.lint [paths] [--baseline FILE]``;
stdlib only, it loads no ``torch``):

=======  ==============================================================
RL001    Seed discipline — one integer key feeding ≥2 generators,
         seeded launches or unknown consumers without a fresh
         ``utils.prng.fold``; ``utils.prng.consume(key)`` marks a key
         spent explicitly.
RL002    Host sync in a hot path — ``.item()`` / ``.tolist()`` /
         ``.cpu()`` / ``float()`` of a tensor / ``torch.cuda.synchronize``
         … reachable from ``Trainer.fit``/``step``, ``Engine`` ticks, a
         ``torch.compile``d function or a ``# lint: hot-root``; in
         *driver* functions, per-iteration syncs in loops.
RL003    Python ``if``/``while`` on a tensor value in hot code (an
         implicit ``bool()`` sync).
RL004    Frozen-config mutation and dict-mutation of carried state in
         hot code.
=======  ==============================================================

The reference's RL005 (reads after ``donate_argnums``) has no
counterpart: eager PyTorch donates no buffer.

Suppress intentional findings in place with a trailing
``# lint: disable=RL002`` comment that says why; ``src/repro_torch``
lints clean with no baseline file.

Runtime layer (``repro_torch.lint.runtime``, loaded on first use):
``check_finite`` / ``checked`` / ``debug_checks``, the sanitizers the
trainer and the engine arm with ``debug_checks=True``.
"""

from __future__ import annotations

from repro_torch.lint.analysis import Project, load_project, project_from_sources
from repro_torch.lint.findings import (Finding, Suppressions, load_baseline,
                                       new_findings, write_baseline)
from repro_torch.lint.hotpath import hot_reachable, run_rl002, run_rl003
from repro_torch.lint.rules import run_rl001, run_rl004

ALL_RULES = ("RL001", "RL002", "RL003", "RL004")
# the reference's rules that have no counterpart here, with the reason
NO_COUNTERPART = {"RL005": "RL005 (read after donate) has no counterpart: eager PyTorch "
                           "donates no buffer"}

# the static analyzer is stdlib-only; the runtime sanitizers need torch,
# so they resolve lazily
_RUNTIME_NAMES = ("runtime", "NonFiniteError", "check_finite", "check_tree", "checked",
                  "debug_checks", "debug_checks_enabled")


def __getattr__(name):
    if name in _RUNTIME_NAMES:
        from repro_torch.lint import runtime
        return runtime if name == "runtime" else getattr(runtime, name)
    raise AttributeError(f"module 'repro_torch.lint' has no attribute {name!r}")


def run_rules(proj: Project, rules=ALL_RULES) -> tuple[list[Finding], int]:
    """All findings for a project, minus inline suppressions.

    Returns ``(findings, n_suppressed)``; findings are sorted by
    (path, line, rule).
    """
    reachable = hot_reachable(proj)
    raw: list[Finding] = []
    if "RL001" in rules:
        raw += run_rl001(proj)
    if "RL002" in rules:
        raw += run_rl002(proj, reachable)
    if "RL003" in rules:
        raw += run_rl003(proj, reachable)
    if "RL004" in rules:
        raw += run_rl004(proj, reachable)
    sups = {path: Suppressions(mod.lines) for path, mod in proj.modules.items()}
    kept, suppressed = [], 0
    for f in raw:
        s = sups.get(f.path)
        lines = (f.line, f.line + 1)
        if s is not None and s.covers(f.rule, *lines):
            suppressed += 1
        else:
            kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    return kept, suppressed


def lint_paths(paths, rules=ALL_RULES) -> tuple[list[Finding], int]:
    """Lint files/directories -> (findings, n_suppressed)."""
    return run_rules(load_project(list(paths)), rules)


def lint_source(source: str, path: str = "fixture.py",
                rules=ALL_RULES) -> list[Finding]:
    """Lint one in-memory module (test fixtures)."""
    findings, _ = run_rules(project_from_sources({path: source}), rules)
    return findings
