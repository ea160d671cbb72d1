"""Findings, inline suppressions, and the committed baseline.

A finding is one (rule, file, line) diagnostic.  Two escape hatches keep
the analyzer's exit code meaningful instead of aspirational:

* **inline suppression** — a trailing ``# lint: disable=RL002`` comment
  on the flagged line (or on the last line of a multi-line statement)
  acknowledges an *intentional* violation in place, with the comment
  itself documenting why.  ``# lint: disable`` with no rule list
  suppresses every rule on that line; ``# lint: disable-file=RL003``
  anywhere in a file suppresses a rule for the whole file (reserved for
  generated or fixture code).
* **baseline** — a JSON file (``--baseline``) records known findings as
  (rule, path, stripped-source-line) triples so the gate fails only on
  NEW findings.  Line numbers are deliberately not part of the match key:
  unrelated edits above a baselined finding must not break the gate.
  ``src/repro_torch`` needs no baseline — every real finding was fixed or
  suppressed-with-comment at introduction time.

Counterpart of ``repro/lint/findings.py``, a stdlib copy.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import re

_DISABLE_RE = re.compile(r"#\s*lint:\s*disable(?:=([A-Z0-9, ]+))?")
_DISABLE_FILE_RE = re.compile(r"#\s*lint:\s*disable-file=([A-Z0-9, ]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str  # "RL001" … "RL004"
    path: str  # repo-relative path of the offending file
    line: int  # 1-based line of the flagged node
    message: str
    code: str = ""  # stripped source line — the baseline match key

    @property
    def key(self) -> tuple:
        return (self.rule, self.path, self.code)

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _rules_in(match_group: str | None) -> set[str] | None:
    """None means "all rules" (a bare ``# lint: disable``)."""
    if match_group is None:
        return None
    return {r.strip() for r in match_group.split(",") if r.strip()}


class Suppressions:
    """Per-file view of inline + file-level disable comments."""

    def __init__(self, lines: list[str]):
        self.line_rules: dict[int, set[str] | None] = {}
        self.file_rules: set[str] = set()
        for i, text in enumerate(lines, start=1):
            m = _DISABLE_FILE_RE.search(text)
            if m:
                self.file_rules |= _rules_in(m.group(1)) or set()
                continue
            m = _DISABLE_RE.search(text)
            if m:
                self.line_rules[i] = _rules_in(m.group(1))

    def covers(self, rule: str, *lines: int | None) -> bool:
        if rule in self.file_rules:
            return True
        for ln in lines:
            if ln is None:
                continue
            rules = self.line_rules.get(ln, False)
            if rules is False:
                continue
            if rules is None or rule in rules:
                return True
        return False


def load_baseline(path: str | None) -> collections.Counter:
    """Baseline file -> multiset of finding keys (empty when absent)."""
    if path is None:
        return collections.Counter()
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return collections.Counter()
    return collections.Counter(
        (e["rule"], e["path"], e.get("code", "")) for e in data.get("findings", ()))


def write_baseline(path: str, findings: list[Finding]) -> None:
    entries = [{"rule": f.rule, "path": f.path, "code": f.code}
               for f in sorted(findings, key=lambda f: (f.path, f.rule, f.code))]
    with open(path, "w") as f:
        json.dump({"version": 1, "findings": entries}, f, indent=2)
        f.write("\n")


def new_findings(findings: list[Finding],
                 baseline: collections.Counter) -> list[Finding]:
    """Findings not accounted for by the baseline multiset."""
    budget = collections.Counter(baseline)
    fresh = []
    for f in findings:
        if budget[f.key] > 0:
            budget[f.key] -= 1
        else:
            fresh.append(f)
    return fresh
