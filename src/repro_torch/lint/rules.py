"""Per-function rules: RL001 (seed discipline) and RL004 (frozen-config
and carried-state mutation).  Counterpart of ``repro/lint/rules.py``.

RL001 runs a small flow-aware scan over each function body.  The port's
keys are integers: ``utils.prng.fold`` derives one from a seed and names,
and a draw turns one into random numbers — a generator seeded with it
(``prng.generator(key, device)``, ``torch.Generator().manual_seed(key)``)
or a seeded kernel launch (``seed=key``).  Every assignment mints a fresh
*version* of a name; versions created from key-producing calls
(``prng.fold`` / ``step_key``, ``emu_matmul.seed_words``) are key-typed,
as are parameters named like keys (``key``, ``seed``, ``rng``,
``*_key``).  A key version is *spent* by a draw, or by being handed to an
unresolved call (the callee will draw from it —
``bank_product(a, b, cfg, key)`` spends ``key``).  Derivations (``fold``
and the like) read without spending: ``fold(key, 1)`` then
``fold(key, 2)`` is the intended idiom; ``int(key)`` and ``int(key) & M``
are the key itself.  Spending a version twice flags the second site
(one seed feeding two generators makes two equal streams);
``prng.consume(key)`` kills the version outright so ANY later use flags.
``if``/``else`` branches are scanned against copies and merged by max
(only one branch executes); loop bodies are scanned twice so a
loop-invariant key drawn each iteration is caught on the second pass.

RL005 (a buffer read after it was donated) has no counterpart: eager
PyTorch donates no buffer to a call, so no read can follow a donation.
"""

from __future__ import annotations

import ast
import dataclasses
import itertools

from repro_torch.lint.analysis import (CONSUME_QUALS, DERIVE_QUALS, DRAW_METHODS,
                                       DRAW_QUALS, KEY_CASTS, KEY_PRODUCERS, Func,
                                       Module, Project, param_for_arg)
from repro_torch.lint.findings import Finding


def _src(mod: Module, node: ast.AST) -> str:
    ln = getattr(node, "lineno", 0)
    if 0 < ln <= len(mod.lines):
        return mod.lines[ln - 1].strip()
    return ""


# =========================================================================
# RL001 — seed discipline
# =========================================================================


@dataclasses.dataclass
class _KeyVersion:
    name: str
    vid: int
    spends: int = 0
    dead: bool = False
    dead_site: str = ""


class _KeyScan:
    def __init__(self, proj: Project, mod: Module, fn: Func,
                 findings: list[Finding]):
        self.proj = proj
        self.mod = mod
        self.fn = fn
        self.findings = findings
        self.vids = itertools.count()
        self.reported: set[tuple[int, int]] = set()  # (lineno, version id)

    # -- environment helpers ----------------------------------------------
    def fresh(self, env, name: str, is_key: bool):
        env[name] = _KeyVersion(name, next(self.vids)) if is_key else None

    def flag(self, node: ast.AST, ver: _KeyVersion, why: str):
        site = (node.lineno, ver.vid)
        if site in self.reported:
            return
        self.reported.add(site)
        self.findings.append(Finding(
            "RL001", self.mod.path, node.lineno,
            f"seed `{ver.name}` {why} in {self.fn.qualname} — "
            "fold a fresh key per draw (utils.prng.fold)",
            _src(self.mod, node)))

    # -- expression scan ---------------------------------------------------
    def _key_name(self, node: ast.AST) -> ast.Name | None:
        """The name an argument passes on unchanged: ``key``,
        ``int(key)``, ``int(key) & MASK``."""
        while True:
            if isinstance(node, ast.Name):
                return node
            if (isinstance(node, ast.Call) and len(node.args) == 1
                    and (self.mod.dotted(node.func) or "") in KEY_CASTS):
                node = node.args[0]
            elif isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitAnd, ast.BitXor)):
                node = node.left
            else:
                return None

    def _key_args(self, call: ast.Call) -> list[tuple[ast.Name, bool]]:
        """(name-node, is_first_or_key_kwarg) for arguments that pass a name
        on unchanged."""
        out = []
        for i, a in enumerate(call.args):
            name = self._key_name(a)
            if name is not None:
                out.append((name, i == 0))
        for kw in call.keywords:
            name = self._key_name(kw.value)
            if name is not None:
                out.append((name, kw.arg in ("key", "rng", "seed")))
        return out

    def scan_expr(self, node: ast.AST, env: dict) -> bool:
        """Scan one expression; returns True when it produces a key value."""
        for call in [n for n in ast.walk(node) if isinstance(n, ast.Call)]:
            qual = self.mod.qualify(self.mod.dotted(call.func) or "")
            if qual in KEY_CASTS:
                continue  # the key itself, read by the call around it
            is_draw = qual in DRAW_QUALS or (isinstance(call.func, ast.Attribute)
                                             and call.func.attr in DRAW_METHODS)
            is_derive = qual in DERIVE_QUALS
            is_consume = qual in CONSUME_QUALS
            for name_node, in_key_pos in self._key_args(call):
                ver = env.get(name_node.id)
                if ver is None:
                    continue
                if ver.dead:
                    self.flag(call, ver,
                              f"used after prng.consume ({ver.dead_site})")
                    continue
                if is_consume and in_key_pos:
                    ver.dead = True
                    ver.dead_site = f"line {call.lineno}"
                elif is_draw and in_key_pos:
                    ver.spends += 1
                    if ver.spends > 1:
                        self.flag(call, ver,
                                  "feeds a second random draw with no "
                                  "fresh fold")
                elif is_derive:
                    pass  # reading a key to mint new ones is the idiom
                else:
                    # unresolved callee given a key: assume it draws once —
                    # unless it resolves to a project fn that only derives
                    if (self._takes_key(call, name_node)
                            and not self._callee_derives_only(call, name_node)):
                        ver.spends += 1
                        if ver.spends > 1:
                            self.flag(call, ver,
                                      "is handed to a second consumer with "
                                      "no fresh fold")
        return self._produces_key(node, env)

    def _produces_key(self, node: ast.AST, env: dict) -> bool:
        """Key-typedness of the expression ROOT only — a key buried in an
        argument list (``describe(init, prng.fold(seed, 0))``) does not
        make the assigned value a key."""
        while isinstance(node, ast.Subscript):
            node = node.value  # seed_words(key)[0] is a key
        name = self._key_name(node)
        if name is not None and name is not node:
            return env.get(name.id) is not None  # int(key) & M keeps key-typedness
        if isinstance(node, ast.Call):
            qual = self.mod.qualify(self.mod.dotted(node.func) or "")
            return qual in KEY_PRODUCERS or qual in CONSUME_QUALS
        if isinstance(node, ast.Name):
            return env.get(node.id) is not None  # alias keeps key-typedness
        return False

    def _callee_derives_only(self, call: ast.Call,
                             name_node: ast.Name) -> bool:
        callees = self.proj.resolve_call(self.mod, self.fn, call)
        if not callees:
            return False
        for callee in callees:
            pname = param_for_arg(callee, call, name_node)
            if pname is None or not self.proj.derive_only(callee, pname):
                return False
        return True

    def _takes_key(self, call: ast.Call, name_node: ast.Name) -> bool:
        """Heuristic: a key passed positionally or as key=/rng=/seed= to an
        unknown callee is consumed there (``seed=`` is a kernel's seeded
        launch).  Attribute reads like ``state["hw"]`` or prints are not
        calls and never reach here."""
        for kw in call.keywords:
            if self._key_name(kw.value) is name_node:
                return kw.arg in ("key", "rng", "seed")
        return any(self._key_name(a) is name_node for a in call.args)

    # -- statement scan ----------------------------------------------------
    def scan_block(self, stmts, env: dict):
        for stmt in stmts:
            self.scan_stmt(stmt, env)

    def _assign_targets(self, target, env, is_key: bool):
        if isinstance(target, ast.Name):
            self.fresh(env, target.id, is_key)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._assign_targets(elt, env, is_key)

    def scan_stmt(self, stmt, env: dict):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: scanned as its own function by run_rl001
            return
        if isinstance(stmt, ast.Assign):
            is_key = self.scan_expr(stmt.value, env)
            for t in stmt.targets:
                self._assign_targets(t, env, is_key)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            if stmt.value is not None:
                is_key = self.scan_expr(stmt.value, env)
            else:
                is_key = False
            self._assign_targets(stmt.target, env, is_key)
        elif isinstance(stmt, ast.If):
            self.scan_expr(stmt.test, env)
            b_env = self._copy(env)
            o_env = self._copy(env)
            self.scan_block(stmt.body, b_env)
            self.scan_block(stmt.orelse, o_env)
            b_term = self._terminates(stmt.body)
            o_term = self._terminates(stmt.orelse)
            if b_term and not o_term:
                # early return/raise: spends in the body never reach here
                env.clear()
                env.update(o_env)
            elif o_term and not b_term:
                env.clear()
                env.update(b_env)
            elif not b_term:  # neither terminates: join
                self._merge(env, b_env, o_env)
            # both terminate -> fall-through is unreachable; env moot
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self.scan_expr(stmt.iter, env)
            self._assign_targets(stmt.target, env, False)
            for _ in range(2):  # second pass: loop-invariant key reuse
                body_env = self._copy(env)
                self.scan_block(stmt.body, body_env)
                self._merge(env, body_env, body_env)
            self.scan_block(stmt.orelse, env)
        elif isinstance(stmt, ast.While):
            self.scan_expr(stmt.test, env)
            for _ in range(2):
                body_env = self._copy(env)
                self.scan_block(stmt.body, body_env)
                self._merge(env, body_env, body_env)
            self.scan_block(stmt.orelse, env)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                is_key = self.scan_expr(item.context_expr, env)
                if item.optional_vars is not None:
                    self._assign_targets(item.optional_vars, env, is_key)
            self.scan_block(stmt.body, env)
        elif isinstance(stmt, ast.Try):
            self.scan_block(stmt.body, env)
            for h in stmt.handlers:
                self.scan_block(h.body, self._copy(env))
            self.scan_block(stmt.orelse, env)
            self.scan_block(stmt.finalbody, env)
        elif isinstance(stmt, (ast.Return, ast.Expr)):
            if stmt.value is not None:
                self.scan_expr(stmt.value, env)
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self.scan_expr(child, env)

    @staticmethod
    def _terminates(stmts) -> bool:
        return bool(stmts) and isinstance(
            stmts[-1], (ast.Return, ast.Raise, ast.Break, ast.Continue))

    @staticmethod
    def _copy(env: dict) -> dict:
        return {k: (dataclasses.replace(v) if v is not None else None)
                for k, v in env.items()}

    @staticmethod
    def _merge(env: dict, a: dict, b: dict):
        """Join branch environments: spends by max (one branch runs),
        dead if dead on any path, drop names whose versions diverged."""
        for k in list(env):
            ver = env.get(k)
            if ver is None:
                continue
            va, vb = a.get(k), b.get(k)
            if va is None or vb is None or va.vid != ver.vid or vb.vid != ver.vid:
                env[k] = None  # rebound in a branch — unknown afterwards
                continue
            ver.spends = max(va.spends, vb.spends)
            ver.dead = va.dead or vb.dead
            ver.dead_site = va.dead_site or vb.dead_site


_KEYISH_PARAMS = ("key", "rng", "prng_key", "rngs", "seed", "seed_key")
# predicate-style prefixes: `is_key`, `has_key`, ... are booleans, not keys
_NOT_KEY_PREFIXES = ("is_", "has_", "use_", "with_", "as_", "no_")


def _param_is_keyish(name: str) -> bool:
    if name in _KEYISH_PARAMS:
        return True
    return name.endswith("_key") and not name.startswith(_NOT_KEY_PREFIXES)


def run_rl001(proj: Project) -> list[Finding]:
    findings: list[Finding] = []
    for mod in proj.modules.values():
        for fn in mod.funcs:
            scan = _KeyScan(proj, mod, fn, findings)
            env: dict = {}
            args = fn.node.args
            for a in (list(args.posonlyargs) + list(args.args)
                      + list(args.kwonlyargs)):
                # parameters that look like keys participate from the start
                if _param_is_keyish(a.arg):
                    scan.fresh(env, a.arg, True)
            body = fn.node.body if not isinstance(fn.node, ast.Lambda) else []
            scan.scan_block(body, env)
    return findings


# =========================================================================
# RL004 — frozen-config mutation and dict-mutation of carried state
# =========================================================================

_DICT_MUTATORS = ("update", "pop", "clear", "setdefault", "popitem")


def _annotation_name(node) -> str | None:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(".")[-1].strip()
    return None


def run_rl004(proj: Project, hot_reachable) -> list[Finding]:
    findings: list[Finding] = []
    frozen = proj.frozen_classes
    for mod in proj.modules.values():
        for fn in mod.funcs:
            if isinstance(fn.node, ast.Lambda):
                continue
            # (a) frozen-dataclass attribute assignment
            frozen_vars: set[str] = set()
            args = fn.node.args
            for a in (list(args.posonlyargs) + list(args.args)
                      + list(args.kwonlyargs)):
                ann = _annotation_name(a.annotation)
                if ann in frozen:
                    frozen_vars.add(a.arg)
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                    qual = mod.dotted(node.value.func) or ""
                    name = qual.rsplit(".", 1)[-1]
                    tgt_frozen = name in frozen or (
                        qual in ("dataclasses.replace", "replace")
                        and node.value.args
                        and isinstance(node.value.args[0], ast.Name)
                        and node.value.args[0].id in frozen_vars)
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            if tgt_frozen:
                                frozen_vars.add(t.id)
                            else:
                                frozen_vars.discard(t.id)
                elif isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            frozen_vars.discard(t.id)
            for node in ast.walk(fn.node):
                if not isinstance(node, (ast.Assign, ast.AugAssign)):
                    continue
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id in frozen_vars):
                        findings.append(Finding(
                            "RL004", mod.path, node.lineno,
                            f"mutation of frozen config `{t.value.id}.{t.attr}` "
                            f"in {fn.qualname} — use dataclasses.replace",
                            _src(mod, node)))
            # (b) dict-mutation of carried state (a hot function's inputs)
            if fn not in hot_reachable:
                continue
            params = {a.arg for a in (list(args.posonlyargs) + list(args.args)
                                      + list(args.kwonlyargs))} - {"self"}
            aliases = set(params)
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Assign):
                    src_alias = (isinstance(node.value, ast.Name)
                                 and node.value.id in aliases)
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            if src_alias:
                                aliases.add(t.id)
                            else:
                                aliases.discard(t.id)
            for node in ast.walk(fn.node):
                bad = None
                if (isinstance(node, ast.Assign)
                        and any(isinstance(t, ast.Subscript)
                                and isinstance(t.value, ast.Name)
                                and t.value.id in aliases
                                for t in node.targets)):
                    bad = "item assignment into"
                elif (isinstance(node, ast.Delete)
                      and any(isinstance(t, ast.Subscript)
                              and isinstance(t.value, ast.Name)
                              and t.value.id in aliases
                              for t in node.targets)):
                    bad = "del on"
                elif (isinstance(node, ast.Call)
                      and isinstance(node.func, ast.Attribute)
                      and node.func.attr in _DICT_MUTATORS
                      and isinstance(node.func.value, ast.Name)
                      and node.func.value.id in aliases
                      # .pop with no mutation intent is still mutation; but
                      # reads like .get/.items never reach here
                      ):
                    bad = f".{node.func.attr}() on"
                if bad is not None:
                    name = None
                    for n in ast.walk(node):
                        if isinstance(n, ast.Name) and n.id in aliases:
                            name = n.id
                            break
                    findings.append(Finding(
                        "RL004", mod.path, node.lineno,
                        f"{bad} carried input `{name}` in hot-path "
                        f"{fn.qualname} — carried state must be rebuilt, not "
                        "mutated (the caller's state changes under it)",
                        _src(mod, node)))
    return findings


def calls_compiled(proj: Project, mod: Module, fn, call: ast.Call) -> bool:
    """Whether ``call`` invokes a ``torch.compile``d callable (bound to a
    local name or to ``self.attr``)."""
    func = call.func
    if isinstance(func, ast.Name):
        return ("local", mod.path, func.id) in proj.compiled_names
    if (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
            and func.value.id == "self" and fn.cls):
        return ("attr", mod.path, fn.cls, func.attr) in proj.compiled_names
    return False
