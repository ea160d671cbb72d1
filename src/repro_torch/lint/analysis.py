"""Shared AST infrastructure: parsed modules, import-aware name
resolution, the project-wide function index, and hot-root discovery.
Counterpart of ``repro/lint/analysis.py`` for eager PyTorch; stdlib only.

Everything downstream (rules.py, hotpath.py) works on a ``Project``:

* ``Module`` — one parsed file with its source lines, an import map
  (local alias -> dotted origin, so ``F.softmax`` resolves to
  ``torch.nn.functional.softmax`` and ``prng.consume`` to
  ``repro_torch.utils.prng.consume``) and every function/method def,
  nested defs included.
* ``Func`` — one def with its qualified display name.  Nested defs are
  indexed in their own right (closures defined inside a method) and also
  remain part of the enclosing body's AST, so reachability walks see both
  views.
* hot roots — the port has no ``jax.jit``: the functions every step or
  tick runs are found by name (``hotpath.hot_reachable``), and here any
  function compiled by ``torch.compile`` (decorated, or assigned:
  ``f2 = torch.compile(f)``, ``self._step = torch.compile(self._train)``),
  chased through known transparent wrappers (``functools.partial``,
  ``repro_torch.lint.runtime.checked``).  A ``# lint: hot-root`` comment
  on the def line force-marks a root the resolver cannot see (callables
  passed through containers); it stands where the reference's
  ``# lint: jit-root`` stands.

Resolution is deliberately name-based and over-approximate: a linter
that misses an edge stays silent, one that dies on dynamic dispatch is
useless.  Unresolvable calls are skipped, ambiguous bare names fan out
to every same-name candidate in the module.
"""

from __future__ import annotations

import ast
import dataclasses
import os

# --- name universes -------------------------------------------------------

TRANSPARENT_WRAPPERS = {
    "functools.partial",
    "repro_torch.lint.runtime.checked",
}
COMPILE_QUALS = {"torch.compile"}

# The port's keys are integers (``utils.prng.fold``); a draw is what turns
# one into random numbers: a generator seeded with it, or a seeded launch.
# Calls that seed a generator spend the key they are given (and any
# ``.manual_seed(key)``, whatever its receiver; see rules.py).
DRAW_QUALS = {
    "repro_torch.utils.prng.generator",
    "torch.manual_seed", "torch.random.manual_seed",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
}
DRAW_METHODS = {"manual_seed"}

# derivations: read a key to mint new ones — NOT a spend
DERIVE_QUALS = {
    "repro_torch.utils.prng.fold", "repro_torch.utils.prng.step_key",
    "repro_torch.kernels.emu_matmul.seed_words",
}
# key-producing calls (assigning from one creates a key-typed binding)
KEY_PRODUCERS = set(DERIVE_QUALS)
CONSUME_QUALS = {"repro_torch.utils.prng.consume"}
# conversions a key passes through unchanged (``int(key) & MASK``)
KEY_CASTS = {"int"}
# calls that inspect a value without spending it
INSPECT_QUALS = {"isinstance", "len"}


def base_name(qual: str) -> str:
    return qual.rsplit(".", 1)[-1]


# --- modules --------------------------------------------------------------


@dataclasses.dataclass(eq=False)  # identity hash: one node, one Func
class Func:
    module: "Module"
    qualname: str  # "Trainer.fit", "Engine.__init__.<locals>.tick", "run"
    node: ast.AST  # FunctionDef | AsyncFunctionDef | Lambda
    cls: str | None  # enclosing class name, if a method

    @property
    def name(self) -> str:
        return getattr(self.node, "name", "<lambda>")

    @property
    def display(self) -> str:
        return f"{os.path.basename(self.module.path)}:{self.qualname}"


class Module:
    def __init__(self, path: str, source: str):
        self.path = path
        self.modname = _module_name(path)
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.imports = self._imports(self.tree)
        self.funcs: list[Func] = []
        self.by_name: dict[str, list[Func]] = {}
        self._index_funcs()

    @staticmethod
    def _imports(tree: ast.Module) -> dict[str, str]:
        imp: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        imp[a.asname] = a.name
                    else:
                        # "import torch.nn.functional" binds "torch"
                        head = a.name.split(".")[0]
                        imp[head] = head
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for a in node.names:
                    imp[a.asname or a.name] = f"{node.module}.{a.name}"
        return imp

    def _index_funcs(self):
        def visit(node, prefix: str, cls: str | None):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    q = f"{prefix}{child.name}"
                    fn = Func(self, q, child, cls)
                    self.funcs.append(fn)
                    self.by_name.setdefault(child.name, []).append(fn)
                    visit(child, f"{q}.<locals>.", cls)
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{child.name}.", child.name)
                else:
                    visit(child, prefix, cls)

        visit(self.tree, "", None)

    def dotted(self, node: ast.AST) -> str | None:
        """Resolve a Name/Attribute chain through the import map:
        ``F.relu`` -> "torch.nn.functional.relu"; an unimported bare name
        resolves to itself (it may be a module-local function)."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self.imports.get(node.id, node.id)
        parts.append(head)
        return ".".join(reversed(parts))

    def qualify(self, qual: str) -> str:
        """A bare name of one of this module's top-level defs -> its dotted
        name ("fold" inside ``utils/prng.py`` -> "repro_torch.utils.prng.fold"),
        so the module's own calls match the name universes."""
        if "." not in qual and any(f.cls is None and "." not in f.qualname
                                   for f in self.by_name.get(qual, ())):
            return f"{self.modname}.{qual}"
        return qual


# --- project --------------------------------------------------------------


def _module_name(path: str) -> str:
    """File path -> dotted import name ("src/repro_torch/api.py" ->
    "repro_torch.api")."""
    norm = path.replace(os.sep, "/")
    for marker in ("src/", ""):
        if marker and f"{marker}" in norm:
            norm = norm.split(f"{marker}", 1)[1]
            break
    return norm[:-3].replace("/", ".") if norm.endswith(".py") else norm


class Project:
    """All scanned modules + the cross-module function index."""

    def __init__(self):
        self.modules: dict[str, Module] = {}  # path -> Module
        self.by_modname: dict[str, Module] = {}  # "repro_torch.api" -> Module
        self.frozen_classes: set[str] = set()  # bare names of frozen dataclasses
        # roots discovered in the root pass (compiled or marked):
        self.hot_roots: list[Func] = []
        # compiled-callable bindings: ("local", module_path, name) or
        # ("attr", module_path, class, attr)
        self.compiled_names: set[tuple] = set()
        self._derive_only: dict[tuple, bool] = {}

    def add(self, path: str, source: str) -> Module:
        mod = Module(path, source)
        self.modules[path] = mod
        self.by_modname[_module_name(path)] = mod
        return mod

    def finish(self):
        for mod in self.modules.values():
            self._scan_frozen(mod)
        for mod in self.modules.values():
            self._scan_roots(mod)

    # -- frozen dataclasses ------------------------------------------------
    def _scan_frozen(self, mod: Module):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for dec in node.decorator_list:
                if not isinstance(dec, ast.Call):
                    continue
                qual = mod.dotted(dec.func)
                if qual in ("dataclasses.dataclass", "dataclass"):
                    for kw in dec.keywords:
                        if (kw.arg == "frozen"
                                and isinstance(kw.value, ast.Constant)
                                and kw.value.value is True):
                            self.frozen_classes.add(node.name)

    # -- hot roots ---------------------------------------------------------
    def _is_compile_expr(self, mod: Module, node: ast.AST) -> bool:
        return mod.dotted(node) in COMPILE_QUALS

    def _unwrap(self, mod: Module, scope_funcs: dict[str, ast.AST], node):
        """Chase ``torch.compile``'s argument through transparent wrappers and
        same-scope assignments to the underlying def/lambda/target."""
        for _ in range(8):
            if isinstance(node, ast.Call):
                qual = mod.dotted(node.func)
                if qual in TRANSPARENT_WRAPPERS and node.args:
                    node = node.args[0]
                    continue
                return None
            if isinstance(node, ast.Name) and node.id in scope_funcs:
                node = scope_funcs[node.id]
                continue
            return node
        return node

    def _mark_root(self, mod: Module, target: ast.AST | None, cls: str | None):
        if target is None:
            return
        if isinstance(target, ast.Lambda):
            return  # a compiled lambda's body is its own expression
        if isinstance(target, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for fn in mod.by_name.get(target.name, ()):
                if fn.node is target:
                    self.hot_roots.append(fn)
            return
        name = None
        if isinstance(target, ast.Name):
            name = target.id
        elif (isinstance(target, ast.Attribute)
              and isinstance(target.value, ast.Name)
              and target.value.id == "self"):
            name = target.attr
        if name is not None:
            for fn in mod.by_name.get(name, ()):
                if cls is None or fn.cls in (None, cls):
                    self.hot_roots.append(fn)

    def _scan_roots(self, mod: Module):
        # forced roots: "# lint: hot-root" on the def line
        for fn in mod.funcs:
            ln = getattr(fn.node, "lineno", 0)
            if 0 < ln <= len(mod.lines) and "# lint: hot-root" in mod.lines[ln - 1]:
                self.hot_roots.append(fn)
        for fn in mod.funcs:
            for dec in getattr(fn.node, "decorator_list", ()):
                dec_fn = dec.func if isinstance(dec, ast.Call) else dec
                if self._is_compile_expr(mod, dec_fn):
                    self.hot_roots.append(fn)
                elif (isinstance(dec, ast.Call)
                      and mod.dotted(dec.func) in TRANSPARENT_WRAPPERS
                      and dec.args and self._is_compile_expr(mod, dec.args[0])):
                    self.hot_roots.append(fn)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Assign):
                continue
            call = node.value
            if not (isinstance(call, ast.Call) and self._is_compile_expr(mod, call.func)):
                continue
            scope_funcs = {f.name: f.node for f in mod.funcs}
            enclosing_cls = self._enclosing_class(mod, node)
            if call.args:
                self._mark_root(mod, self._unwrap(mod, scope_funcs, call.args[0]),
                                enclosing_cls)
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self.compiled_names.add(("local", mod.path, tgt.id))
                elif (isinstance(tgt, ast.Attribute)
                      and isinstance(tgt.value, ast.Name)
                      and tgt.value.id == "self" and enclosing_cls):
                    self.compiled_names.add(("attr", mod.path, enclosing_cls, tgt.attr))

    def _enclosing_class(self, mod: Module, node: ast.AST) -> str | None:
        for fn in mod.funcs:
            if fn.cls is None:
                continue
            f = fn.node
            if (f.lineno <= node.lineno
                    and node.lineno <= (f.end_lineno or f.lineno)):
                return fn.cls
        return None

    # -- call resolution ---------------------------------------------------
    def resolve_call(self, mod: Module, caller: Func, call: ast.Call) -> list[Func]:
        """Callee candidates for one call site (possibly empty)."""
        func = call.func
        # self.method(...) -> same-class methods in this module
        if (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
                and func.value.id == "self" and caller.cls):
            return [f for f in mod.by_name.get(func.attr, ())
                    if f.cls == caller.cls]
        qual = mod.dotted(func)
        if qual is None:
            return []
        if "." not in qual:
            # bare name: module-local defs (any nesting level)
            return list(mod.by_name.get(qual, ()))
        target_mod, _, fname = qual.rpartition(".")
        other = self.by_modname.get(target_mod)
        if other is None and qual in (f"{m}.{base_name(qual)}"
                                      for m in self.by_modname):
            other = self.by_modname.get(target_mod)
        if other is not None:
            return [f for f in other.by_name.get(fname, ()) if f.cls is None]
        # "from repro_torch.x import fn" -> qual "repro_torch.x.fn", module repro_torch.x
        return []

    # -- derive-only key parameters ----------------------------------------
    def derive_only(self, fn: Func, param: str) -> bool:
        """True when ``fn`` only ever *derives* from ``param``
        (``prng.fold`` and the like) — handing a key to such a callee is
        itself a derivation, not a spend.  This is the repo's
        named-folding idiom: a callee that folds its key per name may share
        one base key with a sibling that folds other names."""
        cache_key = (id(fn.node), param)
        cached = self._derive_only.get(cache_key)
        if cached is not None:
            return cached
        # optimistic on recursion: a cycle with no direct draw derives only
        self._derive_only[cache_key] = True
        result = self._derive_only_scan(fn, param)
        self._derive_only[cache_key] = result
        return result

    def _derive_only_scan(self, fn: Func, param: str) -> bool:
        mod = fn.module
        parents: dict[int, ast.AST] = {}
        for node in ast.walk(fn.node):
            for child in ast.iter_child_nodes(node):
                parents[id(child)] = node
        for node in ast.walk(fn.node):
            if not (isinstance(node, ast.Name) and node.id == param
                    and isinstance(node.ctx, ast.Load)):
                continue
            parent = parents.get(id(node))
            call = None
            if isinstance(parent, ast.Call) and node in parent.args:
                call = parent
            elif isinstance(parent, ast.keyword):
                grand = parents.get(id(parent))
                if isinstance(grand, ast.Call):
                    call = grand
            if call is None:
                if isinstance(parent, ast.Compare):
                    continue  # inspected (``seed is None``), not spent
                return False  # returned, stored, drawn from, ...
            qual = mod.qualify(mod.dotted(call.func) or "")
            if qual in DERIVE_QUALS or qual in INSPECT_QUALS:
                continue
            callees = self.resolve_call(mod, fn, call)
            if not callees:
                return False
            for callee in callees:
                pname = param_for_arg(callee, call, node)
                if pname is None or not self.derive_only(callee, pname):
                    return False
        return True


def param_for_arg(callee: Func, call: ast.Call,
                  name_node: ast.Name) -> str | None:
    """Name of the callee parameter receiving ``name_node`` at this site."""
    args = callee.node.args
    params = [a.arg for a in list(args.posonlyargs) + list(args.args)]
    if params and params[0] == "self" and isinstance(call.func, ast.Attribute):
        params = params[1:]
    for i, a in enumerate(call.args):
        if a is name_node:
            return params[i] if i < len(params) else None
    for kw in call.keywords:
        if kw.value is name_node:
            return kw.arg
    return None


def load_project(paths: list[str]) -> Project:
    """Build a Project from files and/or directories of ``.py`` sources."""
    proj = Project()
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                if "__pycache__" in root:
                    continue
                files.extend(os.path.join(root, n)
                             for n in names if n.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    for path in sorted(set(files)):
        with open(path, encoding="utf-8") as f:
            source = f.read()
        try:
            proj.add(os.path.relpath(path), source)
        except SyntaxError:
            continue  # not our diagnostic to raise
    proj.finish()
    return proj


def project_from_sources(sources: dict[str, str]) -> Project:
    """In-memory project (test fixtures)."""
    proj = Project()
    for path, src in sources.items():
        proj.add(path, src)
    proj.finish()
    return proj
