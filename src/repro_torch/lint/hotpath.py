"""Call-graph rules for eager PyTorch: RL002 (host syncs in hot paths)
and RL003 (Python control flow on tensor values in hot code).
Counterpart of ``repro/lint/hotpath.py``.

Reachability is computed once and shared.  Roots are:

* ``Trainer.fit`` / ``Trainer.step`` and the ``Engine`` tick methods and
  ``Engine.step`` by name — the training loop and the serving scheduler,
  which run every step or tick;
* any function compiled by ``torch.compile`` or marked ``# lint: hot-root``
  (``analysis.Project.hot_roots``).

RL002 flags a host sync: a call that waits for the card and copies a value
to the host (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
``.to("cpu")``, ``float()`` / ``int()`` / ``bool()`` of a tensor,
``np.asarray(tensor)``, ``torch.cuda.synchronize()``, an event's
``.synchronize()`` / ``.elapsed_time()``).  It keeps the reference's two
severities:

* inside the hot-reachable set, ANY host sync flags: one stray scalar pull
  stalls the launch queue every step;
* in *driver* functions — not hot-reachable themselves but invoking
  ``.fit`` / ``.step`` / ``.tick`` methods or compiled callables — only
  syncs inside ``for`` / ``while`` loops flag.  A single read after a run
  is how results leave the card; one per iteration is the classic
  accidental serialisation in timing loops.

RL003 flags a Python ``if`` / ``while`` whose test is a tensor value in
hot code: the test calls ``bool()`` on it, an implicit sync.  Shape, dtype
and device reflection (``x.shape``, ``x.dtype``, ``x.is_floating_point()``,
``torch.is_tensor``, ...) is no tensor value, as the reference's
``_STATIC_PREDICATES`` are static.  The reference's second RL003 check
(non-hashable static arguments of jitted callables) has no counterpart:
eager PyTorch takes no static arguments.

Python cannot be typed statically, so "a tensor value" is an expression
that calls into ``torch`` (``torch.isfinite(x)``), calls a tensor method
(``x.sum()``, ``x.abs().max()``), compares or combines such values, or is
a local name bound to one in the same function; a method called on a
name bound to a numpy array or a literal is the host's.
"""

from __future__ import annotations

import ast

from repro_torch.lint.analysis import Func, Module, Project
from repro_torch.lint.findings import Finding
from repro_torch.lint.rules import _src, calls_compiled

# attribute calls that drive the step or tick from host loops
_DRIVER_ATTRS = {"fit", "step", "tick"}

# torch functions whose result is no tensor: reflection, not values
_STATIC_TORCH = {
    "is_tensor", "is_floating_point", "is_complex", "is_grad_enabled", "is_storage",
    "finfo", "iinfo", "device", "dtype", "Size", "Generator", "get_default_dtype",
    "promote_types", "result_type", "can_cast", "is_inference_mode_enabled",
}
# tensor methods whose result is a tensor
TENSOR_METHODS = {
    "abs", "all", "amax", "amin", "any", "argmax", "argmin", "clamp", "clamp_min",
    "clone", "count_nonzero", "detach", "double", "eq", "exp", "float", "ge", "gt",
    "half", "isfinite", "isinf", "isnan", "le", "log", "logical_and", "logical_not",
    "logical_or", "lt", "max", "mean", "min", "ne", "norm", "prod", "sqrt", "square",
    "std", "sum", "var",
}
_HOST_CASTS = {"float", "int", "bool"}
# builtins whose result lives on the host
_HOST_BUILTINS = {"len", "range", "list", "dict", "tuple", "set", "int", "float", "bool",
                  "str", "sorted", "enumerate", "zip"}
_HOST_LITERALS = (ast.Constant, ast.List, ast.Dict, ast.Tuple, ast.Set, ast.ListComp,
                  ast.DictComp, ast.SetComp, ast.JoinedStr)


def hot_reachable(proj: Project) -> dict[Func, tuple[str, ...]]:
    """Func -> call chain from its nearest root (roots map to themselves)."""
    roots: list[Func] = list(proj.hot_roots)
    for mod in proj.modules.values():
        for fn in mod.funcs:
            if fn.cls == "Trainer" and fn.name in ("fit", "step"):
                roots.append(fn)
            elif fn.cls == "Engine" and ("tick" in fn.name or fn.name == "step"):
                roots.append(fn)
    seen: dict[Func, tuple[str, ...]] = {}
    stack = [(fn, (fn.display,)) for fn in roots]
    while stack:
        fn, chain = stack.pop()
        if fn in seen or len(chain) > 12:
            continue
        seen[fn] = chain
        mod = fn.module
        for call in [n for n in ast.walk(fn.node) if isinstance(n, ast.Call)]:
            for callee in proj.resolve_call(mod, fn, call):
                if callee not in seen:
                    stack.append((callee, chain + (callee.display,)))
    return seen


def _host_value(mod: Module, node: ast.AST) -> bool:
    if isinstance(node, _HOST_LITERALS):
        return True
    if isinstance(node, ast.Call):
        qual = mod.dotted(node.func) or ""
        return qual.startswith("numpy.") or qual in _HOST_BUILTINS
    return False


def tensor_locals(mod: Module, fn_node) -> dict[str, bool]:
    """Local name -> True where the function binds it to a tensor value,
    False where to a host value (a numpy array, a literal, a builtin's
    result); flow-insensitive, to a fixed point: ``y = x.sum(); z = y * 2``
    binds both to tensors."""
    names: dict[str, bool] = {}
    assigns = [n for n in ast.walk(fn_node) if isinstance(n, (ast.Assign, ast.AnnAssign))]
    for node in assigns:
        if node.value is not None and _host_value(mod, node.value):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update((t.id, False) for t in targets if isinstance(t, ast.Name))
    changed = True
    while changed:
        changed = False
        for node in assigns:
            if node.value is None or not is_tensor_expr(mod, node.value, names):
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and not names.get(t.id):
                    names[t.id] = True
                    changed = True
    return names


def is_tensor_expr(mod: Module, node: ast.AST, names: dict[str, bool]) -> bool:
    """Whether ``node`` is a tensor value (see the module docstring)."""
    if isinstance(node, ast.Name):
        return bool(names.get(node.id))
    if isinstance(node, ast.Call):
        func = node.func
        qual = mod.dotted(func) or ""
        if qual.startswith("torch.") and "." not in qual[len("torch."):]:
            return qual[len("torch."):] not in _STATIC_TORCH
        if qual.startswith(("torch.linalg.", "torch.special.", "torch.nn.functional.")):
            return True
        # a tensor method, unless called on a module or a host value
        return (isinstance(func, ast.Attribute) and func.attr in TENSOR_METHODS
                and not (isinstance(func.value, ast.Name)
                         and (func.value.id in mod.imports
                              or names.get(func.value.id) is False)))
    if isinstance(node, ast.BinOp):
        return is_tensor_expr(mod, node.left, names) or is_tensor_expr(mod, node.right, names)
    if isinstance(node, ast.UnaryOp):
        return is_tensor_expr(mod, node.operand, names)
    if isinstance(node, ast.Compare):
        return any(is_tensor_expr(mod, x, names) for x in [node.left, *node.comparators])
    if isinstance(node, ast.BoolOp):
        return any(is_tensor_expr(mod, x, names) for x in node.values)
    if isinstance(node, ast.Subscript):
        return is_tensor_expr(mod, node.value, names)
    return False


def _is_cpu(mod: Module, node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call) and mod.dotted(node.func) == "torch.device"
            and bool(node.args) and _is_cpu(mod, node.args[0]))


def sync_kind(mod: Module, call: ast.Call, names: dict[str, bool]) -> str | None:
    """The host sync ``call`` makes, or None."""
    func = call.func
    qual = mod.dotted(func) or ""
    if qual == "torch.cuda.synchronize":
        return "torch.cuda.synchronize()"
    if isinstance(func, ast.Attribute):
        if func.attr in ("item", "tolist", "cpu", "numpy") and not call.args:
            return f".{func.attr}()"
        if func.attr in ("synchronize", "elapsed_time"):
            return f".{func.attr}()"
        if func.attr == "to" and (
                (call.args and _is_cpu(mod, call.args[0]))
                or any(kw.arg == "device" and _is_cpu(mod, kw.value) for kw in call.keywords)):
            return '.to("cpu")'
    if qual in ("numpy.asarray", "numpy.array") and call.args \
            and is_tensor_expr(mod, call.args[0], names):
        return f"np.{qual.rsplit('.', 1)[-1]}(tensor)"
    if (isinstance(func, ast.Name) and func.id in _HOST_CASTS and len(call.args) == 1
            and is_tensor_expr(mod, call.args[0], names)):
        return f"{func.id}(tensor)"
    return None


def _is_driver(proj: Project, mod: Module, fn: Func) -> bool:
    for call in [n for n in ast.walk(fn.node) if isinstance(n, ast.Call)]:
        if calls_compiled(proj, mod, fn, call):
            return True
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr in _DRIVER_ATTRS:
            return True
    return False


def _loop_nodes(fn_node) -> list[ast.AST]:
    out = []
    for node in ast.walk(fn_node):
        if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
            out.extend(ast.walk(node))
    return out


def run_rl002(proj: Project, reachable: dict[Func, tuple[str, ...]]) -> list[Finding]:
    findings: list[Finding] = []
    for fn, chain in reachable.items():
        mod = fn.module
        names = tensor_locals(mod, fn.node)
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            kind = sync_kind(mod, node, names)
            if kind is None:
                continue
            via = f" (via {' -> '.join(chain)})" if len(chain) > 1 else ""
            findings.append(Finding(
                "RL002", mod.path, node.lineno,
                f"host sync `{kind}` in hot-path {fn.qualname}{via} — waits for the "
                "card every step; read once, outside the hot path",
                _src(mod, node)))
    # driver loops
    for mod in proj.modules.values():
        for fn in mod.funcs:
            if fn in reachable or isinstance(fn.node, ast.Lambda):
                continue
            if not _is_driver(proj, mod, fn):
                continue
            names = tensor_locals(mod, fn.node)
            seen_lines = set()
            for node in _loop_nodes(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                kind = sync_kind(mod, node, names)
                if kind is None or node.lineno in seen_lines:
                    continue
                seen_lines.add(node.lineno)
                findings.append(Finding(
                    "RL002", mod.path, node.lineno,
                    f"host sync `{kind}` inside a loop of {fn.qualname}, which drives "
                    "steps or ticks — one blocking transfer per iteration; hoist it or "
                    "read once after the loop",
                    _src(mod, node)))
    return findings


def run_rl003(proj: Project, reachable: dict[Func, tuple[str, ...]]) -> list[Finding]:
    findings: list[Finding] = []
    for fn in reachable:
        mod = fn.module
        names = tensor_locals(mod, fn.node)
        for node in ast.walk(fn.node):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            if not is_tensor_expr(mod, node.test, names):
                continue
            kw = "while" if isinstance(node, ast.While) else "if"
            findings.append(Finding(
                "RL003", mod.path, node.lineno,
                f"Python `{kw}` on a tensor value in hot-path {fn.qualname} — an "
                "implicit bool() that waits for the card; keep the branch on the card "
                "(torch.where) or decide it from host values",
                _src(mod, node)))
    return findings
