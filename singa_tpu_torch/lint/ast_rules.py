"""netlint pass family 2: AST lint for the port's own hazards (stdlib
``ast`` only).

Counterpart of ``singa_tpu/lint/ast_rules.py``. That family looks for JAX
hazards (``jax.jit`` bodies, ``jnp`` literals, ``donate_argnums``), none
of which exists in a package that imports no jax, so none is ported. This
one keeps its file walk (``walk_source_files``, ``PRUNE_DIRS``), its
suppression syntax and its parse-failure rule, and checks what the
port's own rules forbid:

- PRT001: a file under ``singa_tpu_torch/``, or ``chip_smoke.py``,
  imports ``jax`` or ``singa_tpu`` (the port imports ``torch``, never
  ``jax``, and nothing of the JAX package);
- PRT002: a host sync (``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, ``float()``/``int()``/``bool()`` of a tensor,
  ``torch.cuda.synchronize``) inside a body that the same file hands to
  ``utils/graphs.py`` ``Graphed``: a CUDA-graph capture fails on it;
- PRT003: in ``tests/test_torch_cuda.py``, a device decision at import
  time (a ``torch.cuda`` call at module level, in a decorator or a
  default) or a ``skipif``: that file decides inside its ``cuda_device``
  fixture, so that it skips here and runs on the card.

Scope heuristic (documented, deliberately conservative, as the JAX
family's JAX001): PRT002 only scans functions this pass can *prove* are
graphed — passed by name (``Graphed(step, ...)``, ``Graphed(self.step,
...)`` for a method of the enclosing class, or through
``functools.partial``) to a ``Graphed(...)`` call in the same file.
Helpers a body calls are not scanned; zero false positives beats
exhaustive coverage for an ERROR-severity rule, and ``--self`` runs this
over ``singa_tpu_torch/`` itself. A ``float()``/``int()`` fires only on
an expression that mentions ``torch.`` or a name assigned from one, never
through ``.shape``, ``.dtype`` or ``len()``, which are host values.

Per-line suppression: ``# netlint: disable=PRT002`` (comma-separate
codes, or omit ``=...`` to silence every rule on that line).
"""

from __future__ import annotations

import ast
import os
import re

from .core import Collector, ERROR, WARNING, rule

PRT000 = rule("PRT000", ERROR, "python file does not parse")
PRT001 = rule(
    "PRT001",
    ERROR,
    "a port file (singa_tpu_torch/, chip_smoke.py) imports jax or "
    "singa_tpu",
)
PRT002 = rule(
    "PRT002", ERROR, "host sync inside a body handed to Graphed"
)
PRT003 = rule(
    "PRT003",
    WARNING,
    "device decision at import time or in a skipif in "
    "tests/test_torch_cuda.py",
)

# the code list stops at the first non-code token, so trailing prose
# ("# netlint: disable=PRT002 TODO revisit") cannot corrupt the set
_SUPPRESS_RE = re.compile(
    r"#\s*netlint:\s*disable(?:=([A-Z]+\d+(?:\s*,\s*[A-Z]+\d+)*))?"
)

#: directories no lint walk descends into — walk_source_files below is
#: the one walker that honors it, shared by lint_python_tree and the
#: CLI's path collector / --self so every entry point agrees on what
#: gets scanned
PRUNE_DIRS = frozenset({"__pycache__", ".git"})

#: the packages a port file must not import
_FORBIDDEN = ("jax", "singa_tpu")

#: method calls that wait for the device and read its data on the host
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")

#: attributes whose values are host-side metadata, not device data
_STATIC_ATTRS = frozenset({"shape", "dtype", "device", "ndim"})

#: calls whose results are host values whatever their argument
_STATIC_CALLS = frozenset({"len", "size", "dim", "numel", "isinstance"})


def walk_source_files(root: str, exts: tuple[str, ...]):
    """Yield every file under ``root`` with one of the ``exts`` suffixes,
    pruning PRUNE_DIRS, filenames sorted per directory. The single
    PRUNE_DIRS-aware tree walk."""
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in PRUNE_DIRS]
        for fname in sorted(filenames):
            if fname.endswith(exts):
                yield os.path.join(dirpath, fname)


def _suppressions(source: str) -> dict[int, set[str] | None]:
    """lineno -> suppressed codes (None = all)."""
    out: dict[int, set[str] | None] = {}
    for i, line in enumerate(source.splitlines(), 1):
        m = _SUPPRESS_RE.search(line)
        if m:
            codes = m.group(1)
            out[i] = (
                {c.strip() for c in codes.split(",") if c.strip()}
                if codes
                else None
            )
    return out


def _dotted(node: ast.AST) -> str:
    """``torch.cuda.synchronize`` for that attribute chain, '' for
    anything that is not a plain dotted name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    return ".".join(reversed(parts))


def _mentions_torch(node: ast.AST, tracked: set[str]) -> bool:
    """Does the expression reach device data: a ``torch.`` call or a
    tracked name, not only through host metadata (``.shape``,
    ``len()``)?"""
    if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
        return False
    if isinstance(node, ast.Call):
        func = node.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else "")
        if name in _STATIC_CALLS:
            return False
        if _dotted(func).startswith("torch."):
            return True
    if isinstance(node, ast.Name):
        return isinstance(node.ctx, ast.Load) and node.id in tracked
    return any(_mentions_torch(c, tracked) for c in ast.iter_child_nodes(node))


def _tensor_names(fn: ast.AST) -> set[str]:
    """Names that hold device tensors inside ``fn``'s body: assigned
    from an expression that reaches ``torch.`` or an already-tracked
    name, in source order; a later rebind to anything else un-tracks the
    name (only names the pass can PROVE tensor-valued are tracked)."""
    tracked: set[str] = set()

    def bind(target: ast.AST, tensor: bool) -> None:
        for t in ast.walk(target):
            if isinstance(t, ast.Name) and isinstance(t.ctx, ast.Store):
                if tensor:
                    tracked.add(t.id)
                else:
                    tracked.discard(t.id)

    def visit(parent: ast.AST) -> None:
        # iter_child_nodes (not ast.walk, which is breadth-first) keeps
        # statements in SOURCE order, so tracking follows dataflow order
        for node in ast.iter_child_nodes(parent):
            if isinstance(node, ast.Assign):
                tensor = _mentions_torch(node.value, tracked)
                for tgt in node.targets:
                    bind(tgt, tensor)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                bind(node.target, _mentions_torch(node.value, tracked))
            elif isinstance(node, ast.AugAssign):
                # x += <expr>: keeps its trackedness unless the rhs makes
                # it a tensor
                if _mentions_torch(node.value, tracked):
                    bind(node.target, True)
            visit(node)

    visit(fn)
    return tracked


class _FileLinter:
    def __init__(self, path: str, source: str, col: Collector):
        self.path = path
        self.col = col
        self.suppress = _suppressions(source)
        # scope: the package a file belongs to, not the directories
        # above it (a checkout under e.g. /home/singa_tpu_torch/ must not
        # put every file on the port's side)
        base = os.path.basename(path)
        self.port_file = (_top_package(path) == "singa_tpu_torch"
                          or base == "chip_smoke.py")
        self.card_tests = base == "test_torch_cuda.py"

    def emit(
        self,
        r,
        node: ast.AST,
        msg: str,
        *,
        fix_hint: str = "",
        end_line: int | None = None,
    ) -> None:
        # a multi-line construct may carry the disable comment on any of
        # its lines; block statements pass end_line to stop at their
        # header
        if end_line is None:
            end_line = getattr(node, "end_lineno", None) or node.lineno
        for line in range(node.lineno, end_line + 1):
            sup = self.suppress.get(line, "unset")
            if sup is None or (sup != "unset" and r.code in sup):
                return
        self.col.emit(
            r,
            f"{self.path}:{node.lineno}:{node.col_offset}",
            msg,
            fix_hint=fix_hint,
        )

    # ---------------- PRT001 ----------------

    def check_imports(self, tree: ast.Module) -> None:
        if not self.port_file:
            return
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                if mod.split(".")[0] in _FORBIDDEN:
                    self.emit(
                        PRT001,
                        node,
                        f"imports {mod!r}: the port imports torch, never "
                        "jax, and nothing of the JAX package",
                        fix_hint="keep the port's own copy of what it "
                        "needs (only the tests import both packages)",
                    )

    # ---------------- PRT002 ----------------

    def graphed_functions(self, tree: ast.Module) -> list[ast.AST]:
        """Bodies handed to ``Graphed(...)`` in this file. A bare name
        resolves LEXICALLY (defs whose enclosing scope is an ancestor of
        the call site; defs in class bodies only from the class body
        itself); ``self.name`` resolves to a method of the class that
        encloses the call."""
        defs: dict[str, list[tuple[ast.AST, tuple, bool]]] = {}
        methods: dict[int, dict[str, ast.AST]] = {}
        calls: list[tuple[ast.expr, tuple, int | None]] = []

        def body_arg(call: ast.Call) -> ast.expr | None:
            if not call.args:
                return None
            arg = call.args[0]
            # functools.partial(fn, ...) / partial(fn, ...)
            if (
                isinstance(arg, ast.Call)
                and _dotted(arg.func) in ("partial", "functools.partial")
                and arg.args
            ):
                arg = arg.args[0]
            return arg

        def walk(node: ast.AST, path: tuple, cls: int | None) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    in_class = isinstance(node, ast.ClassDef)
                    defs.setdefault(child.name, []).append(
                        (child, path, in_class)
                    )
                    if in_class:
                        methods.setdefault(id(node), {})[child.name] = child
                    walk(child, path + (id(child),), cls)
                elif isinstance(child, ast.ClassDef):
                    walk(child, path + (id(child),), id(child))
                else:
                    if (
                        isinstance(child, ast.Call)
                        and _dotted(child.func).split(".")[-1] == "Graphed"
                    ):
                        arg = body_arg(child)
                        if arg is not None:
                            calls.append((arg, path, cls))
                    walk(child, path, cls)

        walk(tree, (), None)
        found: list[ast.AST] = []
        seen: set[int] = set()
        for arg, cpath, cls in calls:
            fns = []
            if isinstance(arg, ast.Name):
                fns = [
                    fn
                    for fn, dpath, in_class in defs.get(arg.id, [])
                    if (
                        dpath == cpath
                        if in_class
                        else dpath == cpath[: len(dpath)]
                    )
                ]
            elif (
                isinstance(arg, ast.Attribute)
                and isinstance(arg.value, ast.Name)
                and arg.value.id == "self"
                and cls is not None
            ):
                fn = methods.get(cls, {}).get(arg.attr)
                fns = [fn] if fn is not None else []
            for fn in fns:
                if id(fn) not in seen:
                    seen.add(id(fn))
                    found.append(fn)
        return found

    def check_graphed_body(self, fn: ast.AST) -> None:
        tracked = _tensor_names(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            what = None
            if isinstance(func, ast.Attribute) and (
                func.attr in _SYNC_METHODS
            ):
                what = f".{func.attr}()"
            elif _dotted(func) == "torch.cuda.synchronize":
                what = "torch.cuda.synchronize()"
            elif (
                isinstance(func, ast.Name)
                and func.id in ("float", "int", "bool")
                and node.args
                and _mentions_torch(node.args[0], tracked)
            ):
                what = f"{func.id}() of a tensor"
            if what is not None:
                self.emit(
                    PRT002,
                    node,
                    f"{what} inside {fn.name!r}, a body handed to Graphed: "
                    "it waits for the card, and a CUDA-graph capture "
                    "fails on it",
                    fix_hint="keep the value on the device (a static "
                    "buffer the caller reads after the replay)",
                )

    # ---------------- PRT003 ----------------

    def check_card_tests(self, tree: ast.Module) -> None:
        if not self.card_tests:
            return
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Call)
                and _dotted(node.func).split(".")[-1] == "skipif"
            ):
                self.emit(
                    PRT003,
                    node,
                    "skipif in the card tests: the condition is decided "
                    "at collection, not where the test runs",
                    fix_hint="take the cuda_device fixture, which skips "
                    "inside the test",
                )
        for node in _import_time_nodes(tree):
            if (
                isinstance(node, ast.Call)
                and _dotted(node.func).startswith("torch.cuda.")
            ):
                self.emit(
                    PRT003,
                    node,
                    f"{_dotted(node.func)}() runs at import time: the "
                    "device is decided before any test runs",
                    fix_hint="decide inside the cuda_device fixture",
                )


def _top_package(path: str) -> str:
    """The name of the outermost package directory (one holding an
    ``__init__.py``) that contains ``path``; '' outside any package."""
    d = os.path.dirname(os.path.abspath(path))
    top = ""
    while os.path.isfile(os.path.join(d, "__init__.py")):
        top = os.path.basename(d)
        d = os.path.dirname(d)
    return top


def _import_time_nodes(tree: ast.Module):
    """Every node that runs when the module is imported: module- and
    class-level code, decorators and defaults — never a function or
    lambda body."""
    todo: list[ast.AST] = [tree]
    while todo:
        node = todo.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            todo.extend(node.decorator_list)
            todo.extend(node.args.defaults)
            todo.extend(d for d in node.args.kw_defaults if d)
        elif isinstance(node, ast.Lambda):
            todo.extend(node.args.defaults)
        else:
            todo.extend(ast.iter_child_nodes(node))


def lint_python_file(path: str, col: Collector) -> None:
    try:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
    except (OSError, UnicodeDecodeError) as e:
        # one unreadable file must not abort the rest of the run
        col.emit(PRT000, f"{path}:0:0", f"cannot read: {e}")
        return
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        col.emit(
            PRT000,
            f"{path}:{e.lineno or 0}:0",
            f"file does not parse: {e.msg}",
        )
        return
    linter = _FileLinter(path, source, col)
    linter.check_imports(tree)
    for fn in linter.graphed_functions(tree):
        linter.check_graphed_body(fn)
    linter.check_card_tests(tree)


def lint_python_tree(root: str, col: Collector) -> int:
    """Lint every .py under ``root``; returns the file count."""
    n = 0
    for path in walk_source_files(root, (".py",)):
        lint_python_file(path, col)
        n += 1
    return n
