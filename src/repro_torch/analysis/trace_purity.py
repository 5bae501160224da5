"""Rule: code that torch runs again, or at another time than the call,
stays side-effect free.

The JAX package's rule guards what ``jax.jit`` and Pallas trace.  The port
has no jit; what PyTorch runs twice, or later than the call, is

- a function passed to ``torch.utils.checkpoint.checkpoint``: its forward
  runs once in the forward pass and again, recomputed, in backward;
- the ``forward`` / ``backward`` of a ``torch.autograd.Function``
  subclass: backward runs when the graph is differentiated, on the
  autograd engine's thread, and forward runs again whenever the Function
  sits in a checkpointed region.

A clock read, a host RNG draw, a lock, a module-global mutation or a
MetricsHub instrument in such code runs twice and counts twice (or blocks
the autograd thread), which is torch's form of "counts compilations
instead of calls".

Roots are collected per module:

- ``checkpoint(f, ...)`` call sites resolving to
  ``torch.utils.checkpoint.checkpoint``, where ``f`` is a module-level
  function, a ``self.method``, a function defined in the calling function,
  ``functools.partial(g, ...)`` of one of those, or an inline lambda
- ``forward``, ``backward``, ``setup_context``, ``jvp`` and ``vjp`` of
  classes whose bases resolve to ``torch.autograd.Function``

A function whose ``def`` line, or the line above it, carries ``#
recompute-ok: <reason>`` is a reviewed assertion that running it again is
right (it counts or times work that really happens again, such as a
kernel launch or a collective): the BFS neither checks it nor follows its
calls.

From the roots we BFS a conservative call graph: plain-name calls into
the same module, ``self.method`` calls within the same class, and
``alias.fn`` calls through project-module imports.  Dynamic references
(``mod.ingest`` where ``mod`` is a parameter) are unresolvable and
deliberately skipped — the rule under-approximates reachability rather
than spray false positives.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.engine import (
    Finding, Project, SourceFile, dotted_name, functions_of, module_imports,
)

RULE = "trace-purity"

_RECOMPUTE_OK = re.compile(r"#\s*recompute-ok:\s*\S")
_HUB_METHODS = frozenset({"inc", "observe", "observe_n", "observe_many"})


def _resolve_dotted(name: str, mod_aliases: dict[str, str],
                    from_imports: dict[str, tuple[str, str]]) -> str:
    """Canonicalize a dotted name through the module's imports."""
    head, _, rest = name.partition(".")
    if head in from_imports:
        m, n = from_imports[head]
        head = f"{m}.{n}"
    elif head in mod_aliases:
        head = mod_aliases[head]
    return f"{head}.{rest}" if rest else head


class _ModuleIndex:
    """Per-module lookup tables shared by root collection and the BFS."""

    def __init__(self, sf: SourceFile) -> None:
        self.sf = sf
        self.mod_aliases, self.from_imports = module_imports(sf.tree)
        self.functions: dict[str, ast.AST] = {}   # qualname -> def node
        self.by_class: dict[str, dict[str, str]] = {}
        for qual, cls, node in functions_of(sf.tree):
            self.functions[qual] = node
            if cls is not None:
                self.by_class.setdefault(cls, {})[node.name] = qual
        self.top_level = {q for q in self.functions if "." not in q}
        self.globals: set[str] = set()
        for node in sf.tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.globals.add(t.id)
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                self.globals.add(node.target.id)

    def resolve(self, name: str) -> str:
        return _resolve_dotted(name, self.mod_aliases, self.from_imports)


_CHECKPOINT = "torch.utils.checkpoint.checkpoint"
_FUNCTION = "torch.autograd.Function"
_FUNCTION_METHODS = ("forward", "backward", "setup_context", "jvp", "vjp")


def _nested_defs(fn: ast.AST) -> dict[str, ast.AST]:
    """Functions defined (at any depth) inside ``fn``, by name."""
    return {n.name: n for n in ast.walk(fn)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n is not fn}


def _recompute_roots(idx: _ModuleIndex) -> list[tuple[ast.AST, str, str]]:
    """(node, qualname-or-display, root label) of the functions torch runs
    again or later, in one module."""
    roots: list[tuple[ast.AST, str, str]] = []

    def note_arg(arg: ast.AST, local: dict[str, ast.AST], label: str) -> None:
        if isinstance(arg, ast.Lambda):
            roots.append((arg, f"<lambda:{arg.lineno}>", label))
            return
        if isinstance(arg, ast.Call):  # functools.partial(g, ...)
            cname = dotted_name(arg.func)
            if cname is not None and arg.args and \
                    idx.resolve(cname).split(".")[-1] == "partial":
                note_arg(arg.args[0], local, label)
            return
        name = dotted_name(arg)
        if name is None:
            return
        if name in local:
            roots.append((local[name], name, label))
        elif name in idx.top_level:
            roots.append((idx.functions[name], name, label))
        elif name.startswith("self."):
            meth = name[len("self."):]
            for methods in idx.by_class.values():
                if meth in methods:
                    roots.append((idx.functions[methods[meth]],
                                  methods[meth], label))
        # anything else (parameters, foreign modules, locals bound to a
        # value the AST cannot follow) is a dynamic reference this rule
        # cannot resolve — skipped

    for _qual, _cls, fn in functions_of(idx.sf.tree):
        local = _nested_defs(fn)
        # a local name bound to functools.partial(g, ...) or to a choice
        # of functions roots what it may hold
        bound: dict[str, list[ast.AST]] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                value = node.value
                options = [value.body, value.orelse] \
                    if isinstance(value, ast.IfExp) else [value]
                bound.setdefault(node.targets[0].id, []).extend(options)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            cname = dotted_name(node.func)
            if cname is None or idx.resolve(cname) != _CHECKPOINT:
                continue
            arg = node.args[0]
            label = f"checkpoint at line {node.lineno}"
            if isinstance(arg, ast.Name) and arg.id in bound \
                    and arg.id not in local:
                for value in bound[arg.id]:
                    note_arg(value, local, label)
            else:
                note_arg(arg, local, label)

    for node in idx.sf.tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        if not any((dotted_name(b) is not None
                    and idx.resolve(dotted_name(b)) == _FUNCTION)
                   for b in node.bases):
            continue
        for meth in _FUNCTION_METHODS:
            qual = idx.by_class.get(node.name, {}).get(meth)
            if qual is not None:
                roots.append((idx.functions[qual], qual,
                              f"autograd.Function {node.name}"))
    return roots


def _out_edges(node: ast.AST, idx: _ModuleIndex, cls: str | None,
               project: Project) -> list[tuple[str, str]]:
    """(module, qualname) functions referenced from ``node``'s body."""
    edges: list[tuple[str, str]] = []
    mod = idx.sf.module
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Call):
            name = dotted_name(sub.func)
        elif isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
            name = sub.id
        if name is None:
            continue
        if name in idx.top_level:
            edges.append((mod, name))
            continue
        if name.startswith("self.") and cls is not None:
            meth = name[len("self."):]
            qual = idx.by_class.get(cls, {}).get(meth)
            if qual is not None:
                edges.append((mod, qual))
            continue
        head, _, rest = name.partition(".")
        if not rest or "." in rest:
            continue
        target_mod = None
        if head in idx.from_imports:
            m, n = idx.from_imports[head]
            target_mod = f"{m}.{n}"
        elif head in idx.mod_aliases:
            target_mod = idx.mod_aliases[head]
        if target_mod is not None and project.get(target_mod) is not None:
            edges.append((target_mod, rest))
    return edges


def _check_body(node: ast.AST, qual: str, origin: str, idx: _ModuleIndex,
                findings: list[Finding]) -> None:
    mod = idx.sf.module

    def flag(lineno: int, what: str) -> None:
        findings.append(Finding(RULE, mod, lineno,
                                f"recomputed function {qual!r} (from "
                                f"{origin}) {what}"))

    for sub in ast.walk(node):
        if isinstance(sub, ast.Global):
            flag(sub.lineno, "declares `global` (module-state mutation)")
        elif isinstance(sub, ast.With):
            for item in sub.items:
                ctx = dotted_name(item.context_expr)
                if ctx is None and isinstance(item.context_expr, ast.Call):
                    ctx = dotted_name(item.context_expr.func)
                if ctx is None:
                    continue
                last = ctx.split(".")[-1].lower()
                if "lock" in last or last == "_cv":
                    flag(sub.lineno, f"acquires lock `{ctx}`")
        elif isinstance(sub, (ast.Assign, ast.AugAssign)):
            targets = sub.targets if isinstance(sub, ast.Assign) \
                else [sub.target]
            for t in targets:
                base = t
                while isinstance(base, (ast.Subscript, ast.Attribute)):
                    base = base.value
                if isinstance(base, ast.Name) and t is not base \
                        and base.id in idx.globals:
                    flag(sub.lineno,
                         f"mutates module-level `{base.id}`")
        elif isinstance(sub, ast.Call):
            cname = dotted_name(sub.func)
            if cname is None:
                continue
            canonical = idx.resolve(cname)
            root = canonical.split(".")[0]
            if root == "time" and "." in canonical:
                flag(sub.lineno, f"calls `{canonical}` (clock)")
            elif root == "random" and "." in canonical:
                flag(sub.lineno, f"calls `{canonical}` (host RNG)")
            elif canonical.startswith("numpy.random."):
                flag(sub.lineno, f"calls `{canonical}` (host RNG)")
            elif canonical.split(".")[-1] == "get_hub":
                flag(sub.lineno, "touches the metrics hub (`get_hub`)")
            elif canonical.split(".")[-1] == "acquire" and \
                    "lock" in canonical.lower():
                flag(sub.lineno, f"acquires lock `{cname}`")
            elif isinstance(sub.func, ast.Attribute):
                base = dotted_name(sub.func.value) or ""
                meth = sub.func.attr
                if "hub" in base.lower() and (
                        meth in _HUB_METHODS or meth == "set"
                        or meth in ("counter", "gauge", "histogram")):
                    flag(sub.lineno,
                         f"touches metrics instrument `{base}.{meth}`")


def _recompute_ok(sf: SourceFile, node: ast.AST) -> bool:
    """Whether a def carries ``# recompute-ok: <reason>`` on the line above
    it or on its signature lines."""
    body = getattr(node, "body", None)
    last = body[0].lineno - 1 if isinstance(body, list) and body \
        else node.lineno
    return any(_RECOMPUTE_OK.search(sf.line(ln))
               for ln in range(node.lineno - 1, max(node.lineno, last) + 1))


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    indexes = {mod: _ModuleIndex(sf) for mod, sf in project.files.items()}

    # seed: every root in every module
    queue: list[tuple[str, str, ast.AST, str | None, str]] = []
    seen: set[tuple[str, int]] = set()  # (module, node lineno) identity
    for mod, idx in indexes.items():
        qual_by_node = {id(n): q for q, n in idx.functions.items()}
        cls_of = {}
        for qual, cls, node in functions_of(idx.sf.tree):
            cls_of[qual] = cls
        for node, display, root in _recompute_roots(idx):
            qual = qual_by_node.get(id(node), display)
            key = (mod, node.lineno)
            if key not in seen:
                seen.add(key)
                queue.append((mod, qual, node, cls_of.get(qual), root))

    while queue:
        mod, qual, node, cls, root = queue.pop()
        idx = indexes[mod]
        if _recompute_ok(idx.sf, node):
            continue
        _check_body(node, qual, root, idx, findings)
        for tmod, tqual in _out_edges(node, idx, cls, project):
            tidx = indexes.get(tmod)
            if tidx is None:
                continue
            tnode = tidx.functions.get(tqual)
            if tnode is None:
                continue
            key = (tmod, tnode.lineno)
            if key in seen:
                continue
            seen.add(key)
            tcls = tqual.split(".")[0] if "." in tqual else None
            queue.append((tmod, tqual, tnode, tcls, root))
    return findings
