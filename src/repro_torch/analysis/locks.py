"""Rule: ``# guarded-by`` field discipline + static lock-order graph.

The JAX package's ``analysis/locks.py`` over the port's modules, unchanged
in what it checks.

Annotation syntax (DESIGN.md §Analysis):

``# guarded-by: <lock>``
    trailing comment on the field's declaration (a dataclass field line,
    or the ``self.x = ...`` line in ``__init__``/``__post_init__``).
    Every touch of the field in that class — read or write — must happen
    lexically inside ``with self.<lock>:`` (or in a method annotated
    ``# requires-lock: <lock>``).

``# guarded-by(writes): <lock>``
    writes need the lock; bare reads are allowed lock-free.  This is the
    publish pattern: ``SnapshotBuffer._front`` is an immutable-snapshot
    reference that readers may load without synchronization, but every
    store happens under the buffer lock.

``# requires-lock: <lock>``
    trailing comment on a ``def`` line: the method is a private helper
    whose *callers* hold the lock.  Its body is checked as if the lock
    were held, and every in-class use of the method is checked to occur
    with the lock held.

The second half builds a static lock-order graph: every ``with`` on a
lock-like expression (attribute ending in ``lock``/named ``_cv``, or a
module-level lock) is an acquisition; lexical nesting and acquisitions
made by (resolvable) callees while a lock is held become edges.  A cycle
is a potential deadlock and fails the gate.  The graph is site-level
over class-qualified lock names — two instances of the same class/lock
field share a node, which matches the witness's allocation-site model.

Constructors are exempt from the guard check (no concurrent reader can
exist before ``__init__`` returns); nested functions are checked with an
*empty* held-set, because a closure may run on another thread later.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.engine import (
    PACKAGE, Finding, Project, SourceFile, dotted_name, functions_of,
    module_imports,
)

RULE = "lock-discipline"

_GUARD_RE = re.compile(
    r"#\s*guarded-by(?P<writes>\(writes\))?:\s*(?P<lock>[A-Za-z_]\w*)")
_REQUIRES_RE = re.compile(r"#\s*requires-lock:\s*(?P<lock>[A-Za-z_]\w*)")

_EXEMPT_METHODS = frozenset({"__init__", "__post_init__", "__new__"})


def _is_lockish(name: str) -> bool:
    last = name.split(".")[-1]
    return "lock" in last.lower() or last == "_cv"


def _with_locks(node: ast.With) -> list[tuple[str, bool]]:
    """``(name, is_self_field)`` locks acquired by one ``with`` statement."""
    out: list[tuple[str, bool]] = []
    for item in node.items:
        ctx = dotted_name(item.context_expr)
        if ctx is None:
            continue
        if ctx.startswith("self."):
            field = ctx[len("self."):]
            if "." not in field and _is_lockish(field):
                out.append((field, True))
        elif "." not in ctx and _is_lockish(ctx):
            out.append((ctx, False))
    return out


# ------------------------------------------------------------- guarded-by
class _ClassAnnotations:
    def __init__(self) -> None:
        self.guards: dict[str, tuple[str, bool]] = {}  # field -> (lock, writes_only)
        self.requires: dict[str, str] = {}             # method -> lock


def _collect_annotations(sf: SourceFile, cls: ast.ClassDef
                         ) -> _ClassAnnotations:
    ann = _ClassAnnotations()

    def note_guard(field: str, lineno: int) -> None:
        m = _GUARD_RE.search(sf.line(lineno))
        if m:
            ann.guards[field] = (m.group("lock"),
                                 m.group("writes") is not None)

    for node in cls.body:
        if isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            note_guard(node.target.id, node.lineno)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    note_guard(t.id, node.lineno)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            m = _REQUIRES_RE.search(sf.line(node.lineno)) or \
                _REQUIRES_RE.search(sf.line(node.lineno - 1))
            if m:
                ann.requires[node.name] = m.group("lock")
            if node.name in _EXEMPT_METHODS:
                for sub in ast.walk(node):
                    targets: list[ast.expr] = []
                    if isinstance(sub, ast.Assign):
                        targets = sub.targets
                    elif isinstance(sub, ast.AnnAssign):
                        targets = [sub.target]
                    for t in targets:
                        if isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id == "self":
                            note_guard(t.attr, sub.lineno)
    return ann


def _check_method(sf: SourceFile, cls: ast.ClassDef,
                  method: ast.FunctionDef, ann: _ClassAnnotations,
                  findings: list[Finding]) -> None:
    mod = sf.module

    def touch(node: ast.Attribute, held: frozenset[str]) -> None:
        field = node.attr
        guard = ann.guards.get(field)
        if guard is not None:
            lock, writes_only = guard
            is_write = isinstance(node.ctx, (ast.Store, ast.Del))
            if (is_write or not writes_only) and lock not in held:
                verb = "writes" if is_write else "reads"
                kind = "guarded-by(writes)" if writes_only else "guarded-by"
                findings.append(Finding(
                    RULE, mod, node.lineno,
                    f"{cls.name}.{method.name} {verb} "
                    f"`self.{field}` ({kind}: {lock}) without "
                    f"holding `self.{lock}`"))
            return
        req = ann.requires.get(field)
        if req is not None and field != method.name and req not in held:
            findings.append(Finding(
                RULE, mod, node.lineno,
                f"{cls.name}.{method.name} uses `self.{field}` "
                f"(requires-lock: {req}) without holding `self.{req}`"))

    def walk(node: ast.AST, held: frozenset[str]) -> None:
        if isinstance(node, ast.With):
            acquired = frozenset(
                lk for lk, is_self in _with_locks(node) if is_self)
            for item in node.items:
                walk(item.context_expr, held)
                if item.optional_vars is not None:
                    walk(item.optional_vars, held)
            inner = held | acquired
            for stmt in node.body:
                walk(stmt, inner)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not method:
            # a closure may run later, on any thread, without the lock
            body = node.body if isinstance(node.body, list) else [node.body]
            for stmt in body:
                walk(stmt, frozenset())
            return
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "self":
            touch(node, held)
            return
        for child in ast.iter_child_nodes(node):
            walk(child, held)

    start = frozenset({ann.requires[method.name]}) \
        if method.name in ann.requires else frozenset()
    for stmt in method.body:
        walk(stmt, start)


# -------------------------------------------------------------- lock order
def _qual_lock(module: str, cls: str | None, lock: str) -> str:
    return f"{module}.{cls}.{lock}" if cls else f"{module}.{lock}"


class _FuncInfo:
    def __init__(self, module: str, cls: str | None, qual: str,
                 node: ast.AST) -> None:
        self.module = module
        self.cls = cls
        self.qual = qual
        self.node = node
        self.direct: set[str] = set()          # locks acquired in body
        # (held qualified lock, acquired qualified lock, lineno)
        self.edges: list[tuple[str, str, int]] = []
        # (held qualified lock, callee key, lineno)
        self.calls_while_holding: list[
            tuple[str, tuple[str, str], int]] = []
        self.calls: set[tuple[str, str]] = set()


def _resolve_callee(name: str, module: str, cls: str | None,
                    idx_funcs: set[str], from_imports, project: Project
                    ) -> tuple[str, str] | None:
    if name.startswith("self.") and cls is not None:
        meth = name[len("self."):]
        if "." not in meth:
            return (module, f"{cls}.{meth}")
        return None
    if "." not in name:
        if name in idx_funcs:
            return (module, name)
        if name in from_imports:
            m, n = from_imports[name]
            if project.get(m) is not None:
                return (m, n)
        return None
    head, _, rest = name.partition(".")
    if "." in rest:
        return None
    if head in from_imports:
        m, n = from_imports[head]
        target = f"{m}.{n}"
        if project.get(target) is not None:
            return (target, rest)
    return None


def _build_lock_graph(project: Project
                      ) -> dict[tuple[str, str], tuple[str, int]]:
    """Edges ``(held_lock, acquired_lock) -> (module, lineno)``."""
    infos: dict[tuple[str, str], _FuncInfo] = {}
    for mod, sf in project.files.items():
        _aliases, from_imports = module_imports(sf.tree)
        top_funcs = {qual for qual, cls, _n in functions_of(sf.tree)
                     if cls is None}
        for qual, cls, node in functions_of(sf.tree):
            info = _FuncInfo(mod, cls, qual, node)
            infos[(mod, qual)] = info

            def walk(n: ast.AST, held: tuple[str, ...],
                     info=info, cls=cls, from_imports=from_imports,
                     top_funcs=top_funcs) -> None:
                if isinstance(n, ast.With):
                    acquired = [
                        _qual_lock(info.module, cls if is_self else None, lk)
                        for lk, is_self in _with_locks(n)]
                    for q in acquired:
                        info.direct.add(q)
                        for h in held:
                            info.edges.append((h, q, n.lineno))
                    inner = held + tuple(acquired)
                    for stmt in n.body:
                        walk(stmt, inner)
                    for item in n.items:
                        walk(item.context_expr, held)
                    return
                if isinstance(n, ast.Call):
                    name = dotted_name(n.func)
                    if name is not None:
                        callee = _resolve_callee(
                            name, info.module, cls, top_funcs,
                            from_imports, project)
                        if callee is not None:
                            info.calls.add(callee)
                            for h in held:
                                info.calls_while_holding.append(
                                    (h, callee, n.lineno))
                for child in ast.iter_child_nodes(n):
                    walk(child, held)

            body = node.body if isinstance(node.body, list) else [node.body]
            for stmt in body:
                walk(stmt, ())

    # transitive acquire sets (locks a call may take, directly or deeper)
    memo: dict[tuple[str, str], set[str]] = {}

    def acquires(key: tuple[str, str],
                 stack: frozenset[tuple[str, str]]) -> set[str]:
        if key in memo:
            return memo[key]
        info = infos.get(key)
        if info is None or key in stack:
            return set()
        out = set(info.direct)
        for callee in info.calls:
            out |= acquires(callee, stack | {key})
        memo[key] = out
        return out

    edges: dict[tuple[str, str], tuple[str, int]] = {}
    for key, info in infos.items():
        for h, q, line in info.edges:
            edges.setdefault((h, q), (info.module, line))
        for held, callee, line in info.calls_while_holding:
            for q in acquires(callee, frozenset({key})):
                edges.setdefault((held, q), (info.module, line))
    return edges


def _find_cycles(edges: dict[tuple[str, str], tuple[str, int]]
                 ) -> list[list[str]]:
    graph: dict[str, set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    cycles: list[list[str]] = []
    seen_cycles: set[tuple[str, ...]] = set()

    for a, b in sorted(edges):
        if a == b:
            key = (a,)
            if key not in seen_cycles:
                seen_cycles.add(key)
                cycles.append([a, a])
            continue
        # path b ~> a means edge a->b closes a cycle
        stack, visited, parent = [b], {b}, {b: None}
        found = False
        while stack and not found:
            cur = stack.pop()
            for nxt in sorted(graph.get(cur, ())):
                if nxt == a:
                    path = [a, b]
                    node = cur
                    trail = []
                    while node is not None and node != b:
                        trail.append(node)
                        node = parent[node]
                    path.extend(reversed(trail))
                    path.append(a)
                    key = tuple(sorted(set(path)))
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        cycles.append(path)
                    found = True
                    break
                if nxt not in visited:
                    visited.add(nxt)
                    parent[nxt] = cur
                    stack.append(nxt)
    return cycles


# ------------------------------------------------------------------ check
def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []

    for mod, sf in sorted(project.files.items()):
        for node in sf.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            ann = _collect_annotations(sf, node)
            if not ann.guards and not ann.requires:
                continue
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and sub.name not in _EXEMPT_METHODS:
                    _check_method(sf, node, sub, ann, findings)

    edges = _build_lock_graph(project)
    for cycle in _find_cycles(edges):
        if len(cycle) == 2 and cycle[0] == cycle[1]:
            mod, line = edges.get((cycle[0], cycle[0]), (PACKAGE, 1))
            findings.append(Finding(
                RULE, mod, line,
                f"nested reacquisition of lock `{cycle[0]}` "
                "(self-deadlock on a non-reentrant lock)"))
            continue
        mod, line = edges.get((cycle[0], cycle[1]), (PACKAGE, 1))
        findings.append(Finding(
            RULE, mod, line,
            "lock-order cycle (potential deadlock): "
            + " -> ".join(cycle)))
    return findings
