"""Rule: no tensor of a published front is written in place.

The JAX package gets snapshot isolation from immutable arrays, and its
``use-after-donate`` rule guards the one place it gives that up (buffer
donation).  The port has no donation: every sketch module's ``ingest``
adds into its tensors in place, and isolation rests on one rule instead
(``serving/snapshot.py``): no tensor of a front that has been handed out
is ever written again.  This rule makes the static half of that
mechanical; the witness (:mod:`repro_torch.analysis.witness`) checks the
bytes of every live front at run time, which also sees writes made
through a raw pointer by a CUDA kernel (they never bump a tensor's
``_version``).

An in-place write is any of

- a tensor method ending in ``_`` (``x.add_(...)``, ``x.zero_()``,
  ``x.index_put_(...)``): it writes ``x``;
- an ``out=`` keyword argument: it writes the expression given;
- a store or augmented assignment into a subscript (``x[i] = v``,
  ``x[i] += v``): it writes ``x``;
- a call of a function whose ``def`` carries a ``# writes: N[,M]``
  marker (resolved by name in its module, through a from-import or
  through a module alias), or a call whose own lines carry the marker:
  it writes its positional arguments N, M.  The marker is the counterpart
  of the JAX package's ``# donates: N``: a reviewed assertion, on the
  kernel wrappers that write an argument through a raw pointer and on the
  sketch modules' in-place ``ingest``, that this rule makes load-bearing.

A written expression reads a published front when it contains
``self._front``, or the ``.sketch`` of a published snapshot: of an
expression ending in ``.snapshot`` or ``._front``, of a call of
``publish``, ``adopt_published``, ``merged_snapshot`` or ``Snapshot``,
of a parameter annotated ``Snapshot``, or of a local name bound in the
function to one of those; a local name bound to such a ``.sketch`` reads
it too.  Like the reference's rules this under-approximates: a front
reached through a container, another function's return or an alias the
AST cannot follow is not seen, and nothing clean is flagged for the
patterns this codebase uses.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.engine import (
    Finding, Project, SourceFile, dotted_name, functions_of, module_imports,
)

RULE = "write-after-publish"

_MARKER = re.compile(r"#\s*writes:\s*([0-9]+(?:\s*,\s*[0-9]+)*)")
_SNAPSHOT_CALLS = frozenset({"publish", "adopt_published", "merged_snapshot",
                             "Snapshot"})


def _marker(sf: SourceFile, first: int, last: int) -> frozenset[int] | None:
    """``# writes: ...`` positions on any of lines ``first..last``."""
    for lineno in range(first, last + 1):
        m = _MARKER.search(sf.line(lineno))
        if m:
            return frozenset(int(p) for p in m.group(1).split(","))
    return None


def _writing_functions(project: Project
                       ) -> dict[tuple[str, str], frozenset[int]]:
    """(module, function) -> written positions, from ``# writes:`` markers
    on a top-level ``def``'s signature lines."""
    out: dict[tuple[str, str], frozenset[int]] = {}
    for mod, sf in project.files.items():
        if "writes:" not in sf.text:
            continue
        for qual, cls, node in functions_of(sf.tree):
            if cls is not None:
                continue
            last = node.body[0].lineno - 1 if node.body else node.lineno
            nums = _marker(sf, node.lineno, max(node.lineno, last))
            if nums is not None:
                out[(mod, qual)] = nums
    return out


class _Fronts:
    """What one function's expressions may read of a published front."""

    def __init__(self, fn: ast.AST) -> None:
        self.snapshots: set[str] = set()  # names bound to a published snapshot
        self.sketches: set[str] = set()   # names bound to its .sketch
        args = getattr(fn, "args", None)
        if args is not None:
            for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
                ann = dotted_name(a.annotation) if a.annotation else None
                if ann is not None and ann.split(".")[-1] == "Snapshot":
                    self.snapshots.add(a.arg)
        # bindings in source order, repeated to a fixed point so that a
        # chain of aliases resolves whatever its order
        binds = [(t.id, node.value) for node in ast.walk(fn)
                 if isinstance(node, ast.Assign)
                 for t in node.targets if isinstance(t, ast.Name)]
        changed = True
        while changed:
            changed = False
            for name, value in binds:
                if name not in self.snapshots and self.is_snapshot(value):
                    self.snapshots.add(name)
                    changed = True
                elif name not in self.sketches and self.is_front_sketch(value):
                    self.sketches.add(name)
                    changed = True

    def is_snapshot(self, node: ast.AST) -> bool:
        name = dotted_name(node)
        if name is not None:
            return (name in self.snapshots or name == "self._front"
                    or name.endswith("._front")
                    or name.split(".")[-1] == "snapshot")
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func)
            return fname is not None and \
                fname.split(".")[-1] in _SNAPSHOT_CALLS
        return False

    def is_front_sketch(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Attribute) and node.attr == "sketch"
                and self.is_snapshot(node.value)) or (
            isinstance(node, ast.Name) and node.id in self.sketches)

    def reads_front(self, node: ast.AST) -> bool:
        for sub in ast.walk(node):
            name = dotted_name(sub)
            if name is not None and (name == "self._front"
                                     or name.startswith("self._front.")):
                return True
            if self.is_front_sketch(sub):
                return True
        return False


def _callee(name: str, mod: str, top: set[str], mod_aliases, from_imports,
            project: Project) -> tuple[str, str] | None:
    if "." not in name:
        if name in top:
            return (mod, name)
        if name in from_imports:
            return from_imports[name]
        return None
    head, _, rest = name.partition(".")
    if "." in rest:
        return None
    if head in from_imports:
        m, n = from_imports[head]
        return (f"{m}.{n}", rest)
    if head in mod_aliases and project.get(mod_aliases[head]) is not None:
        return (mod_aliases[head], rest)
    return None


def _writes(sf: SourceFile, node: ast.AST, writers, resolve
            ) -> list[tuple[ast.AST, str]]:
    """(written expression, how) pairs of one AST node."""
    out: list[tuple[ast.AST, str]] = []
    if isinstance(node, ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr.endswith("_") \
                and not func.attr.startswith("__"):
            out.append((func.value, f"`.{func.attr}()`"))
        for kw in node.keywords:
            if kw.arg == "out":
                out.append((kw.value, "`out=`"))
        fname = dotted_name(func)
        end = getattr(node, "end_lineno", node.lineno) or node.lineno
        nums = _marker(sf, node.lineno, end)
        if nums is None and fname is not None:
            target = resolve(fname)
            if target is not None:
                nums = writers.get(target)
        if nums is not None:
            for pos in sorted(nums):
                if pos < len(node.args):
                    out.append((node.args[pos],
                                f"`{fname or '<call>'}` (writes: {pos})"))
    elif isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            if isinstance(t, ast.Subscript):
                out.append((t.value, "a subscript store"))
    return out


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    writers = _writing_functions(project)
    for mod, sf in sorted(project.files.items()):
        mod_aliases, from_imports = module_imports(sf.tree)
        top = {q for q, cls, _n in functions_of(sf.tree) if cls is None}

        def resolve(name: str, mod=mod, top=top, mod_aliases=mod_aliases,
                    from_imports=from_imports):
            return _callee(name, mod, top, mod_aliases, from_imports,
                           project)

        for qual, _cls, fn in functions_of(sf.tree):
            fronts = _Fronts(fn)
            seen: set[tuple[int, str]] = set()
            for node in ast.walk(fn):
                for target, how in _writes(sf, node, writers, resolve):
                    if not fronts.reads_front(target):
                        continue
                    text = ast.unparse(target)
                    if (node.lineno, text) in seen:
                        continue
                    seen.add((node.lineno, text))
                    findings.append(Finding(
                        RULE, mod, node.lineno,
                        f"{qual!r} writes `{text}` in place through {how}, "
                        "and it reads a published front; a front that has "
                        "been handed out is never written again (write a "
                        "private copy, or the delta)"))
    return findings
