"""Core model for the port's invariant checker: sources, findings, baseline.

The JAX package's ``analysis/engine.py`` on the port: the same model over
``src/repro_torch`` and the port's own wire lock.

Everything operates on parsed ASTs plus raw source lines (the lock rules
read trailing ``# guarded-by:`` comments, which ``ast`` drops), so a
:class:`Project` can be built either from the repo on disk
(:meth:`Project.from_root`) or from in-memory fixture snippets
(:meth:`Project.from_sources`) — the test suite feeds each rule
deliberately-broken and deliberately-clean sources through the exact
code path the CI gate runs.

Baselines: a baseline file holds one finding *key* per line.  Keys are
``rule|module|message`` — deliberately line-number free, so unrelated
edits above a deferred finding don't un-suppress it.  The shipped tree
targets an *empty* baseline; the mechanism exists for genuinely-deferred
findings only.  The port's default baseline is
``<root>/analysis_baseline_torch.txt``, not the JAX package's file, so
neither package's baseline can suppress the other's findings or go stale
because of them.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Callable, Iterable

PACKAGE = "repro_torch"
BASELINE_NAME = "analysis_baseline_torch.txt"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a specific site."""

    rule: str
    module: str  # dotted module, e.g. "repro_torch.net.wire"
    line: int
    message: str

    @property
    def key(self) -> str:
        """Stable baseline key — no line number, survives drift above."""
        return f"{self.rule}|{self.module}|{self.message}"

    def render(self, project: "Project | None" = None) -> str:
        loc = self.module
        if project is not None:
            sf = project.files.get(self.module)
            if sf is not None and sf.path:
                loc = sf.path
        return f"{loc}:{self.line}: [{self.rule}] {self.message}"


class SourceFile:
    """One parsed module: dotted name, path (may be ""), text, AST."""

    def __init__(self, module: str, path: str, text: str) -> None:
        self.module = module
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path or f"<{module}>")

    def line(self, lineno: int) -> str:
        """1-based physical source line ("" when out of range)."""
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


class Project:
    """A set of parseable modules plus auxiliary (non-Python) files.

    ``files`` maps dotted module name -> :class:`SourceFile`; ``aux``
    maps posix-style src-relative paths (e.g. ``repro_torch/net/
    wire_schema.lock``) -> text, for committed artifacts rules check.
    """

    def __init__(self, files: dict[str, SourceFile],
                 aux: dict[str, str] | None = None,
                 root: str | None = None) -> None:
        self.files = files
        self.aux = aux or {}
        self.root = root

    @classmethod
    def from_root(cls, root: str) -> "Project":
        """Parse every ``src/repro_torch/**/*.py`` under the repo root."""
        src = os.path.join(root, "src")
        pkg = os.path.join(src, PACKAGE)
        if not os.path.isdir(pkg):
            raise FileNotFoundError(f"no src/{PACKAGE} package under {root!r}")
        files: dict[str, SourceFile] = {}
        for dirpath, dirnames, filenames in os.walk(pkg):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__")
            for name in sorted(filenames):
                if not name.endswith(".py"):
                    continue
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, src)
                parts = rel[:-3].replace(os.sep, "/").split("/")
                if parts[-1] == "__init__":
                    parts = parts[:-1]
                module = ".".join(parts)
                with open(path, "r", encoding="utf-8") as f:
                    files[module] = SourceFile(module, path, f.read())
        aux: dict[str, str] = {}
        lock_rel = f"{PACKAGE}/net/wire_schema.lock"
        lock_path = os.path.join(src, *lock_rel.split("/"))
        if os.path.exists(lock_path):
            with open(lock_path, "r", encoding="utf-8") as f:
                aux[lock_rel] = f.read()
        return cls(files, aux, root=root)

    @classmethod
    def from_sources(cls, sources: dict[str, str],
                     aux: dict[str, str] | None = None) -> "Project":
        """Build a project from in-memory {module: source} (tests)."""
        files = {mod: SourceFile(mod, "", text)
                 for mod, text in sources.items()}
        return cls(files, aux)

    def get(self, module: str) -> SourceFile | None:
        return self.files.get(module)


Rule = Callable[[Project], list[Finding]]


def all_rules() -> list[tuple[str, Rule]]:
    """The registered (name, checker) pairs, in report order.

    Imported lazily so fixture tests can import a single rule module
    without dragging the rest in.
    """
    from repro_torch.analysis import (
        isolation, locks, pickle_rules, trace_purity, wire_schema,
    )

    return [
        ("trace-purity", trace_purity.check),
        ("wire-schema", wire_schema.check),
        ("unpickler-allowlist", pickle_rules.check_unpickler),
        ("no-pickle-hot-path", pickle_rules.check_hot_path),
        ("lock-discipline", locks.check),
        ("write-after-publish", isolation.check),
    ]


def run_rules(project: Project,
              only: Iterable[str] | None = None) -> list[Finding]:
    wanted = set(only) if only is not None else None
    out: list[Finding] = []
    for name, rule in all_rules():
        if wanted is not None and name not in wanted:
            continue
        out.extend(rule(project))
    out.sort(key=lambda f: (f.module, f.line, f.rule, f.message))
    return out


def load_baseline(path: str) -> set[str]:
    """Read one finding key per line; blank lines and ``#`` comments ok."""
    if not os.path.exists(path):
        return set()
    keys: set[str] = set()
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                keys.add(line)
    return keys


def split_by_baseline(findings: list[Finding], baseline: set[str]
                      ) -> tuple[list[Finding], list[Finding], set[str]]:
    """-> (new, suppressed, stale_baseline_keys)."""
    new: list[Finding] = []
    suppressed: list[Finding] = []
    seen: set[str] = set()
    for f in findings:
        if f.key in baseline:
            suppressed.append(f)
            seen.add(f.key)
        else:
            new.append(f)
    return new, suppressed, baseline - seen


# --------------------------------------------------------------- helpers
# Shared AST utilities used by several rules.

def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def module_imports(tree: ast.Module) -> tuple[dict[str, str], dict[str, tuple[str, str]]]:
    """Top-level imports of a module.

    Returns ``(mod_aliases, from_imports)`` where ``mod_aliases`` maps
    local alias -> imported module (``import numpy as np`` -> ``{"np":
    "numpy"}``) and ``from_imports`` maps local name -> (module, name)
    (``from repro_torch.net import wire`` -> ``{"wire": ("repro_torch.net",
    "wire")}``).  Function-local imports are deliberately included too —
    hot-path modules import lazily.
    """
    mod_aliases: dict[str, str] = {}
    from_imports: dict[str, tuple[str, str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    mod_aliases[alias.asname] = alias.name
                else:
                    top = alias.name.split(".")[0]
                    mod_aliases[top] = top
        elif isinstance(node, ast.ImportFrom):
            if node.module is None or node.level:
                continue
            for alias in node.names:
                from_imports[alias.asname or alias.name] = \
                    (node.module, alias.name)
    return mod_aliases, from_imports


def functions_of(tree: ast.Module):
    """Yield (qualname, class_name_or_None, node) for every def in a
    module: top-level functions and class methods (one level deep, which
    is all this codebase uses)."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, None, node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield f"{node.name}.{sub.name}", node.name, sub
