"""Rules: unpickler-allowlist consistency + no pickle on hot paths.

**unpickler-allowlist** — the port's ``net/wire.py`` decodes every control
frame with a restricted unpickler whose project surface is two literal
dicts: ``_SAFE_REPRO_CLASSES`` names the admitted classes by the JAX
package's module names (what a JAX peer writes), and ``_PORT_MODULES``
maps each of those modules to the port module holding the twin class.  The
classes that legitimately cross a pipe/socket are marked ``# wire-type``
at their definition; this rule keeps the three in lockstep:

- every allowlist key has a ``_PORT_MODULES`` entry, and every
  ``_PORT_MODULES`` key is an allowlist key (a mapping with no class is
  dead weight; an allowlisted module with no mapping cannot decode)
- every allowlist entry resolves, through the map, to a live class in
  the port module, marked ``# wire-type`` there (a dead entry is latent
  gadget surface: it re-opens the exact module path an attacker would
  want back)
- every ``# wire-type`` marked class is reachable through the map (or a
  hostile-looking frame rejection is one refactor away)

**no-pickle-hot-path** — the v3 item path exists so no pickle byte is
touched per batch.  Modules marked ``# analysis: hot-path`` (whole
module) and functions marked ``# hot-path`` (single def) must not
reference ``pickle`` or ``restricted_loads`` directly.  The check is
deliberately non-transitive: ``decode_message`` legally dispatches
pickled *control* frames and is reachable from hot code — what the rule
forbids is pickle appearing in the hot functions themselves.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.engine import Finding, Project, dotted_name

UNPICKLER_RULE = "unpickler-allowlist"
HOT_RULE = "no-pickle-hot-path"

WIRE_MODULE = "repro_torch.net.wire"
ALLOWLIST_NAME = "_SAFE_REPRO_CLASSES"
PORT_MAP_NAME = "_PORT_MODULES"
WIRE_TYPE_MARKER = "# wire-type"
HOT_MODULE_MARKER = "# analysis: hot-path"
HOT_FUNC_MARKER = "# hot-path"


# ------------------------------------------------------- allowlist rule
def _dict_literal(tree: ast.Module, name: str) -> ast.Dict | None | bool:
    """The module-level ``name = {...}`` dict literal; False when ``name``
    is not assigned at module level, None when it is but not as a dict."""
    for node in tree.body:
        targets: list[ast.expr] = []
        value: ast.expr | None = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if any(isinstance(t, ast.Name) and t.id == name for t in targets):
            return value if isinstance(value, ast.Dict) else None
    return False


def extract_allowlist(tree: ast.Module) -> dict[str, set[str]] | None:
    """``_SAFE_REPRO_CLASSES`` as {module: {class, ...}}; None if absent."""
    value = _dict_literal(tree, ALLOWLIST_NAME)
    if not value:
        return None
    out: dict[str, set[str]] = {}
    for k, v in zip(value.keys, value.values):
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            continue
        names: set[str] = set()
        for el in ast.walk(v):
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                names.add(el.value)
        out[k.value] = names
    return out


def extract_port_modules(tree: ast.Module) -> dict[str, str] | None:
    """``_PORT_MODULES`` as {reference module: port module}; None if absent."""
    value = _dict_literal(tree, PORT_MAP_NAME)
    if not value:
        return None
    return {k.value: v.value for k, v in zip(value.keys, value.values)
            if isinstance(k, ast.Constant) and isinstance(k.value, str)
            and isinstance(v, ast.Constant) and isinstance(v.value, str)}


def _marked_classes(project: Project) -> dict[tuple[str, str], int]:
    """{(module, class): lineno} of every ``# wire-type`` marked class."""
    marked: dict[tuple[str, str], int] = {}
    for mod, sf in project.files.items():
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            candidates = [node.lineno, node.lineno - 1]
            if node.decorator_list:
                candidates.append(node.decorator_list[0].lineno - 1)
            if any(WIRE_TYPE_MARKER in sf.line(ln) for ln in candidates):
                marked[(mod, node.name)] = node.lineno
    return marked


def check_unpickler(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    sf = project.get(WIRE_MODULE)
    if sf is None:
        return findings
    allowlist = extract_allowlist(sf.tree)
    if allowlist is None:
        findings.append(Finding(
            UNPICKLER_RULE, WIRE_MODULE, 1,
            f"{ALLOWLIST_NAME} dict literal not found in the wire module "
            "(the restricted unpickler must enumerate repro classes "
            "explicitly)"))
        return findings
    port_map = extract_port_modules(sf.tree)
    if port_map is None:
        findings.append(Finding(
            UNPICKLER_RULE, WIRE_MODULE, 1,
            f"{PORT_MAP_NAME} dict literal not found in the wire module "
            "(each allowlisted module must name the port module of its "
            "classes)"))
        port_map = {}
    for key in sorted(set(allowlist) - set(port_map)):
        findings.append(Finding(
            UNPICKLER_RULE, WIRE_MODULE, 1,
            f"allowlist module {key!r} has no {PORT_MAP_NAME} entry: its "
            "classes cannot resolve to a port class"))
    for key in sorted(set(port_map) - set(allowlist)):
        findings.append(Finding(
            UNPICKLER_RULE, WIRE_MODULE, 1,
            f"{PORT_MAP_NAME} entry {key!r} -> {port_map[key]!r} has no "
            f"{ALLOWLIST_NAME} entry (dead mapping)"))
    marked = _marked_classes(project)

    reachable: set[tuple[str, str]] = set()
    for key, names in sorted(allowlist.items()):
        mod = port_map.get(key)
        if mod is None:
            continue
        target = project.get(mod)
        for name in sorted(names):
            reachable.add((mod, name))
            if target is None:
                findings.append(Finding(
                    UNPICKLER_RULE, WIRE_MODULE, 1,
                    f"allowlist entry {key}.{name} is dead: module "
                    f"{mod!r} does not exist (latent gadget surface)"))
                continue
            defined = any(isinstance(n, ast.ClassDef) and n.name == name
                          for n in ast.walk(target.tree))
            if not defined:
                findings.append(Finding(
                    UNPICKLER_RULE, WIRE_MODULE, 1,
                    f"allowlist entry {key}.{name} is dead: no such class "
                    f"in {mod} (latent gadget surface)"))
            elif (mod, name) not in marked:
                findings.append(Finding(
                    UNPICKLER_RULE, mod, 1,
                    f"class {name!r} is in the unpickler allowlist but not "
                    f"marked `{WIRE_TYPE_MARKER}` at its definition"))

    for (mod, name), lineno in sorted(marked.items()):
        if (mod, name) not in reachable:
            findings.append(Finding(
                UNPICKLER_RULE, mod, lineno,
                f"class {name!r} is marked `{WIRE_TYPE_MARKER}` but missing "
                f"from {ALLOWLIST_NAME} in the wire module — it cannot "
                "cross a transport"))
    return findings


# -------------------------------------------------------- hot-path rule
def _pickle_refs(node: ast.AST, pickle_aliases: set[str]) -> list[tuple[int, str]]:
    refs: list[tuple[int, str]] = []
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Import, ast.ImportFrom)):
            continue  # the import line itself is reported separately
        name = None
        if isinstance(sub, ast.Attribute):
            name = dotted_name(sub)
        elif isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
            name = sub.id
        if name is None:
            continue
        parts = name.split(".")
        if parts[0] == "pickle" or parts[0] in pickle_aliases \
                or parts[-1] == "restricted_loads":
            refs.append((sub.lineno, name))
    # an Attribute walk also yields its inner Name: keep one (the longest
    # dotted form) reference per line
    best: dict[int, str] = {}
    for lineno, name in refs:
        if len(name) > len(best.get(lineno, "")):
            best[lineno] = name
    return sorted(best.items())


def check_hot_path(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for mod, sf in sorted(project.files.items()):
        # names bound from pickle by a from-import anywhere in the module
        pickle_aliases: set[str] = set()
        import_lines: list[tuple[int, str]] = []
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.split(".")[0] == "pickle":
                        pickle_aliases.add(alias.asname
                                           or alias.name.split(".")[0])
                        import_lines.append((node.lineno, alias.name))
            elif isinstance(node, ast.ImportFrom):
                if node.module and node.module.split(".")[0] == "pickle":
                    for alias in node.names:
                        pickle_aliases.add(alias.asname or alias.name)
                        import_lines.append(
                            (node.lineno, f"{node.module}.{alias.name}"))

        module_hot = any(HOT_MODULE_MARKER in line
                         for line in sf.lines[:40])
        if module_hot:
            for lineno, what in import_lines:
                findings.append(Finding(
                    HOT_RULE, mod, lineno,
                    f"hot-path module imports {what} (marked "
                    f"`{HOT_MODULE_MARKER}`: no pickle allowed)"))
            for lineno, what in sorted(set(_pickle_refs(
                    sf.tree, pickle_aliases))):
                findings.append(Finding(
                    HOT_RULE, mod, lineno,
                    f"hot-path module references `{what}`"))
            continue

        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            def_line = sf.line(node.lineno)
            if HOT_FUNC_MARKER not in def_line:
                continue
            for lineno, what in sorted(set(_pickle_refs(
                    node, pickle_aliases))):
                findings.append(Finding(
                    HOT_RULE, mod, lineno,
                    f"hot-path function {node.name!r} references `{what}`"))
    return findings
