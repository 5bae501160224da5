"""Rule: frame-registry discipline + committed schema fingerprint.

The JAX package's ``analysis/wire_schema.py`` over the port's transport
modules and the port's own lock, ``src/repro_torch/net/wire_schema.lock``
(written by ``python -m repro_torch.analysis --write-wire-lock``).  The
fingerprint code is the reference's, so the two locks of one schema carry
the same ``version`` and ``fingerprint``: a JAX peer and a port peer speak
one schema.

DESIGN.md's bump rules say any change to the wire surface — the frame
registry, the header struct, or the columnar item layout — must bump
``WIRE_VERSION`` (and extend ``COMPAT_VERSIONS`` when the old decoder is
still accepted).  This rule makes that mechanical:

- frame ids must be unique and frame kinds well-formed
- within each transport-tier dispatcher function, a registered kind is
  handled at most once (double handling == dead elif == decode skew),
  and no dispatcher compares against an unregistered kind string
- when the full transport tier is in view, every registered kind must be
  dispatched *somewhere* (a registered-but-never-handled frame is dead
  weight at best, a silent drop at worst)
- the schema fingerprint (magic, versions, sorted frame registry, every
  top-level ``struct.Struct`` format) must equal the committed
  ``src/repro_torch/net/wire_schema.lock`` — editing the schema without a
  version bump, or bumping without regenerating the lock, fails the gate

Everything is read from the AST of ``repro_torch.net.wire``, so the drift test
can feed a synthetically-edited wire source through the same code path
CI runs.
"""
from __future__ import annotations

import ast
import hashlib

from repro_torch.analysis.engine import Finding, Project, functions_of

RULE = "wire-schema"

WIRE_MODULE = "repro_torch.net.wire"
LOCK_AUX_PATH = "repro_torch/net/wire_schema.lock"

# dispatcher surface: every module that switches on frame kinds
TRANSPORT_MODULES = (
    "repro_torch.net.wire",
    "repro_torch.net.backend",
    "repro_torch.net.ingest_server",
    "repro_torch.net.query_server",
    "repro_torch.runtime.backend",
)


# ------------------------------------------------------------ extraction
def extract_schema(tree: ast.Module) -> dict:
    """Pull the wire schema constants out of a parsed wire module.

    Returns ``{"magic": str, "version": int|None, "compat": list[int],
    "frames": list[(kind, id)], "structs": {name: fmt}}``.  Missing
    pieces stay None/empty — the checker reports them as findings.
    """
    schema: dict = {"magic": None, "version": None, "compat": [],
                    "frames": [], "structs": {}}
    version_name = "WIRE_VERSION"
    for node in tree.body:
        targets: list[ast.expr] = []
        value: ast.expr | None = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if not targets or value is None:
            continue
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        if not names:
            continue
        name = names[0]
        if name == "MAGIC" and isinstance(value, ast.Constant) \
                and isinstance(value.value, (bytes, str)):
            raw = value.value
            schema["magic"] = raw.decode("ascii", "replace") \
                if isinstance(raw, bytes) else raw
        elif name == version_name and isinstance(value, ast.Constant) \
                and isinstance(value.value, int):
            schema["version"] = value.value
        elif name == "COMPAT_VERSIONS":
            schema["compat"] = _int_collection(value, schema)
        elif name == "FRAME_TYPES" and isinstance(value, ast.Dict):
            for k, v in zip(value.keys, value.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str) \
                        and isinstance(v, ast.Constant) \
                        and isinstance(v.value, int):
                    schema["frames"].append((k.value, v.value))
        elif isinstance(value, ast.Call):
            fmt = _struct_format(value)
            if fmt is not None:
                schema["structs"][name] = fmt
    return schema


def _int_collection(value: ast.expr, schema: dict) -> list[int]:
    """Ints of ``frozenset({2, WIRE_VERSION})``-style literals."""
    out: list[int] = []
    for node in ast.walk(value):
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            out.append(node.value)
        elif isinstance(node, ast.Name) and node.id == "WIRE_VERSION" \
                and schema["version"] is not None:
            out.append(schema["version"])
    return sorted(set(out))


def _struct_format(call: ast.Call) -> str | None:
    func = call.func
    is_struct = (isinstance(func, ast.Attribute) and func.attr == "Struct"
                 and isinstance(func.value, ast.Name)
                 and func.value.id == "struct") or \
                (isinstance(func, ast.Name) and func.id == "Struct")
    if is_struct and call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


# ----------------------------------------------------------- fingerprint
def fingerprint(schema: dict) -> str:
    lines = [f"magic={schema['magic']}",
             f"version={schema['version']}",
             "compat=" + ",".join(str(v) for v in schema["compat"])]
    for kind, fid in sorted(schema["frames"]):
        lines.append(f"frame:{kind}={fid}")
    for name, fmt in sorted(schema["structs"].items()):
        lines.append(f"struct:{name}={fmt}")
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def render_lock(schema: dict) -> str:
    frames = " ".join(f"{k}={v}" for k, v in sorted(schema["frames"]))
    return (
        "# Wire schema lock — regenerate ONLY alongside a WIRE_VERSION\n"
        "# bump: `python -m repro_torch.analysis --write-wire-lock`.\n"
        "# The gate fails when the live schema in repro_torch/net/wire.py\n"
        "# no longer matches this fingerprint; the fingerprint equals the\n"
        "# JAX package's lock of the same schema.\n"
        f"version = {schema['version']}\n"
        f"fingerprint = {fingerprint(schema)}\n"
        f"# frames: {frames}\n"
    )


def parse_lock(text: str) -> tuple[int | None, str | None]:
    version: int | None = None
    digest: str | None = None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("#") or "=" not in line:
            continue
        key, _, val = line.partition("=")
        key, val = key.strip(), val.strip()
        if key == "version":
            try:
                version = int(val)
            except ValueError:
                pass
        elif key == "fingerprint":
            digest = val
    return version, digest


# ------------------------------------------------------------ dispatcher
def _kind_side(node: ast.expr) -> bool:
    """Is this expression a frame-kind carrier (``kind`` or ``msg[0]``)?"""
    if isinstance(node, ast.Name) and node.id == "kind":
        return True
    if isinstance(node, ast.Subscript):
        sl = node.slice
        return isinstance(sl, ast.Constant) and sl.value == 0
    return False


def _kind_literals(func_node: ast.AST) -> list[tuple[str, int]]:
    """(literal, lineno) for every frame-kind comparison in a function."""
    out: list[tuple[str, int]] = []
    for node in ast.walk(func_node):
        if not isinstance(node, ast.Compare) or len(node.ops) != 1:
            continue
        left, right = node.left, node.comparators[0]
        op = node.ops[0]
        if isinstance(op, (ast.Eq, ast.NotEq)):
            for a, b in ((left, right), (right, left)):
                if _kind_side(a) and isinstance(b, ast.Constant) \
                        and isinstance(b.value, str):
                    out.append((b.value, node.lineno))
        elif isinstance(op, (ast.In, ast.NotIn)) and _kind_side(left) \
                and isinstance(right, (ast.Tuple, ast.List, ast.Set)):
            for el in right.elts:
                if isinstance(el, ast.Constant) \
                        and isinstance(el.value, str):
                    out.append((el.value, node.lineno))
    return out


# ----------------------------------------------------------------- check
def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    sf = project.get(WIRE_MODULE)
    if sf is None:
        return findings
    schema = extract_schema(sf.tree)

    if schema["version"] is None:
        findings.append(Finding(RULE, WIRE_MODULE, 1,
                                "WIRE_VERSION constant not found"))
    if not schema["frames"]:
        findings.append(Finding(RULE, WIRE_MODULE, 1,
                                "FRAME_TYPES registry not found or empty"))

    by_id: dict[int, str] = {}
    kinds: set[str] = set()
    for kind, fid in schema["frames"]:
        if kind in kinds:
            findings.append(Finding(
                RULE, WIRE_MODULE, 1,
                f"frame kind {kind!r} registered twice"))
        kinds.add(kind)
        if fid in by_id:
            findings.append(Finding(
                RULE, WIRE_MODULE, 1,
                f"frame id {fid} reused by {by_id[fid]!r} and {kind!r}"))
        else:
            by_id[fid] = kind

    # dispatcher discipline over whatever transport modules are in view
    mentioned: set[str] = set()
    for mod in TRANSPORT_MODULES:
        tsf = project.get(mod)
        if tsf is None:
            continue
        for qual, _cls, node in functions_of(tsf.tree):
            counts: dict[str, int] = {}
            lines: dict[str, int] = {}
            for lit, lineno in _kind_literals(node):
                counts[lit] = counts.get(lit, 0) + 1
                lines.setdefault(lit, lineno)
            for lit, n in sorted(counts.items()):
                mentioned.add(lit)
                if kinds and lit not in kinds:
                    findings.append(Finding(
                        RULE, mod, lines[lit],
                        f"dispatcher {qual!r} switches on unregistered "
                        f"frame kind {lit!r}"))
                if n > 1:
                    findings.append(Finding(
                        RULE, mod, lines[lit],
                        f"dispatcher {qual!r} handles frame kind {lit!r} "
                        f"{n} times"))
    if all(project.get(m) is not None for m in TRANSPORT_MODULES):
        for kind in sorted(kinds - mentioned):
            findings.append(Finding(
                RULE, WIRE_MODULE, 1,
                f"frame kind {kind!r} is registered but never dispatched "
                "by any transport module"))

    # committed fingerprint vs live schema
    lock_text = project.aux.get(LOCK_AUX_PATH)
    if lock_text is None:
        findings.append(Finding(
            RULE, WIRE_MODULE, 1,
            "missing committed wire_schema.lock "
            "(generate: python -m repro_torch.analysis --write-wire-lock)"))
        return findings
    lock_version, lock_digest = parse_lock(lock_text)
    live_digest = fingerprint(schema)
    if lock_version != schema["version"]:
        findings.append(Finding(
            RULE, WIRE_MODULE, 1,
            f"wire_schema.lock records version {lock_version} but "
            f"WIRE_VERSION is {schema['version']} — regenerate the lock "
            "alongside the bump (--write-wire-lock)"))
    elif lock_digest != live_digest:
        findings.append(Finding(
            RULE, WIRE_MODULE, 1,
            "wire schema changed without a WIRE_VERSION bump "
            f"(lock fingerprint {str(lock_digest)[:12]}… != live "
            f"{live_digest[:12]}…)"))
    return findings
