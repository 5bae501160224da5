"""The completeness gate: the port holds the reference's whole public surface.

Every module file of ``src/repro``, every public top-level def, class,
public method and constant in it, every name it re-exports from
``repro.*``, every ``--flag`` of its ``launch/*.py`` drivers and every root
``examples/*.py`` must have a same-named counterpart at the mirrored path
of ``src/repro_torch`` (the examples under ``repro_torch/examples/``), or
an entry in one of the two tables below:

  COVERED   reference item -> the port item that does its work under
            another name or path (which must exist);
  JAX_ONLY  reference item -> why the port has none, in one sentence.

An entry goes stale when its COVERED target is gone, when the port now
holds the item under its own name, or when the reference no longer has
the item; a stale entry fails the gate as a missing name does.

Items are written ``path`` (a module or an example), ``path::Name``,
``path::Class.method`` or ``path::--flag``, paths relative to
``src/repro`` (examples: ``examples/NAME.py``).  The gate reads both
trees with ``ast`` alone: it imports neither package and starts no
process.

  PYTHONPATH=src python -m pytest -q tests/test_torch_surface.py
"""
import ast
import functools
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF = REPO / "src" / "repro"
PORT = REPO / "src" / "repro_torch"
EXAMPLES = REPO / "examples"

_DONATION = ("marks the sketch safe to pass to a jax.jit call that donates "
             "its buffers; PyTorch has no buffer donation, and the port's "
             "guard on published state is the write-after-publish rule "
             "(analysis/isolation.py).")

COVERED = {
    "analysis/donation.py": "analysis/isolation.py",
    "examples/distributed_sketch.py": "distributed/demo.py",
}

JAX_ONLY = {
    "common/struct.py::pytree_dataclass":
        "registers a dataclass as a JAX pytree; the port's states are plain "
        "frozen dataclasses (struct.tensor_dataclass) that need no registry.",
    "common/__init__.py::pytree_dataclass":
        "the package's re-export of struct.pytree_dataclass, a JAX pytree "
        "registration with no PyTorch counterpart.",
    "common/struct.py::tree_map_with_path":
        "a wrapper of jax.tree_util.tree_map_with_path with no caller; the "
        "port walks its states with interop.export_state and tree_leaves.",
    "common/struct.py::field_names":
        "a one-line alias of dataclasses.fields with no caller in either "
        "package; the port's walkers (interop) also tell static fields apart.",
    "core/countmin.py::DONATION_SAFE": _DONATION,
    "core/gsketch.py::DONATION_SAFE": _DONATION,
    "core/kmatrix.py::DONATION_SAFE": _DONATION,
    "core/kmatrix_accel.py::DONATION_SAFE": _DONATION,
    "core/matrix_sketch.py::DONATION_SAFE": _DONATION,
    "serving/snapshot.py::donation_enabled":
        "reads the REPRO_DONATE switch of jax.jit buffer donation, which "
        "PyTorch lacks; the port's snapshots are guarded by the "
        "write-after-publish rule (analysis/isolation.py) and the witness.",
    "launch/stream_ingest.py::--no-donate":
        "turns off jax.jit buffer donation, which the port does not have "
        "(its query_serve keeps the flag only to refuse it).",
    "kernels/ref.py":
        "the pure-jnp oracles that judge the port: the parity tests import "
        "them from the reference, and ROADMAP section A keeps them unported.",
    "kernels/__init__.py::ref":
        "the package's handle on kernels/ref.py, the judge the port is held "
        "to and does not copy.",
    "launch/dryrun.py::parse_collectives":
        "parses XLA's compiled HLO text; the port's dry run counts "
        "collectives with torch's CommDebugMode and its counted groups.",
    "models/common.py::stacked_layer_init":
        "initialises layers by vmapping over split JAX PRNG keys; the port "
        "draws from a torch.Generator and takes JAX's weights through interop.",
    "models/gnn/gatedgcn.py::init_layer":
        "a JAX-keyed layer init under stacked_layer_init; the port's "
        "init_params draws from a torch.Generator and interop carries JAX's.",
    "models/gnn/equiformer_v2.py::init_layer":
        "a JAX-keyed layer init under stacked_layer_init; the port's "
        "init_params draws from a torch.Generator and interop carries JAX's.",
}


def _method_is_public(name: str) -> bool:
    """A public method, or a special one (``__iter__``, ``__call__``, ...)."""
    return not name.startswith("_") or (name.startswith("__")
                                        and name.endswith("__"))


def _target_names(target: ast.AST) -> list[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for t in target.elts for n in _target_names(t)]
    if isinstance(target, ast.Starred):
        return _target_names(target.value)
    return []  # attribute and subscript stores bind no module name


def _literal_strings(node: ast.AST, consts: dict) -> list[str]:
    """The strings a module-level ``__all__`` expression names: literals,
    ``*NAME`` and ``*sorted(NAME)`` of a module-level list or dict."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.List, ast.Tuple)):
        return [s for e in node.elts for s in _literal_strings(e, consts)]
    if isinstance(node, ast.Dict):
        return [s for k in node.keys if k is not None
                for s in _literal_strings(k, consts)]
    if isinstance(node, ast.Starred):
        return _literal_strings(node.value, consts)
    if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "sorted":
        return [s for a in node.args for s in _literal_strings(a, consts)]
    if isinstance(node, ast.Name) and node.id in consts:
        return _literal_strings(consts[node.id], consts)
    return []


def _flags(tree: ast.AST) -> set[str]:
    return {a.value for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", None) == "add_argument"
            for a in n.args if isinstance(a, ast.Constant)
            and isinstance(a.value, str) and a.value.startswith("--")}


def _all_names(body: list, consts: dict) -> set[str]:
    return {s for node in body if isinstance(node, (ast.Assign, ast.AnnAssign))
            and "__all__" in [n for t in (node.targets if isinstance(
                node, ast.Assign) else [node.target]) for n in _target_names(t)]
            and node.value is not None
            for s in _literal_strings(node.value, consts)}


def _consts(body: list) -> dict:
    return {n: node.value for node in body if isinstance(node, ast.Assign)
            for t in node.targets for n in _target_names(t)}


def _by_text(fn):
    """``fn(tree, path, **kw)`` computed once for each text ``path`` has
    held (the gate runs once per module over the same trees)."""
    @functools.lru_cache(maxsize=None)
    def cached(text: str, filename: str, **kw) -> frozenset:
        return frozenset(fn(ast.parse(text, filename=filename),
                            Path(filename), **kw))

    @functools.wraps(fn)
    def wrapper(path: Path, **kw) -> frozenset:
        return cached(path.read_text(), str(path), **kw)

    return wrapper


@_by_text
def reference_surface(tree: ast.Module, path: Path, *, launch: bool) -> set[str]:
    """The public surface of a reference module: its public top-level defs,
    classes and assigned names, each public class's public and special
    methods (``Class.method``), the names in ``__all__``, the names a
    package's ``__init__`` imports from ``repro.*`` and the names any module
    imports from ``repro.*`` under a new name, and (``launch``) its
    ``--flags``."""
    init = path.name == "__init__.py"
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and _method_is_public(m.name)}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out |= {n for t in targets for n in _target_names(t)
                    if not n.startswith("_")}
        elif (isinstance(node, ast.ImportFrom) and node.level == 0
              and node.module and node.module.split(".")[0] == "repro"):
            for alias in node.names:
                bound = alias.asname or alias.name
                renamed = alias.asname not in (None, alias.name)
                if not bound.startswith("_") and (init or renamed):
                    out.add(bound)
    out |= _all_names(tree.body, _consts(tree.body))
    if launch:
        out |= _flags(tree)
    return out


def _bound(body: list) -> set[str]:
    """Every name a block binds at its own level: defs, classes, assigned
    names and imports."""
    out = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {n for t in node.targets for n in _target_names(t)}
        elif isinstance(node, ast.AnnAssign):
            out |= set(_target_names(node.target))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


@_by_text
def port_bindings(tree: ast.Module, path: Path) -> set[str]:
    """Every name a port module binds: its top-level bindings, the names
    in ``__all__`` (lazy exports), every ``Class.member`` its classes bind,
    and its ``--flags``."""
    out = _bound(tree.body) | _all_names(tree.body, _consts(tree.body))
    out |= {f"{n.name}.{m}" for n in tree.body if isinstance(n, ast.ClassDef)
            for m in _bound(n.body)}
    return out | _flags(tree)


def reference_items(ref_root: Path, examples_root: Path) -> dict[str, list[str]]:
    """{module or example: its items, the module itself first} over the
    reference tree and its root examples."""
    items = {}
    for path in sorted(ref_root.rglob("*.py")):
        rel = path.relative_to(ref_root).as_posix()
        launch = rel.startswith("launch/")
        names = sorted(reference_surface(path, launch=launch))
        items[rel] = [rel, *(f"{rel}::{n}" for n in names)]
    for path in sorted(examples_root.glob("*.py")):
        rel = f"examples/{path.name}"
        items[rel] = [rel]
    return items


def surface_gaps(ref_root: Path, port_root: Path, examples_root: Path,
                 covered: dict, jax_only: dict, *, only: str | None = None
                 ) -> list[str]:
    """What the port lacks of the reference's surface, and every stale
    table entry; with ``only``, those of one reference module or example
    (a table entry belongs to the module its key names)."""
    items = reference_items(ref_root, examples_root)
    cache: dict[str, set | None] = {}

    def held(rel: str) -> set | None:
        """The port module's bindings, or None where there is no file."""
        if rel not in cache:
            path = port_root / rel
            cache[rel] = port_bindings(path) if path.is_file() else None
        return cache[rel]

    def port_has(key: str) -> bool:
        rel, _, name = key.partition("::")
        names = held(rel)
        return names is not None and (not name or name in names)

    problems = []
    for module, keys in items.items():
        if only is not None and module != only:
            continue
        if module in jax_only:
            continue  # the module and every name in it
        home = covered.get(module, module)  # the port module holding its names
        if not port_has(home):
            problems.append(f"missing module: {module}")
            continue
        for key in keys[1:]:
            if key in jax_only or key in covered:
                continue
            name = key.partition("::")[2]
            if not port_has(f"{home}::{name}"):
                problems.append(f"missing: {key} (no {name} in "
                                f"repro_torch/{home})")
    for table, entries in (("COVERED", covered), ("JAX_ONLY", jax_only)):
        for key in sorted(entries):
            module = key.partition("::")[0]
            if only is not None and module != only:
                continue
            if key not in items.get(module, ()):
                problems.append(f"stale {table}: {key} (the reference no "
                                "longer has it)")
                continue
            name = key.partition("::")[2]
            home = covered.get(module, module) if name else module
            own = f"{home}::{name}" if name else home
            if port_has(own):
                problems.append(f"stale {table}: {key} (the port now has "
                                f"repro_torch/{own})")
            if table == "COVERED" and not port_has(entries[key]):
                problems.append(f"stale COVERED: {key} -> {entries[key]} "
                                "(the target is gone)")
    return problems


MODULES = sorted(reference_items(REF, EXAMPLES))


@pytest.mark.parametrize("module", MODULES)
def test_port_holds_the_reference_surface(module):
    gaps = surface_gaps(REF, PORT, EXAMPLES, COVERED, JAX_ONLY, only=module)
    assert not gaps, "\n".join(gaps)


def test_every_table_entry_names_a_reference_module():
    """An entry whose module the reference lost is stale too (the cases
    above see only the reference's modules)."""
    stale = [k for k in (*COVERED, *JAX_ONLY)
             if k.partition("::")[0] not in MODULES]
    assert not stale
    assert not surface_gaps(REF, PORT, EXAMPLES, COVERED, JAX_ONLY)


def test_each_reason_is_one_sentence():
    for key, reason in JAX_ONLY.items():
        body = reason.rstrip(".")
        assert reason.endswith(".") and ". " not in body and body, key


def _write(root: Path, files: dict) -> Path:
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return root


def test_the_gate_catches_planted_gaps(tmp_path):
    """Two tiny trees: the gate passes the complete one and names a missing
    def, method, constant, re-export, flag, module and example, a stale
    COVERED entry (target gone, or the port now has the name) and a stale
    JAX_ONLY entry (the port has the name, or the reference lost it)."""
    ref = _write(tmp_path / "ref", {
        "pkg/__init__.py": "from repro.pkg.mod import kept, gone\n",
        "pkg/mod.py": ("LIMIT = 3\n_PRIVATE = 1\n"
                       "def kept(): pass\ndef gone(): pass\n"
                       "def renamed(): pass\ndef jaxy(): pass\n"
                       "class C:\n    def m(self): pass\n"
                       "    def __iter__(self): pass\n"
                       "    def _p(self): pass\n"),
        "pkg/alias.py": "from repro.pkg.mod import kept as also_kept\n",
        "launch/run.py": ("import argparse\n_ap = argparse.ArgumentParser()\n"
                          "_ap.add_argument('--fast')\n"
                          "_ap.add_argument('--jax-only')\n"),
        "extra.py": "X = 1\n",
    })
    examples = _write(tmp_path / "examples", {"demo.py": "", "other.py": ""})
    complete = {
        "pkg/__init__.py": "from repro_torch.pkg.mod import kept, gone\n",
        "pkg/mod.py": ("LIMIT = 3\ndef kept(): pass\ndef gone(): pass\n"
                       "def new_name(): pass\n"
                       "class C:\n    def __iter__(self): pass\n"
                       "    m = __iter__\n"),
        "pkg/alias.py": "from repro_torch.pkg.mod import kept as also_kept\n",
        "launch/run.py": ("def parser(ap):\n    ap.add_argument('--fast')\n"),
        "extra.py": "X = 1\n",
        "examples/demo.py": "",
        "examples/other.py": "",
    }
    port = _write(tmp_path / "port", complete)
    covered = {"pkg/mod.py::renamed": "pkg/mod.py::new_name"}
    jax_only = {"pkg/mod.py::jaxy": "a JAX-only def.",
                "launch/run.py::--jax-only": "a JAX-only flag."}

    def gaps(c=covered, j=jax_only):
        return surface_gaps(ref, port, examples, c, j)

    assert gaps() == []
    # names, a method, a protocol method, a constant, a re-export, a flag
    _write(port, {"pkg/mod.py": ("def kept(): pass\ndef new_name(): pass\n"
                                 "class C:\n    pass\n"),
                  "pkg/alias.py": "from repro_torch.pkg.mod import kept\n",
                  "launch/run.py": "",
                  "pkg/__init__.py": "from repro_torch.pkg.mod import kept\n"})
    found = gaps()
    for item in ("pkg/mod.py::gone", "pkg/mod.py::C.m", "pkg/mod.py::LIMIT",
                 "pkg/mod.py::C.__iter__", "pkg/alias.py::also_kept",
                 "launch/run.py::--fast", "pkg/__init__.py::gone"):
        assert any(f"missing: {item} " in p for p in found), (item, found)
    assert not any("_p " in p or "_PRIVATE" in p for p in found)
    # a module and an example
    _write(port, complete)
    (port / "extra.py").unlink()
    (port / "examples" / "other.py").unlink()
    assert sorted(gaps()) == ["missing module: examples/other.py",
                              "missing module: extra.py"]
    _write(port, complete)
    # stale COVERED: the target is gone; the port now has the name
    _write(port, {"pkg/mod.py": complete["pkg/mod.py"].replace(
        "def new_name", "def other_name")})
    assert gaps() == ["stale COVERED: pkg/mod.py::renamed -> "
                      "pkg/mod.py::new_name (the target is gone)"]
    _write(port, {"pkg/mod.py": complete["pkg/mod.py"]
                  + "def renamed(): pass\n"})
    assert gaps() == ["stale COVERED: pkg/mod.py::renamed (the port now "
                      "has repro_torch/pkg/mod.py::renamed)"]
    _write(port, complete)
    # stale JAX_ONLY: the port now has it; the reference no longer has it
    _write(port, {"pkg/mod.py": complete["pkg/mod.py"] + "def jaxy(): pass\n"})
    assert gaps() == ["stale JAX_ONLY: pkg/mod.py::jaxy (the port now has "
                      "repro_torch/pkg/mod.py::jaxy)"]
    _write(port, complete)
    lost = {**jax_only, "pkg/mod.py::lost": "a def the reference dropped."}
    assert gaps(j=lost) == ["stale JAX_ONLY: pkg/mod.py::lost (the reference "
                            "no longer has it)"]
    assert surface_gaps(ref, port, examples, covered, lost,
                        only="pkg/mod.py") == gaps(j=lost)
    assert surface_gaps(ref, port, examples, covered, lost,
                        only="extra.py") == []
