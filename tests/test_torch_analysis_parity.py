"""The port's analysis against the JAX package's: the four rules both
packages share give the same findings on the same fixtures (module names
mapped ``repro.`` <-> ``repro_torch.``), both run clean over the port's
tree, the port's modules carry the reference's markers, and the two wire
locks pin one schema."""
from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

import test_analysis as ref_fixtures
from repro import analysis as ref_analysis
from repro.analysis import pickle_rules as ref_pickle
from repro.analysis import wire_schema as ref_wire
from repro_torch import analysis as port_analysis
from repro_torch.analysis import wire_schema as port_wire

REPO = Path(__file__).resolve().parents[1]
SHARED_RULES = ("wire-schema", "unpickler-allowlist", "no-pickle-hot-path",
                "lock-discipline")
_PORT_NAME = re.compile(r"\brepro_torch\b")


def to_reference_names(text: str) -> str:
    return _PORT_NAME.sub("repro", text)


def port_module(module: str) -> str:
    return "repro_torch" + module[len("repro"):]


def port_fixture(sources: dict, aux: dict) -> tuple[dict, dict]:
    """The port's twin of a reference fixture: module names and the lock's
    path renamed, and the wire module's allowlist mapped to port modules
    through ``_PORT_MODULES`` (keys stay the reference's names)."""
    out = {}
    for mod, text in sources.items():
        if mod == ref_wire.WIRE_MODULE:
            allow = ref_pickle.extract_allowlist(ast.parse(text))
            if allow is not None:
                text += "\n_PORT_MODULES = {\n" + "".join(
                    f"    {k!r}: {port_module(k)!r},\n"
                    for k in sorted(allow)) + "}\n"
        out[port_module(mod)] = text
    port_aux = {path.replace("repro/", "repro_torch/", 1): text
                for path, text in aux.items()}
    return out, port_aux


def findings_pair(rule: str, sources: dict, aux: dict | None = None):
    aux = aux or {}
    ref = ref_analysis.run_rules(
        ref_analysis.Project.from_sources(sources, aux), only=[rule])
    psrc, paux = port_fixture(sources, aux)
    port = port_analysis.run_rules(
        port_analysis.Project.from_sources(psrc, paux), only=[rule])
    as_tuples = [(f.rule, f.module, f.line, f.message) for f in ref]
    mapped = [(f.rule, to_reference_names(f.module), f.line,
               to_reference_names(f.message)) for f in port]
    return as_tuples, mapped


# ----------------------------------------------------------- the fixtures
WIRE = ref_fixtures.WIRE_FIXTURE
WIRE_MOD = "repro.net.wire"
LOCK = ref_wire.LOCK_AUX_PATH


def _lock(src: str) -> dict:
    return {LOCK: ref_fixtures.lock_for(src)}


_REQUIRES = '''
import threading

class Q:
    def __init__(self):
        self._cv = threading.Condition()
        self._items = []  # guarded-by: _cv

    def _depth(self):  # requires-lock: _cv
        return len(self._items)

    def ok(self):
        with self._cv:
            return self._depth()

    def bad(self):
        return self._depth()
'''
_CLOSURE = '''
import threading

class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0  # guarded-by: _lock

    def deferred(self):
        with self._lock:
            def cb():
                return self._n
            return cb
'''
_CYCLE = '''
import threading

class A:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()

    def helper(self):
        with self._a_lock:
            pass

    def fwd(self):
        with self._a_lock:
            with self._b_lock:
                pass

    def rev(self):
        with self._b_lock:
            self.helper()

    def rev2(self):
        with self._b_lock:
            with self._a_lock:
                pass
'''
_SELF = '''
import threading

class A:
    def __init__(self):
        self._lock = threading.Lock()

    def inner(self):
        with self._lock:
            pass

    def outer(self):
        with self._lock:
            self.inner()
'''
_HOT_MODULE = ('"""Queue.\n\n# analysis: hot-path\n"""\n'
               "import pickle\n\n"
               "def put(x):\n    return pickle.dumps(x)\n")
_HOT_FUNC = ("import pickle\n\n"
             "def encode(x):  # hot-path\n"
             "    return pickle.dumps(x)\n\n"
             "def debug_dump(x):\n"
             "    return pickle.dumps(x)\n")

CASES = {
    # wire-schema
    "wire-clean": ("wire-schema", {WIRE_MOD: WIRE}, _lock(WIRE)),
    "wire-no-lock": ("wire-schema", {WIRE_MOD: WIRE}, {}),
    "wire-frame-added": ("wire-schema", {WIRE_MOD: WIRE.replace(
        '"stop": 8}', '"stop": 8, "gossip": 9}').replace(
        'if kind == "stop":', 'if kind in ("stop", "gossip"):')},
        _lock(WIRE)),
    "wire-bump-no-regen": ("wire-schema", {WIRE_MOD: WIRE.replace(
        "WIRE_VERSION = 3", "WIRE_VERSION = 4")}, _lock(WIRE)),
    "wire-struct": ("wire-schema", {WIRE_MOD: WIRE.replace(
        '">4sHHI"', '">4sHHQ"')}, _lock(WIRE)),
    "wire-dup-id": ("wire-schema", {WIRE_MOD: WIRE.replace(
        '"item": 3', '"item": 1')}, {}),
    "wire-double": ("wire-schema", {WIRE_MOD: WIRE.replace(
        "    if kind == \"stop\":\n        return 3\n",
        "    if kind == \"stop\":\n        return 3\n"
        "    if kind == \"stop\":\n        return 4\n")}, {}),
    "wire-unregistered": ("wire-schema", {WIRE_MOD: WIRE.replace(
        'if kind == "stop":', 'if kind == "halt":')}, {}),
    "wire-no-version": ("wire-schema", {WIRE_MOD: WIRE.replace(
        "WIRE_VERSION = 3\n", "")}, {}),
    # unpickler-allowlist
    "allow-clean": ("unpickler-allowlist",
                    {WIRE_MOD: ref_fixtures.ALLOW_WIRE,
                     "repro.api": ref_fixtures.ALLOW_TYPES}, {}),
    "allow-dead": ("unpickler-allowlist",
                   {WIRE_MOD: ref_fixtures.ALLOW_WIRE,
                    "repro.api": "class Other:  # wire-type\n    pass\n"}, {}),
    "allow-no-module": ("unpickler-allowlist",
                        {WIRE_MOD: ref_fixtures.ALLOW_WIRE}, {}),
    "allow-unmarked": ("unpickler-allowlist",
                       {WIRE_MOD: ref_fixtures.ALLOW_WIRE,
                        "repro.api": "class Spec:\n    pass\n"}, {}),
    "allow-missing": ("unpickler-allowlist", {WIRE_MOD: "x = 1\n"}, {}),
    # no-pickle-hot-path
    "hot-module": ("no-pickle-hot-path",
                   {"repro.runtime.queueing": _HOT_MODULE}, {}),
    "hot-func": ("no-pickle-hot-path", {WIRE_MOD: _HOT_FUNC}, {}),
    "hot-clean": ("no-pickle-hot-path", {"repro.runtime.queueing": (
        '"""Queue.\n\n# analysis: hot-path\n"""\n'
        "def put(x):\n    return x\n")}, {}),
    # lock-discipline
    "guard-clean": ("lock-discipline",
                    {"repro.box": ref_fixtures.GUARDED_CLEAN}, {}),
    "guard-dirty": ("lock-discipline",
                    {"repro.box": ref_fixtures.GUARDED_DIRTY}, {}),
    "guard-writes-only": ("lock-discipline", {"repro.box": (
        ref_fixtures.GUARDED_CLEAN.replace(
            "    def peek(self):\n        return self._front\n",
            "    def peek(self):\n        return self._front\n\n"
            "    def clobber(self):\n        self._front = None\n"))}, {}),
    "requires-lock": ("lock-discipline", {"repro.q": _REQUIRES}, {}),
    "closure": ("lock-discipline", {"repro.box": _CLOSURE}, {}),
    "cycles": ("lock-discipline", {"repro.ab": _CYCLE}, {}),
    "self-reacquire": ("lock-discipline", {"repro.a": _SELF}, {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_shared_rule_findings_equal_the_reference(name):
    rule, sources, aux = CASES[name]
    ref, port = findings_pair(rule, sources, aux)
    assert port == ref
    clean = name.endswith("clean")
    assert (ref == []) == clean, ref  # each fixture triggers or is clean


# ---------------------------------------------------------- whole tree
def _port_sources() -> tuple[dict, str]:
    project = port_analysis.Project.from_root(str(REPO))
    return ({mod: sf.text for mod, sf in project.files.items()},
            project.aux[port_wire.LOCK_AUX_PATH])


def test_reference_rules_over_the_renamed_port_tree_are_clean():
    sources, lock = _port_sources()
    renamed = {to_reference_names(mod): to_reference_names(text)
               for mod, text in sources.items()}
    project = ref_analysis.Project.from_sources(renamed, {ref_wire.LOCK_AUX_PATH:
                                                          lock})
    assert len(project.files) == len(sources) > 90
    assert ref_analysis.run_rules(project) == []


def test_port_rules_over_the_port_tree_are_clean():
    project = port_analysis.Project.from_root(str(REPO))
    assert port_analysis.run_rules(project) == []
    for rule in SHARED_RULES:
        assert port_analysis.run_rules(project, only=[rule]) == []


def test_reference_allowlist_rule_under_port_names_would_misfire():
    """Why the port keeps its own allowlist rule: the port's unpickler keys
    its allowlist by the reference's module names, so the reference's rule
    over the port's tree under the port's own names finds every entry
    dead, and the port's rule (through ``_PORT_MODULES``) none."""
    sources, lock = _port_sources()
    as_is = {mod.replace("repro_torch.", "repro.", 1)
             if mod == port_wire.WIRE_MODULE else mod: text
             for mod, text in sources.items()}
    got = ref_analysis.run_rules(ref_analysis.Project.from_sources(as_is),
                                 only=["unpickler-allowlist"])
    dead = [f for f in got if "is dead: module" in f.message]
    assert len(dead) == 3


# -------------------------------------------------------- marker parity
_MARKERS = re.compile(
    r"#\s*(?P<kind>guarded-by\(writes\)|guarded-by|requires-lock)"
    r":\s*(?P<lock>\w+)|#\s*(?P<flag>wire-type|hot-path)\b")


def _markers(path: Path) -> set[tuple]:
    """Every marker of a module, keyed by what it sits on."""
    text = path.read_text()
    lines = text.splitlines()
    tree = ast.parse(text)
    out: set[tuple] = set()

    def on(lineno: int):
        line = lines[lineno - 1] if 0 < lineno <= len(lines) else ""
        for m in _MARKERS.finditer(line):
            if m.group("kind"):
                yield (m.group("kind"), m.group("lock"))
            elif m.group("flag") and "analysis: hot-path" not in line:
                yield (m.group("flag"),)

    if any("# analysis: hot-path" in line for line in lines[:40]):
        out.add(("module", "analysis: hot-path"))
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for mk in on(node.lineno):
                out.add(("class", node.name, *mk))
            for sub in node.body:
                fields = []
                if isinstance(sub, ast.AnnAssign) and \
                        isinstance(sub.target, ast.Name):
                    fields.append((sub.target.id, sub.lineno))
                elif isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    for mk in (*on(sub.lineno), *on(sub.lineno - 1)):
                        out.add(("def", f"{node.name}.{sub.name}", *mk))
                    for st in ast.walk(sub):
                        targets = st.targets if isinstance(st, ast.Assign) \
                            else [st.target] if isinstance(st, ast.AnnAssign) \
                            else []
                        fields += [(t.attr, st.lineno) for t in targets
                                   if isinstance(t, ast.Attribute)
                                   and isinstance(t.value, ast.Name)
                                   and t.value.id == "self"]
                for field, lineno in fields:
                    for mk in on(lineno):
                        out.add(("field", node.name, field, *mk))
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for mk in on(node.lineno):
                out.add(("def", node.name, *mk))
    return out


_REF = REPO / "src" / "repro"
_MARKED = sorted(
    p.relative_to(_REF).as_posix() for p in _REF.rglob("*.py")
    if "analysis" not in p.parts and _markers(p))


def test_reference_markers_are_where_the_port_expects_them():
    assert _MARKED == ["net/backend.py", "net/query_server.py", "net/wire.py",
                       "runtime/backend.py", "runtime/metrics.py",
                       "runtime/queueing.py", "runtime/worker.py",
                       "serving/engine.py", "serving/registry.py",
                       "serving/snapshot.py"]


@pytest.mark.parametrize("rel", _MARKED)
def test_port_twin_carries_every_reference_marker(rel):
    ref = _markers(_REF / rel)
    port = _markers(REPO / "src" / "repro_torch" / rel)
    assert ref, rel
    assert ref <= port, sorted(ref - port)


def test_donates_markers_have_no_port_counterpart():
    """``# donates: N`` marks the JAX package's donated buffers; the port
    has one in-place ingest into a private delta instead, marked
    ``# writes: 0`` for the write-after-publish rule."""
    ref = [p for p in _REF.rglob("*.py") if "analysis" not in p.parts
           and re.search(r"#\s*donates:", p.read_text())]
    port = [p for p in (REPO / "src" / "repro_torch").rglob("*.py")
            if "analysis" not in p.parts
            and re.search(r"#\s*donates:", p.read_text())]
    assert ref and port == []
    snapshot = (REPO / "src/repro_torch/serving/snapshot.py").read_text()
    assert "self._mod.ingest(self._delta, batch)  # writes: 0" in snapshot


def test_hot_path_marker_on_the_port_worker():
    assert ("module", "analysis: hot-path") in _markers(
        REPO / "src/repro_torch/runtime/worker.py")


# ------------------------------------------------------------ wire locks
def test_the_two_wire_locks_pin_one_schema():
    ref = ref_wire.parse_lock(
        (REPO / "src/repro/net/wire_schema.lock").read_text())
    port = port_wire.parse_lock(
        (REPO / "src/repro_torch/net/wire_schema.lock").read_text())
    assert port == ref and ref[0] == 3 and ref[1]
    # and both equal the live schemas' fingerprints
    live = port_analysis.Project.from_root(str(REPO)).get(
        port_wire.WIRE_MODULE)
    assert port_wire.fingerprint(port_wire.extract_schema(live.tree)) == ref[1]
