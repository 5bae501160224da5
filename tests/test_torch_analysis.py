"""repro_torch.analysis: trigger + clean fixtures per rule on the port's
engine and under the port's module names, the recompute-purity and
write-after-publish rules that replace the JAX package's trace-purity
roots and use-after-donate, and the gate over the shipped port tree.

Every fixture runs through :meth:`Project.from_sources`, the code path the
gate takes over the real tree (``from_root`` only differs in where the
text comes from).
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import Project, run_rules
from repro_torch.analysis import (isolation, locks, pickle_rules,
                                  trace_purity, wire_schema)
from repro_torch.analysis.engine import (BASELINE_NAME, Finding, all_rules,
                                         split_by_baseline)

REPO = Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}


def msgs(findings, rule=None):
    return [f.message for f in findings if rule is None or f.rule == rule]


# ============================================ trace-purity (recompute) rule
CLEAN_CHECKPOINT = '''
import torch
from torch.utils.checkpoint import checkpoint

def _layer(x, w):
    return torch.tanh(x @ w)

def forward(x, w):
    return checkpoint(_layer, x, w, use_reentrant=False)
'''

DIRTY_CHECKPOINT = '''
import threading
import time

import torch
from torch.utils.checkpoint import checkpoint

_CACHE = {}
_lock = threading.Lock()

def _inner(x):
    _CACHE["t"] = time.monotonic()
    return x

def _layer(x):
    with _lock:
        pass
    return _inner(x)

def forward(x):
    return checkpoint(_layer, x, use_reentrant=False)
'''

DIRTY_FUNCTION = '''
import random

import numpy as np
import torch

class _Op(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * random.random()

    @staticmethod
    def backward(ctx, g):
        return g * np.random.rand()
'''


def test_trace_purity_clean():
    p = Project.from_sources({"repro_torch.models.m": CLEAN_CHECKPOINT})
    assert trace_purity.check(p) == []


def test_trace_purity_flags_clock_lock_and_global():
    p = Project.from_sources({"repro_torch.models.m": DIRTY_CHECKPOINT})
    got = msgs(trace_purity.check(p))
    assert any("acquires lock `_lock`" in m for m in got)
    # _inner is reached THROUGH the checkpointed root, not passed directly
    assert any("time.monotonic" in m and "'_inner'" in m for m in got)
    assert any("mutates module-level `_CACHE`" in m for m in got)
    assert all("checkpoint at line" in m for m in got)


def test_trace_purity_roots_autograd_function_forward_and_backward():
    p = Project.from_sources({"repro_torch.kernels.k": DIRTY_FUNCTION})
    got = msgs(trace_purity.check(p))
    assert any("'_Op.forward'" in m and "random.random" in m for m in got)
    assert any("'_Op.backward'" in m and "numpy.random.rand" in m
               for m in got)
    assert all("autograd.Function _Op" in m for m in got)
    # the same class without the Function base has no roots
    plain = DIRTY_FUNCTION.replace("(torch.autograd.Function)", "")
    assert trace_purity.check(Project.from_sources(
        {"repro_torch.kernels.k": plain})) == []


def test_trace_purity_flags_hub_touch():
    src = '''
import torch
from repro_torch.obs.hub import get_hub

class _Op(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        get_hub()
        return x
'''
    p = Project.from_sources({"repro_torch.kernels.k": src})
    assert any("metrics hub" in m for m in msgs(trace_purity.check(p)))


@pytest.mark.parametrize("call", [
    "checkpoint(kernel, x)",
    "torch.utils.checkpoint.checkpoint(kernel, x)",
    "checkpoint(functools.partial(kernel), x)",
    "checkpoint(lambda y: time.time(), x)",
])
def test_trace_purity_follows_checkpoint_call_site(call):
    src = f'''
import functools
import time

import torch
from torch.utils.checkpoint import checkpoint

def kernel(x):
    return time.time()

def run(x):
    return {call}
'''
    p = Project.from_sources({"repro_torch.kernels": src})
    assert any("time.time" in m for m in msgs(trace_purity.check(p)))


def test_trace_purity_follows_local_binding_and_nested_def():
    src = '''
import functools
import time
from torch.utils.checkpoint import checkpoint

def _a(x):
    return time.time()

def _b(x):
    return x

def run(x, flag):
    fn = _b if flag else functools.partial(_a)
    def local(y):
        return time.perf_counter()
    return checkpoint(fn, x) + checkpoint(local, x)
'''
    got = msgs(trace_purity.check(Project.from_sources(
        {"repro_torch.models.m": src})))
    assert any("'_a'" in m and "time.time" in m for m in got)
    assert any("'local'" in m and "time.perf_counter" in m for m in got)


def test_trace_purity_recompute_ok_marker_stops_the_search():
    src = '''
import threading
import torch

_LOCK = threading.Lock()

# recompute-ok: counts a launch, and a recomputed launch is one
def count(w):
    with _LOCK:
        w.n += 1

def uncounted(w):
    with _LOCK:
        w.n += 1

class _Op(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        count(x)
        uncounted(x)
        return x
'''
    got = msgs(trace_purity.check(Project.from_sources(
        {"repro_torch.kernels.k": src})))
    assert len(got) == 1 and "'uncounted'" in got[0]


# ====================================================== wire-schema rule
WIRE = "repro_torch.net.wire"
WIRE_FIXTURE = '''
import struct

MAGIC = b"KMTX"
WIRE_VERSION = 3
COMPAT_VERSIONS = frozenset({2, WIRE_VERSION})
FRAME_TYPES = {"hello": 1, "item": 3, "stop": 8}
_HEADER = struct.Struct(">4sHHI")

def dispatch(msg):
    kind = msg[0]
    if kind == "hello":
        return 1
    if kind == "item":
        return 2
    if kind == "stop":
        return 3
'''


def lock_for(src: str) -> str:
    schema = wire_schema.extract_schema(
        Project.from_sources({WIRE: src}).get(WIRE).tree)
    return wire_schema.render_lock(schema)


def test_wire_schema_clean_with_matching_lock():
    p = Project.from_sources(
        {WIRE: WIRE_FIXTURE},
        aux={wire_schema.LOCK_AUX_PATH: lock_for(WIRE_FIXTURE)})
    assert wire_schema.check(p) == []


def test_wire_frame_added_without_version_bump_is_rejected():
    edited = WIRE_FIXTURE.replace(
        '"stop": 8}', '"stop": 8, "gossip": 9}').replace(
        'if kind == "stop":', 'if kind in ("stop", "gossip"):')
    p = Project.from_sources(
        {WIRE: edited},
        aux={wire_schema.LOCK_AUX_PATH: lock_for(WIRE_FIXTURE)})
    got = msgs(wire_schema.check(p))
    assert any("changed without a WIRE_VERSION bump" in m for m in got)


def test_wire_bump_without_lock_regen_is_rejected():
    edited = WIRE_FIXTURE.replace("WIRE_VERSION = 3", "WIRE_VERSION = 4")
    p = Project.from_sources(
        {WIRE: edited},
        aux={wire_schema.LOCK_AUX_PATH: lock_for(WIRE_FIXTURE)})
    got = msgs(wire_schema.check(p))
    assert any("records version 3" in m and "regenerate" in m for m in got)


def test_wire_struct_layout_change_is_rejected():
    edited = WIRE_FIXTURE.replace('">4sHHI"', '">4sHHQ"')
    p = Project.from_sources(
        {WIRE: edited},
        aux={wire_schema.LOCK_AUX_PATH: lock_for(WIRE_FIXTURE)})
    assert any("changed without a WIRE_VERSION bump" in m
               for m in msgs(wire_schema.check(p)))


def test_wire_missing_lock_names_the_port_command():
    got = msgs(wire_schema.check(Project.from_sources({WIRE: WIRE_FIXTURE})))
    assert any("python -m repro_torch.analysis --write-wire-lock" in m
               for m in got)


def test_wire_duplicate_ids_and_double_handling():
    dup = WIRE_FIXTURE.replace('"item": 3', '"item": 1')
    double = WIRE_FIXTURE.replace(
        "    if kind == \"stop\":\n        return 3\n",
        "    if kind == \"stop\":\n        return 3\n"
        "    if kind == \"stop\":\n        return 4\n")
    p = Project.from_sources({WIRE: dup})
    assert any("frame id 1 reused" in m for m in msgs(wire_schema.check(p)))
    p = Project.from_sources({WIRE: double})
    assert any("handles frame kind 'stop' 2 times" in m
               for m in msgs(wire_schema.check(p)))


def test_wire_unregistered_kind_in_dispatcher():
    edited = WIRE_FIXTURE.replace('if kind == "stop":',
                                  'if kind == "halt":')
    p = Project.from_sources({WIRE: edited})
    got = msgs(wire_schema.check(p))
    assert any("unregistered frame kind 'halt'" in m for m in got)


def test_committed_lock_matches_live_tree():
    project = Project.from_root(str(REPO))
    assert wire_schema.LOCK_AUX_PATH in project.aux
    assert msgs(wire_schema.check(project)) == []


# ============================================== unpickler-allowlist rule
ALLOW_WIRE = '''
_SAFE_REPRO_CLASSES = {
    "repro.api": frozenset({"Spec"}),
}
_PORT_MODULES = {
    "repro.api": "repro_torch.api",
}
'''

ALLOW_TYPES = '''
class Spec:  # wire-type
    pass
'''


def test_allowlist_clean():
    p = Project.from_sources({WIRE: ALLOW_WIRE,
                              "repro_torch.api": ALLOW_TYPES})
    assert pickle_rules.check_unpickler(p) == []


def test_allowlist_dead_entry_flagged():
    p = Project.from_sources({
        WIRE: ALLOW_WIRE,
        "repro_torch.api": "class Other:  # wire-type\n    pass\n"})
    got = msgs(pickle_rules.check_unpickler(p))
    assert any("repro.api.Spec is dead" in m and "gadget" in m for m in got)
    assert any("'Other' is marked" in m and "missing" in m for m in got)


def test_allowlist_unmarked_class_flagged():
    p = Project.from_sources({WIRE: ALLOW_WIRE,
                              "repro_torch.api": "class Spec:\n    pass\n"})
    assert any("not marked" in m
               for m in msgs(pickle_rules.check_unpickler(p)))


def test_allowlist_missing_dict_flagged():
    p = Project.from_sources({WIRE: "x = 1\n"})
    assert any("not found" in m
               for m in msgs(pickle_rules.check_unpickler(p)))


def test_allowlist_missing_port_map_flagged():
    wire = ALLOW_WIRE.split("_PORT_MODULES")[0]
    p = Project.from_sources({WIRE: wire, "repro_torch.api": ALLOW_TYPES})
    got = msgs(pickle_rules.check_unpickler(p))
    assert any("_PORT_MODULES dict literal not found" in m for m in got)
    assert any("'repro.api' has no _PORT_MODULES entry" in m for m in got)
    # the marked class is then reachable through no mapping
    assert any("'Spec' is marked" in m and "missing" in m for m in got)


def test_allowlist_and_port_map_must_agree_both_ways():
    extra_map = ALLOW_WIRE.replace(
        '"repro.api": "repro_torch.api",',
        '"repro.api": "repro_torch.api",\n'
        '    "repro.gone": "repro_torch.gone",')
    got = msgs(pickle_rules.check_unpickler(Project.from_sources(
        {WIRE: extra_map, "repro_torch.api": ALLOW_TYPES})))
    assert got == ["_PORT_MODULES entry 'repro.gone' -> 'repro_torch.gone' "
                   "has no _SAFE_REPRO_CLASSES entry (dead mapping)"]
    extra_key = ALLOW_WIRE.replace(
        '"repro.api": frozenset({"Spec"}),',
        '"repro.api": frozenset({"Spec"}),\n'
        '    "repro.other": frozenset({"Spec"}),')
    got = msgs(pickle_rules.check_unpickler(Project.from_sources(
        {WIRE: extra_key, "repro_torch.api": ALLOW_TYPES})))
    assert got == ["allowlist module 'repro.other' has no _PORT_MODULES "
                   "entry: its classes cannot resolve to a port class"]


def test_allowlist_entry_must_resolve_to_the_mapped_port_module():
    # the class exists, marked, but in another port module than the map
    # names: the entry is dead and the marked class unreachable
    moved = ALLOW_WIRE.replace('"repro_torch.api"', '"repro_torch.elsewhere"')
    got = msgs(pickle_rules.check_unpickler(Project.from_sources(
        {WIRE: moved, "repro_torch.api": ALLOW_TYPES,
         "repro_torch.elsewhere": "x = 1\n"})))
    assert any("repro.api.Spec is dead: no such class in "
               "repro_torch.elsewhere" in m for m in got)
    assert any("'Spec' is marked" in m for m in got)


def test_real_unpickler_rejects_unlisted_repro_class():
    import pickle as _pickle

    from repro_torch.net import wire
    from repro_torch.runtime.queueing import QueueItem

    payload = _pickle.dumps(QueueItem(0, b"", b"", b"", 0))
    with pytest.raises(_pickle.UnpicklingError, match="not allowed"):
        wire.restricted_loads(payload)


def test_real_unpickler_accepts_wire_types():
    from repro_torch.net import wire
    from repro_torch.serving.engine import Request

    req = Request("edge_freq", src=1, dst=2)
    frame = wire.encode_message(("query", [req]))
    assert wire.decode_message(frame)[1] == [req]


# ================================================= no-pickle-on-hot-path
def test_hot_module_pickle_flagged():
    src = ('"""Queue.\n\n# analysis: hot-path\n"""\n'
           "import pickle\n\n"
           "def put(x):\n    return pickle.dumps(x)\n")
    p = Project.from_sources({"repro_torch.runtime.queueing": src})
    got = msgs(pickle_rules.check_hot_path(p))
    assert any("imports pickle" in m for m in got)
    assert any("references `pickle.dumps`" in m for m in got)


def test_hot_function_pickle_flagged_others_free():
    src = ("import pickle\n\n"
           "def encode(x):  # hot-path\n"
           "    return pickle.dumps(x)\n\n"
           "def debug_dump(x):\n"
           "    return pickle.dumps(x)\n")
    p = Project.from_sources({WIRE: src})
    got = msgs(pickle_rules.check_hot_path(p))
    assert got == ["hot-path function 'encode' references `pickle.dumps`"]


def test_hot_module_clean():
    src = ('"""Queue.\n\n# analysis: hot-path\n"""\n'
           "def put(x):\n    return x\n")
    p = Project.from_sources({"repro_torch.runtime.queueing": src})
    assert pickle_rules.check_hot_path(p) == []


def test_port_worker_is_a_hot_path_module():
    project = Project.from_root(str(REPO))
    sf = project.get("repro_torch.runtime.worker")
    assert any(pickle_rules.HOT_MODULE_MARKER in line
               for line in sf.lines[:40])
    # a pickle in the per-batch loop would now be a finding
    broken = Project.from_sources({sf.module: sf.text + (
        "\n\ndef _spill(x):\n    import pickle\n    return pickle.dumps(x)\n")})
    assert any("hot-path module imports pickle" in m
               for m in msgs(pickle_rules.check_hot_path(broken)))


# ================================================== lock-discipline rule
GUARDED_CLEAN = '''
import threading

class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0  # guarded-by: _lock
        self._front = None  # guarded-by(writes): _lock

    def bump(self):
        with self._lock:
            self._n += 1
            self._front = self._n

    def peek(self):
        return self._front
'''

GUARDED_DIRTY = '''
import threading

class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0  # guarded-by: _lock

    def bump(self):
        self._n += 1

    def read(self):
        return self._n
'''


def test_guarded_by_clean():
    p = Project.from_sources({"repro_torch.box": GUARDED_CLEAN})
    assert locks.check(p) == []


def test_guarded_by_violations():
    p = Project.from_sources({"repro_torch.box": GUARDED_DIRTY})
    got = msgs(locks.check(p))
    assert any("Box.bump writes `self._n`" in m for m in got)
    assert any("Box.read reads `self._n`" in m for m in got)


def test_writes_only_guard_allows_bare_reads():
    src = GUARDED_CLEAN.replace(
        "    def peek(self):\n        return self._front\n",
        "    def peek(self):\n        return self._front\n\n"
        "    def clobber(self):\n        self._front = None\n")
    p = Project.from_sources({"repro_torch.box": src})
    got = msgs(locks.check(p))
    assert got == ["Box.clobber writes `self._front` (guarded-by(writes): "
                   "_lock) without holding `self._lock`"]


def test_requires_lock_helper():
    src = '''
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
    p = Project.from_sources({"repro_torch.q": src})
    got = msgs(locks.check(p))
    assert got == ["Q.bad uses `self._depth` (requires-lock: _cv) "
                   "without holding `self._cv`"]


def test_closure_is_not_treated_as_locked():
    src = '''
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
    p = Project.from_sources({"repro_torch.box": src})
    assert any("reads `self._n`" in m for m in msgs(locks.check(p)))


CYCLE_DIRECT = '''
import threading

class A:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()

    def fwd(self):
        with self._a_lock:
            with self._b_lock:
                pass

    def rev(self):
        with self._b_lock:
            with self._a_lock:
                pass
'''

CYCLE_THROUGH_CALL = '''
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
'''


@pytest.mark.parametrize("src", [CYCLE_DIRECT, CYCLE_THROUGH_CALL],
                         ids=["direct", "through-call"])
def test_static_lock_order_cycle(src):
    p = Project.from_sources({"repro_torch.ab": src})
    got = msgs(locks.check(p))
    assert any("lock-order cycle" in m and "repro_torch.ab.A._a_lock" in m
               for m in got)


def test_static_self_reacquisition():
    src = '''
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
    p = Project.from_sources({"repro_torch.a": src})
    assert any("nested reacquisition" in m for m in msgs(locks.check(p)))


def test_acyclic_order_is_clean():
    src = CYCLE_DIRECT.replace(
        "    def rev(self):\n        with self._b_lock:\n"
        "            with self._a_lock:\n                pass\n",
        "    def two(self):\n        with self._a_lock:\n            pass\n")
    p = Project.from_sources({"repro_torch.ab": src})
    assert locks.check(p) == []


# ============================================== write-after-publish rule
PUBLISH_CLEAN = '''
import torch
from repro_torch.core import kmatrix
from repro_torch.kernels.matrix_ingest import matrix_ingest

class Buffer:
    def ingest(self, batch):
        with self._lock:
            self._mod.ingest(self._delta, batch)  # writes: 0
            self._pending += 1

    def publish(self):
        with self._lock:
            merged = self._mod.merge(self._front.sketch, self._delta)
            torch.add(self._front.sketch.pool, 1, out=self._scratch)
            self._delta = self._mod.empty_like(self._delta)

def replay(tenant, stream):
    sk = kmatrix.empty_like(tenant.snapshot.sketch)
    for batch in stream:
        kmatrix.ingest(sk, batch)
    matrix_ingest(sk.pools[0], 0, 0, 0)
    return sk
'''


def test_write_after_publish_clean():
    p = Project.from_sources({"repro_torch.serving.s": PUBLISH_CLEAN})
    assert isolation.check(p) == []


@pytest.mark.parametrize("stmt,how", [
    ("self._front.sketch.pools[0].add_(1)", "`.add_()`"),
    ("self._front.sketch.conn.zero_()", "`.zero_()`"),
    ("torch.add(x, 1, out=self._front.sketch.pool)", "`out=`"),
    ("self._front.sketch.pool[0, 0] = 5", "a subscript store"),
    ("self._front.sketch.pool[0] += 1", "a subscript store"),
    ("self._mod.ingest(self._front.sketch, b)  # writes: 0",
     "`self._mod.ingest` (writes: 0)"),
])
def test_write_after_publish_flags_writes_into_self_front(stmt, how):
    src = f'''
import torch

class Buffer:
    def bad(self, x, b):
        {stmt}
'''
    got = msgs(isolation.check(Project.from_sources(
        {"repro_torch.serving.s": src})))
    assert len(got) == 1 and how in got[0] and "'Buffer.bad'" in got[0]


@pytest.mark.parametrize("body", [
    # a marked wrapper, resolved through a from-import
    "snap = buf.publish()\n    matrix_ingest(snap.sketch.pools[0], hi, hj, wt)",
    # a marked sketch module's ingest through the module's import alias
    "kmatrix.ingest(tenant.snapshot.sketch, batch)",
    # a name bound to the sketch of a published snapshot
    "sk = tenant.snapshot.sketch\n    sk.pools[0].index_put_(idx, v, accumulate=True)",
    # an alias chain, bound out of order
    "front = held\n    held = tenant.snapshot\n    front.sketch.overflow.add_(1)",
])
def test_write_after_publish_follows_snapshots_and_marked_wrappers(body):
    kernels = ("def matrix_ingest(pool, hi, hj, wt):  # writes: 0\n"
               "    pool.add_(1)\n")
    core = "def ingest(sk, batch):  # writes: 0\n    return sk\n"
    src = f'''
from repro_torch.core import kmatrix
from repro_torch.kernels.matrix_ingest import matrix_ingest

def bad(buf, tenant, batch, held, hi, hj, wt, idx, v):
    {body}
'''
    got = msgs(isolation.check(Project.from_sources({
        "repro_torch.kernels.matrix_ingest": kernels,
        "repro_torch.core.kmatrix": core,
        "repro_torch.launch.x": src})))
    assert len(got) == 1 and "reads a published front" in got[0]


def test_write_after_publish_snapshot_parameter_is_a_front():
    src = '''
from repro_torch.serving.snapshot import Snapshot

def bad(s: Snapshot, t):
    s.sketch.table.copy_(t)

def fine(s, t):
    s.sketch.table.copy_(t)
'''
    got = msgs(isolation.check(Project.from_sources(
        {"repro_torch.serving.x": src})))
    assert len(got) == 1 and "'bad'" in got[0]


def test_shipped_wrappers_carry_the_writes_marker():
    writers = isolation._writing_functions(Project.from_root(str(REPO)))
    for key in [("repro_torch.kernels.matrix_ingest", "matrix_ingest"),
                ("repro_torch.kernels.matrix_ingest", "matrix_ingest_edges"),
                ("repro_torch.kernels.ops", "kmatrix_accel_ingest"),
                ("repro_torch.kernels.ops", "rectangle_ingest"),
                *((f"repro_torch.core.{m}", "ingest") for m in (
                    "kmatrix", "kmatrix_accel", "matrix_sketch", "gsketch",
                    "countmin"))]:
        assert writers[key] == frozenset({0}), key


def test_write_after_publish_registered_in_gate():
    names = [n for n, _ in all_rules()]
    assert names == ["trace-purity", "wire-schema", "unpickler-allowlist",
                     "no-pickle-hot-path", "lock-discipline",
                     "write-after-publish"]


# ================================================== baseline + CLI gate
def test_baseline_split_is_line_number_free():
    f1 = Finding("r", "repro_torch.m", 10, "problem one")
    f2 = Finding("r", "repro_torch.m", 99, "problem one")  # drifted line
    assert f1.key == f2.key
    new, suppressed, stale = split_by_baseline([f2], {f1.key, "r|x|gone"})
    assert new == [] and suppressed == [f2] and stale == {"r|x|gone"}


def test_run_rules_on_real_tree_is_empty():
    project = Project.from_root(str(REPO))
    assert len(project.files) > 90
    assert [f.render(project) for f in run_rules(project)] == []


def _copy_port_tree(dst: Path) -> Path:
    src = dst / "src" / "repro_torch"
    shutil.copytree(REPO / "src" / "repro_torch", src,
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    return src


def test_gate_clean_on_shipped_tree_and_fails_on_violation(tmp_path):
    # the shipped tree must gate clean with NO baseline file
    assert not (REPO / BASELINE_NAME).exists()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--gate",
         "--root", str(REPO)],
        capture_output=True, text=True, env=ENV, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr

    # a frame added without a version bump in a copied tree flips the code
    port = _copy_port_tree(tmp_path)
    wire = port / "net" / "wire.py"
    txt = wire.read_text()
    assert '"auth": 40,' in txt
    wire.write_text(txt.replace('"auth": 40,', '"auth": 40,\n    "gossip": 41,'))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--gate",
         "--root", str(tmp_path)],
        capture_output=True, text=True, env=ENV, timeout=120)
    assert r.returncode == 1
    assert "WIRE_VERSION bump" in r.stdout or "never dispatched" in r.stdout


def test_gate_baseline_suppresses_and_stale_entries_fail(tmp_path):
    port = _copy_port_tree(tmp_path)
    snap = port / "serving" / "snapshot.py"
    snap.write_text(snap.read_text() + (
        "\n\ndef poke(buf):\n    buf._front.sketch.overflow.add_(1)\n"))
    gate = [sys.executable, "-m", "repro_torch.analysis", "--gate", "--root",
            str(tmp_path)]
    r = subprocess.run(gate, capture_output=True, text=True, env=ENV,
                       timeout=120)
    assert r.returncode == 1 and "[write-after-publish]" in r.stdout
    r = subprocess.run([*gate, "--write-baseline"], capture_output=True,
                       text=True, env=ENV, timeout=120)
    assert r.returncode == 0 and (tmp_path / BASELINE_NAME).exists()
    r = subprocess.run(gate, capture_output=True, text=True, env=ENV,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    # the JAX package's baseline file is not the port's
    (tmp_path / BASELINE_NAME).rename(tmp_path / "analysis_baseline.txt")
    r = subprocess.run(gate, capture_output=True, text=True, env=ENV,
                       timeout=120)
    assert r.returncode == 1


def test_write_wire_lock_regenerates_the_port_lock(tmp_path):
    port = _copy_port_tree(tmp_path)
    lock = port / "net" / "wire_schema.lock"
    shipped = lock.read_text()
    lock.unlink()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--write-wire-lock",
         "--root", str(tmp_path)],
        capture_output=True, text=True, env=ENV, timeout=120)
    assert r.returncode == 0, r.stderr
    assert lock.read_text() == shipped


def test_unknown_rule_is_refused():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--rule", "nope",
         "--root", str(REPO)],
        capture_output=True, text=True, env=ENV, timeout=120)
    assert r.returncode == 2 and "unknown rule" in r.stderr
