"""Dynamic lock-order witness (the runtime half of the locks rule), and the
port's isolation check at run time.

``python -m repro_torch.analysis.witness <module> [args...]`` calls
:func:`install` before anything of ``repro_torch`` is imported, runs
``<module>`` as ``__main__`` with ``args``, then prints one line,
``lock witness: {"sites": ..., "edges": ..., "cycles": ...,
"unlocked_publishes": ..., "fronts_written": ..., "rc": ...}``, and exits
1 on any violation (else with the module's own exit code).

:func:`install` replaces ``threading.Lock``/``threading.RLock`` with
factories that wrap any lock *allocated from repro_torch code* in a
tracking proxy (``threading.Condition()`` picks the patched RLock up
automatically; locks allocated by the stdlib — queues, logging — stay raw
and free).

Each proxy carries its **allocation site** (``file:line`` of the
``threading.Lock()`` call), so every ``SnapshotBuffer`` instance shares
one node, matching the static rule's class-qualified model.  On every
successful acquire the witness appends edges ``held-site -> new-site``
to a global order graph and checks for a path back: a cycle means two
threads can deadlock under the observed orders, and the run fails even
though this particular run got lucky with timing.  Reentrant RLock
acquires and same-site pairs (two instances of one class, e.g. paired
buffers) are excluded — the latter is a documented under-approximation,
not a bug: site-level identity cannot distinguish instance order.

The witness also enforces the publish invariant dynamically:
:func:`guard_publishes` patches the port's ``SnapshotBuffer.__setattr__``
so any ``_front`` store while ``_lock`` is not held by the storing thread
is recorded as a violation (``# guarded-by(writes): _lock``, enforced at
runtime even for code paths the static rule cannot see).

And it checks what the port has in place of immutable arrays: no tensor of
a published front is written again.  At each publish (a ``_front`` store
after the buffer's construction) it keeps a private copy of every tensor
of the new front's sketch; at every later publish and at report time it
compares each front that is still alive with its copy, byte for byte.
Any difference is a violation, "front of epoch N written after publish".
A tensor's ``_version`` cannot serve: the card's ingest kernel writes
through a raw pointer, which never bumps it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import runpy
import sys
import threading
import traceback
import weakref

# real factories, captured before any patching
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

_PACKAGE = "repro_torch"
_REPRO_FRAGMENT = f"{os.sep}{_PACKAGE}{os.sep}"
_SELF_FILE = os.path.abspath(__file__)


def _allocation_site() -> str | None:
    """``file:line`` of the nearest caller outside threading/witness
    code; None when the allocation is not repro_torch code."""
    f = sys._getframe(2)
    while f is not None:
        fname = f.f_code.co_filename
        if not (fname.endswith("threading.py")
                or os.path.abspath(fname) == _SELF_FILE):
            rel = os.path.abspath(fname)
            if _REPRO_FRAGMENT not in rel:
                return None
            tail = rel.split(_REPRO_FRAGMENT)[-1]
            return f"{_PACKAGE}/{tail.replace(os.sep, '/')}:{f.f_lineno}"
        f = f.f_back
    return None


class LockWitness:
    """Global acquisition-order graph + violation log."""

    def __init__(self) -> None:
        self._mu = _REAL_LOCK()
        self._tls = threading.local()
        # site -> set of successor sites; edge evidence kept separately
        self._graph: dict[str, set[str]] = {}
        self._evidence: dict[tuple[str, str], str] = {}
        self.cycles: list[dict] = []
        self.unlocked_publishes: list[dict] = []
        self.fronts_written: list[dict] = []
        self._reported: set[tuple[str, ...]] = set()
        self._fronts: list[_FrontCopy] = []  # guarded by _mu

    # ------------------------------------------------------------ held state
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def holds(self, proxy: "object") -> bool:
        return any(p is proxy for p in self._stack())

    # ------------------------------------------------------------- recording
    def note_acquire(self, proxy: "_WitnessedLockBase") -> None:
        stack = self._stack()
        reentrant = any(p is proxy for p in stack)
        if not reentrant:
            held_sites = []
            seen: set[int] = set()
            for p in stack:
                if id(p) not in seen:
                    seen.add(id(p))
                    held_sites.append(p.site)
            if held_sites:
                self._note_edges(held_sites, proxy.site)
        stack.append(proxy)

    def note_release(self, proxy: "_WitnessedLockBase") -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is proxy:
                del stack[i]
                return

    def _note_edges(self, held_sites: list[str], new_site: str) -> None:
        tb = "".join(traceback.format_stack(sys._getframe(3), limit=6))
        with self._mu:
            for held in held_sites:
                if held == new_site:
                    continue  # two instances of one class: site-level blind
                self._graph.setdefault(held, set()).add(new_site)
                self._graph.setdefault(new_site, set())
                self._evidence.setdefault((held, new_site), tb)
                path = self._path(new_site, held)
                if path is not None:
                    cycle = [held, new_site] + path[1:]
                    key = tuple(sorted(set(cycle)))
                    if key not in self._reported:
                        self._reported.add(key)
                        self.cycles.append({
                            "cycle": cycle,
                            "thread": threading.current_thread().name,
                            "forward": tb,
                            "reverse": self._evidence.get(
                                (new_site, path[1] if len(path) > 1
                                 else held), ""),
                        })

    def _path(self, src: str, dst: str) -> list[str] | None:
        """Directed path src ~> dst in the order graph (callers hold _mu)."""
        if src == dst:
            return [src]
        stack = [(src, [src])]
        visited = {src}
        while stack:
            cur, path = stack.pop()
            for nxt in self._graph.get(cur, ()):
                if nxt == dst:
                    return path + [dst]
                if nxt not in visited:
                    visited.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def note_unlocked_publish(self, what: str) -> None:
        with self._mu:
            self.unlocked_publishes.append({
                "what": what,
                "thread": threading.current_thread().name,
                "stack": "".join(traceback.format_stack(
                    sys._getframe(2), limit=8)),
            })

    # ------------------------------------------------------ published fronts
    def note_publish(self, snapshot) -> None:
        """Check every live front against its copy, then keep a copy of
        ``snapshot``'s tensors (a new front, stored under its buffer's
        lock)."""
        copy = _FrontCopy(snapshot)
        with self._mu:
            self._check_fronts(f"the publish of epoch {snapshot.epoch}")
            self._fronts.append(copy)

    def _check_fronts(self, when: str) -> None:
        """Compare each live front with its copy (callers hold _mu)."""
        alive: list[_FrontCopy] = []
        for rec in self._fronts:
            snap = rec.ref()
            if snap is None:
                continue
            changed = rec.changed(snap)
            if changed:
                self.fronts_written.append({
                    "epoch": rec.epoch, "tenant": rec.tenant,
                    "tensors": changed, "seen_at": when,
                    "thread": threading.current_thread().name})
                continue  # reported once; its copy is dropped
            alive.append(rec)
        self._fronts = alive

    # --------------------------------------------------------------- reports
    def edge_count(self) -> int:
        with self._mu:
            return sum(len(v) for v in self._graph.values())

    def report(self) -> dict:
        """The order graph's size and every violation, after checking each
        live front once more."""
        with self._mu:
            self._check_fronts("report")
            return {
                "sites": len(self._graph),
                "edges": sum(len(v) for v in self._graph.values()),
                "cycles": list(self.cycles),
                "unlocked_publishes": list(self.unlocked_publishes),
                "fronts_written": list(self.fronts_written),
            }

    def violated(self, rep: dict | None = None) -> bool:
        rep = rep or self.report()
        return bool(rep["cycles"] or rep["unlocked_publishes"]
                    or rep["fronts_written"])

    def render_violations(self) -> str:
        rep = self.report()
        out: list[str] = []
        for c in rep["cycles"]:
            out.append("lock-order cycle: " + " -> ".join(c["cycle"])
                       + f" (thread {c['thread']})\n"
                       + "forward acquisition:\n" + c["forward"]
                       + ("reverse acquisition:\n" + c["reverse"]
                          if c["reverse"] else ""))
        for p in rep["unlocked_publishes"]:
            out.append(f"publish while unlocked: {p['what']} "
                       f"(thread {p['thread']})\n" + p["stack"])
        for w in rep["fronts_written"]:
            out.append(f"front of epoch {w['epoch']} written after publish: "
                       f"tenant {w['tenant']}, tensors {w['tensors']} "
                       f"(seen at {w['seen_at']}, thread {w['thread']})")
        return "\n".join(out)


def _tensor_leaves(obj, prefix: str = ""):
    """(path, tensor) of every tensor in a nest of dataclasses and tuples."""
    import torch

    if isinstance(obj, torch.Tensor):
        yield prefix or ".", obj
    elif isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            yield from _tensor_leaves(x, f"{prefix}[{i}]")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensor_leaves(getattr(obj, f.name),
                                      f"{prefix}.{f.name}")


def _bytes_of(t):
    import torch

    return t.detach().reshape(-1).view(torch.uint8)


class _FrontCopy:
    """A published front, held weakly, and a private copy of its tensors."""

    def __init__(self, snapshot) -> None:
        self.ref = weakref.ref(snapshot)
        self.epoch = snapshot.epoch
        self.tenant = snapshot.tenant_id
        self.copies = {path: t.detach().clone()
                       for path, t in _tensor_leaves(snapshot.sketch)}

    def changed(self, snapshot) -> list[str]:
        """Paths of the tensors whose bytes differ from the copy."""
        import torch

        live = dict(_tensor_leaves(snapshot.sketch))
        out = [path for path, copy in self.copies.items()
               if path not in live or live[path].shape != copy.shape
               or live[path].dtype != copy.dtype
               or not torch.equal(_bytes_of(live[path]), _bytes_of(copy))]
        return out + sorted(set(live) - set(self.copies))


class _WitnessedLockBase:
    """Common acquire/release tracking; subclasses pick the inner lock."""

    def __init__(self, inner, site: str, witness: LockWitness) -> None:
        self._inner = inner
        self.site = site
        self._witness = witness

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._witness.note_acquire(self)
        return ok

    def release(self) -> None:
        self._witness.note_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<witnessed {type(self._inner).__name__} @ {self.site}>"


class WitnessedLock(_WitnessedLockBase):
    pass


class WitnessedRLock(_WitnessedLockBase):
    # threading.Condition probes for _is_owned; without the delegation its
    # acquire(False) fallback wrongly succeeds on a reentrant lock the
    # current thread already owns.  _release_save/_acquire_restore are
    # deliberately NOT forwarded: Condition then falls back to plain
    # release()/acquire() on this proxy, which keeps the witness's held
    # stack exact across cv.wait().
    def _is_owned(self) -> bool:
        return self._inner._is_owned()


# ------------------------------------------------------------ installation
_witness: LockWitness | None = None
_installed = False


def get_witness() -> LockWitness | None:
    return _witness


def _make_lock():
    site = _allocation_site()
    if site is None or _witness is None:
        return _REAL_LOCK()
    return WitnessedLock(_REAL_LOCK(), site, _witness)


def _make_rlock():
    site = _allocation_site()
    if site is None or _witness is None:
        return _REAL_RLOCK()
    return WitnessedRLock(_REAL_RLOCK(), site, _witness)


def install() -> LockWitness:
    """Patch the lock factories; idempotent.  Returns the witness."""
    global _witness, _installed
    if _witness is None:
        _witness = LockWitness()
    if not _installed:
        threading.Lock = _make_lock
        threading.RLock = _make_rlock
        guard_publishes(_witness)
        _installed = True
    return _witness


def uninstall() -> None:
    global _installed
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    _unguard_publishes()
    _installed = False


_publish_guarded = False


def guard_publishes(witness: LockWitness) -> None:
    """Enforce ``SnapshotBuffer._front  # guarded-by(writes): _lock`` at
    runtime: every `_front` store must come from a thread holding the
    buffer's lock.  (During ``__init__`` the lock does not exist yet —
    those stores are exempt, same as the static rule.)  Every such store
    after construction is a publish: the witness copies the new front and
    checks the live ones (:meth:`LockWitness.note_publish`)."""
    global _publish_guarded
    if _publish_guarded:
        return
    from repro_torch.serving.snapshot import SnapshotBuffer

    def checked_setattr(self, name, value, _w=witness):
        if name == "_front":
            lock = self.__dict__.get("_lock")
            if lock is not None:
                held = _w.holds(lock) if isinstance(
                    lock, _WitnessedLockBase) else lock.locked()
                if not held:
                    _w.note_unlocked_publish(
                        "SnapshotBuffer._front store outside _lock")
                _w.note_publish(value)
        object.__setattr__(self, name, value)

    SnapshotBuffer.__setattr__ = checked_setattr
    _publish_guarded = True


def _unguard_publishes() -> None:
    global _publish_guarded
    if not _publish_guarded:
        return
    from repro_torch.serving.snapshot import SnapshotBuffer

    try:
        del SnapshotBuffer.__setattr__
    except AttributeError:
        pass
    _publish_guarded = False


# ---------------------------------------------------------------- runner
def run_module(module: str, args: list[str]) -> int:
    """Run ``module`` as ``__main__`` with ``args`` under the witness; print
    the witness's line and return the exit code (1 on a violation)."""
    w = install()
    sys.argv = [module, *args]
    rc = 0
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    except SystemExit as exc:
        code = exc.code
        rc = code if isinstance(code, int) else (0 if code is None else 1)
        if not isinstance(code, (int, type(None))):
            print(code, file=sys.stderr)
    except Exception:  # the module failed: report it beside the witness
        traceback.print_exc()
        rc = 1
    rep = w.report()
    sys.stdout.flush()
    if w.violated(rep):
        print(w.render_violations(), file=sys.stderr)
    print("lock witness: " + json.dumps({
        "sites": rep["sites"], "edges": rep["edges"],
        "cycles": len(rep["cycles"]),
        "unlocked_publishes": len(rep["unlocked_publishes"]),
        "fronts_written": len(rep["fronts_written"]), "rc": rc}), flush=True)
    return 1 if w.violated(rep) else rc


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m repro_torch.analysis.witness MODULE [ARGS...]",
              file=sys.stderr)
        return 2
    return run_module(argv[0], argv[1:])


if __name__ == "__main__":
    # run through the imported module, so that the lock factories and the
    # witness the module under test sees are the package's own
    from repro_torch.analysis import witness as _witness

    sys.exit(_witness.main())
