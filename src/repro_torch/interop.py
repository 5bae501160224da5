"""Carry sketch state between the JAX package and the port.

A sketch travels as two dicts:

* ``leaves``: numpy arrays keyed the way ``repro/checkpoint/store.py``
  (``_flatten_with_paths``) keys a JAX sketch's pytree leaves —
  ``".pools/[0]"``, ``".conn"``, ``".hashes/.a"``, ``".route/.keys"``, ...;
* ``static``: the static (layout) fields under the same kind of keys —
  ``".class_widths"``, ``".route/.outlier"``, ... — plus ``"__type__"``,
  the sketch's class name.

``export_state`` reads any sketch object of either package (it walks the
dataclass fields, telling static fields by the metadata key both packages
use), so a test can start both sides from one state and compare them leaf
by leaf.  ``import_state`` builds the port's sketch on a device.

``snapshot_state_from_jax`` carries a whole snapshot buffer across: a JAX
``SnapshotBuffer.state()`` (front and delta sketches, the pending count, the
epoch and the edge count) becomes the port's ``SnapshotBuffer.load_state``
input; ``snapshot_state_to_jax`` gives the port's ``state()`` back in
leaves, which the JAX package loads into sketch templates of its own (as
its checkpoint store restores leaves keyed the same way).

``fm_params_from_jax`` does the same for the FM: the JAX package's params
dict (``emb``, ``lin``, ``bias``) as numpy arrays becomes the port's ``FM``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common.hashing import HashFamily
from repro_torch.common.struct import is_static
from repro_torch.core.countmin import CountMin
from repro_torch.core.gsketch import GSketch
from repro_torch.core.kmatrix import KMatrix
from repro_torch.core.kmatrix_accel import KMatrixAccel
from repro_torch.core.matrix_sketch import MatrixSketch
from repro_torch.core.routing import RouteTable
from repro_torch.models.recsys.fm import FM, FMConfig

SKETCH_TYPES = {cls.__name__: cls for cls in
                (CountMin, GSketch, MatrixSketch, KMatrix, KMatrixAccel)}
_NESTED = {"hashes": HashFamily, "route": RouteTable}


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _walk(obj, prefix: str, leaves: dict, static: dict) -> None:
    # hash parameters are uint32 in the JAX package, held in int64 here
    dtype = np.uint32 if type(obj).__name__ == "HashFamily" else None
    for f in dataclasses.fields(obj):
        key = f"{prefix}.{f.name}"
        val = getattr(obj, f.name)
        if is_static(f):
            static[key] = val
        elif dataclasses.is_dataclass(val):
            _walk(val, key + "/", leaves, static)
        elif isinstance(val, (tuple, list)):
            for i, v in enumerate(val):
                leaves[f"{key}/[{i}]"] = _to_numpy(v)
        else:
            arr = _to_numpy(val)
            leaves[key] = arr.astype(dtype) if dtype is not None else arr


def export_state(sk) -> tuple[dict[str, np.ndarray], dict]:
    """(leaves, static) of a sketch of either package."""
    leaves: dict[str, np.ndarray] = {}
    static: dict = {"__type__": type(sk).__name__}
    _walk(sk, "", leaves, static)
    return leaves, static


def _build(cls, prefix: str, leaves: dict, static: dict, used: set, device):
    kwargs = {}
    for f in dataclasses.fields(cls):
        key = f"{prefix}.{f.name}"
        if is_static(f):
            if key in static:
                kwargs[f.name] = static[key]
            elif f.default is dataclasses.MISSING:
                raise KeyError(f"static field {key!r} missing")
        elif f.name in _NESTED:
            kwargs[f.name] = _build(_NESTED[f.name], key + "/", leaves,
                                    static, used, device)
        elif f.name == "pools":
            n = sum(1 for k in leaves if k.startswith(key + "/["))
            kwargs[f.name] = tuple(
                _put(leaves, f"{key}/[{i}]", used, device) for i in range(n))
        else:
            kwargs[f.name] = _put(leaves, key, used, device,
                                  int64=cls is HashFamily)
    return cls(**kwargs)


def _put(leaves: dict, key: str, used: set, device, int64: bool = False):
    if key not in leaves:
        raise KeyError(f"leaf {key!r} missing")
    used.add(key)
    arr = np.asarray(leaves[key])
    return torch.as_tensor(arr.astype(np.int64) if int64 else arr.copy(),
                           device=device)


def import_state(leaves: dict, static: dict, *, device="cuda"):
    """The port's sketch of type ``static["__type__"]`` holding ``leaves``.

    Raises on a missing or unexpected leaf.  The tensors are fresh copies.
    """
    kind = static.get("__type__")
    if kind not in SKETCH_TYPES:
        raise ValueError(f"unknown sketch type {kind!r} "
                         f"(expected one of {sorted(SKETCH_TYPES)})")
    used: set = set()
    sk = _build(SKETCH_TYPES[kind], "", leaves, static, used, device)
    extra = sorted(set(leaves) - used)
    if extra:
        raise ValueError(f"unexpected leaves for {kind}: {extra}")
    return sk


def snapshot_state_from_jax(state: dict, *, device="cuda") -> dict:
    """A snapshot buffer ``state()`` of the JAX package (its ``front`` and
    ``delta`` sketches, ``pending``, ``epoch``, ``n_edges``) as the port's
    ``SnapshotBuffer.load_state`` input, its sketches on ``device``."""
    return {
        "front": import_state(*export_state(state["front"]), device=device),
        "delta": import_state(*export_state(state["delta"]), device=device),
        "pending": int(np.asarray(state["pending"])),
        "epoch": int(state["epoch"]),
        "n_edges": int(state["n_edges"]),
    }


def snapshot_state_to_jax(state: dict) -> dict:
    """The inverse, for the port's ``state()``: ``front`` and ``delta`` as
    ``(leaves, static)`` (``export_state``), the counts as ints."""
    return {
        "front": export_state(state["front"]),
        "delta": export_state(state["delta"]),
        "pending": int(state["pending"]),
        "epoch": int(state["epoch"]),
        "n_edges": int(state["n_edges"]),
    }


def fm_params_from_jax(cfg: FMConfig, np_params: dict, *, device="cuda") -> FM:
    """The port's ``FM`` holding copies of the JAX package's FM params
    (``{"emb", "lin", "bias"}`` as numpy arrays) on ``device``."""
    missing = {"emb", "lin", "bias"} - set(np_params)
    if missing:
        raise KeyError(f"FM params missing {sorted(missing)}")
    return FM(cfg, *(torch.as_tensor(np.array(np_params[k], dtype=np.float32),
                                     device=device)
                     for k in ("emb", "lin", "bias")))
