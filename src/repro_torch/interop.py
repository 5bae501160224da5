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

``tree_leaves`` / ``tree_unflatten`` carry a sketch (or a nest of them) as
the flat leaf list of ``jax.tree_util.tree_leaves``: the data fields of
each dataclass in declaration order, recursively, tuples and lists in
order, dict values by sorted key, ``None`` skipped; numpy arrays in the JAX
package's dtypes.  The process and socket backends ship sketches so, and a
JAX peer rebuilds them with ``tree_unflatten`` of its own.

``fm_params_from_jax`` does the same for the FM: the JAX package's params
dict (``emb``, ``lin``, ``bias``) as numpy arrays becomes the port's ``FM``.
``lm_params_from_jax`` carries a transformer's params tree (the same
layout on both sides), ``gnn_params_from_jax`` a GNN's (its stacked
``layers`` included), and ``train_state_from_jax`` a whole JAX
``TrainState`` (params and AdamW moments, numpy leaves) into a port
``TrainState`` template, FM, LM or GNN, keyed as the checkpoint store keys
them.  bfloat16 leaves (``ml_dtypes`` arrays) travel as their raw 2-byte
words.
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


def _leaf_numpy(x, dtype) -> np.ndarray:
    # a copy: a CPU tensor's .numpy() would share the tensor's storage
    if isinstance(x, torch.Tensor):
        arr = x.detach().to("cpu", copy=True).numpy()
    else:
        arr = np.array(x)
    return arr.astype(dtype) if dtype is not None else arr


def _flatten(obj, out: list, dtype) -> None:
    if obj is None:
        return
    if isinstance(obj, (tuple, list)):
        for x in obj:
            _flatten(x, out, dtype)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            _flatten(obj[k], out, dtype)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        dtype = np.uint32 if isinstance(obj, HashFamily) else None
        for f in dataclasses.fields(obj):
            if not is_static(f):
                _flatten(getattr(obj, f.name), out, dtype)
    else:
        out.append(_leaf_numpy(obj, dtype))


def tree_leaves(tree) -> list[np.ndarray]:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order, as
    numpy copies in the JAX package's dtypes (hash parameters uint32).
    Reading a CUDA tensor synchronises with the stream that writes it."""
    out: list[np.ndarray] = []
    _flatten(tree, out, None)
    return out


def _unflatten(obj, leaves, device, int64: bool):
    if obj is None:
        return None
    if isinstance(obj, (tuple, list)):
        return type(obj)(_unflatten(x, leaves, device, int64) for x in obj)
    if isinstance(obj, dict):
        return {k: _unflatten(obj[k], leaves, device, int64)
                for k in sorted(obj)}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        int64 = isinstance(obj, HashFamily)
        return dataclasses.replace(obj, **{
            f.name: _unflatten(getattr(obj, f.name), leaves, device, int64)
            for f in dataclasses.fields(obj) if not is_static(f)})
    try:
        leaf = next(leaves)
    except StopIteration:
        raise ValueError("too few leaves for the template") from None
    arr = np.asarray(leaf)
    if int64:
        arr = arr.astype(np.int64)
    if not isinstance(obj, torch.Tensor):
        return torch.as_tensor(np.array(arr), device=device)
    if tuple(arr.shape) != tuple(obj.shape):
        raise ValueError(f"leaf of shape {arr.shape} where the template "
                         f"holds {tuple(obj.shape)}")
    out = torch.as_tensor(np.array(arr), device=device or obj.device)
    if out.dtype != obj.dtype:
        raise ValueError(f"leaf of dtype {arr.dtype} where the template "
                         f"holds {obj.dtype}")
    return out


def tree_unflatten(template, leaves, *, device=None):
    """``template``'s structure (and static fields) holding ``leaves``, the
    inverse of :func:`tree_leaves`: fresh tensors on ``device`` (default:
    each template tensor's own).  Raises on a leaf count, shape or dtype
    that does not fit the template."""
    it = iter(leaves)
    out = _unflatten(template, it, device, False)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


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


def fm_params_from_jax(cfg: FMConfig, np_params: dict, *, device="cuda",
                       requires_grad: bool = False) -> FM:
    """The port's ``FM`` holding copies of the JAX package's FM params
    (``{"emb", "lin", "bias"}`` as numpy arrays) on ``device``; its
    parameters require grad when ``requires_grad`` (training)."""
    missing = {"emb", "lin", "bias"} - set(np_params)
    if missing:
        raise KeyError(f"FM params missing {sorted(missing)}")
    return FM(cfg, *(torch.as_tensor(np.array(np_params[k], dtype=np.float32),
                                     device=device)
                     for k in ("emb", "lin", "bias")),
              requires_grad=requires_grad)


def array_tensor(arr, device) -> torch.Tensor:
    """A tensor copy of a numpy array; bfloat16 (``ml_dtypes``, kind ``V``)
    from its raw 2-byte words."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        words = np.ascontiguousarray(arr).view(np.int16).copy()
        return torch.from_numpy(words).view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(arr), device=device)


def lm_params_from_jax(cfg, np_params: dict, *, device="cuda",
                       requires_grad: bool = True) -> dict:
    """The port's transformer params (the JAX tree layout: ``embed``,
    ``layers``, ``tail``, ``ln_final``, ``lm_head`` unless tied) holding
    copies of the JAX package's, given as numpy arrays, on ``device``."""
    want = {"embed", "layers", "tail", "ln_final"} | (
        set() if cfg.tie_embed else {"lm_head"})
    if set(np_params) != want:
        raise KeyError(f"{cfg.name} params must hold {sorted(want)}, got "
                       f"{sorted(np_params)}")

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        t = array_tensor(x, device)
        return t.requires_grad_(requires_grad and t.is_floating_point())

    return conv(np_params)


# the top-level keys of each GNN's params tree, the JAX package's layout
GNN_PARAM_KEYS = {
    "gatedgcn": {"embed_h", "embed_e", "layers", "head"},
    "graphcast": {"embed_grid", "embed_mesh", "embed_edge", "g2m",
                  "processor", "m2g", "head"},
    "nequip": {"embed", "layers", "head_w1", "head_w2"},
    "equiformer-v2": {"embed", "layers", "head_w1", "head_w2"},
}


def gnn_params_from_jax(arch_name: str, np_params: dict, *, device="cuda",
                        requires_grad: bool = True) -> dict:
    """The port's params of the GNN ``arch_name`` holding copies of the JAX
    package's (the same tree: dicts of numpy arrays, ``layers`` /
    ``processor`` leaves stacked over the layers) on ``device``."""
    if arch_name not in GNN_PARAM_KEYS:
        raise KeyError(f"unknown GNN {arch_name!r} "
                       f"(one of {sorted(GNN_PARAM_KEYS)})")
    want = GNN_PARAM_KEYS[arch_name]
    if set(np_params) != want:
        raise KeyError(f"{arch_name} params must hold {sorted(want)}, got "
                       f"{sorted(np_params)}")

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        t = array_tensor(x, device)
        return t.requires_grad_(requires_grad and t.is_floating_point())

    return conv(np_params)


class _KeyedLeaves(dict):
    """Leaves keyed as the checkpoint store keys them, in the shape of an
    opened ``npz`` (``.files``), for the store's restore walk."""

    @property
    def files(self):
        return list(self)


def train_state_from_jax(np_state, template):
    """The port's ``TrainState`` ``template`` (FM, LM or GNN) filled with a JAX
    ``TrainState`` whose leaves are numpy arrays (``jax.tree.map(
    np.asarray, state)``): a module template is filled in place, other
    leaves are fresh tensors on their template's devices.  Raises on a
    leaf the JAX state lacks or a shape that differs."""
    from repro_torch.checkpoint import store

    leaves = _KeyedLeaves(store._flatten(np_state))
    filled: list = []
    state = store._unflatten(leaves, template, "", filled)
    if filled:
        raise KeyError(f"the JAX state lacks {filled}")
    return state
