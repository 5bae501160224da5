"""Checkpointing: npz leaves + JSON metadata, atomic, with stream offsets.

The on-disk layout is the JAX package's (``repro/checkpoint/store.py``), so
a checkpoint written by either package restores in the other:

  <directory>/step_%010d/leaves.npz   one array per sketch leaf, keyed as
                                      ``_flatten_with_paths`` keys a JAX
                                      sketch (".table", ".hashes/.a", ...)
  <directory>/step_%010d/meta.json    {"step", "extra", "leaf_keys"}

A state may also be a dict of sketches, tensors, numpy arrays and such
dicts (an ingest worker's ``{"front", "delta", "pending", "reservoir"}``);
its leaves are keyed as JAX keys a dict pytree's: ``"['front']/.table"``,
``"['pending']"``, ``"['reservoir']/['src']"``.  A NamedTuple's fields are
keyed ``.name`` and a list's items ``[i]``, and a module counts as the dict
of its named parameters, so a training state keys as JAX keys its own:
``".params/['emb']"``, ``".opt/.mu/['layers']/[0]/['wq']"``, ``".opt/.step"``.
Restoring into a module copies into its parameters in place.

bfloat16 leaves are written as numpy writes the JAX package's ``ml_dtypes``
bfloat16 arrays, raw 2-byte words (``|V2``), and read back as such words
viewed as ``torch.bfloat16``; numpy itself has no bfloat16.

Hash parameters are uint32 on disk, as in JAX, and int64 in the port.  The
stream is seekable (batch i is a pure function of (seed, i)), so a
checkpoint plus its ``stream_offset`` resumes bit-exactly.  Writes are
atomic (a temporary directory renamed into place), and a rolling window of
``keep`` checkpoints is retained.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch
from torch import nn

from repro_torch import interop


def _join(prefix: str, key: str) -> str:
    return f"{prefix}/{key}" if prefix else key


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _tensor_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _flatten(state, prefix: str = "") -> dict[str, np.ndarray]:
    """Leaves of ``state`` keyed as the JAX package's store keys a pytree."""
    if isinstance(state, nn.Module):
        state = dict(state.named_parameters())
    if isinstance(state, dict):
        out = {}
        for k in sorted(state):
            out.update(_flatten(state[k], _join(prefix, f"['{k}']")))
        return out
    if _is_namedtuple(state):
        out = {}
        for name in state._fields:
            out.update(_flatten(getattr(state, name), _join(prefix, f".{name}")))
        return out
    if isinstance(state, (list, tuple)):
        out = {}
        for i, x in enumerate(state):
            out.update(_flatten(x, _join(prefix, f"[{i}]")))
        return out
    if isinstance(state, torch.Tensor):
        return {prefix: _tensor_numpy(state)}
    if isinstance(state, np.ndarray):
        return {prefix: state}
    leaves, _ = interop.export_state(state)
    return {_join(prefix, k): v for k, v in leaves.items()}


def _leaf(data, key: str, like, filled: list):
    """Checkpoint leaf ``key`` cast to ``like``'s dtype (``like`` itself if
    the checkpoint lacks it, listed in ``filled``)."""
    want = np.asarray(like.cpu() if isinstance(like, torch.Tensor) else like)
    if key not in data.files:
        filled.append(key)
        return want
    arr = data[key]
    if arr.shape != want.shape:
        raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}, "
                         f"the template {want.shape}")
    return arr.astype(want.dtype)


def _tensor_leaf(data, key: str, like: torch.Tensor, filled: list):
    """Checkpoint leaf ``key`` as a tensor of ``like``'s dtype on its
    device (a copy of ``like`` if the checkpoint lacks it, listed in
    ``filled``); bfloat16 from the raw 2-byte words JAX writes."""
    if key not in data.files:
        filled.append(key)
        return like.detach().clone()
    arr = data[key]
    if arr.shape != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}, "
                         f"the template {tuple(like.shape)}")
    if like.dtype == torch.bfloat16:
        if arr.dtype.kind == "V":
            return interop.array_tensor(arr, like.device)
        return torch.as_tensor(arr.astype(np.float32)).to(like.device,
                                                          torch.bfloat16)
    want = torch.empty(0, dtype=like.dtype).numpy().dtype
    return torch.as_tensor(arr.astype(want)).to(like.device)


def _unflatten(data, template, prefix: str, filled: list):
    """``template``'s structure holding the checkpoint's leaves, each
    tensor on its template's device; a module is filled in place."""
    if isinstance(template, nn.Module):
        with torch.no_grad():
            for k, p in template.named_parameters():
                p.copy_(_tensor_leaf(data, _join(prefix, f"['{k}']"), p,
                                     filled))
        return template
    if isinstance(template, dict):
        return {k: _unflatten(data, v, _join(prefix, f"['{k}']"), filled)
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(
            _unflatten(data, getattr(template, name),
                       _join(prefix, f".{name}"), filled)
            for name in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten(data, x, _join(prefix, f"[{i}]"), filled)
            for i, x in enumerate(template))
    if isinstance(template, torch.Tensor):
        out = _tensor_leaf(data, prefix, template, filled)
        return out.requires_grad_(template.requires_grad)
    if isinstance(template, np.ndarray):
        return _leaf(data, prefix, template, filled)
    want, static = interop.export_state(template)
    leaves = {k: _leaf(data, _join(prefix, k), v, filled)
              for k, v in want.items()}
    return interop.import_state(leaves, static,
                                device=template.hashes.a.device)


def save(directory: str, step: int, state, *, extra: dict | None = None,
         keep: int = 3) -> str:
    """Atomically write checkpoint ``step`` of ``state`` (a sketch, a
    training state, or a dict or list of them and of tensors); prune old
    ones.  Returns the checkpoint's
    path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        leaves = _flatten(state)
        np.savez(os.path.join(tmp, "leaves.npz"), **leaves)
        meta = {"step": step, "extra": extra or {},
                "leaf_keys": sorted(leaves)}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    if not ckpts:
        return None
    return int(ckpts[-1].split("_")[1])


def _step_dir(directory: str, step: int | None) -> str:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return os.path.join(directory, f"step_{step:010d}")


def read_meta(directory: str, step: int | None = None) -> dict:
    """Metadata of checkpoint ``step`` (default: latest) without loading
    arrays."""
    with open(os.path.join(_step_dir(directory, step), "meta.json")) as f:
        return json.load(f)


def restore(directory: str, template, step: int | None = None):
    """Restore checkpoint ``step`` (default: latest) into the structure of
    ``template`` (a sketch, a training state, or a dict or list as ``save``
    takes), each tensor on its template's device.  Returns (state, meta).

    A leaf the template has and the checkpoint lacks is taken from the
    template and listed in ``meta["filled_from_template"]``; a leaf whose
    shape differs from the template's raises ``ValueError``.
    """
    path = _step_dir(directory, step)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    filled: list = []
    with np.load(os.path.join(path, "leaves.npz")) as data:
        state = _unflatten(data, template, "", filled)
    meta["filled_from_template"] = filled
    return state, meta
