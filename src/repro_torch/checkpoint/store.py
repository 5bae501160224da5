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
``"['pending']"``, ``"['reservoir']/['src']"``.

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

from repro_torch import interop


def _join(prefix: str, key: str) -> str:
    return f"{prefix}/{key}" if prefix else key


def _flatten(state, prefix: str = "") -> dict[str, np.ndarray]:
    """Leaves of ``state`` keyed as the JAX package's store keys a pytree."""
    if isinstance(state, dict):
        out = {}
        for k in sorted(state):
            out.update(_flatten(state[k], _join(prefix, f"['{k}']")))
        return out
    if isinstance(state, torch.Tensor):
        return {prefix: state.cpu().numpy()}
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


def _unflatten(data, template, prefix: str, filled: list):
    """``template``'s structure holding the checkpoint's leaves, each
    tensor on its template's device."""
    if isinstance(template, dict):
        return {k: _unflatten(data, v, _join(prefix, f"['{k}']"), filled)
                for k, v in template.items()}
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(_leaf(data, prefix, template, filled),
                               device=template.device)
    if isinstance(template, np.ndarray):
        return _leaf(data, prefix, template, filled)
    want, static = interop.export_state(template)
    leaves = {k: _leaf(data, _join(prefix, k), v, filled)
              for k, v in want.items()}
    return interop.import_state(leaves, static,
                                device=template.hashes.a.device)


def save(directory: str, step: int, state, *, extra: dict | None = None,
         keep: int = 3) -> str:
    """Atomically write checkpoint ``step`` of ``state`` (a sketch, or a
    dict of them and of tensors); prune old ones.  Returns the checkpoint's
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
    ``template`` (a sketch, or a dict as ``save`` takes), each tensor on its
    template's device.  Returns (state, meta).

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
