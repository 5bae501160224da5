"""Checkpointing: npz leaves + JSON metadata, atomic, with stream offsets.

The on-disk layout is the JAX package's (``repro/checkpoint/store.py``), so
a checkpoint written by either package restores in the other:

  <directory>/step_%010d/leaves.npz   one array per sketch leaf, keyed as
                                      ``_flatten_with_paths`` keys a JAX
                                      sketch (".table", ".hashes/.a", ...)
  <directory>/step_%010d/meta.json    {"step", "extra", "leaf_keys"}

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

from repro_torch import interop


def save(directory: str, step: int, state, *, extra: dict | None = None,
         keep: int = 3) -> str:
    """Atomically write checkpoint ``step`` of sketch ``state``; prune old
    ones.  Returns the checkpoint's path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        leaves, _ = interop.export_state(state)
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
    """Restore checkpoint ``step`` (default: latest) into the layout of the
    sketch ``template``, on the template's device.  Returns (sketch, meta).

    A leaf the template has and the checkpoint lacks is taken from the
    template and listed in ``meta["filled_from_template"]``; a leaf whose
    shape differs from the template's raises ``ValueError``.
    """
    path = _step_dir(directory, step)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    want, static = interop.export_state(template)
    leaves, filled = {}, []
    with np.load(os.path.join(path, "leaves.npz")) as data:
        for key, leaf in want.items():
            if key not in data.files:
                filled.append(key)
                leaves[key] = leaf
                continue
            arr = data[key]
            if arr.shape != leaf.shape:
                raise ValueError(f"checkpoint leaf {key!r} has shape "
                                 f"{arr.shape}, the template {leaf.shape}")
            leaves[key] = arr.astype(leaf.dtype)
    sketch = interop.import_state(leaves, static,
                                  device=template.hashes.a.device)
    meta["filled_from_template"] = filled
    return sketch, meta
