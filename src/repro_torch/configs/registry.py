"""Architecture registry and cell builder: the FM part of
``repro/configs/registry.py``.

A cell is (arch x shape): the step function and its inputs.  The port
builds the FM's serve and retrieval cells on one card; the JAX package's
shardings and its other families belong to the model-zoo slice
(ROADMAP.md, item 16), and its mesh is ``repro_torch.launch.mesh``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.recsys import fm as fm_mod


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str  # "recsys" (the LM and GNN families are not ported yet)
    config: Any
    shape_names: tuple[str, ...]


def _fm_config() -> fm_mod.FMConfig:
    return fm_mod.FMConfig(n_fields=39, embed_dim=10, total_vocab=10_000_000)


@functools.lru_cache(maxsize=1)
def archs() -> dict[str, Arch]:
    return {"fm": Arch("fm", "recsys", _fm_config(), tuple(RECSYS_SHAPES))}


@dataclasses.dataclass
class Cell:
    """One (arch, shape) on one device: ``run()`` is
    ``step_fn(params, *inputs)``, which scores ``rows`` rows (the batch,
    or the candidates of a retrieval)."""

    arch: str
    shape: str
    step_fn: Callable
    params: Any
    inputs: tuple
    rows: int

    def run(self):
        return self.step_fn(self.params, *self.inputs)


def build_fm_cell(shape_name: str, params, rng: np.random.Generator,
                  device="cuda") -> Cell:
    """The FM cell ``shape_name`` over ``params`` (an ``FM`` on ``device``).

    Ids are uniform in [0, 2^30) from the numpy generator ``rng``, made on
    the host and copied to ``device``, so the same seed gives the same ids
    on any device.  Serve and retrieval cells only: the train kind waits
    for FM training (ROADMAP.md, item 16).
    """
    if shape_name not in RECSYS_SHAPES:
        raise ValueError(f"fm has no shape {shape_name!r} "
                         f"(one of {sorted(RECSYS_SHAPES)})")
    shape = RECSYS_SHAPES[shape_name]
    if shape.kind == "train":
        raise NotImplementedError(
            f"fm {shape_name}: FM training is not ported yet "
            "(ROADMAP.md, item 16: FM training)")
    device = torch.device(device)
    if params.emb.device.type != device.type:
        raise ValueError(f"params are on {params.emb.device}, not {device}")
    cfg = params.cfg

    def ids(*shape_):
        arr = rng.integers(0, 1 << 30, shape_, dtype=np.int32)
        return torch.as_tensor(arr).to(device)

    if shape.kind == "serve":
        def step(p, ids_):
            return fm_mod.forward(cfg, p, ids_)

        return Cell("fm", shape_name, step, params,
                    (ids(shape.batch, cfg.n_fields),), shape.batch)

    # retrieval: 1 query x n_candidates
    def step(p, q_, cands_):
        return fm_mod.retrieval_scores(cfg, p, q_, cands_)

    return Cell("fm", shape_name, step, params,
                (ids(cfg.n_fields), ids(shape.n_candidates, cfg.n_fields)),
                shape.n_candidates)
