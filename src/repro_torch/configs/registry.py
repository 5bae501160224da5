"""Architecture registry and cell builder: the FM part of
``repro/configs/registry.py``.

A cell is (arch x shape): the step function and its inputs.  The port
builds the FM's train, serve and retrieval cells on one card.  The JAX
package's LM and GNN cells and its shardings come with the dry-run slice
(ROADMAP.md, §A); its mesh is ``repro_torch.launch.mesh``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.recsys import fm as fm_mod
from repro_torch.training import AdamWConfig, init_train_state, make_train_step
from repro_torch.training.steps import fm_loss_fn

# the JAX package's FM train cell (repro/configs/registry.py build_fm_cell)
FM_TRAIN_OPT = AdamWConfig(lr_peak=1e-3, warmup_steps=100, total_steps=5000)


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
    or the candidates of a retrieval).  A train cell's ``params`` is a
    ``TrainState``: ``run()`` takes one step, keeps the new state and
    returns the step's metrics."""

    arch: str
    shape: str
    step_fn: Callable
    params: Any
    inputs: tuple
    rows: int
    train: bool = False

    def run(self):
        out = self.step_fn(self.params, *self.inputs)
        if not self.train:
            return out
        self.params, metrics = out
        return metrics


def build_fm_cell(shape_name: str, params, rng: np.random.Generator,
                  device="cuda") -> Cell:
    """The FM cell ``shape_name`` over ``params`` (an ``FM`` on ``device``).

    Ids are uniform in [0, 2^30) from the numpy generator ``rng``, made on
    the host and copied to ``device``, so the same seed gives the same ids
    on any device.  The train kind: labels in {0, 1} from the same
    generator, after the ids; ``params`` must require grad, and the cell
    holds a fresh ``TrainState`` over them (AdamW as the JAX package's FM
    train cell sets it, ``FM_TRAIN_OPT``).
    """
    if shape_name not in RECSYS_SHAPES:
        raise ValueError(f"fm has no shape {shape_name!r} "
                         f"(one of {sorted(RECSYS_SHAPES)})")
    shape = RECSYS_SHAPES[shape_name]
    device = torch.device(device)
    if params.emb.device.type != device.type:
        raise ValueError(f"params are on {params.emb.device}, not {device}")
    cfg = params.cfg

    def ids(*shape_):
        arr = rng.integers(0, 1 << 30, shape_, dtype=np.int32)
        return torch.as_tensor(arr).to(device)

    if shape.kind == "train":
        if not all(p.requires_grad for p in params.parameters()):
            raise ValueError("fm train_batch trains its params: make them "
                             "with requires_grad=True")
        batch = {"ids": ids(shape.batch, cfg.n_fields)}
        labels = rng.integers(0, 2, shape.batch).astype(np.float32)
        batch["labels"] = torch.as_tensor(labels).to(device)
        return Cell("fm", shape_name,
                    make_train_step(fm_loss_fn(cfg), FM_TRAIN_OPT),
                    init_train_state(params, FM_TRAIN_OPT), (batch,),
                    shape.batch, train=True)

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
