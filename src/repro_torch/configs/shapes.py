"""Input-shape sets, one per architecture family.

The port's copy of the recsys part of ``repro/configs/shapes.py``; the LM
and GNN shapes come with the cells that use them (ROADMAP.md, §A).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RecsysShape:
    name: str
    kind: str  # "train" | "serve" | "retrieval"
    batch: int
    n_candidates: int = 0


RECSYS_SHAPES = {
    "train_batch": RecsysShape("train_batch", "train", 65_536),
    "serve_p99": RecsysShape("serve_p99", "serve", 512),
    "serve_bulk": RecsysShape("serve_bulk", "serve", 262_144),
    "retrieval_cand": RecsysShape("retrieval_cand", "retrieval", 1, n_candidates=1_000_000),
}
