"""Input-shape sets, one per architecture family: the port's copy of
``repro/configs/shapes.py``."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


LM_SHAPES = {
    "train_4k": LMShape("train_4k", "train", 4_096, 256),
    "prefill_32k": LMShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": LMShape("decode_32k", "decode", 32_768, 128),
    "long_500k": LMShape("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    kind: str  # "full" | "sampled" | "batched"
    n_nodes: int
    n_edges: int
    d_feat: int
    batch_graphs: int = 1
    batch_nodes: int = 0  # sampled-training seed nodes
    fanout: tuple[int, ...] = ()


GNN_SHAPES = {
    "full_graph_sm": GNNShape("full_graph_sm", "full", 2_708, 10_556, 1_433),
    "minibatch_lg": GNNShape(
        "minibatch_lg", "sampled", 232_965, 114_615_892, 602,
        batch_nodes=1_024, fanout=(15, 10),
    ),
    "ogb_products": GNNShape("ogb_products", "full", 2_449_029, 61_859_140, 100),
    "molecule": GNNShape("molecule", "batched", 30, 64, 16, batch_graphs=128),
}


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


def sampled_subgraph_sizes(shape: GNNShape) -> tuple[int, int]:
    """(n_nodes, n_edges) of the padded sampled subgraph for minibatch shapes."""
    layers = [shape.batch_nodes]
    for f in shape.fanout:
        layers.append(layers[-1] * f)
    n_nodes = sum(layers)
    n_edges = sum(layers[1:])  # one edge per sampled neighbour
    return n_nodes, n_edges
