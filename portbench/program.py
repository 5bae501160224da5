"""The system under test, as the benchmark sees it: the PyTorch and CUDA
port ``repro_torch`` under ``src/``.

Everything the harness takes from the program goes through here: the
sketch module and its planned sketch, the serving registry, engine and
snapshot buffer, the kernels' launch counters and the metrics hub.  The
program's state comes back to the reference only as NumPy arrays and plain
values (``plan_of``, ``counters_of``, ``answer_value``), once the window has
closed.
"""
from __future__ import annotations

import importlib
import sys
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "src"
KERNELS = ("matrix_ingest", "matrix_lookup", "reach_closure")


def import_port():
    """Put ``src`` on the path and import the port's modules the benchmark
    drives; raises ``ImportError`` where the checkout holds no port."""
    if not (SRC / "repro_torch").is_dir():
        raise ImportError(f"no repro_torch package under {SRC}")
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    return importlib.import_module("repro_torch")


def build_kernels(device) -> None:
    """Build the kernels the cells launch, all at once, into the program's
    own cache inside the checkout (``src/repro_torch/kernels/build``); a
    built one is only loaded."""
    if device.type != "cuda":
        return
    from repro_torch.kernels import build
    build.build_all(KERNELS)


def launch_counts() -> dict:
    from repro_torch.kernels import launch_counts as counts
    return counts()


def engine_group_states(since: dict | None = None) -> dict:
    """{family: (sum of seconds, count)} of the hub histogram
    ``repro_engine_group_seconds{family=...}`` so far, or its change since
    an earlier reading."""
    from repro_torch.obs.hub import get_hub

    from portbench.traffic.requests import FAMILIES
    hub = get_hub()
    out = {}
    for family in FAMILIES:
        st = hub.histogram("repro_engine_group_seconds", family=family).state()
        s0, c0 = (since or {}).get(family, (0.0, 0))
        out[family] = (float(st["sum"]) - s0, int(st["count"]) - c0)
    return out


def planned_sketch(config: dict, sample_stream, seed: int, device):
    """(sketch, module) as ``launch/stream_ingest.run_pipeline`` builds it:
    the program's reservoir sample of ``sample_stream`` (keyed seed + 1),
    its vertex statistics and ``build_sketch`` for the configuration."""
    from repro_torch.core import vertex_stats_from_sample
    from repro_torch.serving.registry import build_sketch
    from repro_torch.streams import sample_stream as sample

    from portbench.traffic.stream import sample_size
    stats = vertex_stats_from_sample(
        *sample(sample_stream, sample_size(config), seed=seed + 1))
    return build_sketch(config["sketch"], int(config["budget_kb"]) * 1024,
                        stats, int(config["depth"]), seed,
                        config.get("partitioner", "banded"),
                        backend=config.get("sketch_backend") or None,
                        device=device)


def open_tenant(config: dict, batch_edges: int, seed: int, device):
    """One tenant of a ``SketchRegistry`` for the configuration, as
    ``launch/query_serve.py`` opens it (the registry builds its own stream,
    sample and plan from the seed)."""
    from repro_torch.serving import SketchRegistry

    registry = SketchRegistry(
        depth=int(config["depth"]), batch_size=batch_edges,
        sample_size=int(config["sample_size"]),
        scale=float(config.get("scale", 1.0)),
        partitioner=config.get("partitioner", "banded"),
        sketch_backend=config.get("sketch_backend") or None, device=device)
    return registry.open(config["stream"]["name"], config["sketch"],
                         int(config["budget_kb"]), seed=seed)


def edge_batch(src, dst, weight, device):
    from repro_torch.core import EdgeBatch
    return EdgeBatch.from_numpy(src, dst, weight, device=device)


def to_request(req: tuple):
    """The program's ``Request`` for one of the generator's tuples."""
    from repro_torch.serving import engine as eng
    fam = req[0]
    if fam == "edge_freq":
        return eng.edge_freq(req[1], req[2])
    if fam == "reach":
        return eng.reach(req[1], req[2])
    if fam == "node_out":
        return eng.node_out(req[1])
    if fam == "path_weight":
        return eng.path_weight(req[1])
    if fam == "subgraph_weight":
        return eng.subgraph_weight(req[1])
    if fam == "heavy_nodes":
        return eng.heavy_nodes(req[1], req[2])
    raise ValueError(f"unknown family {fam!r}")


def answer_value(value):
    """A result's value as plain Python / NumPy."""
    if isinstance(value, tuple):
        return tuple(np.asarray(v) for v in value)
    return value


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def plan_of(sk) -> dict:
    """The program's plan of a sketch, as arrays."""
    out = {"a": _host(sk.hashes.a), "b": _host(sk.hashes.b)}
    if hasattr(sk, "table"):
        out["w"] = int(sk.w)
        return out
    out.update(route_keys=_host(sk.route.keys), route_part=_host(sk.route.part),
               outlier=int(sk.route.outlier), part_width=_host(sk.part_width),
               part_class=_host(sk.part_class),
               part_index=_host(sk.part_index),
               class_widths=tuple(sk.class_widths),
               class_counts=tuple(sk.class_counts), conn_w=int(sk.conn_w))
    return out


def counters_of(sk) -> dict:
    """The program's counters of a sketch, as arrays."""
    if hasattr(sk, "table"):
        return {"table": _host(sk.table)}
    return {"pools": [_host(p) for p in sk.pools], "conn": _host(sk.conn)}


def snapshot_buffer(sketch, mod, tenant_id: str, kind: str):
    """A ``SnapshotBuffer`` over ``sketch`` whose ingest runs ``mod``'s (a
    stand-in for the program's sketch module)."""
    from repro_torch.serving import SnapshotBuffer
    return SnapshotBuffer(sketch, mod, tenant_id=tenant_id, kind=kind)
