"""Distributed sketching on ``torch.distributed``: ranks and their process
group (``group``), and the data- and partition-parallel kMatrix
(``sketch_parallel``), the JAX package's ``repro.distributed`` on the port."""
from repro_torch.distributed.group import (
    RankFailure,
    choose_topology,
    collective_stats,
    reset_collective_stats,
    run_ranks,
)
from repro_torch.distributed.sketch_parallel import (
    build_owner_map,
    make_dp_edge_freq,
    make_dp_ingest,
    make_pp_edge_freq,
    make_pp_ingest,
    stacked_state,
)

__all__ = [
    "RankFailure",
    "build_owner_map",
    "choose_topology",
    "collective_stats",
    "make_dp_edge_freq",
    "make_dp_ingest",
    "make_pp_edge_freq",
    "make_pp_ingest",
    "reset_collective_stats",
    "run_ranks",
    "stacked_state",
]
