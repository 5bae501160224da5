from repro_torch.streams.generators import (
    DATASETS,
    StreamSpec,
    SyntheticStream,
    make_stream,
)
from repro_torch.streams.reservoir import Reservoir, sample_stream

__all__ = [
    "DATASETS",
    "StreamSpec",
    "SyntheticStream",
    "make_stream",
    "Reservoir",
    "sample_stream",
]
