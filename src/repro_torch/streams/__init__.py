from repro_torch.streams.generators import (
    DATASETS,
    FileStream,
    StreamSpec,
    SyntheticStream,
    make_stream,
)
from repro_torch.streams.reservoir import Reservoir, sample_stream

__all__ = [
    "DATASETS",
    "FileStream",
    "StreamSpec",
    "SyntheticStream",
    "make_stream",
    "Reservoir",
    "sample_stream",
]
