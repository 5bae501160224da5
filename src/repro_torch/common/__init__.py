from repro_torch.common.hashing import HashFamily, fastrange, hash_pair_mix
from repro_torch.common.struct import (
    static_field,
    tensor_dataclass,
    tree_size_bytes,
)

__all__ = ["HashFamily", "fastrange", "hash_pair_mix", "static_field",
           "tensor_dataclass", "tree_size_bytes"]
