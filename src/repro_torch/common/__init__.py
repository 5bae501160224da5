from repro_torch.common.hashing import HashFamily, fastrange
from repro_torch.common.struct import static_field, tensor_dataclass

__all__ = ["HashFamily", "fastrange", "static_field", "tensor_dataclass"]
