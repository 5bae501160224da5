"""Width-class kMatrix sketches of a chosen class structure and query ids
that reach every routing case, for the tests of the kMatrix query kernels
(``kmatrix_lookup_edges``, ``kmatrix_node_out``) on the CPU and on the
card.  Imports only the port."""
import numpy as np
import torch

from repro_torch.common.hashing import HashFamily
from repro_torch.core import KMatrixAccel
from repro_torch.core.routing import RouteTable

# (class widths, partitions per class): a single class; the serving cell's
# classes 16 / 32 / 64 with 14 / 2 / 1 partitions; the class table's 16
# classes, widths 1 to 256 (a width may repeat: the kernels take any table)
STRUCTURES = {
    "one_class": ((16,), (5,)),
    "cell": ((16, 32, 64), (14, 2, 1)),
    "sixteen": ((1, 2, 4, 8, 16, 32, 64, 128, 256, 4, 8, 16, 32, 64, 2, 128),
                (1, 2, 1, 3, 1, 1, 2, 1, 1, 1, 2, 1, 1, 1, 1, 1)),
}


def class_sketch(structure: str, depth: int, seed: int, device="cpu",
                 near_2_31: bool = False) -> KMatrixAccel:
    """A width-class kMatrix with random counters: partitions dealt to the
    classes in random order, the outlier the last partition, route keys
    negative and positive.  ``near_2_31`` fills the pools with counters
    within 2^22 of 2^31, so that every row sum wraps."""
    widths, counts = STRUCTURES[structure]
    rng = np.random.default_rng(seed)
    part_class = rng.permutation(
        np.repeat(np.arange(len(widths)), counts)).astype(np.int32)
    part_index = np.zeros_like(part_class)
    for c in range(len(widths)):
        members = np.nonzero(part_class == c)[0]
        part_index[members] = np.arange(len(members))
    part_width = np.asarray(widths, np.int32)[part_class]
    n_parts = len(part_class)
    keys = np.unique(rng.integers(-5000, 5000, 40 * n_parts)).astype(np.int32)
    slab = part_width.astype(np.int64) ** 2
    offsets = np.concatenate([[0], np.cumsum(slab)[:-1]]).astype(np.int32)
    lo, hi = (2**31 - 2**22, 2**31 - 1) if near_2_31 else (0, 1000)

    def put(x):
        return torch.as_tensor(x, device=device)

    route = RouteTable(
        keys=put(keys),
        part=put(rng.integers(0, n_parts, len(keys)).astype(np.int32)),
        offsets=put(offsets), widths=put(part_width), outlier=n_parts - 1,
        n_partitions=n_parts, max_width=int(part_width.max()))
    pools = tuple(put(rng.integers(lo, hi, (depth, n, w, w)).astype(np.int32))
                  for w, n in zip(widths, counts))
    return KMatrixAccel(
        pools=pools, conn=torch.zeros((depth, 4, 4), dtype=torch.int32,
                                      device=device),
        overflow=torch.zeros((), dtype=torch.int32, device=device),
        hashes=HashFamily.create(seed, depth, device=device), route=route,
        part_class=put(part_class), part_index=put(part_index),
        part_width=put(part_width), class_widths=tuple(widths),
        class_counts=tuple(counts), conn_w=4)


def query_ids(sk: KMatrixAccel, n: int, seed: int) -> torch.Tensor:
    """int32[n] on the sketch's device: route keys (negative ones among
    them), unseen ids of the outlier partition (any int32) and padded
    zeros, shuffled."""
    rng = np.random.default_rng(seed)
    keys = sk.route.keys.cpu().numpy()
    kind = rng.integers(0, 3, n)
    ids = np.where(kind == 0, rng.choice(keys, n),
                   rng.integers(-2**31, 2**31 - 1, n)).astype(np.int32)
    ids[kind == 2] = 0
    return torch.as_tensor(ids, device=sk.conn.device)
