"""Peaks of the chip and the work each kernel's inputs need, for the
``*_roofline`` metrics: the least time the chip could take over the
kernel's measured device time.

Peaks: one NVIDIA H100 SXM (80 GB HBM3) at its 700 W limit, from NVIDIA's
data sheet: 3.35 TB/s of memory bandwidth and 67 TFLOP/s in float32
outside the tensor cores.  The sketch kernels do integer work (hashing,
routing, adds); it is held against the 67 T operations a second of the
float32 pipes, and it is the bytes that bound every shape here.

Bytes count each input byte once and each output byte once: the edge
arrays, the hash family, the routing tables, and every counter the
call touches (read and, for an ingest, written back), counted once however
many updates it takes.  Operations count, per edge and layer,
the two endpoint hashes (7 each: multiply, add, shift, xor, multiply,
shift, xor), the reductions to a width (2 each), the address (2 each
array) and the add; and per edge of a kMatrix one binary search
of the routing keys.  Padding is no work the inputs need and is not
counted.
"""
from __future__ import annotations

import numpy as np

from portbench.reference.plan import Plan

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S)


def _distinct(idx: np.ndarray) -> int:
    return int(np.unique(idx.ravel()).size)


def ingest_work(plan: Plan, layout, src, dst, weight) -> tuple[float, float]:
    """(bytes, operations) one ``matrix_ingest_edges`` call needs for a
    batch of edges."""
    from portbench.reference.control import batch_cells
    n = len(src)
    d = plan.depth
    idx, _ = batch_cells(layout, src, dst, weight)
    counters = _distinct(idx)
    nbytes = 12 * n + 16 * d + 8 * counters
    if plan.kind == "gmatrix":
        ops = n * d * (14 + 2 + 2 + 1)
    else:
        nbytes += 8 * len(plan.route_keys) + 8 * len(plan.widths)
        search = max(1, int(len(plan.route_keys)).bit_length())
        ops = n * (search + d * (14 + 2 * (2 + 2 + 1)))
    return float(nbytes), float(ops)

