"""The raw-edge entry points' plain versions (the CPU path of
``matrix_ingest_edges`` and ``matrix_lookup_edges``) against the JAX
package's Pallas ingest and lookup in interpret mode, against the port's
own rectangle dispatch (``dispatch_rectangles`` + ``matrix_ingest``), and
against a numpy mirror of the CUDA kernels' arithmetic
(``csrc/sketch_addr.cuh``: uint32 mix, high-word fastrange, a left binary
search with a signed compare, one tally increment per live edge)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import EdgeBatch as JBatch
from repro.core import KMatrixAccel as JAccel
from repro.core import MatrixSketch as JMatrix
from repro.core import kmatrix_accel as jkma
from repro.core import vertex_stats_from_sample as j_stats
from repro.kernels.ops import accel_matrix_edge_freq as j_accel_edge_freq
from repro.kernels.ops import accel_matrix_ingest as j_accel_ingest
from repro_torch import interop
from repro_torch.common.hashing import HashFamily, fastrange, mix
from repro_torch.core import EdgeBatch, MatrixSketch
from repro_torch.core import kmatrix_accel as tkma
from repro_torch.core import matrix_sketch as tms
from repro_torch.core.routing import RouteTable
from repro_torch.kernels import (
    matrix_ingest_edges,
    matrix_ingest_edges_plain,
    matrix_lookup_edges,
    matrix_lookup_edges_plain,
    matrix_lookup_plain,
    ops,
)
from repro_torch.streams import make_stream

# a budget per depth whose banded plan over the stream's first batch has
# three width classes, one of them a single partition, and a conn width
# that is not a power of two
BUDGETS = {1: 1 << 16, 3: 1 << 16, 7: 1 << 17}
CASES = ("default", "overflow", "turnstile", "empty_route", "negative_ids")


def _batch(case: str):
    stream = make_stream("cit-HepPh", batch_size=2048, scale=0.03)
    src, dst, w = stream.batch_numpy(0)
    rng = np.random.default_rng(len(case))
    if case == "turnstile":  # negative and zero weights among the positive
        w = rng.integers(-2, 4, w.shape).astype(np.int32)
    if case == "negative_ids":  # ids below zero: the keys shifted by as much
        src, dst = src - 600, dst - 600
        src[::7] = rng.integers(-2**31, 0, src[::7].shape).astype(np.int32)
    return stream, src.astype(np.int32), dst.astype(np.int32), w


def _sketches(case: str, depth: int):
    """The JAX sketch and the port's copy of it (via interop)."""
    stream, src, dst, w = _batch("default")
    ref = JAccel.create(bytes_budget=BUDGETS[depth], stats=j_stats(src, dst, w),
                        depth=depth, seed=depth, partitioner="banded")
    if case == "empty_route":  # every edge to the outlier partition
        none = jnp.zeros((0,), jnp.int32)
        ref = ref.replace(route=ref.route.replace(keys=none, part=none))
    if case == "negative_ids":  # shifted keys, some below zero
        ref = ref.replace(route=ref.route.replace(keys=ref.route.keys - 600))
    port = interop.import_state(*interop.export_state(ref), device="cpu")
    return ref, port


def _assert_same_state(port, ref):
    pl, ps = interop.export_state(port)
    rl, rs = interop.export_state(ref)
    assert ps == rs and sorted(pl) == sorted(rl)
    for k in rl:
        assert pl[k].dtype == rl[k].dtype, k
        np.testing.assert_array_equal(pl[k], rl[k], err_msg=k)


@pytest.mark.parametrize("depth", [1, 3, 7])
@pytest.mark.parametrize("case", CASES)
def test_routed_ingest_equals_pallas_and_rectangles(case, depth):
    """One batch into the width-class kMatrix: the port's edge ingest (its
    plain version here) == the JAX package's Pallas ingest in interpret
    mode == the port's rectangle dispatch; pools, conn and overflow."""
    ref, port = _sketches(case, depth)
    rect = tkma.empty_like(port)
    assert 1 in port.class_counts and len(port.class_counts) == 3
    assert port.conn_w & (port.conn_w - 1)  # not a power of two
    _, src, dst, w = _batch(case)
    capacity = 128 if case == "overflow" else None
    ref = jkma.ingest(ref, JBatch.from_numpy(src, dst, w), capacity=capacity)
    batch = EdgeBatch.from_numpy(src, dst, w, device="cpu")
    assert tkma.ingest(port, batch, capacity=capacity) is port  # in place
    ops.rectangle_ingest(rect, batch, capacity=capacity)
    # an empty route sends every live edge to the outlier, past its
    # planned share of the batch: that overflows too
    assert (int(port.overflow) > 0) == (case in ("overflow", "empty_route"))
    _assert_same_state(port, ref)
    _assert_same_state(rect, ref)
    if case == "empty_route":
        outlier = port.route.outlier
        cls, row = int(port.part_class[outlier]), int(port.part_index[outlier])
        live = int(w[w > 0].sum())
        assert int(port.pools[cls][0, row].sum()) == live


@pytest.mark.parametrize("depth", [1, 3, 7])
def test_p1_ingest_and_lookup_equal_pallas(depth):
    """TCM / gMatrix: every nonzero weight, negative ones too, and negative
    ids; w is not a power of two.  Queries == the Pallas lookup and the
    rectangle entry point on ``node_cells``."""
    rng = np.random.default_rng(depth)
    n = 1500
    src = rng.integers(-3000, 3000, n).astype(np.int32)
    dst = rng.integers(-3000, 3000, n).astype(np.int32)
    w = rng.integers(-3, 4, n).astype(np.int32)
    jsk = JMatrix.create(bytes_budget=40_000, depth=depth, seed=depth)
    tsk = MatrixSketch.create(bytes_budget=40_000, depth=depth, seed=depth,
                              device="cpu")
    assert tsk.w & (tsk.w - 1)
    for _ in range(2):
        jsk = j_accel_ingest(jsk, JBatch.from_numpy(src, dst, w))
        tms.ingest(tsk, EdgeBatch.from_numpy(src, dst, w, device="cpu"))
    np.testing.assert_array_equal(tsk.table.numpy(), np.asarray(jsk.table))
    assert int(tsk.table.min()) < 0
    qs = np.concatenate([src[:900], rng.integers(-2**31, 2**31 - 1, 101)])
    qd = np.concatenate([dst[:900], rng.integers(-2**31, 2**31 - 1, 101)])
    qs, qd = qs.astype(np.int32), qd.astype(np.int32)
    expect = np.asarray(j_accel_edge_freq(jsk, jnp.asarray(qs), jnp.asarray(qd)))
    ts, td = torch.as_tensor(qs), torch.as_tensor(qd)
    got = tms.edge_freq(tsk, ts, td)
    np.testing.assert_array_equal(got.numpy(), expect)
    cells = [tms.node_cells(tsk, x).view(depth, 1, -1) for x in (ts, td)]
    np.testing.assert_array_equal(
        got.numpy(), matrix_lookup_plain(tsk.table.unsqueeze(1), *cells)[0].numpy())
    # shape-preserving, any id dtype (int64 ids hash by their low 32 bits)
    got2 = tms.edge_freq(tsk, ts.long().view(1, -1), td.long().view(1, -1))
    assert got2.shape == (1, qs.size)
    np.testing.assert_array_equal(got2[0].numpy(), expect)
    assert tms.edge_freq(tsk, ts[:0], td[:0]).shape == (0,)


# ---------------------------------------------------------------------------
# a numpy mirror of the CUDA kernels' arithmetic

def _np_mix(a, b, x):
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        h = a.astype(np.uint32)[:, None] * x[None] + b.astype(np.uint32)[:, None]
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x7FEB352D)
        h ^= h >> np.uint32(15)
    return h


def _np_fastrange(h, w):
    """__umulhi(h, w)."""
    return ((h.astype(np.uint64) * np.uint64(w)) >> np.uint64(32)).astype(np.int64)


def _np_route(keys, part, outlier, v):
    """sketch::route: a left binary search with a signed compare."""
    n = len(keys)
    lo = np.zeros(v.shape, np.int64)
    hi = np.full(v.shape, n, np.int64)
    while (lo < hi).any():
        active = lo < hi
        mid = (lo + hi) >> 1
        less = active & (keys[np.minimum(mid, n - 1)] < v)
        lo = np.where(less, mid + 1, lo)
        hi = np.where(active & ~less, mid, hi)
    if n == 0:
        return np.full(v.shape, outlier, np.int64)
    at = np.minimum(lo, n - 1)
    return np.where((lo < n) & (keys[at] == v), part[at], outlier)


def _mirror_routed(sk, src, dst, w, capacity):
    """The routed kernel, thread by thread in numpy: int64 counters."""
    a, b = sk.hashes.a.numpy(), sk.hashes.b.numpy()
    hs, ht = _np_mix(a, b, src), _np_mix(a, b, dst)
    p = _np_route(sk.route.keys.numpy(), sk.route.part.numpy(),
                  sk.route.outlier, src)
    cls, row = sk.part_class.numpy()[p], sk.part_index.numpy()[p]
    pools = [pool.numpy().astype(np.int64) for pool in sk.pools]
    layers = np.arange(len(a))[:, None]
    for c, pool in enumerate(pools):
        e = np.nonzero((w > 0) & (cls == c))[0]
        wc = pool.shape[-1]
        np.add.at(pool, (layers, row[e][None], _np_fastrange(hs[:, e], wc),
                         _np_fastrange(ht[:, e], wc)), w[e][None])
    conn = sk.conn.numpy().astype(np.int64)
    cw = sk.conn_w
    np.add.at(conn, (layers, _np_fastrange(hs, cw), _np_fastrange(ht, cw)), w[None])
    seen = np.zeros(len(sk.part_class), np.int64)  # atomicAdd(&n[p], 1)
    tally = 0
    for e in np.nonzero(w > 0)[0]:
        tally += int(seen[p[e]] >= capacity)
        seen[p[e]] += 1
    return pools, conn, tally


@pytest.mark.parametrize("case", ["default", "overflow", "turnstile",
                                  "empty_route", "negative_ids", "above_2_24"])
def test_routed_plain_equals_kernel_mirror(case):
    _, port = _sketches("empty_route" if case == "empty_route" else
                        "negative_ids" if case == "negative_ids" else
                        "default", 3)
    _, src, dst, w = _batch("turnstile" if case == "turnstile" else
                            "negative_ids" if case == "negative_ids" else
                            "default")
    if case == "above_2_24":  # cells far above what a float32 holds exactly
        w = np.random.default_rng(0).integers(1, 1 << 22, w.shape).astype(np.int32)
    capacity = 128 if case == "overflow" else 2048
    pools, conn, tally = _mirror_routed(port, src, dst, w, capacity)
    batch = EdgeBatch.from_numpy(src, dst, w, device="cpu")
    matrix_ingest_edges(port.pools, port.hashes.a, port.hashes.b, batch.src,
                        batch.dst, batch.weight, route=port.route,
                        part_class=port.part_class, part_index=port.part_index,
                        conn=port.conn, overflow=port.overflow,
                        capacity=capacity)
    for got, want in zip(port.pools, pools):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port.conn.numpy(), conn)
    assert int(port.overflow) == tally
    assert (tally > 0) == (case == "overflow")
    if case == "above_2_24":
        assert max(int(p.max()) for p in pools) > 1 << 24


@pytest.mark.parametrize("k", range(17))
def test_mix_and_power_of_two_shift_equal_fastrange(k):
    """For w = 2^k, fastrange(h, w) == h >> (32 - k) (0 at k = 0), on mix
    outputs of negative, sequential and extreme ids; mix == the numpy
    uint32 mirror."""
    rng = np.random.default_rng(k)
    x = np.concatenate([rng.integers(-2**31, 2**31 - 1, 3000),
                        np.arange(-500, 500),
                        [-2**31, -1, 0, 2**31 - 1]]).astype(np.int32)
    fam = HashFamily.create(k, 3, device="cpu")
    h = mix(fam.a, fam.b, torch.as_tensor(x))
    np.testing.assert_array_equal(h.numpy(), _np_mix(fam.a.numpy(), fam.b.numpy(), x))
    np.testing.assert_array_equal(h.numpy(), fam.mix(torch.as_tensor(x)).numpy())
    shift = (h >> (32 - k)) if k else torch.zeros_like(h)
    np.testing.assert_array_equal(fastrange(h, 1 << k).numpy(), shift.numpy())
    np.testing.assert_array_equal(fastrange(h, 1 << k).numpy(),
                                  _np_fastrange(h.numpy().astype(np.uint32), 1 << k))


def test_p1_plain_equals_kernel_mirror_above_2_24():
    rng = np.random.default_rng(4)
    d, w, n = 5, 136, 8000
    fam = HashFamily.create(9, d, device="cpu")
    a, b = fam.a, fam.b
    src = rng.integers(-10, 10, n).astype(np.int32)
    dst = rng.integers(-10, 10, n).astype(np.int32)
    wt = rng.integers(-(1 << 22), 1 << 23, n).astype(np.int32)
    table = torch.zeros((d, 1, w, w), dtype=torch.int32)
    matrix_ingest_edges((table,), a, b, *(torch.as_tensor(x) for x in (src, dst, wt)))
    want = np.zeros((d, w, w), np.int64)
    hs, ht = _np_mix(a.numpy(), b.numpy(), src), _np_mix(a.numpy(), b.numpy(), dst)
    np.add.at(want, (np.arange(d)[:, None], _np_fastrange(hs, w),
                     _np_fastrange(ht, w)), wt[None])
    assert np.abs(want).max() > 1 << 24
    np.testing.assert_array_equal(table[:, 0].numpy(), want)
    got = matrix_lookup_edges(table[:, 0].contiguous(), a, b,
                              torch.as_tensor(src), torch.as_tensor(dst))
    np.testing.assert_array_equal(
        got.numpy(), want[np.arange(d)[:, None], _np_fastrange(hs, w),
                          _np_fastrange(ht, w)].min(0))


# ---------------------------------------------------------------------------
# the wrappers' checks (the same on the CPU and on the card)

def _routed_args(n_classes=3, device="cpu"):
    d, b = 2, 64
    fam = HashFamily.create(0, d, device=device)
    pools = [torch.zeros((d, 1, 8, 8), dtype=torch.int32, device=device)
             for _ in range(n_classes)]
    route = RouteTable(
        keys=torch.arange(4, dtype=torch.int32, device=device),
        part=torch.arange(4, dtype=torch.int32, device=device) % n_classes,
        offsets=torch.zeros(n_classes, dtype=torch.int32, device=device),
        widths=torch.full((n_classes,), 8, dtype=torch.int32, device=device),
        outlier=n_classes - 1, n_partitions=n_classes, max_width=8)
    ids = torch.arange(b, dtype=torch.int32, device=device) % 6
    kw = dict(route=route,
              part_class=torch.arange(n_classes, dtype=torch.int32, device=device),
              part_index=torch.zeros(n_classes, dtype=torch.int32, device=device),
              conn=torch.zeros((d, 5, 5), dtype=torch.int32, device=device),
              overflow=torch.zeros((), dtype=torch.int32, device=device),
              capacity=16)
    return [pools, fam.a, fam.b, ids, ids.clone(), torch.ones_like(ids)], kw


BAD_INGEST = {
    "17 classes": (lambda args, kw: ((_routed_args(17)[0]), _routed_args(17)[1]),
                   ValueError, "1 to 16"),
    "weight int64": (lambda args, kw: (args[:5] + [args[5].long()], kw),
                     TypeError, "weight must be torch.int32"),
    "a int32": (lambda args, kw: (args[:1] + [args[1].int()] + args[2:], kw),
                TypeError, "a must be torch.int64"),
    "strided src": (lambda args, kw: (args[:3] + [args[3][::2], args[4][::2],
                                                  args[5][::2]], kw),
                    ValueError, "src must be contiguous"),
    "conn on meta": (lambda args, kw: (args, {**kw, "conn": kw["conn"].to("meta")}),
                     ValueError, "conn is on meta"),
    "width 12": (lambda args, kw: ([[torch.zeros((2, 1, 12, 12), dtype=torch.int32)]
                                    * 3] + args[1:], kw),
                 ValueError, "powers of two"),
    "no conn": (lambda args, kw: (args, {**kw, "conn": None}),
                ValueError, "needs part_class"),
    "P = 1 with a conn": (lambda args, kw: ([args[0][:1]] + args[1:],
                                            {"conn": kw["conn"]}),
                          ValueError, "belong to a routed"),
    "P = 1 of two rows": (lambda args, kw: ([[torch.zeros((2, 2, 8, 8),
                                                          dtype=torch.int32)]]
                                            + args[1:], {}),
                          ValueError, "one pool"),
    "outlier 7": (lambda args, kw: (args, {**kw, "route": kw["route"].replace(
        outlier=7)}), ValueError, "outlier 7"),
}


@pytest.mark.parametrize("bad", list(BAD_INGEST))
def test_matrix_ingest_edges_refuses_bad_input(bad):
    make, exc, match = BAD_INGEST[bad]
    args, kw = make(*_routed_args())
    before = matrix_ingest_edges.launches
    with pytest.raises(exc, match=match):
        matrix_ingest_edges(*args, **kw)
    assert matrix_ingest_edges.launches == before


def test_matrix_ingest_edges_takes_good_input_on_the_cpu():
    args, kw = _routed_args()
    matrix_ingest_edges(*args, **kw)
    ref_args, ref_kw = _routed_args()
    matrix_ingest_edges_plain(*ref_args, **ref_kw)
    for got, want in zip(args[0], ref_args[0]):
        assert torch.equal(got, want)
    assert sum(int(p.sum()) for p in args[0]) == 2 * 64
    assert int(kw["conn"].sum()) == 2 * 64
    # 64 live edges over 3 partitions (ids 0-3 routed, 4 and 5 to the
    # outlier) at capacity 16
    part = np.asarray([0, 1, 2, 0, 2, 2])[np.arange(64) % 6]
    assert int(kw["overflow"]) == int(np.maximum(
        np.bincount(part, minlength=3) - 16, 0).sum())


BAD_LOOKUP = {
    "table [d, P, w, w]": (lambda t, a, b, s: (t[:, None], a, b, s, s),
                           ValueError, "table must be"),
    "a of d + 1": (lambda t, a, b, s: (t, torch.cat([a, a[:1]]), b, s, s),
                   ValueError, "a, b must be"),
    "src int64": (lambda t, a, b, s: (t, a, b, s.long(), s), TypeError,
                  "src must be torch.int32"),
    "dst shorter": (lambda t, a, b, s: (t, a, b, s, s[:3]), ValueError,
                    "src, dst must be"),
    "strided dst": (lambda t, a, b, s: (t, a, b, s[::2], s[1::2]), ValueError,
                    "must be contiguous"),
    "src on meta": (lambda t, a, b, s: (t, a, b, s.to("meta"), s), ValueError,
                    "src is on meta"),
}


@pytest.mark.parametrize("bad", list(BAD_LOOKUP))
def test_matrix_lookup_edges_refuses_bad_input(bad):
    make, exc, match = BAD_LOOKUP[bad]
    fam = HashFamily.create(0, 3, device="cpu")
    table = torch.zeros((3, 9, 9), dtype=torch.int32)
    src = torch.arange(10, dtype=torch.int32)
    before = matrix_lookup_edges.launches
    with pytest.raises(exc, match=match):
        matrix_lookup_edges(*make(table, fam.a, fam.b, src))
    assert matrix_lookup_edges.launches == before
    out = matrix_lookup_edges(table, fam.a, fam.b, src, src)
    assert torch.equal(out, matrix_lookup_edges_plain(table, fam.a, fam.b, src, src))
