"""The port's CUDA kernels on the card, against their plain versions.

These need an NVIDIA card (Hopper: the kernels are built for sm_90a) and
skip elsewhere.  On the card:  python -m pytest -q -m cuda tests/
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.common.hashing import HashFamily
from repro_torch.configs import registry
from repro_torch.core import EdgeBatch, KMatrixAccel, vertex_stats_from_sample
from repro_torch.core import kmatrix_accel as tkma
from repro_torch.kernels import (
    embedding_bag,
    embedding_bag_plain,
    matrix_ingest,
    matrix_ingest_edges,
    matrix_ingest_edges_plain,
    matrix_ingest_plain,
    matrix_lookup,
    matrix_lookup_edges,
    matrix_lookup_edges_plain,
    matrix_lookup_plain,
    ops,
    reach_closure,
    reach_closure_plain,
    reach_step,
    reach_step_plain,
)
from repro_torch.kernels.reach_closure import CLOSURE_MAX_W
from repro_torch.core import queries as tq
from repro_torch.launch import query_serve, stream_ingest
from repro_torch.models.recsys import fm as tfm
from repro_torch.serving import QueryEngine, SketchRegistry, gates, synth_requests
from repro_torch.serving import engine as eng
from repro_torch.serving import mix_for_sketch
from repro_torch.streams import make_stream

pytestmark = pytest.mark.cuda

# the modules, which the package shadows with its wrappers of the same name
eb = importlib.import_module("repro_torch.kernels.embedding_bag")
mi = importlib.import_module("repro_torch.kernels.matrix_ingest")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("d,p,w,c", [(1, 1, 8, 32), (7, 14, 16, 8192),
                                     (7, 2, 32, 8192), (3, 5, 128, 1000)])
def test_matrix_ingest_kernel_equals_plain(card, d, p, w, c):
    rng = np.random.default_rng(d * w + c)
    pool = torch.as_tensor(rng.integers(-9, 9, (d, p, w, w)).astype(np.int32),
                           device=card)
    # out-of-range slots are dropped; wt == 0 is padding; weights may be < 0
    hi = torch.as_tensor(rng.integers(-2, w + 2, (d, p, c)).astype(np.int32),
                         device=card)
    hj = torch.as_tensor(rng.integers(-2, w + 2, (d, p, c)).astype(np.int32),
                         device=card)
    wt = torch.as_tensor(rng.integers(-2, 3, (p, c)).astype(np.int32),
                         device=card)
    before = matrix_ingest.launches
    out = matrix_ingest(pool.clone(), hi, hj, wt)
    assert matrix_ingest.launches == before + 1
    expect = matrix_ingest_plain(pool.clone(), hi, hj, wt)
    torch.cuda.synchronize()
    assert torch.equal(out, expect)


# fragment edges (1, 15, 16, 17), the path's widths (43, 136), ragged
# edges (65, 200), both tile sizes (1024 takes 128 x 128 at d = 3, the
# rest 32 x 32), sparse to full
@pytest.mark.parametrize("density", [0.002, 0.05, 1.0])
@pytest.mark.parametrize("w", [1, 15, 16, 17, 43, 64, 65, 136, 200, 1024])
def test_reach_step_kernel_equals_plain(card, w, density):
    gen = torch.Generator(device=card).manual_seed(w)
    reach = (torch.rand((3, w, w), generator=gen, device=card) < density).float()
    before = reach_step.launches
    for _ in range(3):
        out, expect = reach_step(reach), reach_step_plain(reach)
        assert torch.equal(out, expect)
        reach = out
    assert reach_step.launches == before + 3


def _graph(kind: str, w: int, card) -> torch.Tensor:
    """int32[2, w, w] counters: a path 0 -> 1 -> ... (its closure needs
    every squaring), a complete graph (one squaring) or a sparse random
    graph, the second layer a shuffled copy of the first."""
    if kind == "path":
        layer = torch.zeros((w, w), dtype=torch.int32)
        layer[torch.arange(w - 1), torch.arange(1, w)] = 3
    elif kind == "complete":
        layer = torch.ones((w, w), dtype=torch.int32)
    else:
        rng = np.random.default_rng(w)
        layer = torch.as_tensor((rng.integers(1, 4, (w, w))
                                 * (rng.random((w, w)) < 2.0 / w)).astype(np.int32))
    perm = torch.as_tensor(np.random.default_rng(w + 1).permutation(w))
    return torch.stack([layer, layer[perm][:, perm]]).contiguous().to(card)


@pytest.mark.parametrize("max_hops", [None, 3])
@pytest.mark.parametrize("kind", ["path", "complete", "random"])
@pytest.mark.parametrize("w", [1, 2, 15, 16, 17, 43, 100, 136, 200,
                               CLOSURE_MAX_W])
def test_reach_closure_kernel_equals_plain(card, w, kind, max_hops):
    table = _graph(kind, w, card)
    steps = tq._closure_steps(w, max_hops)
    before = reach_closure.launches
    out = reach_closure(table, steps)
    assert reach_closure.launches == before + 1
    expect = reach_closure_plain(table, steps)
    torch.cuda.synchronize()
    assert out.dtype == torch.bool and out.shape == (2, w, w)
    assert torch.equal(out, expect)
    if kind == "path" and max_hops is None and w > 2:
        upper = torch.ones((w, w), dtype=torch.bool, device=card).triu()
        assert torch.equal(out[0], upper)
        # the path needs all ceil(log2(w - 1)) squarings: one fewer leaves
        # its far end unreached
        need = (w - 2).bit_length()
        assert bool(reach_closure(table, need)[0, 0, w - 1])
        assert not bool(reach_closure(table, need - 1)[0, 0, w - 1])


def test_accel_reach_closure_above_the_limit_cascades(card):
    w = CLOSURE_MAX_W + 1
    table = _graph("random", w, card)
    steps = tq._closure_steps(w, None)
    before = (reach_closure.launches, reach_step.launches)
    out = ops.accel_reach_closure(table)
    assert (reach_closure.launches, reach_step.launches) == (
        before[0], before[1] + steps)
    assert torch.equal(out, reach_closure_plain(table, steps))
    with pytest.raises(ValueError, match=f"w <= {CLOSURE_MAX_W}"):
        reach_closure(table, steps)


@pytest.mark.parametrize("d,p,w,c", [(1, 1, 8, 32), (7, 1, 136, 10_000),
                                     (3, 5, 128, 1000), (7, 64, 128, 8192),
                                     (2, 3, 17, 1)])
def test_matrix_lookup_kernel_equals_plain(card, d, p, w, c):
    rng = np.random.default_rng(d * w + c)
    pool = torch.as_tensor(
        rng.integers(-2**31, 2**31 - 1, (d, p, w, w)).astype(np.int32),
        device=card)
    hi = torch.as_tensor(rng.integers(0, w, (d, p, c)).astype(np.int32),
                         device=card)
    hj = torch.as_tensor(rng.integers(0, w, (d, p, c)).astype(np.int32),
                         device=card)
    before = matrix_lookup.launches
    out = matrix_lookup(pool, hi, hj)
    assert matrix_lookup.launches == before + 1
    expect = matrix_lookup_plain(pool, hi, hj)
    torch.cuda.synchronize()
    assert out.shape == (p, c) and out.dtype == torch.int32
    assert torch.equal(out, expect)


def test_wrappers_check_inputs_on_card(card):
    pool = torch.zeros((1, 1, 8, 8), dtype=torch.int32, device=card)
    hi = torch.zeros((1, 1, 16), dtype=torch.int32, device=card)
    wt = torch.zeros((1, 16), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="pool on"):
        matrix_ingest(pool, hi.cpu(), hi, wt)
    with pytest.raises(TypeError):
        reach_step(torch.zeros((1, 4, 4), dtype=torch.float64, device=card))
    before = matrix_lookup.launches
    with pytest.raises(ValueError, match="pool on"):
        matrix_lookup(pool, hi.cpu(), hi)
    with pytest.raises(TypeError):
        matrix_lookup(pool, hi.long(), hi)
    with pytest.raises(ValueError, match="contiguous"):
        matrix_lookup(pool, hi[:, :, ::2], hi[:, :, ::2])
    with pytest.raises(ValueError, match="hi/hj must be"):
        matrix_lookup(pool, hi, hi[:, :, :8])
    assert matrix_lookup.launches == before


@pytest.mark.parametrize("sketch", ["kmatrix", "gmatrix"])
def test_stream_ingest_on_card_equals_cpu(card, sketch):
    flags = ["--scale", "0.03", "--budget-kb", "64", "--depth", "3",
             "--eval-queries", "500", "--sketch", sketch]
    parser = stream_ingest.build_parser()
    counters = (matrix_ingest_edges, matrix_lookup_edges, matrix_ingest,
                matrix_lookup)
    before = [fn.launches for fn in counters]
    gpu = stream_ingest.inline_main(parser.parse_args([*flags, "--device", "cuda"]))
    # one edge-ingest launch per batch; one edge-lookup launch for the
    # gMatrix queries (kMatrix queries are gathers); no rectangle launch
    lookups = 1 if sketch == "gmatrix" else 0
    assert [fn.launches - n for fn, n in zip(counters, before)] == [
        gpu["batches"], lookups, 0, 0]
    cpu = stream_ingest.inline_main(parser.parse_args([*flags, "--device", "cpu"]))
    gl, gs = interop.export_state(gpu["sketch"])
    cl, cs = interop.export_state(cpu["sketch"])
    assert gs == cs
    for k in cl:
        np.testing.assert_array_equal(gl[k], cl[k], err_msg=k)
    assert gpu["ARE"] == cpu["ARE"]


# ragged B * D (not a multiple of the 256-thread block), D = 1 and 10 of
# the FM, a wide D, and a table of more than 2^31 floats (64-bit offsets)
@pytest.mark.parametrize("v,d,b,f", [(1000, 10, 512, 39), (1000, 1, 333, 39),
                                     (50, 128, 7, 2), (1, 3, 1, 1),
                                     (17, 10, 101, 5), (2_200_000, 1000, 3, 4)])
@pytest.mark.parametrize("weighted", [False, True], ids=["sum", "weighted"])
def test_embedding_bag_kernel_equals_plain(card, v, d, b, f, weighted):
    rng = np.random.default_rng(v + d + b + f)
    gen = torch.Generator(device=card).manual_seed(v + d)
    table = torch.randn((v, d), generator=gen, device=card)
    idx = torch.as_tensor(rng.integers(0, v, (b, f)).astype(np.int32),
                          device=card)
    if v * d > 2**31:  # a row whose offset passes 2^31 floats
        idx[:, 0] = v - 1
    wts = (torch.as_tensor(rng.normal(size=(b, f)).astype(np.float32),
                           device=card) if weighted else None)
    before = embedding_bag.launches
    out = embedding_bag(table, idx, wts)
    assert embedding_bag.launches == before + 1
    expect = embedding_bag_plain(table, idx, wts)
    torch.cuda.synchronize()
    assert out.shape == (b, d) and out.dtype == torch.float32
    assert torch.equal(out, expect)


@pytest.mark.parametrize("weighted", [False, True], ids=["sum", "weighted"])
@pytest.mark.parametrize("f", [1, 31, 32, 33, 39, 64])
@pytest.mark.parametrize("d", [1, 2, 3, 10, 16, 128])
def test_embedding_bag_vector_paths_equal_plain(card, d, f, weighted):
    """Every vector width (D = 1, 3: float; 2, 10: float2; 16, 128:
    float4), field counts around a warp, a ragged B of small and large
    batches (4 bags a block and full blocks)."""
    rng = np.random.default_rng(d * 100 + f)
    v = 5000
    table = torch.as_tensor(rng.normal(size=(v, d)).astype(np.float32),
                            device=card)
    for b in (1, 300, 4099):
        idx = torch.as_tensor(rng.integers(0, v, (b, f)).astype(np.int32),
                              device=card)
        wts = (torch.as_tensor(rng.normal(size=(b, f)).astype(np.float32),
                               device=card) if weighted else None)
        before = embedding_bag.launches
        out = embedding_bag(table, idx, wts)
        assert embedding_bag.launches == before + 1
        expect = embedding_bag_plain(table, idx, wts)
        torch.cuda.synchronize()
        assert torch.equal(out, expect), (b, f, d)


@pytest.mark.parametrize("d", [2, 10, 16])
def test_embedding_bag_unaligned_table_takes_the_scalar_path(card, d):
    """A contiguous table view 4 bytes past an 8-byte boundary: the plan
    falls back to scalar loads, and the result stays bit-equal."""
    rng = np.random.default_rng(d)
    v, b, f = 3000, 700, 39
    flat = torch.as_tensor(rng.normal(size=v * d + 1).astype(np.float32),
                           device=card)
    table = flat[1:].view(v, d)
    assert table.is_contiguous() and table.data_ptr() % 8 == 4
    assert eb.bag_plan(b, f, d, table.data_ptr(), False)[0] == 1
    idx = torch.as_tensor(rng.integers(0, v, (b, f)).astype(np.int32),
                          device=card)
    wts = torch.as_tensor(rng.normal(size=(b, f)).astype(np.float32),
                          device=card)
    for w in (None, wts):
        assert torch.equal(embedding_bag(table, idx, w),
                           embedding_bag_plain(table, idx, w))


@pytest.mark.parametrize("weighted", [False, True], ids=["sum", "weighted"])
def test_embedding_bag_staged_in_chunks_equals_plain(card, weighted):
    """More fields than a block can stage at once: the partial sums pass
    through the output between chunks, unchanged in order and bits."""
    rng = np.random.default_rng(5)
    v, b, f, d = 2000, 40_000, 200, 1
    plan = eb.bag_plan(b, f, d, 256, weighted)
    assert plan[3] < f  # chunked
    table = torch.as_tensor(rng.normal(size=(v, d)).astype(np.float32),
                            device=card)
    idx = torch.as_tensor(rng.integers(0, v, (b, f)).astype(np.int32),
                          device=card)
    wts = (torch.as_tensor(rng.normal(size=(b, f)).astype(np.float32),
                           device=card) if weighted else None)
    out = embedding_bag(table, idx, wts)
    assert torch.equal(out, embedding_bag_plain(table, idx, wts))


def test_embedding_bag_checks_inputs_on_card(card):
    table = torch.zeros((8, 10), device=card)
    idx = torch.zeros((4, 3), dtype=torch.int32, device=card)
    before = embedding_bag.launches
    with pytest.raises(ValueError, match="table on"):
        embedding_bag(table, idx.cpu())
    with pytest.raises(TypeError):
        embedding_bag(table, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(table, idx[:, ::2])
    assert embedding_bag.launches == before


@pytest.mark.parametrize("shape", ["serve_p99", "retrieval_cand"])
def test_fm_cells_on_card_equal_cpu(card, shape):
    cfg = tfm.FMConfig(total_vocab=100_000, n_fields=39, embed_dim=10)
    params = tfm.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                             device=card)
    cell = registry.build_fm_cell(shape, params, np.random.default_rng(0),
                                  device=card)
    before = embedding_bag.launches
    out = cell.run()
    torch.cuda.synchronize()
    assert embedding_bag.launches - before == (3 if shape == "serve_p99" else 6)
    cpu = tfm.FM(cfg, params.emb.cpu(), params.lin.cpu(), params.bias.cpu())
    ref = cell.step_fn(cpu, *(x.cpu() for x in cell.inputs))
    # bags bit-equal; the k-sum, the tail and the GEMV run in another order
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the raw-edge entry points

def _routed_sketch(depth: int, card, case: str = "default"):
    """A width-class kMatrix on the CPU and its copy on the card: the banded
    plan of the cit-HepPh stream's first batch (three width classes, one
    of a single partition; conn_w not a power of two)."""
    stream = make_stream("cit-HepPh", batch_size=2048, scale=0.03)
    src, dst, w = stream.batch_numpy(0)
    budget = {1: 1 << 16, 3: 1 << 16, 7: 1 << 17}[depth]
    sk = KMatrixAccel.create(bytes_budget=budget,
                             stats=vertex_stats_from_sample(src, dst, w),
                             depth=depth, seed=depth, partitioner="banded",
                             device="cpu")
    if case == "empty_route":
        none = torch.zeros(0, dtype=torch.int32)
        sk = sk.replace(route=sk.route.replace(keys=none, part=none))
    if case == "negative_ids":
        sk = sk.replace(route=sk.route.replace(keys=sk.route.keys - 600))
    rng = np.random.default_rng(depth)
    if case == "turnstile":
        w = rng.integers(-2, 4, w.shape).astype(np.int32)
    if case == "negative_ids":
        src, dst = src - 600, dst - 600
        src[::7] = rng.integers(-2**31, 0, src[::7].shape).astype(np.int32)
    if case == "above_2_24":
        w = rng.integers(1, 1 << 22, w.shape).astype(np.int32)
    batch = EdgeBatch.from_numpy(src, dst, w, device="cpu")
    on_card = interop.import_state(*interop.export_state(sk), device=card)
    return sk, on_card, batch


def _ingest_args(sk, batch, capacity):
    return ((sk.pools, sk.hashes.a, sk.hashes.b, batch.src, batch.dst,
             batch.weight),
            dict(route=sk.route, part_class=sk.part_class,
                 part_index=sk.part_index, conn=sk.conn, overflow=sk.overflow,
                 capacity=capacity))


@pytest.mark.parametrize("layers_per_thread", [1, 2, 7])
@pytest.mark.parametrize("case,depth", [
    ("default", 1), ("default", 3), ("default", 7), ("overflow", 7),
    ("turnstile", 3), ("empty_route", 3), ("negative_ids", 7),
    ("above_2_24", 7)])
def test_matrix_ingest_edges_kernel_equals_plain(card, monkeypatch, case,
                                                 depth, layers_per_thread):
    """The routed kernel == its plain version on the CPU: pools, conn and
    the overflow tally; two runs bit-identical (atomics commute); one launch
    per call, whatever the layers a thread takes."""
    monkeypatch.setattr(mi, "LAYERS_PER_THREAD", layers_per_thread)
    cpu, gpu, batch = _routed_sketch(depth, card, case)
    capacity = 128 if case == "overflow" else 2048
    args, kw = _ingest_args(cpu, batch, capacity)
    matrix_ingest_edges_plain(*args, **kw)
    runs = []
    for _ in range(2):
        sk = tkma.empty_like(gpu)
        before = matrix_ingest_edges.launches
        args, kw = _ingest_args(sk, batch.replace(
            src=batch.src.to(card), dst=batch.dst.to(card),
            weight=batch.weight.to(card)), capacity)
        matrix_ingest_edges(*args, **kw)
        assert matrix_ingest_edges.launches == before + 1
        torch.cuda.synchronize()
        runs.append(interop.export_state(sk)[0])
    want = interop.export_state(cpu)[0]
    for k in want:
        np.testing.assert_array_equal(runs[0][k], want[k], err_msg=k)
        np.testing.assert_array_equal(runs[1][k], runs[0][k], err_msg=k)
    assert (int(cpu.overflow) > 0) == (case == "overflow")
    if case == "above_2_24":
        assert max(int(p.max()) for p in cpu.pools) > 1 << 24


@pytest.mark.parametrize("layers_per_thread", [1, 7])
@pytest.mark.parametrize("d,w,n", [(1, 8, 1), (3, 57, 1500), (7, 136, 8192),
                                   (7, 136, 100_003), (2, 4096, 5000)])
def test_matrix_ingest_edges_p1_kernel_equals_plain(card, monkeypatch, d, w, n,
                                                    layers_per_thread):
    """P = 1 (TCM / gMatrix): every nonzero weight, negative ones and
    cells above 2^24 too, negative ids, w not a power of two."""
    monkeypatch.setattr(mi, "LAYERS_PER_THREAD", layers_per_thread)
    rng = np.random.default_rng(d * w + n)
    fam = HashFamily.create(d, d, device=card)
    ids = [torch.as_tensor(rng.integers(-50, 50, n).astype(np.int32), device=card)
           for _ in range(2)]
    wt = torch.as_tensor(rng.integers(-(1 << 22), 1 << 23, n).astype(np.int32),
                         device=card)
    tables = [torch.zeros((d, 1, w, w), dtype=torch.int32, device=card)
              for _ in range(3)]
    before = matrix_ingest_edges.launches
    matrix_ingest_edges((tables[0],), fam.a, fam.b, *ids, wt)
    matrix_ingest_edges((tables[1],), fam.a, fam.b, *ids, wt)
    assert matrix_ingest_edges.launches == before + 2
    matrix_ingest_edges_plain((tables[2],), fam.a, fam.b, *ids, wt)
    torch.cuda.synchronize()
    assert torch.equal(tables[0], tables[2]) and torch.equal(tables[0], tables[1])


# d = 8 and 11 take one and two chunks of the kernel's 8 layers
@pytest.mark.parametrize("d,w,n", [(1, 8, 1), (7, 136, 10_000), (3, 57, 0),
                                   (2, 1000, 100_003), (7, 4096, 4097),
                                   (8, 64, 3000), (11, 64, 3000)])
def test_matrix_lookup_edges_kernel_equals_plain(card, d, w, n):
    rng = np.random.default_rng(d * w + n)
    table = torch.as_tensor(
        rng.integers(-2**31, 2**31 - 1, (d, w, w)).astype(np.int32), device=card)
    fam = HashFamily.create(w, d, device=card)
    src = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
                          device=card)
    dst = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
                          device=card)
    before = matrix_lookup_edges.launches
    out = matrix_lookup_edges(table, fam.a, fam.b, src, dst)
    assert matrix_lookup_edges.launches == before + 1
    expect = matrix_lookup_edges_plain(table, fam.a, fam.b, src, dst)
    torch.cuda.synchronize()
    assert out.shape == (n,) and out.dtype == torch.int32
    assert torch.equal(out, expect)


def test_edge_wrappers_check_inputs_on_card(card):
    cpu, gpu, batch = _routed_sketch(3, card)
    on_card = batch.replace(src=batch.src.to(card), dst=batch.dst.to(card),
                            weight=batch.weight.to(card))
    args, kw = _ingest_args(gpu, on_card, 128)
    before = (matrix_ingest_edges.launches, matrix_lookup_edges.launches)
    with pytest.raises(ValueError, match="src is on cpu"):
        matrix_ingest_edges(*args[:3], batch.src, *args[4:], **kw)
    with pytest.raises(TypeError, match="weight must be"):
        matrix_ingest_edges(*args[:5], args[5].long(), **kw)
    with pytest.raises(ValueError, match="must be contiguous"):
        matrix_ingest_edges(args[0], args[1], args[2], args[3][::2],
                            args[4][::2], args[5][::2], **kw)
    with pytest.raises(ValueError, match="1 to 16"):
        matrix_ingest_edges([args[0][0]] * 17, *args[1:], **kw)
    with pytest.raises(ValueError, match="needs part_class"):
        matrix_ingest_edges(*args, **{**kw, "overflow": None})
    table = gpu.conn
    with pytest.raises(ValueError, match="src is on cpu"):
        matrix_lookup_edges(table, gpu.hashes.a, gpu.hashes.b, batch.src,
                            on_card.dst)
    with pytest.raises(TypeError, match="a must be"):
        matrix_lookup_edges(table, gpu.hashes.a.int(), gpu.hashes.b,
                            on_card.src, on_card.dst)
    with pytest.raises(ValueError, match="must be contiguous"):
        matrix_lookup_edges(table, gpu.hashes.a, gpu.hashes.b,
                            on_card.src[::2], on_card.dst[::2])
    assert (matrix_ingest_edges.launches, matrix_lookup_edges.launches) == before


def test_kmatrix_ingest_is_one_launch_per_batch(card):
    """kmatrix_accel_ingest and rectangle_ingest on the card: the same
    sketch; the first one launch per batch and no rectangle launch."""
    cpu, gpu, batch = _routed_sketch(7, card)
    on_card = batch.replace(src=batch.src.to(card), dst=batch.dst.to(card),
                            weight=batch.weight.to(card))
    rect = tkma.empty_like(gpu)
    before = (matrix_ingest_edges.launches, matrix_ingest.launches)
    for capacity in (None, 128):
        tkma.ingest(gpu, on_card, capacity=capacity)
    assert (matrix_ingest_edges.launches - before[0],
            matrix_ingest.launches - before[1]) == (2, 0)
    for capacity in (None, 128):
        ops.rectangle_ingest(rect, on_card, capacity=capacity)
    assert matrix_ingest.launches - before[1] == 2 * len(gpu.class_counts)
    torch.cuda.synchronize()
    got, want = interop.export_state(gpu)[0], interop.export_state(rect)[0]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(gpu.overflow) > 0


SERVING_KINDS = {"countmin": "width_class", "gsketch": "width_class",
                 "tcm": "width_class", "gmatrix": "width_class",
                 "kmatrix": "width_class", "kmatrix-flat": "flat"}


def _serving_requests(kind, n_nodes):
    reqs = synth_requests(300, mix_for_sketch(kind.split("-")[0]),
                          n_nodes=n_nodes, seed=3,
                          heavy_universe=min(n_nodes, 1 << 14))
    if kind in ("tcm", "gmatrix"):
        reqs += [eng.node_in(v) for v in range(0, n_nodes, 401)]
    return reqs


@pytest.mark.parametrize("kind", list(SERVING_KINDS))
def test_serving_engine_on_card_equals_cpu(card, kind):
    """A tenant on the card and on the CPU: the same counters after three
    batches, the engine's answers on the card equal to its CPU answers and
    to the direct answers on the card; launches: one edge ingest per batch
    (the matrix kinds), one reach_closure per closure miss, one edge
    lookup per TCM/gMatrix edge, path and subgraph group."""
    name = kind.split("-")[0]
    regs = {dev: SketchRegistry(depth=5, scale=0.1, device=dev,
                                sketch_backend=SERVING_KINDS[kind])
            for dev in ("cuda", "cpu")}
    tenants = {dev: reg.open("cit-HepPh", name, 256) for dev, reg in regs.items()}
    counters = (matrix_ingest_edges, matrix_lookup_edges, reach_closure,
                reach_step, matrix_ingest, matrix_lookup)
    before = [fn.launches for fn in counters]
    snaps = {}
    for dev, t in tenants.items():
        t.step(3)
        snaps[dev] = t.publish()
    torch.cuda.synchronize()
    assert gates.layout_counters_equal(snaps["cuda"].sketch, snaps["cpu"].sketch)
    assert interop.export_state(snaps["cuda"].sketch)[1] == \
        interop.export_state(snaps["cpu"].sketch)[1]
    reqs = _serving_requests(kind, tenants["cpu"].stream.spec.n_nodes)
    engine = QueryEngine()
    mid = [fn.launches for fn in counters]
    got = [r.value for r in engine.execute(snaps["cuda"], reqs)]
    launched = [fn.launches - n for fn, n in zip(counters, mid)]
    want = [r.value for r in QueryEngine().execute(snaps["cpu"], reqs)]
    assert gates.mismatched_indices(got, want) == []
    assert gates.mismatched_indices(
        got, eng.direct_answers(snaps["cuda"], reqs)) == []
    matrix = name in ("tcm", "gmatrix")
    ingests = 3 if matrix or kind == "kmatrix" else 0
    assert mid[0] - before[0] == ingests
    edge_groups = len({engine._group_key(r) for r in reqs
                       if r.family in ("edge_freq", "path_weight",
                                       "subgraph_weight")})
    assert launched == [0, edge_groups if matrix else 0,
                        engine.closures.misses, 0, 0, 0]


def test_published_front_on_card_is_never_written_again(card):
    reg = SketchRegistry(depth=5, scale=0.1, device="cuda")
    t = reg.open("cit-HepPh", "kmatrix", 256)
    t.step(2)
    held = t.publish()
    host = {k: v.copy() for k, v in interop.export_state(held.sketch)[0].items()}
    token = t.buffer.dispatch_token()
    t.step(2)
    fence = t.buffer.dispatch_token()
    assert isinstance(fence, torch.cuda.Event) and fence is not token
    fence.synchronize()
    assert fence.query()
    new = t.publish()
    ptrs = {x.data_ptr() for x in (*held.sketch.pools, held.sketch.conn)}
    assert not ptrs & {x.data_ptr() for x in (*new.sketch.pools, new.sketch.conn)}
    after = interop.export_state(held.sketch)[0]
    for k in host:
        np.testing.assert_array_equal(after[k], host[k], err_msg=k)


@pytest.mark.parametrize("sketch", ["kmatrix", "gmatrix"])
def test_query_serve_on_card_equals_cpu(card, sketch, capsys):
    flags = ["--scale", "0.05", "--n-requests", "400", "--sketch", sketch]
    counters = (matrix_ingest_edges, matrix_lookup_edges, reach_closure,
                reach_step)
    before = [fn.launches for fn in counters]
    gpu = query_serve._run(query_serve.parse_args([*flags, "--device", "cuda"]))
    launched = [fn.launches - n for fn, n in zip(counters, before)]
    cpu = query_serve._run(query_serve.parse_args([*flags, "--device", "cpu"]))
    assert gates.layout_counters_equal(gpu["tenant"].snapshot.sketch,
                                       cpu["tenant"].snapshot.sketch)
    batches = gpu["tenant"].stream.num_batches
    misses = gpu["summary"]["engine_closure_misses"]
    assert launched[0] == batches and launched[2] == misses and launched[3] == 0
    assert (launched[1] > 0) == (sketch == "gmatrix")
    for key in ("total_edges", "n_requests", "sketch", "sketch_backend"):
        assert gpu["summary"][key] == cpu["summary"][key]
    snaps = [run["tenant"].snapshot for run in (gpu, cpu)]
    reqs = gpu["requests"][:200]
    assert gates.mismatched_indices(
        [r.value for r in QueryEngine().execute(snaps[0], reqs)],
        [r.value for r in QueryEngine().execute(snaps[1], reqs)]) == []


def test_launch_counts_stay_exact_with_two_launching_threads(card):
    """The ingest worker and the query thread launch at once: 10,000
    ``matrix_lookup_edges`` launches from two threads, none lost."""
    import threading

    t = SketchRegistry(depth=5, scale=0.05, device="cuda").open(
        "cit-HepPh", "gmatrix", 256)
    t.step(1)
    sk = t.publish().sketch
    q = torch.arange(64, dtype=torch.int32, device=card)
    want = matrix_lookup_edges(sk.table, sk.hashes.a, sk.hashes.b, q, q)
    before = matrix_lookup_edges.launches
    outs = []

    def launch(n):
        for _ in range(n):
            out = matrix_lookup_edges(sk.table, sk.hashes.a, sk.hashes.b, q, q)
        outs.append(out)

    threads = [threading.Thread(target=launch, args=(5000,)) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    torch.cuda.synchronize()
    assert matrix_lookup_edges.launches - before == 10_000
    assert all(torch.equal(o, want) for o in outs)


@pytest.mark.parametrize("dedup", [False, True], ids=["plain", "dedup"])
def test_worker_staging_fence_keeps_back_to_back_dispatches_exact(card,
                                                                  dedup):
    """Coalesced groups go through the worker's two pinned staging slots and
    asynchronous copies, back to back (a pre-filled queue, every batch's
    data different): the slot refilled two groups later must wait for the
    copy that read it, or the card would ingest the later group's rows
    twice.  A long stall queued on the stream first keeps every copy
    pending while the host fills the slots, so a missing or early fence
    shows.  Counters equal one replay of the stream; the fences are the
    buffer's CUDA events and the slots are pinned."""
    from repro_torch.runtime import QueueItem, Runtime

    reg = SketchRegistry(depth=5, scale=0.25, device="cuda")
    t = reg.open("cit-HepPh", "kmatrix", 256)
    items = [QueueItem.from_arrays(i, *t.stream.batch_numpy(i))
             for i in range(t.stream.num_batches)]
    rt = Runtime(queue_capacity=len(items) + 1, publish_policy="every:1000",
                 reservoir_k=0, poll_s=0.01, coalesce_batches=2,
                 coalesce_target=2 * t.stream.batch_size, dedup=dedup)
    handle = rt.attach(t, pump=False)
    for it in items:
        assert handle.queue.put(it, timeout=5)
    before = matrix_ingest_edges.launches
    torch.cuda.synchronize()
    # ~1 s of device time on the stream that the worker's copies join
    # (the device's default stream, shared by both threads)
    torch.cuda._sleep(2_000_000_000)
    rt.start()
    rep = rt.stop(drain=True, timeout=300)[t.key.tenant_id]
    assert not handle.worker.is_alive() and rep["state"] == "stopped"
    assert matrix_ingest_edges.launches - before == -(-len(items) // 2)
    stage = [s for s in handle.worker._stage if s is not None]
    assert len(stage) == 2 and all(c.is_pinned() for s in stage
                                   for c in s[3])
    replay = gates.replay_sketch(t.mod, t.mod.empty_like(t.snapshot.sketch),
                                 t.stream, t.stream.num_batches)
    assert gates.layout_counters_equal(t.snapshot.sketch, replay)
    assert t.snapshot.n_edges == t.stream.spec.n_edges
    assert rep["unaccounted_edges"] == 0
    assert isinstance(t.buffer.dispatch_token(), torch.cuda.Event)


@pytest.mark.parametrize("kind", ["kmatrix", "gmatrix"])
def test_sharded_engine_on_card_equals_cpu(card, kind):
    """Two shards on the card and on the CPU: the same counters, the sharded
    engine's answers on the card equal to the direct ones there and to the
    CPU engine's; each sharded closure miss is one reach_closure launch."""
    from repro_torch.serving import ShardedQueryEngine, sharded_direct_answers

    tenants = {dev: SketchRegistry(depth=5, scale=0.1, device=dev)
               .open_sharded("cit-HepPh", kind, 256, n_shards=2)
               for dev in ("cuda", "cpu")}
    snaps = {}
    for dev, st in tenants.items():
        st.step(3)
        snaps[dev] = st.publish()
    for a, b in zip(snaps["cuda"].parts, snaps["cpu"].parts):
        assert gates.layout_counters_equal(a.sketch, b.sketch)
    reqs = _serving_requests(kind, tenants["cpu"].stream.spec.n_nodes)
    engine = ShardedQueryEngine(QueryEngine())
    before = reach_closure.launches
    got = [r.value for r in engine.execute(snaps["cuda"], reqs)]
    assert reach_closure.launches - before == \
        engine.stats["sharded_closure_misses"] + engine.stats["closure_misses"]
    assert gates.mismatched_indices(
        got, sharded_direct_answers(snaps["cuda"], reqs)) == []
    assert gates.mismatched_indices(got, [r.value for r in ShardedQueryEngine(
        QueryEngine()).execute(snaps["cpu"], reqs)]) == []


@pytest.mark.parametrize("shards", [1, 2])
def test_background_query_serve_on_card_equals_cpu(card, shards):
    flags = ["--scale", "0.05", "--n-requests", "400", "--background-ingest",
             "--shards", str(shards)]
    gpu = query_serve._run(query_serve.parse_args([*flags, "--device", "cuda"]))
    cpu = query_serve._run(query_serve.parse_args([*flags, "--device", "cpu"]))
    assert gpu["summary"]["device"] == "cuda"
    for key in ("total_edges", "n_requests", "sketch_backend"):
        assert gpu["summary"][key] == cpu["summary"][key]
    if shards == 1:
        assert gates.layout_counters_equal(gpu["tenant"].snapshot.sketch,
                                           cpu["tenant"].snapshot.sketch)
        assert gpu["summary"]["unaccounted_edges"] == 0
    else:
        assert gpu["summary"]["per_shard_published"] == \
            cpu["summary"]["per_shard_published"]
        assert gates.layout_counters_equal(
            gpu["tenant"].merged_snapshot().sketch,
            cpu["tenant"].merged_snapshot().sketch)
