"""The port's CUDA kernels on the card, against their plain versions.

These need an NVIDIA card (Hopper: the kernels are built for sm_90a) and
skip elsewhere.  On the card:  python -m pytest -q -m cuda tests/
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.kernels import (
    embedding_bag,
    embedding_bag_plain,
    matrix_ingest,
    matrix_ingest_plain,
    matrix_lookup,
    matrix_lookup_plain,
    ops,
    reach_closure,
    reach_closure_plain,
    reach_step,
    reach_step_plain,
)
from repro_torch.kernels.reach_closure import CLOSURE_MAX_W
from repro_torch.core import queries as tq
from repro_torch.launch import stream_ingest
from repro_torch.models.recsys import fm as tfm

pytestmark = pytest.mark.cuda

# the module, which the package shadows with its wrapper of the same name
eb = importlib.import_module("repro_torch.kernels.embedding_bag")


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
    before = (matrix_ingest.launches, matrix_lookup.launches)
    gpu = stream_ingest.inline_main(parser.parse_args([*flags, "--device", "cuda"]))
    if sketch == "gmatrix":  # one ingest launch per batch, one lookup
        assert (matrix_ingest.launches - before[0],
                matrix_lookup.launches - before[1]) == (gpu["batches"], 1)
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
