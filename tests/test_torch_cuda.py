"""The port's CUDA kernels on the card, against their plain versions.

These need an NVIDIA card (Hopper: the kernels are built for sm_90a) and
skip elsewhere.  On the card:  python -m pytest -q -m cuda tests/
"""
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
    reach_step,
    reach_step_plain,
)
from repro_torch.launch import stream_ingest
from repro_torch.models.recsys import fm as tfm

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("w", [1, 43, 64, 65, 200])
def test_reach_step_kernel_equals_plain(card, w):
    gen = torch.Generator(device=card).manual_seed(w)
    reach = (torch.rand((3, w, w), generator=gen, device=card) < 0.05).float()
    before = reach_step.launches
    for _ in range(3):
        out, expect = reach_step(reach), reach_step_plain(reach)
        assert torch.equal(out, expect)
        reach = out
    assert reach_step.launches == before + 3


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
