"""The port's CUDA kernels on the card, against their plain versions.

These need an NVIDIA card (Hopper: the kernels are built for sm_90a) and
skip elsewhere.  On the card:  python -m pytest -q -m cuda tests/
"""
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.kernels import (
    matrix_ingest,
    matrix_ingest_plain,
    reach_step,
    reach_step_plain,
)
from repro_torch.launch import stream_ingest

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


def test_wrappers_check_inputs_on_card(card):
    pool = torch.zeros((1, 1, 8, 8), dtype=torch.int32, device=card)
    hi = torch.zeros((1, 1, 16), dtype=torch.int32, device=card)
    wt = torch.zeros((1, 16), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="pool on"):
        matrix_ingest(pool, hi.cpu(), hi, wt)
    with pytest.raises(TypeError):
        reach_step(torch.zeros((1, 4, 4), dtype=torch.float64, device=card))


def test_stream_ingest_on_card_equals_cpu(card):
    flags = ["--scale", "0.03", "--budget-kb", "64", "--depth", "3",
             "--eval-queries", "500"]
    parser = stream_ingest.build_parser()
    gpu = stream_ingest.inline_main(parser.parse_args([*flags, "--device", "cuda"]))
    cpu = stream_ingest.inline_main(parser.parse_args([*flags, "--device", "cpu"]))
    gl, gs = interop.export_state(gpu["sketch"])
    cl, cs = interop.export_state(cpu["sketch"])
    assert gs == cs
    for k in cl:
        np.testing.assert_array_equal(gl[k], cl[k], err_msg=k)
    assert gpu["ARE"] == cpu["ARE"]
