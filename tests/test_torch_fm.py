"""The port's FM serving path vs the JAX package's, on one set of weights.

Weights and ids are made with numpy and handed to both packages (the port
through ``interop.fm_params_from_jax``).  Tolerance: rtol 1e-5, atol 1e-6.
The port's bags sum the fields in order (bit-equal to the Pallas kernel,
tests/test_torch_embedding_bag.py); the JAX ``forward`` gathers and sums
as a tree, and XLA orders the k-sum and the elementwise tail its own
way, so logits differ in their last bits.  Weights are drawn at the
model's own scale (stddev 0.01, as ``init_params`` draws them): at a much
larger scale the difference of squares in the pairwise term cancels and
those last bits grow past atol.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.configs.registry import _fm_config as j_fm_config
from repro.models.recsys import fm as jfm
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.kernels import embedding_bag
from repro_torch.models.common import count_params
from repro_torch.models.recsys import fm as tfm

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
CFG = tfm.FMConfig(total_vocab=5_000, n_fields=7, embed_dim=10)
CFG39 = tfm.FMConfig(total_vocab=5_000, n_fields=39, embed_dim=10)


def _np_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    rows = cfg.table_rows
    return {"emb": (rng.normal(size=(rows, cfg.embed_dim)) * 0.01).astype(np.float32),
            "lin": (rng.normal(size=(rows, 1)) * 0.01).astype(np.float32),
            "bias": np.float32(0.25)}


def _ids(b, f, seed):
    return np.random.default_rng(seed).integers(0, 1 << 30, (b, f)).astype(np.int32)


def _both(cfg, seed=0):
    np_params = _np_params(cfg, seed)
    jcfg = jfm.FMConfig(total_vocab=cfg.total_vocab, n_fields=cfg.n_fields,
                        embed_dim=cfg.embed_dim)
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    return jcfg, jparams, interop.fm_params_from_jax(cfg, np_params, device="cpu")


def test_config_equals_jax_at_full_width():
    cfg, jcfg = registry._fm_config(), j_fm_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(cfg.field_vocabs(), jcfg.field_vocabs())
    np.testing.assert_array_equal(cfg.field_offsets(), jcfg.field_offsets())
    assert cfg.table_rows == jcfg.table_rows == 10_000_384
    assert registry.archs()["fm"].shape_names == tuple(RECSYS_SHAPES)


@pytest.mark.parametrize("cfg", [CFG, CFG39], ids=["7_fields", "39_fields"])
def test_forward_matches_jax_forward_and_kernel_path(cfg):
    jcfg, jparams, params = _both(cfg)
    ids = _ids(16, cfg.n_fields, cfg.n_fields)
    embedding_bag.launches = 0
    got = tfm.forward(cfg, params, torch.as_tensor(ids)).numpy()
    assert embedding_bag.launches == 0  # CPU: plain versions
    assert got.shape == (16,) and got.dtype == np.float32
    expect = np.asarray(jfm.forward(jcfg, jparams, jnp.asarray(ids)))
    np.testing.assert_allclose(got, expect, rtol=RTOL, atol=ATOL)
    kernel = np.asarray(jfm.forward_with_kernel(jcfg, jparams, jnp.asarray(ids),
                                                interpret=True))
    np.testing.assert_allclose(got, kernel, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(params(torch.as_tensor(ids)).numpy(), got)


@pytest.mark.parametrize("cfg", [CFG, CFG39], ids=["7_fields", "39_fields"])
def test_forward_with_kernel_matches_jax_forward_with_kernel(cfg):
    """The reference's name for the bag-kernel forward: on the port it is
    ``forward`` (three bags; plain versions on the CPU)."""
    jcfg, jparams, params = _both(cfg, seed=2)
    ids = _ids(16, cfg.n_fields, 4)
    embedding_bag.launches = 0
    got = tfm.forward_with_kernel(cfg, params, torch.as_tensor(ids)).numpy()
    assert embedding_bag.launches == 0
    np.testing.assert_array_equal(
        got, tfm.forward(cfg, params, torch.as_tensor(ids)).numpy())
    expect = np.asarray(jfm.forward_with_kernel(jcfg, jparams, jnp.asarray(ids),
                                                interpret=True))
    np.testing.assert_allclose(got, expect, rtol=RTOL, atol=ATOL)


def test_flat_ids_equal_jax_including_negative_ids():
    ids = _ids(8, CFG.n_fields, 3)
    ids[0] = -ids[0]  # floor mod on both sides
    got = tfm._flat_ids(CFG, torch.as_tensor(ids)).numpy()
    expect = np.asarray(jfm._flat_ids(
        jfm.FMConfig(total_vocab=5_000, n_fields=7), jnp.asarray(ids)))
    np.testing.assert_array_equal(got, expect)
    assert got.min() >= 0 and got.max() < CFG.table_rows


def test_bags_equal_pallas_kernel_bags():
    """Each of the port's three bags equals the JAX kernel path's bag (at
    its 128-lane padding) bit for bit."""
    from repro.kernels.embedding_bag import embedding_bag as j_bag

    jcfg, jparams, params = _both(CFG39, seed=5)
    ids = _ids(8, CFG39.n_fields, 5)
    rows = tfm._flat_ids(CFG39, torch.as_tensor(ids))
    jrows = jnp.asarray(rows.numpy())
    emb = jnp.pad(jparams["emb"], ((0, 0), (0, 118)))
    lin = jnp.pad(jparams["lin"], ((0, 0), (0, 127)))
    for table, jtable, d in ((params.emb, emb, 10),
                             (params.squared_table(), emb * emb, 10),
                             (params.lin, lin, 1)):
        expect = np.asarray(j_bag(jtable, jrows, interpret=True))[:, :d]
        np.testing.assert_array_equal(embedding_bag(table, rows).numpy(), expect)


@pytest.mark.parametrize("cfg", [CFG, CFG39], ids=["7_fields", "39_fields"])
def test_retrieval_scores_match_jax(cfg):
    jcfg, jparams, params = _both(cfg, seed=1)
    q = _ids(1, cfg.n_fields, 11)[0]
    cands = _ids(64, cfg.n_fields, 12)
    got = tfm.retrieval_scores(cfg, params, torch.as_tensor(q),
                               torch.as_tensor(cands)).numpy()
    expect = np.asarray(jfm.retrieval_scores(jcfg, jparams, jnp.asarray(q),
                                             jnp.asarray(cands)))
    assert got.shape == (64,)
    np.testing.assert_allclose(got, expect, rtol=RTOL, atol=ATOL)


def test_bce_loss_matches_jax():
    jcfg, jparams, params = _both(CFG, seed=2)
    ids = _ids(32, CFG.n_fields, 21)
    labels = np.random.default_rng(22).integers(0, 2, 32).astype(np.float32)
    got = float(tfm.bce_loss(CFG, params, torch.as_tensor(ids),
                             torch.as_tensor(labels)))
    expect = float(jfm.bce_loss(jcfg, jparams, jnp.asarray(ids),
                                jnp.asarray(labels)))
    np.testing.assert_allclose(got, expect, rtol=RTOL, atol=ATOL)


def test_squared_table_is_made_once_and_refreshed_after_updates():
    _, _, params = _both(CFG, seed=3)
    ids = torch.as_tensor(_ids(16, CFG.n_fields, 31))
    before = tfm.forward(CFG, params, ids)
    sq = params.squared_table()
    assert params.squared_table() is sq  # derived once
    torch.testing.assert_close(sq, params.emb * params.emb, rtol=0, atol=0)
    assert "emb_sq" not in params.state_dict()
    rows = tfm._flat_ids(CFG, ids)
    with torch.no_grad():
        params.emb[rows[0, 0]] += 1.0  # in place, through emb
    after = tfm.forward(CFG, params, ids)
    assert params.squared_table() is not sq
    torch.testing.assert_close(params.squared_table(), params.emb * params.emb,
                               rtol=0, atol=0)
    assert not torch.equal(after, before)
    fresh = interop.fm_params_from_jax(
        CFG, {k: getattr(params, k).numpy() for k in ("emb", "lin", "bias")},
        device="cpu")
    torch.testing.assert_close(after, tfm.forward(CFG, fresh, ids), rtol=0, atol=0)
    # a new tensor in emb's place is a new table too
    params.emb = torch.nn.Parameter(params.emb.detach().clone() * 2,
                                    requires_grad=False)
    torch.testing.assert_close(params.squared_table(), params.emb * params.emb,
                               rtol=0, atol=0)


def test_init_params_and_count():
    gen = torch.Generator().manual_seed(0)
    params = tfm.init_params(CFG, gen, device="cpu")
    rows = CFG.table_rows
    assert params.emb.shape == (rows, 10) and params.lin.shape == (rows, 1)
    assert float(params.bias) == 0.0
    assert count_params(params) == rows * 11 + 1
    assert abs(float(params.emb.std()) - 0.01) < 1e-3
    assert not params.emb.requires_grad
    with pytest.raises(ValueError, match="emb must be"):
        tfm.FM(CFG, params.emb[:-1], params.lin, params.bias)


def test_build_fm_cell_runs_serve_p99_at_reduced_vocab():
    params = interop.fm_params_from_jax(CFG39, _np_params(CFG39), device="cpu")
    cell = registry.build_fm_cell("serve_p99", params, np.random.default_rng(0),
                                  device="cpu")
    (ids,) = cell.inputs
    assert ids.shape == (512, 39) and ids.dtype == torch.int32
    assert cell.rows == 512
    logits = cell.run()
    assert logits.shape == (512,) and bool(torch.isfinite(logits).all())
    jcfg, jparams, _ = _both(CFG39)
    expect = np.asarray(jfm.forward(jcfg, jparams, jnp.asarray(ids.numpy())))
    np.testing.assert_allclose(logits.numpy(), expect, rtol=RTOL, atol=ATOL)
    # the same seed gives the same ids
    again = registry.build_fm_cell("serve_p99", params,
                                   np.random.default_rng(0), device="cpu")
    assert torch.equal(again.inputs[0], ids)


def test_build_fm_cell_retrieval_and_refusals():
    params = interop.fm_params_from_jax(CFG, _np_params(CFG), device="cpu")
    cell = registry.build_fm_cell("retrieval_cand", params,
                                  np.random.default_rng(1), device="cpu")
    q, cands = cell.inputs
    assert q.shape == (7,) and cands.shape == (1_000_000, 7)
    assert cell.rows == 1_000_000
    # the train kind trains the params, so they must require grad
    with pytest.raises(ValueError, match="requires_grad=True"):
        registry.build_fm_cell("train_batch", params, np.random.default_rng(0),
                               device="cpu")
    with pytest.raises(ValueError, match="no shape"):
        registry.build_fm_cell("decode_32k", params, np.random.default_rng(0),
                               device="cpu")
    with pytest.raises(ValueError, match="params are on cpu"):
        registry.build_fm_cell("serve_p99", params, np.random.default_rng(0),
                               device="meta")


def _smoke(*args):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.smoke",
                           *args], capture_output=True, text=True, env=env,
                          timeout=180, cwd=REPO)


def test_smoke_cli_runs_on_cpu_and_refuses_other_families():
    """Every family is ported now: a GNN runs too, and only a name the
    smoke does not know is refused."""
    proc = _smoke("--arch", "fm", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert "[smoke OK] fm" in proc.stdout and "'bce'" in proc.stdout
    proc = _smoke("--arch", "gatedgcn", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert "[smoke OK] gatedgcn" in proc.stdout and "[24, 4]" in proc.stdout
    proc = _smoke("--arch", "gcn-unknown", "--device", "cpu")
    assert proc.returncode != 0 and "invalid choice" in proc.stderr
    assert "smoke OK" not in proc.stdout


def test_smoke_cli_defaults_to_cuda_and_refuses_without_a_card():
    from repro_torch.launch import smoke

    assert smoke.build_parser().parse_args(["--arch", "fm"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs on it")
    proc = _smoke("--arch", "fm")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "--device cpu" in proc.stderr
    assert "smoke OK" not in proc.stdout
