"""FM training in the port against the JAX package: the bag's backward, the
FM's gradient and three train steps, on numpy-made weights and ids.

Tolerances, each against the largest magnitude of the compared quantity:
* the bag's backward (the plain version here: float64 sums in field order,
  one float32 rounding) against ``jax.grad`` of ``embedding_bag_ref``:
  within 1e-6 of max |grad| + 1e-9 (JAX sums in float32 in its own order);
* the FM's gradient against ``jax.grad`` of ``bce_loss``: within 1e-6 of
  max |grad| + 1e-9 per leaf (the forward's bags sum in another order than
  JAX's gather and reduce, tests/test_torch_fm.py); the bias's gradient,
  a mean of per-row terms that cancel, within 1e-6 of the sum of their
  magnitudes + 1e-9;
* three train steps: losses within 1e-6, parameters within 1e-6.  Adam
  divides by sqrt(v) + 1e-8, so an entry whose gradient is near 1e-8 turns
  a last-bit gradient difference into a difference of up to lr in the
  update; at lr <= 3e-4 that stays below 1e-6.
"""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.ref import embedding_bag_ref
from repro.models.recsys import fm as jfm
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import init_train_state as j_init_train_state
from repro.training import make_train_step as j_make_train_step
from repro.training.steps import fm_loss_fn as j_fm_loss_fn
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.kernels import (
    embedding_bag,
    embedding_bag_backward,
    embedding_bag_backward_plain,
    sum_and_square_bags,
)
from repro_torch.models.recsys import fm as tfm
from repro_torch.training import AdamWConfig, init_train_state, make_train_step
from repro_torch.training.steps import fm_loss_fn

REL = 1e-6
CFG = tfm.FMConfig(total_vocab=5_000, n_fields=7, embed_dim=10)
OPT = dict(lr_peak=3e-4, warmup_steps=2, total_steps=10)


def _close(got, want, rel=REL, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = rel * (np.abs(want).max() if scale is None else scale) + 1e-9
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


def _np_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    rows = cfg.table_rows
    return {"emb": (rng.normal(size=(rows, cfg.embed_dim)) * 0.01).astype(np.float32),
            "lin": (rng.normal(size=(rows, 1)) * 0.01).astype(np.float32),
            "bias": np.float32(0.05)}


def _jcfg(cfg):
    return jfm.FMConfig(total_vocab=cfg.total_vocab, n_fields=cfg.n_fields,
                        embed_dim=cfg.embed_dim)


def _bag_inputs(v, d, b, f, seed, repeat=True):
    """A table and ids with rows repeated inside a bag and across bags."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(0, v, (b, f)).astype(np.int32)
    if repeat:
        idx[:, 1] = idx[:, 0]  # the same row twice in every bag
        idx[1::2, 2] = idx[0, 2]  # one row in half the bags
    g = rng.normal(size=(b, d)).astype(np.float32)
    return table, idx, g


@pytest.mark.parametrize("v,d,b,f", [(50, 10, 16, 7), (7, 1, 33, 39),
                                     (200, 4, 64, 3), (3, 2, 5, 8)])
def test_bag_backward_equals_jax_grad_of_embedding_bag_ref(v, d, b, f):
    table, idx, g = _bag_inputs(v, d, b, f, seed=v + b)
    t = torch.tensor(table, requires_grad=True)
    out = embedding_bag(t, torch.tensor(idx))
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out, t, torch.tensor(g))
    _, vjp = jax.vjp(lambda tab: embedding_bag_ref(tab, jnp.asarray(idx)),
                     jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))
    _close(got.numpy(), want)
    direct = embedding_bag_backward(torch.tensor(g), torch.tensor(idx), v)
    assert torch.equal(direct, got)


@pytest.mark.parametrize("v,d,b,f", [(50, 10, 16, 7), (9, 10, 40, 39)])
def test_squared_term_equals_jax_grad_of_both_bags(v, d, b, f):
    """One backward of ``sum_and_square_bags`` = the gradient through the
    Σv bag and the bag of ``table * table``."""
    table, idx, g = _bag_inputs(v, d, b, f, seed=v * b)
    g_sq = np.random.default_rng(1).normal(size=(b, d)).astype(np.float32)
    t = torch.tensor(table, requires_grad=True)
    with torch.no_grad():
        sq = t * t
    s, q = sum_and_square_bags(t, sq, torch.tensor(idx))
    (got,) = torch.autograd.grad((s, q), t, (torch.tensor(g), torch.tensor(g_sq)))

    def both(tab):
        i = jnp.asarray(idx)
        return embedding_bag_ref(tab, i), embedding_bag_ref(tab * tab, i)

    _, vjp = jax.vjp(both, jnp.asarray(table))
    (want,) = vjp((jnp.asarray(g), jnp.asarray(g_sq)))
    _close(got.numpy(), want)
    # only the Σv gradient reaches the table when Σv² takes none
    s, q = sum_and_square_bags(t, sq, torch.tensor(idx))
    (only,) = torch.autograd.grad(s, t, torch.tensor(g))
    _close(only.numpy(), embedding_bag_backward_plain(
        torch.tensor(g), torch.tensor(idx), v).numpy(), rel=0)


def test_plain_backward_sums_in_float64_and_rounds_contributions_once():
    # contributions that cancel in float32 but not in float64
    g = torch.tensor([[1.0], [1e-8], [-1.0]], dtype=torch.float32)
    idx = torch.tensor([[0], [0], [0]], dtype=torch.int32)
    out = embedding_bag_backward_plain(g, idx, 2)
    assert out.dtype == torch.float32 and out.shape == (2, 1)
    assert float(out[0, 0]) == np.float32(1e-8) and float(out[1, 0]) == 0.0
    # 2 t g_sq + g rounded once (an fma), as the kernel rounds it
    x = 1.0 + 2**-12 + 2**-13
    t = torch.tensor([[x]], dtype=torch.float32)
    gg = torch.tensor([[-2.0]], dtype=torch.float32)
    got = embedding_bag_backward_plain(gg, torch.zeros((1, 1), dtype=torch.int32),
                                       1, t, t)
    exact = 2 * x * x - 2  # exact in float64 and in float32
    two_roundings = float(torch.tensor(2 * x * x, dtype=torch.float32)) - 2
    assert float(got) == exact != two_roundings


def test_fm_gradient_equals_jax_grad_of_bce_loss():
    np_params = _np_params(CFG)
    params = interop.fm_params_from_jax(CFG, np_params, device="cpu",
                                        requires_grad=True)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 1 << 30, (256, 7)).astype(np.int32)
    ids[:, 3] = ids[0, 3]  # one row of field 3 in every bag
    labels = rng.integers(0, 2, 256).astype(np.float32)
    embedding_bag.launches = embedding_bag_backward.launches = 0
    loss = tfm.bce_loss(CFG, params, torch.tensor(ids), torch.tensor(labels))
    grads = torch.autograd.grad(loss, [params.bias, params.emb, params.lin])
    assert embedding_bag.launches == embedding_bag_backward.launches == 0
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    want = jax.grad(lambda p: jfm.bce_loss(_jcfg(CFG), p, jnp.asarray(ids),
                                           jnp.asarray(labels)))(jparams)
    logits = jfm.forward(_jcfg(CFG), jparams, jnp.asarray(ids))
    terms = float(jnp.abs(jax.nn.sigmoid(logits) - labels).sum()) / 256
    for name, got in zip(("bias", "emb", "lin"), grads):
        _close(got.numpy(), np.asarray(want[name]),
               scale=terms if name == "bias" else None)


def test_three_train_steps_equal_jax():
    np_params = _np_params(CFG, seed=1)
    params = interop.fm_params_from_jax(CFG, np_params, device="cpu",
                                        requires_grad=True)
    state = init_train_state(params, AdamWConfig(**OPT))
    step = make_train_step(fm_loss_fn(CFG), AdamWConfig(**OPT))
    jstate = j_init_train_state({k: jnp.asarray(v) for k, v in np_params.items()},
                                JAdamWConfig(**OPT))
    jstep = jax.jit(j_make_train_step(j_fm_loss_fn(_jcfg(CFG)), JAdamWConfig(**OPT)))
    rng = np.random.default_rng(5)
    for _ in range(3):
        batch = {"ids": rng.integers(0, 1 << 30, (512, 7)).astype(np.int32),
                 "labels": rng.integers(0, 2, 512).astype(np.float32)}
        state, m = step(state, {k: torch.tensor(v) for k, v in batch.items()})
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        for k in ("loss", "bce", "lr", "grad_norm"):
            assert abs(float(m[k]) - float(jm[k])) <= 1e-6, (k, m[k], jm[k])
    assert state.params is params
    for k in ("emb", "lin", "bias"):
        np.testing.assert_allclose(getattr(params, k).detach().numpy(),
                                   np.asarray(jstate.params[k]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(state.opt.mu[k].numpy(),
                                   np.asarray(jstate.opt.mu[k]), rtol=0, atol=1e-6)


def test_train_cell_steps_and_rederives_the_squared_table():
    params = interop.fm_params_from_jax(CFG, _np_params(CFG, 2), device="cpu",
                                        requires_grad=True)
    cell = registry.build_fm_cell("train_batch", params,
                                  np.random.default_rng(0), device="cpu")
    batch = cell.inputs[0]
    assert batch["ids"].shape == (65_536, 7) and batch["ids"].dtype == torch.int32
    assert set(np.unique(batch["labels"].numpy())) == {0.0, 1.0}
    assert cell.train and cell.rows == 65_536
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1 << 30, (65_536, 7), dtype=np.int32)
    assert np.array_equal(batch["ids"].numpy(), ids)
    assert registry.FM_TRAIN_OPT == AdamWConfig(lr_peak=1e-3, warmup_steps=100,
                                                total_steps=5000)
    losses = []
    for _ in range(3):
        sq_before = params.squared_table()
        metrics = cell.run()
        losses.append(float(metrics["loss"]))
        assert int(cell.params.opt.step) == len(losses)
        assert params.squared_table() is not sq_before
        torch.testing.assert_close(params.squared_table(),
                                   params.emb.detach() * params.emb.detach(),
                                   rtol=0, atol=0)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_train_cell_needs_params_that_require_grad():
    params = interop.fm_params_from_jax(CFG, _np_params(CFG), device="cpu")
    with pytest.raises(ValueError, match="requires_grad=True"):
        registry.build_fm_cell("train_batch", params, np.random.default_rng(0),
                               device="cpu")


def test_serving_path_builds_no_graph_and_weighted_bags_refuse_grad():
    params = interop.fm_params_from_jax(CFG, _np_params(CFG), device="cpu")
    ids = torch.randint(0, 1 << 30, (8, 7), dtype=torch.int32)
    assert tfm.forward(CFG, params, ids).grad_fn is None
    table = torch.randn(10, 4, requires_grad=True)
    idx = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="weighted bag's backward"):
        embedding_bag(table, idx, torch.ones(3, 2, requires_grad=True))
    with torch.no_grad():
        assert embedding_bag(table, idx, torch.ones(3, 2)).shape == (3, 4)


def test_backward_checks_its_inputs():
    g = torch.zeros((3, 4))
    idx = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="come together"):
        embedding_bag_backward(g, idx, 5, torch.zeros((5, 4)))
    with pytest.raises(ValueError, match="table must be"):
        embedding_bag_backward(g, idx, 5, torch.zeros((4, 4)), g)
    with pytest.raises(TypeError, match="int32"):
        embedding_bag_backward(g, idx.long(), 5)
    with pytest.raises(ValueError, match=r"idx must lie in \[0, 5\)"):
        embedding_bag_backward(g, idx + 5, 5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        embedding_bag_backward(g.to("meta"), idx.to("meta"), 5)
    assert embedding_bag_backward.launches == 0


# ------------------------------------------- the backward kernels' plan --
# (the kernels run on the card only: tests/test_torch_cuda.py holds them
# bit-equal to the plain version; here the plan they are launched with)

eb = importlib.import_module("repro_torch.kernels.embedding_bag")
SMEM_BUDGET = 232_448  # shared memory a block may use on an H100

PLAN_SHAPES = [(65_536, 39, 10, 10_000_384), (65_536, 39, 1, 10_000_384),
               (512, 39, 10, 1000), (1, 1, 3, 1), (0, 5, 3, 7),
               (7, 2, 128, 50), (1 << 20, 39, 2, 1_000_000),
               (3000, 9, 10, 10_001), (2048, 3, 1, 10_600_000),
               (1 << 24, 2, 1, 5000), (4, 3, 100_000, 9)]


@pytest.mark.parametrize("b,f,d,v", PLAN_SHAPES)
def test_backward_plan_tiles_cover_the_rows(b, f, d, v):
    """Tiles of R = 2^rlog rows cover [0, num_rows), only the last one
    ragged; R within its limits and no larger than the rows need; a bucket
    entry packs (row in tile, b) into 32 bits."""
    p = eb.backward_plan(b, f, d, v)
    r = p.rows_per_tile
    assert (p.tiles - 1) * r < v <= p.tiles * r
    assert r <= eb.TILE_ROWS and (r == 1 or r * d <= eb.TILE_ELEMS)
    assert r == 1 or r < 2 * v
    assert p.rlog + p.bbits <= 32 and max(b - 1, 0) < 1 << p.bbits
    if (b, d, v) == (65_536, 10, 10_000_384):  # the FM's emb: 2,442 tiles
        assert (r, p.tiles) == (4096, 2442)


@pytest.mark.parametrize("d", [1, 2, 10, 128])
@pytest.mark.parametrize("b,f,v", [(65_536, 39, 10_000_384), (512, 39, 1000),
                                   (1 << 20, 39, 60_000_000), (1, 1, 1)])
def test_backward_plan_shared_memory_stays_in_budget(b, f, d, v):
    """Each kernel's shared memory fits a block's budget on the card, the
    reduce's twice over (two blocks a SM); the count blocks take tiles in
    ranges that fit."""
    p = eb.backward_plan(b, f, d, v)
    smem = p.smem_bytes
    assert set(smem) == {"count", "reduce"}
    assert 0 < smem["count"] <= SMEM_BUDGET
    assert 0 < 2 * (smem["reduce"] + 1024) <= SMEM_BUDGET
    assert p.count_tiles == min(eb.COUNT_TILES, p.tiles)
    assert smem["reduce"] % 16 == 0
    assert eb.SORT_CAP % 8 == 0  # the over-capacity path's float64 half
    assert eb.SORT_CAP == eb.BACKWARD_THREADS * 32  # 32 keys a thread


@pytest.mark.parametrize("b,f,d,v", PLAN_SHAPES)
def test_backward_plan_scratch_holds_every_pair(b, f, d, v):
    p = eb.backward_plan(b, f, d, v)
    words = p.scratch_words
    assert words["key"] == words["bucket"] == p.pairs == b * f
    assert (p.chunks - 1) * eb.CHUNK < max(b * f, 1) <= p.chunks * eb.CHUNK
    assert words["cnt"] == p.chunks * p.tiles
    assert words["tot"] == p.tiles and words["base"] == p.tiles + 1


def _bucketed_backward(g, idx, v, plan, table=None, gs=None):
    """The kernels' arithmetic of positions in numpy: pairs p = f B + b,
    counted per (chunk, tile), the counts scanned down the chunks and the
    totals over the tiles, each pair placed at base[tile] + (pairs of its
    tile in earlier chunks) + (its rank in its chunk), packed (row in tile)
    << bbits | b; then every element summed in float64 in bucket order."""
    b_, f_ = idx.shape
    n = b_ * f_
    key = idx.T.reshape(-1).astype(np.int64)
    p = np.arange(n)
    tile, chunk = key >> plan.rlog, p // eb.CHUNK
    cnt = np.zeros((plan.chunks, plan.tiles), np.int64)
    np.add.at(cnt, (chunk, tile), 1)
    earlier = np.cumsum(cnt, 0) - cnt
    base = np.concatenate([[0], np.cumsum(cnt.sum(0))])
    group = chunk * plan.tiles + tile
    order = np.argsort(group, kind="stable")
    rank = np.empty(n, np.int64)
    starts = np.searchsorted(group[order], group[order])
    rank[order] = np.arange(n) - starts
    pos = base[tile] + earlier[chunk, tile] + rank
    bucket = np.full(n, -1, np.int64)
    bucket[pos] = ((key & (plan.rows_per_tile - 1)) << plan.bbits) | (p % b_)
    assert (bucket >= 0).all() and (bucket < 1 << 32).all()  # all placed
    tiles = np.repeat(np.arange(plan.tiles), np.diff(base))
    rows = (tiles << plan.rlog) + (bucket >> plan.bbits)
    bags = torch.as_tensor(bucket & ((1 << plan.bbits) - 1))
    c = g[bags]
    if table is not None:
        c = eb._fma(2 * table[torch.as_tensor(rows)], gs[bags], c)
    acc = np.zeros((v, g.shape[1]))
    np.add.at(acc, rows, c.double().numpy())  # in bucket order
    return torch.as_tensor(acc.astype(np.float32))


@pytest.mark.parametrize("squared", [False, True], ids=["sum", "squared"])
@pytest.mark.parametrize("v,d,b,f,hot", [(1000, 10, 512, 39, False),
                                         (9001, 1, 4096, 3, True),
                                         (10_001, 10, 3000, 9, False),
                                         (50, 128, 7, 2, False),
                                         (200, 3, 1024, 5, False)])
def test_bucket_order_reproduces_the_plain_bits(v, d, b, f, hot, squared):
    """Summed in the order the plan's buckets hold the pairs, every element
    has the plain version's bits: each bucket keeps its pairs in pair
    order, whatever the chunks and tiles.  A third of the bags' gradients
    are +-2^60, so a row's sum in another order (even in float64) has
    other bits."""
    rng = np.random.default_rng(v + d + b)
    idx = rng.integers(0, v, (b, f)).astype(np.int32)
    if hot:
        idx[:] = v // 2
    gn = rng.normal(size=(b, d)).astype(np.float32)
    gn = np.choose(rng.integers(0, 3, (b, d)),
                   [gn, np.float32(2**60), np.float32(-2**60)])
    g = torch.as_tensor(gn)
    table = gs = None
    if squared:
        table = torch.as_tensor(rng.normal(size=(v, d)).astype(np.float32))
        gs = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32))
    plan = eb.backward_plan(b, f, d, v)
    got = _bucketed_backward(g, idx, v, plan, table, gs)
    want = embedding_bag_backward_plain(g, torch.as_tensor(idx), v, table, gs)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_backward_plan_keeps_tiles_within_the_scatter_key():
    """A scatter key packs (tile, place in a chunk) into 32 bits: the FM's
    shapes are far inside; a table the kernels cannot tile is refused on
    the card (the CPU path has no such limit)."""
    assert eb.backward_plan(65_536, 39, 10, 10_000_384).tiles <= eb.MAX_TILES
    assert eb.backward_plan(8, 2, 1 << 17, 1 << 21).tiles > eb.MAX_TILES
