"""The port's transformer family against the JAX package, at ``reduced()``
scale (float32), on weights made by the JAX package and carried across
with ``interop.lm_params_from_jax``.

Tolerances (float32; the two sum products and reductions in other orders,
and evaluate sin, cos, tanh and exp with other libraries):
* loss, cross-entropy and aux loss: rtol 1e-5;
* logits of prefill and decode: rtol 1e-5, atol 2e-5 (logits reach ~10);
* gradients: within 1e-5 of the leaf's max |grad| + 1e-8;
* within the port, decode against a full forward and blockwise attention
  against naive attention: rtol 1e-5, atol 1e-5.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import lm as jlm
from repro.models import common as jcommon
from repro.models.transformer import attention as jattn
from repro.models.transformer import model as jm
from repro.models.transformer import moe as jmoe
from repro_torch import interop
from repro_torch.configs import lm as tlm
from repro_torch.models import common as tcommon
from repro_torch.models.transformer import attention as tattn
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer import moe as tmoe

NAMES = sorted(jlm.LM_CONFIGS)
RTOL, ATOL = 1e-5, 2e-5


def _cfgs(name):
    return jlm.reduced(jlm.LM_CONFIGS[name]), tlm.reduced(tlm.LM_CONFIGS[name])


def _carried(name, seed=0):
    jcfg, tcfg = _cfgs(name)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = interop.lm_params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                    device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(seed, shape=(2, 40)):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


@pytest.mark.parametrize("name", NAMES)
def test_configs_equal_jax(name):
    full_j, full_t = jlm.LM_CONFIGS[name], tlm.LM_CONFIGS[name]
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    jcfg, tcfg = _cfgs(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert full_t.param_count() == full_j.param_count()
    assert full_t.active_param_count() == full_j.active_param_count()
    assert full_t.layer_kinds() == full_j.layer_kinds()


@pytest.mark.parametrize("name", NAMES)
def test_params_have_the_jax_layout_and_count(name):
    jcfg, tcfg = _cfgs(name)
    tp = tm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jp = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.PRNGKey(0)))
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    from repro_torch.checkpoint import store
    tleaves = store._flatten(tp)
    assert sorted(tleaves) == sorted(
        "/".join(str(k) for k in path) for path, _ in jleaves)
    for path, leaf in jleaves:
        t = tleaves["/".join(str(k) for k in path)]
        assert t.shape == leaf.shape and t.dtype == leaf.dtype
    assert tcommon.count_params(tp) == tcfg.param_count()
    assert all(x.requires_grad for x in
               jax.tree_util.tree_leaves(tp, is_leaf=torch.is_tensor))


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_equal_jax(name):
    jcfg, tcfg, jp, tp = _carried(name)
    toks, labels = _tokens(1), _tokens(2)
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.lm_loss(jcfg, p, jnp.asarray(toks), jnp.asarray(labels)),
        has_aux=True))(jp)
    tloss, tmet = tm.lm_loss(tcfg, tp, torch.as_tensor(toks),
                             torch.as_tensor(labels))
    for a, b in ((tloss, jloss), (tmet["ce"], jmet["ce"]), (tmet["aux"], jmet["aux"])):
        assert abs(a.item() - float(b)) <= RTOL * abs(float(b)) + 1e-7
    leaves = [tp["embed"], tp["layers"][0]["wq"], tp["layers"][-1]["w_in"],
              tp["ln_final"]]
    grads = torch.autograd.grad(tloss, leaves)
    for got, want in zip(grads, [jg["embed"], jg["layers"][0]["wq"],
                                 jg["layers"][-1]["w_in"], jg["ln_final"]]):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max() + 1e-8


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_equal_jax_and_the_full_forward(name):
    jcfg, tcfg, jp, tp = _carried(name, seed=3)
    toks = _tokens(4)
    p = 24
    jcache = jm.init_cache(jcfg, 2, 40, dtype=jnp.float32)
    jlog, jcache = jax.jit(lambda a, t, c: jm.prefill(jcfg, a, t, c))(
        jp, jnp.asarray(toks[:, :p]), jcache)
    tcache = tm.init_cache(tcfg, 2, 40, dtype=torch.float32, device="cpu")
    assert [tuple(x.shape) for x in tcache[:4]] == [x.shape for x in jcache[:4]]
    tlog, tcache = tm.prefill(tcfg, tp, torch.as_tensor(toks[:, :p]), tcache)
    got, want = [tlog], [np.asarray(jlog)]
    jdec = jax.jit(lambda a, t, c: jm.decode_step(jcfg, a, t, c))
    for i in range(p, p + 4):
        jlog, jcache = jdec(jp, jnp.asarray(toks[:, i:i + 1]), jcache)
        tlog, tcache = tm.decode_step(tcfg, tp, torch.as_tensor(toks[:, i:i + 1]),
                                      tcache)
        got.append(tlog)
        want.append(np.asarray(jlog))
    assert tcache.length == int(jcache.length) == p + 4
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), np.concatenate(want, 1),
                               rtol=RTOL, atol=ATOL)
    # decode equals the full forward at every decoded position
    positions = torch.arange(p + 4, dtype=torch.int32)[None, :]
    with torch.no_grad():
        hidden, _ = tm.forward_hidden(tcfg, tp, torch.as_tensor(toks[:, :p + 4]),
                                      positions)
        full = tm.logits_from_hidden(tcfg, tp, hidden)
    torch.testing.assert_close(torch.cat(got, 1), full[:, p - 1:p + 4],
                               rtol=1e-5, atol=1e-5)


def _naive_attention(q, k, v, window, cap):
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(dh)
    scores = tcommon.softcap(scores, cap)
    pos = torch.arange(s)
    ok = pos[None, :] <= pos[:, None]
    if window:
        ok &= pos[None, :] > pos[:, None] - window
    scores = scores.masked_fill(~ok, -torch.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)


@pytest.mark.parametrize("window", [None, 5, 64], ids=["global", "w5", "w64"])
@pytest.mark.parametrize("cap", [None, 3.0], ids=["nocap", "cap"])
@pytest.mark.parametrize("s,chunk_q,chunk_kv", [(37, 8, 16), (16, 16, 32),
                                                (9, 4, 3)])
def test_blockwise_attention_equals_naive_and_jax(window, cap, s, chunk_q,
                                                  chunk_kv):
    rng = np.random.default_rng(s)
    q = rng.normal(size=(2, s, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, s, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 8)).astype(np.float32)
    kw = dict(window=window, attn_cap=cap, chunk_q=chunk_q, chunk_kv=chunk_kv)
    got = tattn.blockwise_attention(*map(torch.as_tensor, (q, k, v)), **kw)
    naive = _naive_attention(*map(torch.as_tensor, (q, k, v)), window, cap)
    torch.testing.assert_close(got, naive, rtol=1e-5, atol=1e-5)
    want = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cf,ties", [(4.0, False), (0.5, False), (1.0, True)],
                         ids=["dropless", "drops", "ties"])
def test_moe_ffn_equals_jax(cf, ties):
    rng = np.random.default_rng(7)
    t, d, e, f = 24, 8, 4, 6
    x = rng.normal(size=(t, d)).astype(np.float32)
    router = (np.zeros((d, e)) if ties else rng.normal(size=(d, e))).astype(np.float32)
    w_in = rng.normal(size=(e, d, 2 * f)).astype(np.float32) * 0.3
    w_out = rng.normal(size=(e, f, d)).astype(np.float32) * 0.3
    kw = dict(top_k=2, capacity_factor=cf, act="silu", gated=True)
    args = [torch.as_tensor(a).requires_grad_() for a in (x, router, w_in, w_out)]
    y, aux = tmoe.moe_ffn(*args, **kw)
    jmoe_ffn = jax.jit(functools.partial(jmoe.moe_ffn, **kw))
    jy, jaux = jmoe_ffn(*map(jnp.asarray, (x, router, w_in, w_out)))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    assert abs(aux.item() - float(jaux)) <= 1e-6
    if cf < 1:  # capacity binds: some assignments are dropped
        cap = int(t * 2 * cf / e)
        assert cap < t * 2 / e
    g = torch.autograd.grad((y.sum() + aux), args)
    def jtotal(*a):
        y_, aux_ = jmoe.moe_ffn(*a, **kw)
        return y_.sum() + aux_

    jg = jax.jit(jax.grad(jtotal, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (x, router, w_in, w_out)))
    for a, b in zip(g, jg):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max() + 1e-7


def test_grouped_moe_splits_tokens_like_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(12, 8)).astype(np.float32)
    router = rng.normal(size=(8, 4)).astype(np.float32)
    w_in = rng.normal(size=(4, 8, 12)).astype(np.float32) * 0.3
    w_out = rng.normal(size=(4, 6, 8)).astype(np.float32) * 0.3
    kw = dict(top_k=2, capacity_factor=1.0, act="gelu", gated=True)
    for groups in (1, 3, 5):
        y, aux = tmoe.moe_ffn_grouped(*map(torch.as_tensor, (x, router, w_in, w_out)),
                                      groups=groups, **kw)
        jy, jaux = jax.jit(functools.partial(jmoe.moe_ffn_grouped, groups=groups,
                                             **kw))(
            *map(jnp.asarray, (x, router, w_in, w_out)))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
        assert abs(float(aux) - float(jaux)) <= 1e-6


def test_common_layers_equal_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32) * 3
    gamma = rng.normal(size=(16,)).astype(np.float32)
    beta = rng.normal(size=(16,)).astype(np.float32)
    tx, tg, tb = map(torch.as_tensor, (x, gamma, beta))
    for zc in (True, False):
        np.testing.assert_allclose(
            tcommon.rms_norm(tx, tg, 1e-6, zc).numpy(),
            np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(gamma), 1e-6, zc)),
            rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tcommon.layer_norm(tx, tg, tb).numpy(),
        np.asarray(jcommon.layer_norm(*map(jnp.asarray, (x, gamma, beta)))),
        rtol=1e-5, atol=1e-5)
    for name in ("gelu", "silu", "relu", "tanh"):
        np.testing.assert_allclose(tcommon.ACTIVATIONS[name](tx).numpy(),
                                   np.asarray(jcommon.ACTIVATIONS[name](jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tcommon.softcap(tx, 2.0).numpy(),
                               np.asarray(jcommon.softcap(jnp.asarray(x), 2.0)),
                               rtol=1e-5, atol=1e-6)
    # bf16: (1 + gamma) rounds in bf16 before the float32 product, as in JAX
    xb = torch.as_tensor(x).bfloat16()
    gb = torch.as_tensor(gamma).bfloat16()
    jb = jcommon.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(gamma, jnp.bfloat16))
    np.testing.assert_array_equal(tcommon.rms_norm(xb, gb).float().numpy(),
                                  np.asarray(jb).astype(np.float32))
    q = rng.normal(size=(2, 7, 4, 8)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)[None, :] + 3
    np.testing.assert_allclose(
        tattn.apply_rope(torch.as_tensor(q), torch.as_tensor(pos), 1e4).numpy(),
        np.asarray(jattn.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e4)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["gemma2-2b", "mixtral-8x7b"])
def test_remat_changes_nothing(name):
    _, tcfg, _, tp = _carried(name, seed=5)
    toks = torch.as_tensor(_tokens(6, (2, 24)))
    losses = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        loss, _ = tm.lm_loss(cfg, tp, toks, toks)
        (g,) = torch.autograd.grad(loss, [tp["layers"][0]["wq"]])
        losses.append((loss.detach(), g))
    assert torch.equal(losses[0][0], losses[1][0])
    torch.testing.assert_close(losses[0][1], losses[1][1], rtol=1e-6, atol=1e-9)


def test_mesh_only_options_are_refused():
    """The mesh-only options act only on a mesh: off one they are the plain
    path (as the JAX package's are without an abstract mesh), and on one
    sequence parallelism without the ZeRO-3 storage is refused."""
    from repro_torch.distributed import mesh_ops
    from repro_torch.launch.shardings import MeshShape

    _, tcfg, _, tp = _carried("gemma2-2b", seed=5)
    toks = torch.as_tensor(_tokens(6, (2, 24)))
    plain, _ = tm.lm_loss(tcfg, tp, toks, toks)
    for kw in ({"seq_parallel": ("data",)}, {"zero3_gather": True}):
        cfg = dataclasses.replace(tcfg, **kw)
        assert torch.equal(tm.lm_loss(cfg, tp, toks, toks)[0], plain)
    with mesh_ops.use_mesh(MeshShape(("data", "model"), (2, 2))):
        with pytest.raises(ValueError, match="zero3_gather"):
            tm.lm_loss(dataclasses.replace(tcfg, seq_parallel=("data",)),
                       tp, toks, toks)
