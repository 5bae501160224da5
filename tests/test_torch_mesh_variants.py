"""The transformer's mesh-only variants and the table-parallel FM on four
gloo ranks of a (2, 2) ("data", "model") mesh on the CPU, against the same
computations unsharded: the port's plain path in this process and the
JAX package's unsharded functions, fed the same numpy inputs.

At ``reduced()`` scale in float32, with ``seq_parallel=("data",)``,
``zero3_gather`` and, for mixtral, ``moe_groups=2`` (the yardsticks use
the same groups, so the same assignments drop).  Each rank holds its
blocks of ``launch/shardings.py``'s specs.  Tolerances: losses within
1e-5 relative; outputs and gradient blocks within 1e-5 of the leaf's
largest magnitude (+1e-8); FM logits rtol 1e-5, atol 1e-6 (phase G's).

The sharded MoE is also held against the JAX package's shard_map branch
(``moe_ffn_grouped`` with ``group_axes``), run in a subprocess on four
forced host devices with ``AxisType.Auto`` axes: ungated the two agree;
gated the reference's branch takes other rows of ``w_out`` than the
columns of ``w_in`` it meets and differs from its own plain branch, which
the port equals (ROADMAP.md, §C).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm as jlm
from repro.models.recsys import fm as jfm
from repro.models.transformer import model as jm
from repro.models.transformer import moe as jmoe
from repro_torch import interop
from repro_torch.configs import lm as tlm
from repro_torch.distributed import mesh_ops, run_ranks
from repro_torch.launch import shardings as sh
from repro_torch.models.recsys import fm as tfm
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer import moe as tmoe
from repro_torch.training import AdamWConfig, init_train_state, make_train_step
from repro_torch.training.steps import lm_loss_fn, mesh_grads, mesh_update

REPO = Path(__file__).resolve().parents[1]
MESH = sh.MeshShape(("data", "model"), (2, 2))
WAIT_S = 240.0
B, S = 4, 64
LMS = {"gemma2-2b": False, "mixtral-8x7b": True}  # name -> remat
MOE = dict(t=64, d=16, e=4, f=8, top_k=2, cf=1.25, act="silu", groups=2)
FM_CFG = tfm.FMConfig(total_vocab=5_000, n_fields=7)


def _cfg(name: str, remat: bool, mesh: bool = True):
    cfg = dataclasses.replace(tlm.reduced(tlm.LM_CONFIGS[name]), remat=remat,
                              moe_groups=2 if "mixtral" in name else 1)
    if mesh:
        cfg = dataclasses.replace(cfg, seq_parallel=("data",), zero3_gather=True)
    return cfg


def _jcfg(name: str, remat: bool):
    return dataclasses.replace(jlm.reduced(jlm.LM_CONFIGS[name]), remat=remat,
                               moe_groups=2 if "mixtral" in name else 1)


def _np(t):
    return t.detach().numpy().copy()


def _keyed(tree) -> dict:
    return {k: _np(v) for k, v in sh.tree_items(tree)}


def _lm_inputs(name: str):
    rng = np.random.default_rng(7)
    jp = jm.init_params(_jcfg(name, False), jax.random.PRNGKey(3))
    np_params = jax.tree.map(np.asarray, jp)
    tokens = rng.integers(0, 512, (B, S)).astype(np.int32)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    r = rng.standard_normal((B, S, 64)).astype(np.float32)
    return np_params, tokens, x, r


def _moe_inputs():
    rng = np.random.default_rng(11)
    m = MOE
    return {"x": rng.standard_normal((m["t"], m["d"])).astype(np.float32),
            "router": rng.standard_normal((m["d"], m["e"])).astype(np.float32),
            "w_in_gated": (0.3 * rng.standard_normal((m["e"], m["d"], 2 * m["f"]))
                           ).astype(np.float32),
            "w_in": (0.3 * rng.standard_normal((m["e"], m["d"], m["f"]))
                     ).astype(np.float32),
            "w_out": (0.3 * rng.standard_normal((m["e"], m["f"], m["d"]))
                      ).astype(np.float32)}


def _fm_inputs():
    rng = np.random.default_rng(5)
    rows, k = FM_CFG.table_rows, FM_CFG.embed_dim
    return {"emb": (0.1 * rng.standard_normal((rows, k))).astype(np.float32),
            "lin": (0.1 * rng.standard_normal((rows, 1))).astype(np.float32),
            "bias": np.float32(0.25),
            "ids": rng.integers(0, 1 << 30, (16, FM_CFG.n_fields)).astype(np.int32),
            "r": rng.standard_normal(16).astype(np.float32),
            "labels": rng.integers(0, 2, 16).astype(np.float32)}


SERVE_LEN, SERVE_MAX = 16, 32


def _serve_inputs(name, np_params):
    """A prompt, the next tokens, and the port's plain prefill and decode:
    (prompt, next, the prefill cache's arrays, prefill logits, decode
    logits)."""
    rng = np.random.default_rng(13)
    prompt = rng.integers(0, 512, (B, SERVE_LEN)).astype(np.int32)
    nxt = rng.integers(0, 512, (B, 1)).astype(np.int32)
    cfg = _cfg(name, False, mesh=False)
    tp = interop.lm_params_from_jax(cfg, np_params, device="cpu",
                                    requires_grad=False)
    cache = tm.init_cache(cfg, B, SERVE_MAX, dtype=torch.float32, device="cpu")
    logits, cache = tm.prefill(cfg, tp, torch.as_tensor(prompt), cache)
    arrays = tuple(_np(c) for c in cache[:4])
    step, _ = tm.decode_step(cfg, tp, torch.as_tensor(nxt), cache)
    return prompt, nxt, arrays, _np(logits), _np(step)


# ------------------------------------------------------------ the ranks --

def _lm_rank(mesh, name, remat, np_params, tokens, x, r):
    cfg = _cfg(name, remat)
    params = interop.lm_params_from_jax(cfg, np_params, device="cpu")
    specs = sh.lm_param_specs(params, mesh)
    local = sh.shard_tree(params, specs, mesh)
    tok = sh.local_block(torch.as_tensor(tokens), sh.P(("data",), None), mesh)
    batch = {"tokens": tok, "labels": tok}
    seq = sh.P(("data",), "model", None)
    x_l = sh.local_block(torch.as_tensor(x), seq, mesh).requires_grad_(True)
    r_l = sh.local_block(torch.as_tensor(r), seq, mesh)
    p0 = {k: v[0] for k, v in local["layers"][0].items()}
    out = {}
    with mesh_ops.use_mesh(mesh):
        # _gather_weight / the MoE branch: the FFN of layer 0 on this rank's
        # block of the sequence; its loss share is sum(out * r) over it
        ffn, _ = tm._ffn_block(cfg, p0, x_l, mesh, True)
        ws = [p0["w_in"], p0["w_out"]]
        g_ffn = torch.autograd.grad((ffn * r_l).sum(), ws + [x_l])
        out["ffn"] = _np(ffn)
        out["ffn_grads"] = [_np(g) for g in g_ffn]
        # the sharded embedding: a share of sum(embed[tok] * r') per rank,
        # the rows' gradient summed over "data"
        r_tok = sh.local_block(torch.as_tensor(r), sh.P(("data",), None, None),
                               mesh)
        emb_x = tm.embed_tokens(cfg, local, tok)
        (g_emb,) = torch.autograd.grad((emb_x * r_tok).sum() / 2,
                                       [local["embed"]])
        out["embed"] = _np(emb_x)
        out["embed_grad"] = _np(mesh_ops.psum(g_emb, "data", mesh))
        # sequence parallelism: this rank's block of the final hidden states
        pos = torch.arange(S, dtype=torch.int32)[None, :]
        out["hidden"] = _np(tm.forward_hidden(cfg, local, tok, pos)[0])
        # the whole train step: loss, gradient blocks, one AdamW step
        loss, metrics, grads = mesh_grads(lm_loss_fn(cfg), local, batch,
                                          specs, mesh)
        out["loss"], out["ce"] = float(loss), float(metrics["ce"])
        out["grads"] = dict(zip([k for k, _ in sh.tree_items(specs)],
                                map(_np, grads)))
        state = init_train_state(local, AdamWConfig())
        state, opt_m = mesh_update(AdamWConfig(), state, grads, specs, mesh)
        out["grad_norm"] = float(opt_m["grad_norm"])
        out["updated"] = _keyed(state.params)
    return out


def _moe_rank(mesh, arrs):
    m = MOE
    x = sh.local_block(torch.as_tensor(arrs["x"]), sh.P(("data",), None), mesh)
    every = ("data", "model")
    out = {}
    for gated in (True, False):
        w_in = torch.as_tensor(arrs["w_in_gated" if gated else "w_in"])
        w_in = sh.local_block(w_in, sh.P(None, None, every), mesh)
        w_out = sh.local_block(torch.as_tensor(arrs["w_out"]),
                               sh.P(None, every, None), mesh)
        y, aux = tmoe.moe_ffn_grouped(
            x, torch.as_tensor(arrs["router"]), w_in, w_out, top_k=m["top_k"],
            capacity_factor=m["cf"], act=m["act"], gated=gated, mesh=mesh)
        out["gated" if gated else "ungated"] = (_np(y), float(aux))
    return out


def _fm_rank(mesh, arrs):
    full = {"bias": torch.as_tensor(arrs["bias"]),
            "emb": torch.as_tensor(arrs["emb"]), "lin": torch.as_tensor(arrs["lin"])}
    specs = sh.fm_param_specs(full, mesh)
    local = sh.shard_tree(full, specs, mesh)
    ids = sh.local_block(torch.as_tensor(arrs["ids"]), sh.P(("data",), None), mesh)
    tables = tfm.TableRows().of(local)
    with torch.no_grad():
        logits = tfm.forward(FM_CFG, tables, ids, mesh)
        labels = sh.local_block(torch.as_tensor(arrs["labels"]), sh.P(("data",)),
                                mesh)
        bce = mesh_ops.psum(tfm.bce_loss(FM_CFG, tables, ids, labels, mesh),
                            ("data", "model"), mesh)
    # the train cell's path: the share of sum(logits * r) per rank (the
    # model ranks of a data shard hold the same logits), the table blocks'
    # gradients summed over "data"
    for leaf in local.values():
        leaf.requires_grad_(True)
    r = sh.local_block(torch.as_tensor(arrs["r"]), sh.P(("data",)), mesh)
    score = tfm.forward(FM_CFG, tables.of(local), ids, mesh)
    loss = (score * r).sum() / mesh_ops.axis_size(mesh, "model")
    grads = torch.autograd.grad(loss, [local["emb"], local["lin"]])
    return {"logits": _np(logits), "bce": float(bce), "grads": [
        _np(mesh_ops.psum(g, "data", mesh)) for g in grads]}


def _serve_rank(mesh, name, np_params, prompt, nxt, cache_np):
    """The serve cells' paths: prefill into this rank's head_dim block of
    the cache, and one decode step against its block of the sequence of
    the plain prefill's cache."""
    cfg = dataclasses.replace(_cfg(name, False), seq_parallel=None)
    params = interop.lm_params_from_jax(cfg, np_params, device="cpu",
                                        requires_grad=False)
    local = sh.shard_tree(params, sh.lm_param_specs(params, mesh), mesh)
    tok = sh.P(("data",), None)
    full = tm.KVCache(*(torch.as_tensor(c) for c in cache_np), 0)

    def blocks(kind):
        specs = sh.lm_cache_specs(full, mesh, batch=B, kind=kind)
        return sh.tree_map(lambda _k, t, p: sh.local_block(t, p, mesh)
                           if isinstance(t, torch.Tensor) else t, full, specs)

    with mesh_ops.use_mesh(mesh):
        logits, cache = tm.prefill(cfg, local, sh.local_block(
            torch.as_tensor(prompt), tok, mesh), blocks("prefill"))
        dec = blocks("decode")._replace(length=prompt.shape[1])
        step, _ = tm.decode_step(cfg, local, sh.local_block(
            torch.as_tensor(nxt), tok, mesh), dec)
    return {"prefill": _np(logits), "cache_k": _np(cache.k),
            "decode": _np(step)}


def _mesh_rank(rank, world, lm_jobs, serve_jobs, moe_arrs, fm_arrs):
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"))
    out = {"coord": sh.mesh_coord(mesh)}
    for name, job in lm_jobs.items():
        out[name] = _lm_rank(mesh, name, *job)
        out[name]["serve"] = _serve_rank(mesh, name, job[1], *serve_jobs[name])
    out["moe"] = _moe_rank(mesh, moe_arrs)
    out["fm"] = _fm_rank(mesh, fm_arrs)
    return out


# -------------------------------------------------- the JAX shard_map --

_JAX_MOE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
from jax.sharding import AxisType
from repro.models.transformer import moe

src, dst, top_k, cf, act, groups = sys.argv[1:7]
a = dict(np.load(src))
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
for gated in (True, False):
    args = (a["x"], a["router"], a["w_in_gated" if gated else "w_in"], a["w_out"])
    kw = dict(top_k=int(top_k), capacity_factor=float(cf), act=act,
              gated=gated, groups=int(groups))
    y, _ = moe.moe_ffn_grouped(*args, **kw, group_axes=None)
    out[f"plain_{gated}"] = np.asarray(y)
    with jax.set_mesh(mesh):
        y, _ = jax.jit(lambda *xs: moe.moe_ffn_grouped(
            *xs, **kw, group_axes=("data",)))(*args)
    out[f"shard_map_{gated}"] = np.asarray(y)
np.savez(dst, **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_variants")
    moe_arrs, fm_arrs = _moe_inputs(), _fm_inputs()
    np.savez(tmp / "moe_in.npz", **moe_arrs)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    m = MOE
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _JAX_MOE, str(tmp / "moe_in.npz"),
         str(tmp / "moe_out.npz"), str(m["top_k"]), str(m["cf"]), m["act"],
         str(m["groups"])], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    lm_inputs = {name: _lm_inputs(name) for name in LMS}
    serve = {name: _serve_inputs(name, lm_inputs[name][0]) for name in LMS}
    try:
        ranks = run_ranks(_mesh_rank, 4,
                          {n: (LMS[n], *lm_inputs[n]) for n in LMS},
                          {n: serve[n][:3] for n in LMS},
                          moe_arrs, fm_arrs, device="cpu", timeout_s=WAIT_S)
        _, err = jax_run.communicate(timeout=WAIT_S)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    assert jax_run.returncode == 0, err[-3000:]
    return {"ranks": ranks, "lm": lm_inputs, "serve": serve,
            "moe": moe_arrs, "fm": fm_arrs,
            "jax_moe": dict(np.load(tmp / "moe_out.npz"))}


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    tol = rel * max(float(np.abs(want).max()), 0.0) + 1e-8
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _block(full, spec, coord):
    return np.asarray(full)[sh.block_slices(np.shape(full), spec, MESH, coord)]


def _ref_lm(name, runs):
    """The JAX package's and the port's plain-path numbers for ``name``."""
    np_params, tokens, x, r = runs["lm"][name]
    remat = LMS[name]
    jcfg = _jcfg(name, remat)
    jp = jax.tree.map(jnp.asarray, np_params)
    tcfg = _cfg(name, remat, mesh=False)
    tp = interop.lm_params_from_jax(tcfg, np_params, device="cpu")
    return jcfg, jp, tcfg, tp, tokens, x, r


SEQ = sh.P(("data",), "model", None)


@pytest.mark.parametrize("name", sorted(LMS))
def test_gather_weight_ffn_equals_the_unsharded_ffn(runs, name):
    jcfg, jp, tcfg, tp, tokens, x, r = _ref_lm(name, runs)
    p0 = {k: v[0] for k, v in jp["layers"][0].items()}

    def f(w_in, w_out, xx):
        out, _ = jm._ffn_block(jcfg, dict(p0, w_in=w_in, w_out=w_out), xx)
        return jnp.sum(out * r), out

    (gi, go, gx), out = jax.grad(f, argnums=(0, 1, 2), has_aux=True)(
        p0["w_in"], p0["w_out"], jnp.asarray(x))
    tp0 = {k: v[0] for k, v in tp["layers"][0].items()}
    t_out, _ = tm._ffn_block(tcfg, tp0, torch.as_tensor(x))
    every = ("data", "model")
    for rank in runs["ranks"]:
        c, got = rank["coord"], rank[name]
        _close(got["ffn"], _block(out, SEQ, c))
        _close(got["ffn"], _block(_np(t_out), SEQ, c))
        w_in_spec = sh.P(*([None] * (gi.ndim - 1)), every)
        w_out_spec = sh.P(*([None] * (go.ndim - 2)), every, None)
        _close(got["ffn_grads"][0], _block(gi, w_in_spec, c))
        _close(got["ffn_grads"][1], _block(go, w_out_spec, c))
        _close(got["ffn_grads"][2], _block(gx, SEQ, c))


@pytest.mark.parametrize("name", sorted(LMS))
def test_sharded_embedding_and_its_gradient_equal_the_plain_lookup(runs, name):
    jcfg, jp, _, _, tokens, x, r = _ref_lm(name, runs)

    def f(e):
        xx = jm.embed_tokens(jcfg, dict(jp, embed=e), jnp.asarray(tokens))
        return jnp.sum(xx * r), xx

    g, emb = jax.grad(f, has_aux=True)(jp["embed"])
    for rank in runs["ranks"]:
        c, got = rank["coord"], rank[name]
        _close(got["embed"], _block(emb, sh.P(("data",), None, None), c))
        _close(got["embed_grad"], _block(g, sh.P("model", None), c))


@pytest.mark.parametrize("name", sorted(LMS))
def test_sequence_parallel_hidden_states_equal_the_plain_forward(runs, name):
    jcfg, jp, _, _, tokens, _, _ = _ref_lm(name, runs)
    pos = jnp.arange(S, dtype=jnp.int32)[None, :]
    hidden, _ = jm.forward_hidden(jcfg, jp, jnp.asarray(tokens), pos)
    for rank in runs["ranks"]:
        _close(rank[name]["hidden"], _block(hidden, SEQ, rank["coord"]))


@pytest.mark.parametrize("name", sorted(LMS))
def test_sharded_train_step_equals_the_unsharded_step(runs, name):
    jcfg, jp, tcfg, tp, tokens, _, _ = _ref_lm(name, runs)
    (j_loss, j_m), j_grads = jax.value_and_grad(
        lambda p: jm.lm_loss(jcfg, p, jnp.asarray(tokens), jnp.asarray(tokens)),
        has_aux=True)(jp)
    j_grads = {k: np.asarray(v) for k, v in sh.tree_items(
        jax.tree.map(np.asarray, j_grads))}
    specs = sh.lm_param_specs(tp, MESH)
    spec_of = dict(sh.tree_items(specs))
    assert set(spec_of) == set(j_grads)
    state = init_train_state(tp, AdamWConfig())
    t_tok = torch.as_tensor(tokens)
    state, t_m = make_train_step(lm_loss_fn(tcfg), AdamWConfig())(
        state, {"tokens": t_tok, "labels": t_tok})
    updated = _keyed(state.params)
    for rank in runs["ranks"]:
        c, got = rank["coord"], rank[name]
        np.testing.assert_allclose(got["loss"], float(j_loss), rtol=1e-5)
        np.testing.assert_allclose(got["ce"], float(j_m["ce"]), rtol=1e-5)
        np.testing.assert_allclose(got["loss"], float(t_m["loss"]), rtol=1e-5)
        # the global norm from the blocks: each leaf's squares once
        np.testing.assert_allclose(got["grad_norm"], float(t_m["grad_norm"]),
                                   rtol=1e-5)
        assert set(got["grads"]) == set(j_grads)
        for k, g in got["grads"].items():
            _close(g, _block(j_grads[k], spec_of[k], c))
        for k, p in got["updated"].items():
            # one AdamW step moves a leaf by at most lr; the blocks agree
            # to the float32 noise of the moments' normalisation
            np.testing.assert_allclose(p, _block(updated[k], spec_of[k], c),
                                       rtol=0, atol=2e-6)


def _jax_plain_moe(arrs, gated):
    m = MOE
    y, _ = jmoe.moe_ffn_grouped(
        jnp.asarray(arrs["x"]), jnp.asarray(arrs["router"]),
        jnp.asarray(arrs["w_in_gated" if gated else "w_in"]),
        jnp.asarray(arrs["w_out"]), top_k=m["top_k"], capacity_factor=m["cf"],
        act=m["act"], gated=gated, groups=m["groups"])
    return np.asarray(y)


def _port_moe(runs, key):
    half = MOE["t"] // 2
    y = np.zeros((MOE["t"], MOE["d"]), np.float32)
    for rank in runs["ranks"]:
        d = rank["coord"]["data"]
        y[d * half:(d + 1) * half] = rank["moe"][key][0]
    return y


def test_sharded_gated_moe_equals_the_jax_plain_branch(runs):
    want = _jax_plain_moe(runs["moe"], True)
    _close(_port_moe(runs, "gated"), want)
    _close(runs["jax_moe"]["plain_True"], want)


def test_sharded_ungated_moe_equals_the_jax_shard_map_branch(runs):
    want = runs["jax_moe"]["shard_map_False"]
    _close(_port_moe(runs, "ungated"), want)
    _close(_jax_plain_moe(runs["moe"], False), want)


def test_reference_gated_shard_map_diverges_from_its_plain_branch(runs):
    """The JAX branch's gated experts: its ``w_out`` block covers other d_ff
    indices than the gate/up columns it multiplies, so it is not the
    function of its own plain branch (ROADMAP.md, §C)."""
    plain, sm = runs["jax_moe"]["plain_True"], runs["jax_moe"]["shard_map_True"]
    gap = float(np.abs(sm - plain).max())
    assert gap > 0.1 * float(np.abs(plain).max()), gap


def test_table_parallel_fm_forward_equals_the_plain_forward(runs):
    a = runs["fm"]
    jcfg = jfm.FMConfig(total_vocab=5_000, n_fields=7)
    jp = {"emb": jnp.asarray(a["emb"]), "lin": jnp.asarray(a["lin"]),
          "bias": jnp.asarray(a["bias"])}
    want = np.asarray(jfm.forward(jcfg, jp, jnp.asarray(a["ids"])))
    fm = tfm.FM(FM_CFG, torch.as_tensor(a["emb"]), torch.as_tensor(a["lin"]),
                torch.as_tensor(a["bias"]))
    plain = _np(tfm.forward(FM_CFG, fm, torch.as_tensor(a["ids"])))
    for rank in runs["ranks"]:
        block = _block(want, sh.P(("data",)), rank["coord"])
        np.testing.assert_allclose(rank["fm"]["logits"], block, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(rank["fm"]["logits"],
                                   _block(plain, sh.P(("data",)), rank["coord"]),
                                   rtol=1e-5, atol=1e-6)


def test_table_parallel_fm_bce_shares_sum_to_the_plain_loss(runs):
    """The mesh train cell's loss: the ranks' shares of the mean BCE sum to
    the unsharded port's and the JAX package's."""
    a = runs["fm"]
    jcfg = jfm.FMConfig(total_vocab=5_000, n_fields=7)
    jp = {"emb": jnp.asarray(a["emb"]), "lin": jnp.asarray(a["lin"]),
          "bias": jnp.asarray(a["bias"])}
    want = float(jfm.bce_loss(jcfg, jp, jnp.asarray(a["ids"]),
                              jnp.asarray(a["labels"])))
    fm = tfm.FM(FM_CFG, torch.as_tensor(a["emb"]), torch.as_tensor(a["lin"]),
                torch.as_tensor(a["bias"]))
    plain = float(tfm.bce_loss(FM_CFG, fm, torch.as_tensor(a["ids"]),
                               torch.as_tensor(a["labels"])))
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["fm"]["bce"], want, rtol=1e-5)
        np.testing.assert_allclose(rank["fm"]["bce"], plain, rtol=1e-5)


def test_table_parallel_fm_gradient_equals_the_plain_gradient(runs):
    """The weighted bags' backward of the table-parallel train cell (the
    unweighted backward kernel's path, one bag per pair)."""
    a = runs["fm"]
    jcfg = jfm.FMConfig(total_vocab=5_000, n_fields=7)

    def f(emb, lin):
        p = {"emb": emb, "lin": lin, "bias": jnp.asarray(a["bias"])}
        return jnp.sum(jfm.forward(jcfg, p, jnp.asarray(a["ids"])) * a["r"])

    g_emb, g_lin = jax.grad(f, argnums=(0, 1))(jnp.asarray(a["emb"]),
                                              jnp.asarray(a["lin"]))
    for rank in runs["ranks"]:
        got_emb, got_lin = rank["fm"]["grads"]
        _close(got_emb, _block(g_emb, sh.P("model", None), rank["coord"]))
        _close(got_lin, _block(g_lin, sh.P("model", None), rank["coord"]))


@pytest.mark.parametrize("name", sorted(LMS))
def test_sharded_prefill_and_decode_equal_the_plain_serve_path(runs, name):
    """The serve cells' layouts: prefill writes each rank's head_dim block
    of the cache; decode reads each rank's block of the sequence with a
    distributed softmax; logits gathered over the vocab."""
    _, _, (k_full, *_), prefill, decode = runs["serve"][name]
    for rank in runs["ranks"]:
        c, got = rank["coord"], rank[name]["serve"]
        _close(got["prefill"], _block(prefill, sh.P(("data",), None, None), c))
        _close(got["decode"], _block(decode, sh.P(("data",), None, None), c))
        spec = sh.P(None, None, ("data",), None, None, "model")
        _close(got["cache_k"], _block(k_full, spec, c))
