"""The port's AdamW, schedule, clipping and train step against the JAX
package's, on the same numpy-made parameters and gradients.

Tolerances: the learning rate, the global norm and one AdamW update agree
within 1e-6 absolute (float32 arithmetic in the same order; XLA may fuse
a multiply-add where PyTorch rounds twice, a last-bit difference);
``accum_steps=2`` equals the full batch within 1e-6 (linearity of the
gradient, float32 sums in another order).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.training import optimizer as jopt
from repro.training import steps as jsteps
from repro_torch.training import optimizer as topt
from repro_torch.training import steps as tsteps
from repro_torch.training import (AdamWConfig, TrainState, init_train_state,
                                  make_train_step)

ATOL = 1e-6
CFG = AdamWConfig(lr_peak=1e-2, warmup_steps=3, total_steps=12)


def _jcfg(cfg):
    return jopt.AdamWConfig(**dataclasses.asdict(cfg))


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 5)).astype(dtype),
            "layers": [{"a": rng.normal(size=(3, 4, 2)).astype(dtype),
                        "g": rng.normal(size=(4,)).astype(dtype)}],
            "b": np.asarray(rng.normal(), dtype=dtype)}


def _torch(tree, requires_grad=False):
    return jax.tree.map(lambda x: torch.tensor(np.array(x)).requires_grad_(
        requires_grad), tree)


def test_config_equals_jax():
    assert dataclasses.asdict(AdamWConfig()) == dataclasses.asdict(
        jopt.AdamWConfig())


@pytest.mark.parametrize("cfg", [CFG, AdamWConfig(lr_peak=3e-4, warmup_steps=0,
                                                  total_steps=5)],
                         ids=["warmup", "no_warmup"])
def test_cosine_warmup_lr_equals_jax(cfg):
    for step in range(0, cfg.total_steps + 4):
        got = float(topt.cosine_warmup_lr(cfg, torch.tensor(step, dtype=torch.int32)))
        want = float(jopt.cosine_warmup_lr(_jcfg(cfg), jnp.int32(step)))
        assert abs(got - want) <= ATOL * cfg.lr_peak, (step, got, want)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "passes"])
def test_clip_and_global_norm_equal_jax(max_norm):
    g = _tree(1)
    got, norm = topt.clip_by_global_norm(_torch(g), max_norm)
    want, jnorm = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    assert abs(float(norm) - float(jnorm)) <= ATOL * float(jnorm)
    assert abs(float(topt.global_norm(_torch(g))) - float(jnorm)) <= ATOL * float(jnorm)
    for a, b in zip(topt.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_equals_jax(moment_dtype):
    """Two updates of the same params, grads and state: params, moments and
    the step within 1e-6 (bf16 moments: within one bf16 rounding, 2^-8 of
    the moment), and weight decay only on leaves of ndim >= 2."""
    cfg = dataclasses.replace(CFG, moment_dtype=moment_dtype, weight_decay=0.1)
    p, g1, g2 = _tree(2), _tree(3), _tree(4)
    tp = _torch(p)
    tstate = topt.adamw_init(cfg, tp)
    jp = jax.tree.map(jnp.asarray, p)
    jstate = jopt.adamw_init(_jcfg(cfg), jp)
    for g in (g1, g2):
        versions = [x._version for x in topt.tree_leaves(tp)]
        tp, tstate, tm = topt.adamw_update(cfg, _torch(g), tstate, tp)
        jp, jstate, jm = jopt.adamw_update(_jcfg(cfg), jax.tree.map(jnp.asarray, g),
                                           jstate, jp)
        assert all(x._version > v for x, v in zip(topt.tree_leaves(tp), versions))
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= ATOL * cfg.lr_peak
    assert int(tstate.step) == int(jstate.step) == 2
    for a, b in zip(topt.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)
    for name in ("mu", "nu"):
        for a, b in zip(topt.tree_leaves(getattr(tstate, name)),
                        jax.tree_util.tree_leaves(getattr(jstate, name))):
            assert str(a.dtype).endswith(moment_dtype)
            b = np.asarray(b).astype(np.float32)
            tol = ATOL if moment_dtype == "float32" else 2**-8 * np.abs(b).max()
            np.testing.assert_allclose(a.float().numpy(), b, rtol=0, atol=tol)


def test_weight_decay_skips_vectors_and_scalars():
    cfg = dataclasses.replace(CFG, weight_decay=0.5)
    p = _tree(5)
    zeros = jax.tree.map(np.zeros_like, p)
    tp = _torch(p)
    tp, _, _ = topt.adamw_update(cfg, _torch(zeros), topt.adamw_init(cfg, tp), tp)
    assert torch.equal(tp["b"], torch.tensor(p["b"]))
    assert torch.equal(tp["layers"][0]["g"], torch.tensor(p["layers"][0]["g"]))
    assert not torch.equal(tp["w"], torch.tensor(p["w"]))


def test_tree_helpers_follow_jax_order():
    p = _tree(6)
    assert [x.shape for x in topt.tree_leaves(_torch(p))] == [
        np.shape(x) for x in jax.tree_util.tree_leaves(p)]
    leaves = topt.tree_leaves(_torch(p))
    back = topt.tree_unflatten(_torch(p), leaves)
    assert all(a is b for a, b in zip(topt.tree_leaves(back), leaves))
    with pytest.raises(ValueError, match="more leaves"):
        topt.tree_unflatten(_torch(p), leaves + leaves[:1])


def _lsq_loss(params, batch):
    """A least-squares loss whose gradient is linear in the batch rows."""
    pred = batch["x"] @ params["w"] + params["b"]
    loss = torch.mean((pred - batch["y"]) ** 2)
    return loss, {"mse": loss}


def _jlsq_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = jnp.mean((pred - batch["y"]) ** 2)
    return loss, {"mse": loss}


def _lsq(seed):
    rng = np.random.default_rng(seed)
    p = {"w": rng.normal(size=(5, 3)).astype(np.float32),
         "b": rng.normal(size=(3,)).astype(np.float32)}
    batch = {"x": rng.normal(size=(8, 5)).astype(np.float32),
             "y": rng.normal(size=(8, 3)).astype(np.float32)}
    return p, batch


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_equals_jax(accum):
    p, batch = _lsq(7)
    state = init_train_state(_torch(p, requires_grad=True), CFG)
    step = make_train_step(_lsq_loss, CFG, accum_steps=accum)
    jstate = jsteps.init_train_state(jax.tree.map(jnp.asarray, p), _jcfg(CFG))
    jstep = jax.jit(jsteps.make_train_step(_jlsq_loss, _jcfg(CFG),
                                           accum_steps=accum))
    for _ in range(3):
        state, m = step(state, {k: torch.tensor(v) for k, v in batch.items()})
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        for k in ("loss", "lr", "grad_norm", "mse"):
            assert abs(float(m[k]) - float(jm[k])) <= ATOL * max(1, abs(float(jm[k]))), k
    assert isinstance(state, TrainState)
    for k in p:
        np.testing.assert_allclose(state.params[k].detach().numpy(),
                                   np.asarray(jstate.params[k]), rtol=0, atol=ATOL)


def test_accum_steps_two_equals_full_batch():
    p, batch = _lsq(8)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    out = []
    for accum in (1, 2):
        state = init_train_state(_torch(p, requires_grad=True), CFG)
        state, m = make_train_step(_lsq_loss, CFG, accum_steps=accum)(state, tb)
        out.append((state, m))
    (s1, m1), (s2, m2) = out
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= ATOL
    assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) <= ATOL
    for k in p:
        torch.testing.assert_close(s1.params[k], s2.params[k], rtol=0, atol=ATOL)
        torch.testing.assert_close(s1.opt.mu[k], s2.opt.mu[k], rtol=0, atol=ATOL)


def test_module_params_count_as_their_named_parameters():
    lin = torch.nn.Linear(3, 2)
    state = init_train_state(lin, CFG)
    assert sorted(state.opt.mu) == ["bias", "weight"]
    assert [x.shape for x in topt.tree_leaves(lin)] == [(2,), (2, 3)]
    x = torch.randn(4, 3)

    def loss_fn(m, batch):
        return (m(batch["x"]) ** 2).mean(), {}

    before = lin.weight.detach().clone()
    state, metrics = make_train_step(loss_fn, CFG)(state, {"x": x})
    assert state.params is lin and not torch.equal(lin.weight, before)
    assert set(metrics) == {"loss", "lr", "grad_norm"}
    assert tsteps.TrainState is TrainState
