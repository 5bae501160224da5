"""The port's closure (its CPU path: the plain cascade) vs the JAX package's
``accel_reach_closure`` with the Pallas ``reach_step`` in interpret mode,
and the pure choices the wrappers make before a launch."""
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import queries as jq
from repro.kernels.ops import accel_reach_closure as j_accel_reach_closure
from repro_torch.core import queries as tq
from repro_torch.kernels import (
    build,
    ops,
    reach_closure,
    reach_closure_plain,
    reach_step,
    reach_step_plain,
)

# the module, which the package shadows with its wrapper of the same name
rc = importlib.import_module("repro_torch.kernels.reach_closure")

WIDTHS = [1, 2, 15, 17, 43, 136]
HOPS = [None, 1, 5]


def _table(w: int, seed: int) -> np.ndarray:
    """Counters of a sparse graph: about two edges a vertex, some of them
    counted more than once, so a closure takes several squarings."""
    rng = np.random.default_rng(seed)
    live = rng.random((3, w, w)) < min(1.0, 2.0 / w)
    return (rng.integers(1, 4, (3, w, w)) * live).astype(np.int32)


@functools.cache
def _jax_closure(w: int, max_hops):
    table = _table(w, w)
    steps = jq._closure_steps(w, max_hops)
    return table, steps, np.asarray(j_accel_reach_closure(
        jnp.asarray(table), block=32, n_steps=steps))


@pytest.mark.parametrize("max_hops", HOPS, ids=str)
@pytest.mark.parametrize("w", WIDTHS)
def test_accel_reach_closure_equals_jax(w, max_hops):
    table, steps, expect = _jax_closure(w, max_hops)
    got = ops.accel_reach_closure(torch.as_tensor(table), n_steps=steps)
    assert got.dtype == torch.bool and got.shape == (3, w, w)
    np.testing.assert_array_equal(got.numpy(), expect)
    built = tq.build_closure(torch.as_tensor(table), max_hops)
    np.testing.assert_array_equal(built.numpy(), expect)


@pytest.mark.parametrize("max_hops", HOPS, ids=str)
@pytest.mark.parametrize("w", WIDTHS)
def test_reach_closure_plain_equals_jax(w, max_hops):
    table, steps, expect = _jax_closure(w, max_hops)
    t = torch.as_tensor(table)
    np.testing.assert_array_equal(reach_closure_plain(t, steps).numpy(), expect)
    # the wrapper's CPU path is the plain version, and launches nothing
    reach_closure.launches = 0
    np.testing.assert_array_equal(reach_closure(t, steps).numpy(), expect)
    assert reach_closure.launches == 0


def test_path_graph_needs_every_squaring():
    """On a path 0 -> 1 -> ... -> w-1 the closure needs all ceil(log2(w-1))
    squarings: one fewer leaves the far end unreached."""
    w = 43
    table = np.zeros((1, w, w), np.int32)
    table[0, np.arange(w - 1), np.arange(1, w)] = 1
    need = (w - 2).bit_length()
    assert need == tq._closure_steps(w, None) == 6
    full = reach_closure_plain(torch.as_tensor(table), need)[0]
    assert bool(torch.equal(full, torch.ones(w, w, dtype=torch.bool).triu()))
    short = reach_closure_plain(torch.as_tensor(table), need - 1)[0]
    assert not bool(short[0, w - 1])


@pytest.mark.parametrize("value", [2.0, 0.5, -1.0])
def test_reach_step_refuses_non_binary_input_on_cpu(value):
    reach = torch.eye(4).unsqueeze(0).contiguous()
    reach[0, 1, 2] = value
    reach_step.launches = 0
    with pytest.raises(ValueError, match="only 0 and 1"):
        reach_step(reach)
    assert reach_step.launches == 0
    assert torch.equal(reach_step(torch.eye(4)[None].contiguous()),
                       reach_step_plain(torch.eye(4)[None]))


def test_reach_closure_rejects_bad_inputs():
    table = torch.zeros((2, 5, 5), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        reach_closure(table.float(), 1)
    with pytest.raises(ValueError, match=r"\[d, w, w\]"):
        reach_closure(table[:, :4], 1)
    with pytest.raises(ValueError, match="contiguous"):
        reach_closure(table.transpose(1, 2), 1)
    with pytest.raises(ValueError, match="n_steps"):
        reach_closure(table, -1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        reach_closure(torch.zeros((1, 4, 4), dtype=torch.int32,
                                  device="meta"), 1)


def test_closure_limit_is_the_shared_memory_of_one_block():
    """Two bf16 copies of the layer padded to 16-row multiples, rows 8
    columns longer: w = 224 fits the 232,448 bytes, w = 225 does not."""
    assert rc.CLOSURE_MAX_W == 224
    assert rc.closure_smem_bytes(136) == 2 * 144 * 152 * 2 == 87_552
    assert rc.closure_smem_bytes(224) == 207_872 <= rc.SMEM_BLOCK_MAX
    assert rc.closure_smem_bytes(225) == 238_080 > rc.SMEM_BLOCK_MAX
    assert [rc.closure_fits(w) for w in (1, 223, 224, 225, 1024)] == [
        True, True, True, False, False]


@pytest.mark.parametrize("w,route", [(223, "closure"), (224, "closure"),
                                     (225, "cascade")])
def test_accel_reach_closure_routes_at_the_limit(monkeypatch, w, route):
    """Below and at the limit the kernel path is one reach_closure call;
    above it, the reach_step cascade; the plain step always cascades."""
    calls = []

    def closure(table, n_steps):
        calls.append(("closure", n_steps))
        return reach_closure_plain(table, n_steps)

    def cascade(table, n_steps, step):
        calls.append(("cascade", n_steps, step))
        return rc.closure_cascade(table, n_steps, step)

    monkeypatch.setattr(ops, "reach_closure", closure)
    monkeypatch.setattr(ops, "closure_cascade", cascade)
    table = torch.zeros((1, w, w), dtype=torch.int32)
    ops.accel_reach_closure(table, n_steps=1)
    expect = ("closure", 1) if route == "closure" else ("cascade", 1, reach_step)
    assert calls == [expect]
    calls.clear()
    ops.accel_reach_closure(table, n_steps=1, step=reach_step_plain)
    assert calls == [("cascade", 1, reach_step_plain)]


def test_step_tile_fills_the_card():
    assert rc.step_tile(7, 43) == 32  # 28 blocks: the small tile
    assert rc.step_tile(7, 136) == 32  # 175 blocks, not 14 at 128 x 128
    assert rc.step_tile(7, 273) == 32  # 567 blocks, not 63
    assert rc.step_tile(7, 1024) == 128  # 448 blocks
    assert rc.step_tile(1, 1024) == 32  # 64 blocks at 128 x 128 is too few
    assert rc.step_tile(3, 1024) == 128  # 192 blocks
    for d, w in ((1, 1), (3, 17), (7, 500), (2, 4096)):
        tile = rc.step_tile(d, w)
        assert tile in rc.STEP_TILES
        assert tile == 32 or d * (-(-w // tile)) ** 2 >= build.SMS
