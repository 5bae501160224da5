"""The port's distributed sketch (``repro_torch.distributed``,
``repro_torch.launch.mesh``) against the JAX package's ``sketch_parallel``.

Four gloo ranks on the CPU run every mode on a (2, 2) mesh: data-parallel,
partition-parallel allgather, and a2a at cf = 4 and at cf = 0.5, where
capacity binds.  The reference runs in a subprocess on 8 forced host
devices, its mesh built with ``AxisType.Auto`` axes (with jax 0.9's default
``Explicit`` axes its a2a raises at the ``associative_scan``) and its
functions under ``jax.jit``; it writes an ``.npz`` that the ranks' stacked
states are held against.  Both sides ingest the same batches: a small
cit-HepPh stream and, last, a turnstile batch that deletes a third of
batch 0.  Every rank is spawned with ``file://`` rendezvous and joined with
a bound.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import KMatrix, kmatrix, vertex_stats_from_sample
from repro_torch.core.types import EdgeBatch
from repro_torch.distributed import (
    RankFailure,
    build_owner_map,
    choose_topology,
    collective_stats,
    make_dp_edge_freq,
    make_dp_ingest,
    make_pp_edge_freq,
    make_pp_ingest,
    run_ranks,
    stacked_state,
)
from repro_torch.distributed import group
from repro_torch.launch import mesh as tmesh
from repro_torch.streams import make_stream, sample_stream

REPO = Path(__file__).resolve().parents[1]
CFG = dict(scale=0.02, batch=1024, seed=3, sample=2000, sample_seed=5,
           budget=1 << 16, depth=3, sk_seed=1, queries=256, query_seed=9)
SHAPE = (2, 2)
N_MODEL = SHAPE[1]
# mode key -> (mode, capacity factor); cf = 0.5 gives cap = 64 of a
# 256-edge model slice, so the heavy partitions overflow
MODES = {"dp": ("dp", None), "allgather": ("allgather", None),
         "a2a_cf4": ("a2a", 4.0), "a2a_cf0.5": ("a2a", 0.5)}
MESH_SHAPES = [(2, 2), (1, 4), (4, 1)]
WAIT_S = 240.0

_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.core import KMatrix, kmatrix, vertex_stats_from_sample
from repro.distributed.sketch_parallel import (
    build_owner_map, make_dp_edge_freq, make_dp_ingest, make_pp_edge_freq,
    make_pp_ingest)
from repro.launch.mesh import make_debug_mesh
from repro.streams import make_stream, sample_stream

cfg = json.loads(sys.argv[1])
inp = np.load(sys.argv[2])
out = {}
stream = make_stream("cit-HepPh", batch_size=cfg["batch"], seed=cfg["seed"],
                     scale=cfg["scale"])
own = np.stack([np.stack(stream.batch_numpy(i))
                for i in range(stream.num_batches)])
assert (own == inp["batches"][:len(own)]).all(), "streams differ"
ssrc, sdst, sw = sample_stream(stream, cfg["sample"], seed=cfg["sample_seed"])
sk0 = KMatrix.create(bytes_budget=cfg["budget"],
                     stats=vertex_stats_from_sample(ssrc, sdst, sw),
                     depth=cfg["depth"], seed=cfg["sk_seed"])
out["widths"] = np.asarray(sk0.route.widths)
for n in (1, 2, 3, 4, 8):
    out[f"owner_{n}"] = build_owner_map(sk0, n)
for n in range(1, 9):
    out[f"debug_shape_{n}"] = np.array(make_debug_mesh(n).devices.shape)
auto = lambda k: (AxisType.Auto,) * k
for shape in cfg["mesh_shapes"]:
    m = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=auto(2),
                      devices=jax.devices()[:int(np.prod(shape))])
    out["ids_%dx%d" % tuple(shape)] = np.vectorize(lambda d: d.id)(m.devices)

mesh = jax.make_mesh(tuple(cfg["shape"]), ("data", "model"),
                     axis_types=auto(2), devices=jax.devices()[:4])
qs, qd = jnp.asarray(inp["qs"]), jnp.asarray(inp["qd"])
d, P = sk0.pool.shape
cw = sk0.conn.shape[1:]
n_data, n_rep = mesh.shape["data"], mesh.shape["data"] * mesh.shape["model"]
for key, (mode, cf) in cfg["modes"].items():
    if mode == "dp":
        ingest = jax.jit(make_dp_ingest(sk0, mesh))
        query = jax.jit(make_dp_edge_freq(sk0, mesh))
        rows = n_data
    else:
        fn, _ = make_pp_ingest(sk0, mesh, mode=mode, capacity_factor=cf or 2.0)
        ingest = jax.jit(fn)
        query = jax.jit(make_pp_edge_freq(sk0, mesh))
        rows = n_rep
    pool = jnp.zeros((rows * d, P), jnp.int32)
    conn = jnp.zeros((rows * d,) + cw, jnp.int32)
    drops = []
    for s, t, w in inp["batches"]:
        res = ingest(pool, conn, jnp.asarray(s), jnp.asarray(t), jnp.asarray(w))
        pool, conn = res[0], res[1]
        if mode != "dp":
            drops.append(int(res[2]))
    out[key + "_pool"] = np.asarray(pool)
    out[key + "_conn"] = np.asarray(conn)
    out[key + "_est"] = np.asarray(query(pool, conn, qs, qd))
    out[key + "_drops"] = np.array(drops, np.int64)
np.savez(sys.argv[3], **out)
print("REFERENCE_OK")
"""


def _stream():
    return make_stream("cit-HepPh", batch_size=CFG["batch"], seed=CFG["seed"],
                       scale=CFG["scale"])


def _batches(stream) -> np.ndarray:
    """[n, 3, B]: the stream's batches, then a turnstile batch that deletes
    every third live edge of batch 0."""
    rows = [np.stack(stream.batch_numpy(i)) for i in range(stream.num_batches)]
    s, t, w = rows[0]
    turn = np.where((np.arange(w.size) % 3 == 0) & (w > 0), -1, 0)
    rows.append(np.stack([s, t, turn.astype(np.int32)]))
    return np.stack(rows)


def _template(stream) -> KMatrix:
    ssrc, sdst, sw = sample_stream(stream, CFG["sample"],
                                   seed=CFG["sample_seed"])
    return KMatrix.create(bytes_budget=CFG["budget"],
                          stats=vertex_stats_from_sample(ssrc, sdst, sw),
                          depth=CFG["depth"], seed=CFG["sk_seed"], device="cpu")


def _port_ranks(rank, world, leaves, static, batches, qs, qd):
    """Every mode on a (2, 2) mesh, then the coordinates of each mesh
    shape; rank 0 returns the stacked states."""
    sk = interop.import_state(leaves, static, device=group.rank_device())
    mesh = tmesh.make_mesh(SHAPE, ("data", "model"))
    dev = group.rank_device()
    qs, qd = torch.as_tensor(qs, device=dev), torch.as_tensor(qd, device=dev)
    out = {"modes": {}}
    for key, (mode, cf) in MODES.items():
        pool, conn = torch.zeros_like(sk.pool), torch.zeros_like(sk.conn)
        if mode == "dp":
            ingest, query = make_dp_ingest(sk, mesh), make_dp_edge_freq(sk, mesh)
            axes = ("data",)
        else:
            ingest, owner = make_pp_ingest(sk, mesh, mode=mode,
                                           capacity_factor=cf or 2.0)
            query, axes = make_pp_edge_freq(sk, mesh), None
        drops = []
        for s, t, w in torch.as_tensor(batches, device=dev):
            res = ingest(pool, conn, s, t, w)
            assert res[0] is pool and res[1] is conn  # in place
            if mode != "dp":
                drops.append(int(res[2]))
        est = query(pool, conn, qs, qd)
        sp, sc = stacked_state(pool, conn, mesh, axes)
        out["modes"][key] = dict(pool=sp.cpu().numpy(), conn=sc.cpu().numpy(),
                                 est=est.cpu().numpy(), drops=drops,
                                 device=str(pool.device))
    out["stats"] = collective_stats()
    out["coords"] = {shape: tuple(tmesh.make_mesh(shape, ("data", "model"))
                                  .get_coordinate()) for shape in MESH_SHAPES}
    out["debug"] = tuple(tmesh.make_debug_mesh().shape)
    out["axes"] = (tmesh.dp_axes(mesh), tmesh.all_axes(mesh))
    return out if rank == 0 else {k: out[k] for k in ("coords", "stats")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    stream = _stream()
    batches = _batches(stream)
    qs, qd, _ = sample_stream(stream, CFG["queries"], seed=CFG["query_seed"])
    sk = _template(stream)
    np.savez(tmp / "in.npz", batches=batches, qs=qs, qd=qd)
    cfg = {**CFG, "shape": SHAPE, "modes": MODES, "mesh_shapes": MESH_SHAPES}
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, json.dumps(cfg), str(tmp / "in.npz"),
         str(tmp / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_ranks(_port_ranks, 4, *interop.export_state(sk), batches,
                          qs, qd, device="cpu", timeout_s=WAIT_S)
        out, err = ref.communicate(timeout=WAIT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "REFERENCE_OK" in out, err[-3000:]
    return dict(ranks=ranks, ref=dict(np.load(tmp / "ref.npz")), sk=sk,
                batches=batches, qs=qs, qd=qd)


def _replay(sk, batches, qs, qd):
    """One flat sketch ingesting every batch: the single-card oracle."""
    rep = kmatrix.empty_like(sk)
    for s, t, w in batches:
        kmatrix.ingest(rep, EdgeBatch.from_numpy(s, t, w, device="cpu"))
    est = kmatrix.edge_freq(rep, torch.as_tensor(qs), torch.as_tensor(qd))
    return rep, est.numpy()


def _summed(stacked: np.ndarray, depth: int) -> np.ndarray:
    """The rows of every rank added up, layer by layer (int32 wraps)."""
    return stacked.reshape(-1, depth, *stacked.shape[1:]).sum(
        axis=0, dtype=np.int32)


def test_owner_map_is_the_references(runs):
    sk, ref = runs["sk"], runs["ref"]
    assert (sk.route.widths.numpy() == ref["widths"]).all()
    for n in (1, 2, 3, 4, 8):
        port = build_owner_map(sk, n)
        assert port.dtype == ref[f"owner_{n}"].dtype == np.int32
        assert (port == ref[f"owner_{n}"]).all(), n


def test_owner_map_keeps_numpys_tie_order():
    """Many equal areas: the reference's ``np.argsort(-areas)`` order and
    its first least-loaded rank, on widths the stream's plan never has."""
    from types import SimpleNamespace

    from repro.distributed.sketch_parallel import build_owner_map as j_owner

    rng = np.random.default_rng(0)
    for n_parts, n_model in [(5, 2), (17, 4), (64, 3), (40, 8)]:
        widths = rng.choice([8, 16, 32], size=n_parts).astype(np.int32)
        ref = j_owner(SimpleNamespace(route=SimpleNamespace(widths=widths)),
                      n_model)
        sk = SimpleNamespace(route=SimpleNamespace(
            widths=torch.as_tensor(widths)))
        assert (build_owner_map(sk, n_model) == ref).all(), (n_parts, n_model)


def test_mesh_rank_coordinates_are_jax_make_meshs(runs):
    """Rank r sits where ``jax.make_mesh`` puts device r (row-major), and
    the debug mesh has the reference's shape."""
    ref = runs["ref"]
    for shape in MESH_SHAPES:
        ids = ref["ids_%dx%d" % shape]
        for rank, out in enumerate(runs["ranks"]):
            assert ids[out["coords"][shape]] == rank, (shape, rank)
    assert runs["ranks"][0]["debug"] == tuple(ref["debug_shape_4"]) == (1, 4)
    for n in range(1, 9):
        assert tmesh.debug_mesh_shape(n) == tuple(ref[f"debug_shape_{n}"]), n
    assert runs["ranks"][0]["axes"] == (("data",), ("data", "model"))


@pytest.mark.parametrize("key", list(MODES))
def test_stacked_state_is_bit_equal_to_the_reference(runs, key):
    port, ref = runs["ranks"][0]["modes"][key], runs["ref"]
    assert port["device"] == "cpu"
    for leaf in ("pool", "conn"):
        assert port[leaf].dtype == ref[f"{key}_{leaf}"].dtype == np.int32
        assert port[leaf].shape == ref[f"{key}_{leaf}"].shape
        assert (port[leaf] == ref[f"{key}_{leaf}"]).all(), leaf
    assert (port["est"] == ref[f"{key}_est"]).all()


@pytest.mark.parametrize("key", ["a2a_cf4", "a2a_cf0.5"])
def test_drops_are_true_and_the_reference_divides_them(runs, key):
    """The port's drops are the edges that missed the pools; the reference
    reports each batch's ⌊true / n_model⌋."""
    port, ref = runs["ranks"][0]["modes"][key], runs["ref"]
    batches, depth = runs["batches"], runs["sk"].depth
    drops = np.array(port["drops"])
    assert (ref[f"{key}_drops"] == drops // N_MODEL).all()
    positive = int(batches[:, 2][batches[:, 2] > 0].sum())
    layer0 = int(_summed(port["pool"], depth)[0].sum())
    assert int(drops.sum()) == positive - layer0
    if key == "a2a_cf4":
        assert drops.sum() == 0
    else:  # capacity binds, and the reference under-reports
        assert drops.sum() > N_MODEL * ref[f"{key}_drops"].sum() > 0


def test_turnstile_deletions_reach_pools_in_allgather_only(runs):
    """allgather ingests a deletion into the pools, a2a parks it (weight <=
    0 is padding); both add it to conn (model rank 0)."""
    modes, depth = runs["ranks"][0]["modes"], runs["sk"].depth
    w = runs["batches"][:, 2]
    total, positive = int(w.sum()), int(w[w > 0].sum())
    assert total < positive
    ag = _summed(modes["allgather"]["pool"], depth)
    a2a = _summed(modes["a2a_cf4"]["pool"], depth)
    assert (ag.reshape(depth, -1).sum(axis=1) == total).all()
    assert (a2a.reshape(depth, -1).sum(axis=1) == positive).all()
    for key in ("allgather", "a2a_cf4"):
        conn = _summed(modes[key]["conn"], depth)
        assert (conn.reshape(depth, -1).sum(axis=1) == total).all()
    assert (_summed(modes["allgather"]["conn"], depth)
            == _summed(modes["a2a_cf4"]["conn"], depth)).all()


@pytest.mark.parametrize("key", ["dp", "allgather"])
def test_exact_modes_equal_a_single_sketch_replay(runs, key):
    rep, est = _replay(runs["sk"], runs["batches"], runs["qs"], runs["qd"])
    port = runs["ranks"][0]["modes"][key]
    depth = rep.depth
    assert (_summed(port["pool"], depth) == rep.pool.numpy()).all()
    assert (_summed(port["conn"], depth) == rep.conn.numpy()).all()
    assert (port["est"] == est).all()


def test_a2a_is_exact_but_for_deletions_where_capacity_cannot_bind(runs):
    """cf = 4 on the (2, 2) mesh: cap 512 >= the 256-edge slice, so a2a
    equals the replay of the insert-only stream (its deletions parked)."""
    batches = runs["batches"].copy()
    batches[:, 2] = np.maximum(batches[:, 2], 0)
    rep, est = _replay(runs["sk"], batches, runs["qs"], runs["qd"])
    port = runs["ranks"][0]["modes"]["a2a_cf4"]
    assert (_summed(port["pool"], rep.depth) == rep.pool.numpy()).all()
    assert (port["est"] == est).all()
    ref_est = runs["ref"]["a2a_cf0.5_est"]
    assert (ref_est <= est).all() and (ref_est < est).any()


def test_collectives_are_counted_per_rank(runs):
    """Per batch: one all_gather (allgather), one all_to_all and two
    all_reduce of the drops (a2a); the bytes each delivers to the rank."""
    n = len(runs["batches"])
    b_m = CFG["batch"] // SHAPE[0] // N_MODEL
    for out in runs["ranks"]:
        st = out["stats"]
        assert st["all_gather"]["calls"] >= n
        assert st["all_to_all"]["calls"] == 2 * n
        assert st["all_gather"]["host_bytes"] == 0  # gloo on the CPU
    gathered = runs["ranks"][1]["stats"]["all_gather"]["bytes"]
    # allgather: n x [n_model, 3, b_m] int32, then stacked_state's gathers
    assert gathered >= n * N_MODEL * 3 * b_m * 4
    a2a = runs["ranks"][1]["stats"]["all_to_all"]["bytes"]
    caps = [int(b_m * 4.0 / N_MODEL), max(int(b_m * 0.5 / N_MODEL), 8)]
    assert a2a == sum(n * N_MODEL * 3 * cap * 4 for cap in caps)


def _fails(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    group.all_reduce(torch.zeros(1), None)  # waits for rank 1 until killed
    return rank


def test_a_failing_rank_fails_the_run_and_leaves_no_child():
    import multiprocessing

    before = set(multiprocessing.active_children())
    with pytest.raises(RankFailure, match="rank 1 fails on purpose"):
        run_ranks(_fails, 2, device="cpu", timeout_s=WAIT_S)
    assert set(multiprocessing.active_children()) <= before


def _returns_off_cpu(rank, world):
    return {"host": torch.zeros(2), "state": [rank, torch.empty(3, device="meta")]}


def test_a_rank_returning_a_tensor_off_the_cpu_fails_the_run():
    """What a rank returns holds host values only: a leaf off the CPU fails
    the run, and the failure names the leaf's path in the value."""
    with pytest.raises(RankFailure, match=r"rank 0 returned tensors not on "
                       r"the CPU: value\['state'\]\[1\] on meta"):
        run_ranks(_returns_off_cpu, 2, device="cpu", timeout_s=WAIT_S)


def test_off_cpu_leaves_walks_dicts_sequences_and_dataclasses():
    import dataclasses

    @dataclasses.dataclass
    class Pair:
        a: object
        b: object

    meta = torch.empty(1, device="meta")
    value = {"x": (torch.ones(1), Pair(np.zeros(2), [meta])), "y": meta,
             "z": Pair}
    assert group._off_cpu_leaves(value) == [
        "value['x'][1].b[0] on meta", "value['y'] on meta"]
    assert group._off_cpu_leaves({"x": [torch.ones(1)], "y": 3}) == []


def test_topology_chooses_the_backend_once_from_the_cards():
    assert choose_topology(4, "cpu") == group.Topology("gloo", "cpu", 4)
    t = choose_topology(4, "cuda", n_cards=1)
    assert (t.backend, t.host_carried, str(t.device(3))) == ("gloo", True,
                                                              "cuda:0")
    t = choose_topology(4, "cuda", n_cards=4)
    assert (t.backend, t.host_carried, str(t.device(3))) == ("nccl", False,
                                                              "cuda:3")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        choose_topology(2, "cuda", n_cards=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        choose_topology(2, "meta")


def test_entry_points_need_a_process_group():
    sk = _template(_stream())
    with pytest.raises(RuntimeError, match="no process group"):
        make_dp_ingest(sk, None)
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_debug_mesh()


@pytest.mark.cuda
def test_ranks_on_the_card_equal_ranks_on_the_cpu():
    """Four gloo ranks sharing the card, every tensor on ``cuda:0``: the
    same stacked states, estimates and drops as four ranks on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    stream = _stream()
    batches = _batches(stream)
    qs, qd, _ = sample_stream(stream, CFG["queries"], seed=CFG["query_seed"])
    args = (*interop.export_state(_template(stream)), batches, qs, qd)
    on_card = run_ranks(_port_ranks, 4, *args, timeout_s=WAIT_S)
    on_cpu = run_ranks(_port_ranks, 4, *args, device="cpu", timeout_s=WAIT_S)
    for key in MODES:
        card, cpu = on_card[0]["modes"][key], on_cpu[0]["modes"][key]
        assert card["device"] == "cuda:0" and cpu["device"] == "cpu"
        for leaf in ("pool", "conn", "est"):
            assert (card[leaf] == cpu[leaf]).all(), (key, leaf)
        assert card["drops"] == cpu["drops"]
    assert on_card[1]["stats"]["all_to_all"]["host_bytes"] > 0
    assert [r["coords"] for r in on_card] == [r["coords"] for r in on_cpu]


_IPC_SCRIPT = """
import json, sys
import torch
from repro_torch.distributed import run_ranks


def _rank(rank, world, blocks, scale):
    return {"sum": float((blocks[rank] * scale).sum()), "on": str(scale.device)}


if __name__ == "__main__":
    torch.cuda.init()
    before = torch.cuda.memory_allocated()
    blocks = [torch.full((1 << 22,), float(r + 1), device="cuda")
              for r in range(2)]
    scale = torch.full((), 2.0, device="cuda")
    held = torch.cuda.memory_allocated()
    ranks = run_ranks(_rank, 2, blocks, scale, timeout_s=240)
    del blocks, scale
    torch.cuda.ipc_collect()
    print(json.dumps({"ranks": ranks, "before": before, "held": held,
                      "after": torch.cuda.memory_allocated()}))
"""


@pytest.mark.cuda
def test_cuda_tensors_handed_to_ranks_are_released_before_exit(tmp_path):
    """Two gloo ranks of ``cuda:0`` handed CUDA blocks: the run's parent
    gets its memory back after the join, and at its exit no block is still
    shared (PyTorch warns "Producer process has been terminated before all
    shared CUDA tensors released" otherwise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    script = tmp_path / "ipc_ranks.py"
    script.write_text(_IPC_SCRIPT)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, env=env, timeout=WAIT_S, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [r["sum"] for r in out["ranks"]] == [2.0 * (1 << 22), 4.0 * (1 << 22)]
    assert all(r["on"] == "cuda:0" for r in out["ranks"])
    assert out["held"] > out["before"] == out["after"]
    assert "Producer process has been terminated" not in proc.stderr, \
        proc.stderr[-3000:]
    assert "CudaIPCTypes" not in proc.stderr, proc.stderr[-3000:]


def test_demo_runs_every_mode_on_cpu_ranks():
    """``python -m repro_torch.distributed.demo --device cpu``: one JSON line
    per mode, DP and allgather exact, a2a's drops the true ones."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.distributed.demo", "--device",
         "cpu", "--shape", "1,2"], capture_output=True, text=True, env=env,
        timeout=WAIT_S, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    assert [x["mode"] for x in lines] == ["dp", "allgather", "a2a"]
    assert lines[0]["exact"] and lines[1]["exact"]
    assert lines[2]["dropped"] == lines[2]["true_dropped"]
    assert "gloo: 2 ranks on the CPU" in proc.stdout
