"""Process groups for the distributed sketch: the one place where ranks start.

    run_ranks(fn, world_size, *args, device="cuda")

spawns ``world_size`` processes (never fork: a CUDA context does not
survive one), joins them into one ``torch.distributed`` process group and
calls ``fn(rank, world_size, *args)`` in each.  The parent gets every
rank's return value in rank order, or ``RankFailure`` with the failing
ranks' tracebacks; every child is joined with a bound and killed past it
(at once when the run fails), so none is left behind.

What crosses into a rank and back (``run_ranks`` states the rule in full):
``args`` may hold tensors on the card, which reach the ranks by CUDA IPC
and which each rank releases before it leaves; a rank's return value holds
no tensor that is not on the CPU.

The backend is chosen once, in the parent, from the topology
(``choose_topology``):

  nccl  every rank has a card of its own (no more ranks than cards);
  gloo  the ranks share a card, or run on the CPU.

NCCL refuses two ranks on one device, so ranks that share the one card run
gloo on their CUDA tensors.  gloo takes CUDA tensors for every collective
this package calls (``all_reduce``, ``all_gather``,
``reduce_scatter_tensor``, ``all_to_all_single``: the card's torch 2.11
build), copying them through host memory itself, so
no tensor is moved off the card by the port.  ``collective_stats()``
counts each collective's calls and the bytes it delivers to this rank, and
the share of them that gloo carried through the host.

Rendezvous is a ``file://`` path in a fresh temporary directory, so
concurrent runs never collide on a port, and every collective has the
group's ``timeout``: a hung collective fails the run instead of stalling it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import gc
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
               "permute")
FAILURE_GRACE_S = 2.0
EXIT_GRACE_S = 60.0  # a rank that reported leaves the group within this
COLLECTIVE_TIMEOUT_S = 120.0  # a collective (or the rendezvous) waits no longer


class RankFailure(RuntimeError):
    """A rank raised, died or outlived the run's deadline."""


@dataclasses.dataclass(frozen=True)
class Topology:
    """How the ranks of one run reach each other."""

    backend: str  # "nccl", "gloo", or "fake" (planning, fake_ranks)
    device_type: str  # "cuda" or "cpu"
    world_size: int

    @property
    def host_carried(self) -> bool:
        """Whether gloo carries CUDA tensors through host memory."""
        return self.backend == "gloo" and self.device_type == "cuda"

    def device(self, rank: int) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", rank if self.backend == "nccl" else 0)

    def describe(self) -> str:
        if self.device_type == "cpu":
            where = "on the CPU"
        elif self.backend == "nccl":
            where = "one card each"
        else:
            where = "sharing cuda:0 (CUDA tensors, carried through host memory by gloo)"
        return f"{self.backend}: {self.world_size} ranks {where}"


def choose_topology(world_size: int, device="cuda",
                    n_cards: int | None = None) -> Topology:
    """The backend for ``world_size`` ranks on ``device`` of this host.

    A missing card is an error, never a move to the CPU.
    """
    device_type = torch.device(device).type
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if device_type == "cpu":
        return Topology("gloo", "cpu", world_size)
    if n_cards is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards == 0:
        raise RuntimeError("CUDA is not available: the ranks run on the card; "
                           "pass device='cpu' to run them on the CPU")
    backend = "nccl" if world_size <= n_cards else "gloo"
    return Topology(backend, "cuda", world_size)


# --------------------------------------------------- this rank's group --

@dataclasses.dataclass
class _Comm:
    topology: Topology
    device: torch.device
    stats: dict


_comm: _Comm | None = None  # set once per rank process by _start_rank


def _fresh_stats() -> dict:
    return {name: {"calls": 0, "bytes": 0, "host_bytes": 0, "seconds": 0.0}
            for name in COLLECTIVES}


def current() -> _Comm:
    if _comm is None:
        raise RuntimeError("no process group in this process: start ranks "
                           "with repro_torch.distributed.run_ranks")
    return _comm


def rank_device() -> torch.device:
    """This rank's device: its own card, the shared card, or the CPU."""
    return current().device


def collective_stats() -> dict:
    """Per collective: calls, bytes delivered to this rank, the bytes of
    those that gloo carried through host memory, and the host's seconds
    inside the calls (each returns when its data is in place: gloo waits
    for the copies of a CUDA tensor; NCCL's calls only enqueue)."""
    return {k: dict(v) for k, v in current().stats.items()}


def reset_collective_stats() -> None:
    current().stats = _fresh_stats()


def _count(name: str, out: torch.Tensor, t0: float) -> None:
    seconds = time.perf_counter() - t0
    comm = current()
    nbytes = out.numel() * out.element_size()
    row = comm.stats[name]
    row["calls"] += 1
    row["bytes"] += nbytes
    row["seconds"] += seconds
    if comm.topology.host_carried:
        row["host_bytes"] += nbytes


# recompute-ok: a recomputed collective moves its bytes again; counted again
def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (or reduce it by ``op``); returns
    ``t``."""
    t0 = time.perf_counter()
    dist.all_reduce(t, op=op, group=group)
    _count("all_reduce", t, t0)
    return t


# recompute-ok: a recomputed collective moves its bytes again; counted again
def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every group member's ``t``, stacked in group-rank order (received
    straight into the stacked tensor's rows)."""
    out = torch.empty((dist.get_world_size(group), *t.shape), dtype=t.dtype,
                      device=t.device)
    t0 = time.perf_counter()
    dist.all_gather(list(out.unbind(0)), t.contiguous(), group=group)
    _count("all_gather", out, t0)
    return out


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Row block ``j`` of ``t`` (dim 0 split in group-size equal blocks) goes
    to group rank ``j``; block ``j`` of the result came from group rank ``j``."""
    if t.shape[0] % dist.get_world_size(group):
        raise ValueError(f"all_to_all: dim 0 ({t.shape[0]}) is not a multiple "
                         f"of the group size {dist.get_world_size(group)}")
    out = torch.empty_like(t)
    t0 = time.perf_counter()
    dist.all_to_all_single(out, t.contiguous(), group=group)
    _count("all_to_all", out, t0)
    return out


# recompute-ok: a recomputed collective moves its bytes again; counted again
def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """Block ``j`` of the sum of every member's ``t`` (dim 0 split in
    group-size equal blocks) goes to group rank ``j``: this rank's block."""
    n = dist.get_world_size(group)
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({t.shape[0]}) is not a "
                         f"multiple of the group size {n}")
    out = torch.empty((t.shape[0] // n, *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    t0 = time.perf_counter()
    dist.reduce_scatter_tensor(out, t.contiguous(), op=dist.ReduceOp.SUM,
                               group=group)
    _count("reduce_scatter", out, t0)
    return out


# recompute-ok: a recomputed collective moves its bytes again; counted again
def permute(t: torch.Tensor, group, dst: int, src: int) -> torch.Tensor:
    """A collective permute: ``t`` goes to group rank ``dst``, and the
    result is what group rank ``src`` sent (every member sends a tensor of
    one shape, and each receives exactly one)."""
    n = dist.get_world_size(group)
    send, recv = [0] * n, [0] * n
    send[dst], recv[src] = t.shape[0], t.shape[0]
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    t0 = time.perf_counter()
    dist.all_to_all_single(out, t.contiguous(), recv, send, group=group)
    _count("permute", out, t0)
    return out


@contextlib.contextmanager
def fake_ranks(world_size: int):
    """This process as rank 0 of ``world_size`` fake ranks: a process
    group whose collectives move nothing (``torch.distributed``'s "fake"
    backend), on the CPU, with a group state of its own, so the counted
    collectives count what a real rank would send.  For planning under
    ``FakeTensorMode``; nothing runs on a card."""
    global _comm
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized() or _comm is not None:
        raise RuntimeError("a process group is already running here")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    _comm = _Comm(Topology("fake", "cpu", world_size), torch.device("cpu"),
                  _fresh_stats())
    try:
        yield _comm
    finally:
        _comm = None
        dist.destroy_process_group()


def _start_rank(rank: int, init_file: str, topology: Topology) -> None:
    global _comm
    device = topology.device(rank)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: CUDA is not available")
        torch.cuda.set_device(device)
    else:  # ranks on the CPU share its cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // topology.world_size))
    dist.init_process_group(
        topology.backend, init_method=f"file://{init_file}", rank=rank,
        world_size=topology.world_size,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
        device_id=device if topology.backend == "nccl" else None)
    _comm = _Comm(topology, device, _fresh_stats())


def _stop_rank(finished: bool) -> None:
    """Leave the group; a rank that finished waits for its peers first, so
    none is torn down inside a collective."""
    global _comm
    _comm = None
    if dist.is_initialized():
        if finished:
            dist.barrier()
        dist.destroy_process_group()


def _off_cpu_leaves(value, path: str = "value") -> list:
    """The paths of the tensors in ``value`` (through dicts, lists, tuples
    and dataclasses) that are not on the CPU."""
    if isinstance(value, torch.Tensor):
        return [] if value.device.type == "cpu" else [f"{path} on {value.device}"]
    if isinstance(value, dict):
        items = [(f"{path}[{k!r}]", v) for k, v in value.items()]
    elif isinstance(value, (list, tuple)):
        items = [(f"{path}[{i}]", v) for i, v in enumerate(value)]
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        items = [(f"{path}.{f.name}", getattr(value, f.name))
                 for f in dataclasses.fields(value)]
    else:
        return []
    return [leaf for sub, v in items for leaf in _off_cpu_leaves(v, sub)]


def _rank_main(fn, rank, init_file, topology, handed, results):
    """Child entry: start the rank, run ``fn`` on the arguments in the
    one-item list ``handed``, report (rank, ok, value), then release what it
    was handed before it leaves the group.

    The arguments come in a list that this function empties, since the
    spawned ``Process`` object (``multiprocessing.current_process()``)
    keeps its own arguments, ``handed`` among them, until the interpreter
    exits, and a CUDA block still held then is never handed back."""
    finished = False
    try:
        _start_rank(rank, init_file, topology)
        args = handed.pop()
        value = fn(rank, topology.world_size, *args)
        del args
        leaves = _off_cpu_leaves(value)
        if leaves:
            raise RankFailure(
                f"rank {rank} returned tensors not on the CPU: "
                f"{', '.join(leaves)}; a rank returns host values (.cpu())")
        finished = True
    except Exception:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
    else:
        results.put((rank, True, value))
    finally:
        handed.clear()
        args = value = None
        gc.collect()
        if topology.device_type == "cuda" and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        _stop_rank(finished)


def run_ranks(fn, world_size: int, *args, device="cuda",
              timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned ranks
    of one process group on ``device``; returns the ranks' values in rank
    order.  ``fn`` and ``args`` must pickle (a module-level function).

    What crosses the process boundary, each way:

    * Into a rank: ``args`` may hold tensors on the card.  They reach each
      rank by CUDA IPC, the same blocks, not copies (a layer of mixtral-8x7b
      at full width is about 7 GB of float32 blocks, and host copies for
      every rank would go through pipes).  The parent is their producer and
      keeps its references until every rank has exited; each rank drops
      every reference to its arguments (the spawned ``Process`` object's
      included) once ``fn`` has returned, collects, synchronises the card
      and only then leaves the group, so that no block is still shared
      when a process exits.  ``fn`` keeps nothing of its arguments past its
      return (no global, no cache).  After the join the parent runs
      ``torch.cuda.ipc_collect()``, which frees the blocks that it dropped
      while a rank still held them.
    * Out of a rank: the value ``fn`` returns holds no tensor that is not
      on the CPU (through dicts, lists, tuples and dataclasses), since a
      rank that handed a CUDA block out would be its producer and exits
      first.  A tensor on the card (or on ``meta``) fails the run with a
      ``RankFailure`` that names its path in the value.

    Raises ``RankFailure`` when a rank raises, dies or breaks the return
    rule, or when the run outlives ``timeout_s``; a collective that waits
    longer than ``COLLECTIVE_TIMEOUT_S`` raises in its rank.
    """
    topology = choose_topology(world_size, device)
    print(f"process group: {topology.describe()}", flush=True)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro-rdzv-") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, rank, init_file, topology, [args], results))
            for rank in range(world_size)]
        for p in procs:
            p.start()
        grace = EXIT_GRACE_S
        try:
            values = _collect(procs, results, timeout_s)
        except BaseException:  # a failed run: no rank is waited for
            grace = 10.0
            for p in procs:
                if p.is_alive():
                    p.kill()
            raise
        finally:
            for p in procs:
                p.join(timeout=grace)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
            results.close()
    if torch.cuda.is_initialized():
        torch.cuda.ipc_collect()
    return values


def _collect(procs, results, timeout_s: float) -> list:
    """Every rank's value, draining the queue before any join.  On the
    first failure, the failures reported within FAILURE_GRACE_S more are
    raised together (a rank's error often makes its peers fail too)."""
    values: dict[int, object] = {}
    failures: dict[int, str] = {}
    deadline = time.monotonic() + timeout_s
    silent_exits: dict[int, int] = {}
    while len(values) + len(failures) < len(procs):
        left = deadline - time.monotonic()
        if left <= 0:
            break
        try:
            rank, ok, value = results.get(timeout=min(left, 0.5))
        except queue.Empty:
            # a rank that exited without a report (killed, or crashed in
            # native code); a report still in the pipe arrives within polls
            for r, p in enumerate(procs):
                if r not in values and r not in failures and not p.is_alive():
                    silent_exits[r] = silent_exits.get(r, 0) + 1
                    if silent_exits[r] > 4:
                        failures[r] = f"exited with code {p.exitcode} and no result"
            continue
        if ok:
            values[rank] = value
            continue
        failures[rank] = value
        deadline = min(deadline, time.monotonic() + FAILURE_GRACE_S)
    if failures:
        raise RankFailure("\n".join(f"rank {r} failed:\n{tb}"
                                     for r, tb in sorted(failures.items())))
    if len(values) < len(procs):
        missing = sorted(set(range(len(procs))) - set(values))
        raise RankFailure(f"ranks {missing} did not finish within {timeout_s} s")
    return [values[r] for r in range(len(procs))]
