#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero without the final ``ok`` line):

  A. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
     (all at once) and print the card's name and power limit.
  G. Recsys serving: the Factorization Machine at full width (39 fields,
     k = 10, 10,000,384 table rows; random weights from a torch seed) on
     ``cuda``, through ``build_fm_cell`` for the three serve-kind cells:
     ``serve_p99`` (512 x 39), ``serve_bulk`` (262,144 x 39) and
     ``retrieval_cand`` (1 query, 1,000,000 candidates), ids uniform in
     [0, 2^30) from a numpy seed.  Launch counts are zeroed just before and
     read just after each cell: 3 ``embedding_bag`` launches per forward,
     6 per retrieval, no other kernel.  The same cell runs on the CPU
     through the plain versions on the same weights: every bag's output
     must be bit-equal, and logits and scores equal within rtol 1e-5,
     atol 1e-6 (the k-sum, the elementwise tail and the retrieval GEMV run
     in another order on the card; TF32 is off).  Each cell's latency
     (CUDA events around one synchronised call, median of 30 after
     warm-up), rows/s, and the device's busy time per call with its
     largest operations (torch.profiler).  It runs after A and needs none
     of the sketch phases.
  C. The main path: the paper pipeline on the full cit-HepPh stream (scale
     1.0: 421,578 edges in 52 batches of 8192), 512 KB budget, depth 7,
     banded partitioner, 10,000 evaluation queries, through the port's
     ``stream_ingest`` entry point on ``cuda`` with the width-class layout.
     Launch counts are zeroed just before and read just after: every batch
     must launch ``matrix_ingest_edges`` once (52) and the rectangle
     ``matrix_ingest`` never.  The same stream is ingested again through
     the flat layout on the card and through the plain versions on the CPU
     (which the CPU tests hold against the JAX package): counters, conn,
     the overflow tally and ARE must be identical.  Then the same stream at
     a forced capacity of 128, so that the tally is nonzero: the edge
     ingest on the card, its plain version on the CPU and the rectangle
     dispatch (``ops.rectangle_ingest``) on the card must agree.
  F. The paper's comparison (Fig. 7 at 512 KB): the same driver at the
     same flags with ``--sketch countmin|gsketch|tcm|gmatrix``, and with
     ``--sketch kmatrix --sketch-backend flat``, on ``cuda`` and on the
     CPU.  Counters and ARE must be identical; every TCM/gMatrix run must
     launch ``matrix_ingest_edges`` once per batch (52) and
     ``matrix_lookup_edges`` once (its 10,000 evaluation queries), and no
     rectangle entry point.  One line per sketch (ARE, M edges/s end to
     end, launches) and the ARE ordering, the width-class kMatrix's from
     phase C; the ordering is printed, not gated.
  D. Reachability: the closure of the kMatrix sketch's connectivity layers
     (w = 43) and of the gMatrix table (w = 136), each one ``reach_closure``
     launch, and of a gMatrix table at 2 MB (w = 273, wider than one
     block's shared memory holds) through ``reach_step``, one launch per
     squaring; 10,000 sampled pairs each, compared with the CPU plain
     closure.  Those three answer "reachable" to every pair, so two sparse
     sets follow: empty twins of the kMatrix (w = 43, one ``reach_closure``)
     and of the 2 MB gMatrix (w = 273, the ``reach_step`` cascade) fed only
     the first 300 and 4,000 edges of the stream's first batch, on the card
     and on the CPU, each with both answers at least 1,000 of the 10,000
     pairs and answers and closure equal to the CPU plain version's.  Then
     a checkpoint round trip on the card through the
     driver: the main path with ``--ckpt-dir --steps-per-ckpt 26``, then
     ``--resume`` from the batch-26 checkpoint; both must equal the
     uninterrupted phase-C sketch.
  P. A file-fed stream (after D, from C's and F's results): phase C's
     stream (421,578 edges) written as a SNAP edge list (``#`` header
     lines, tab-separated ``src dst``) to a temporary file and read back by
     ``FileStream(path, batch_size=8192)``: its 52 batches must equal the
     generator's array for array.  The slice's flags then run from the file
     through ``stream_ingest.run_pipeline`` on ``cuda``: the width-class
     kMatrix must be ``same_state`` as phase C's sketch with the same ARE,
     from 52 ``matrix_ingest_edges`` launches and no other; its
     ``kmatrix_reachability`` must answer phase D's 10,000 pairs as phase D
     did, from one ``reach_closure`` launch; the 512 KB gMatrix from the
     file must be ``same_state`` as phase F's table, with the same ARE and
     the same 10,000 edge estimates through ``matrix_lookup_edges`` (52
     ingest and 2 lookup launches: the ARE's queries and the estimates).
     Launch counts are zeroed before and read after each path and join the
     kernels line as ``P file-fed ...`` paths.
  E. A profile of the main path's ingest loop: host time per batch for
     making, copying and issuing it, the device's busy and idle shares, and
     the top operations by device and host time, for the edge ingest and,
     in the same run, for the rectangle dispatch (rectangles, edges,
     edges, rectangles).
  H. Online serving: the port's ``query_serve`` driver (cooperative mode)
     on ``cuda`` at the JAX driver's defaults — the full cit-HepPh stream,
     256 KB, depth 5, 8,000 requests offered open-loop at 2,000 QPS,
     ``batch_max`` 512, a publish every 4 batches after 4 warm batches, the
     default query mix — for a width-class kMatrix tenant and a gMatrix
     tenant.  Launch counts are zeroed just before and read just after each
     run: ``matrix_ingest_edges`` once per batch (52), ``reach_closure``
     once per closure-cache miss, no ``reach_step``, ``matrix_lookup_edges``
     for the gMatrix's edge, path and subgraph groups and never for the
     kMatrix, no rectangle entry point.  Gates: the final front bit-equal to
     one replay of the stream on the card and on the CPU plain path, its
     edge count the stream's; the first 1,000 requests (every family)
     answered by the engine on the final snapshot equal to the direct
     answers on the card and to the CPU engine's on the CPU replay; a held
     snapshot keeps its counters and its answers to 200 requests after 4
     more batches are ingested and published, and shares no counter
     storage with the new front.  Each run's summary line (achieved QPS,
     p50/p90/p99, epochs, closure hits and misses), then a shorter run of
     600 requests under ``torch.profiler``: the device's busy and idle
     share over the load window and the top operations by device and host
     time.
  I. Background and sharded serving: the same two tenants at the same
     flags with ``--background-ingest`` (publish policy every:4, queue 64,
     backpressure block; ingest in a runtime worker thread while the main
     thread serves), the kMatrix again with ``--ingest-dedup``, then both
     with ``--shards 4`` (four shards on the one card).  Launch counts are
     zeroed just before and read just after each run, and the run's
     ``SnapshotBuffer.ingest`` calls are counted by wrapping the method:
     ``matrix_ingest_edges`` once per buffer ingest, ``reach_closure`` once
     per closure miss (sharded: one over the summed shard layers), no
     ``reach_step``, ``matrix_lookup_edges`` only for the gMatrix.  Gates:
     no unaccounted or dropped edge, the worker stopped, 421,578 edges; the
     final front (sharded: ``merged_snapshot()``) bit-equal to phase H's
     replays on the card and the CPU (counters; the overflow tally depends
     on dispatch sizes); the first 1,000 requests equal to the direct
     answers on the card (sharded: ``sharded_direct_answers``, and the CPU
     sharded engine on a CPU replay of the four shard views); dedup's
     pools and conn equal to the run without it; sharded conservation.
     Then a sharded crash and resume through ``attach_shards`` with
     checkpoints (shards at four offsets from pre-filled queues, stopped
     crash-like, restored into a new registry and drained: the merged
     front equals the replays, conservation holds, a different
     ``--shard-seed`` is refused by the manifest); the drain rate of
     ``measure_sharded_ingest``, 3 drains at each K = 1, 2, 4; and a
     profiled 600-request window of the sharded kMatrix run.  Each run
     also prints the engine's groups by family (the hub), each served
     batch's host time, and each request's latency split at the last
     buffer ingest, with p99 per 0.5 s window of arrivals.
  J. The network tier: the same tenants at the same flags with ingest in
     remote workers — ``--runtime-backend process`` (spawn children, a
     CUDA context each; the kMatrix again with ``--publish-mode full``),
     both with ``--shards 4 --runtime-backend process``, the kMatrix with
     ``--runtime-backend socket`` (a self-hosted loopback child), the
     gMatrix through a ``stream_ingest --listen`` subprocess dialled with
     ``socket:HOST:PORT``, and the kMatrix through an in-process
     ``WorkerServer`` over loopback TCP, whose session's launches this
     process counts: ``matrix_ingest_edges`` once per buffer ingest, no
     rectangle entry point.  Each run has phase I's gates (fronts equal
     to phase H's replays, conservation, 1,000 answers equal to the
     direct ones) and shows every worker on the card while it is live
     (its pid among ``nvidia-smi``'s compute apps, or, where the sandbox
     is listed as one process, the card's memory grown by a CUDA context
     per worker) with its spawn-to-ready time.  Then ``query_serve
     --serve 127.0.0.1:0 --connections 4`` for each tenant (QPS, p50/p99,
     shed and answer epoch beside phase H's; 1,000 answers over the wire
     equal to the direct ones on the final snapshot), 3 drains at each
     K = 1, 2, 4 through ``measure_sharded_ingest(backend="process")``,
     and the hub's publish bytes, delta against full.  Every worker
     process (the process and socket children, the listen host, the
     drains' children) leaves its kernel launches and its buffer's ingest
     calls in a file when it stops (``runtime/backend.py``'s
     ``LAUNCH_REPORT_ENV``, a directory per run): each must have launched
     ``matrix_ingest_edges`` at least once for each batch it ingested, and
     the launches join the kernels line.  No kernel may be
     built during the phase: the parent built them, the workers load them.
     The kMatrix ``--serve`` front-end is scraped once, after its load and
     before it stops, by ``python -m repro_torch.obs.dashboard --connect
     HOST:PORT --once``: exit 0 and the kMatrix tenant's ingest panel.
  K. Distributed sketching (``repro_torch.distributed``): phase F's flat
     kMatrix (full cit-HepPh, 52 batches of 8192, 512 KB, depth 7,
     banded) on a (2, 2) mesh of 4 ranks in DP, PP allgather and PP a2a at
     cf = 2 and 4, and on a (2, 4) mesh of 8 ranks in PP a2a at cf = 2,
     where capacity binds (cap 512 of a 1,024-edge slice).  Each mesh's
     ranks are spawned once on the one card (gloo: NCCL refuses two ranks
     on one device; every tensor on the card, a CUDA context each) and run
     every mode.  Gates: DP, allgather and the (2, 2) a2a runs bit-equal to
     a single-card replay (10,000 estimates, summed pools and conns; 0
     drops, since cap = 2,048 * cf / 2 >= the slice); the (2, 4) a2a
     estimates <= the replay's; reported drops == positive weight in -
     the layer-0 mass of the summed pools.  Prints the backend, each
     mode's ingest wall per batch and M edges/s (host clock, one
     synchronise at the end), the collective bytes per batch, the drops,
     the ARE and the card's memory per rank; after each mesh this
     process's allocated memory is back at its level before the ranks.  No
     kernel runs in phase K: the flat kMatrix ingests with ``index_put_``.
  L. Training: the FM ``train_batch`` cell at full width through
     ``build_fm_cell`` (65,536 x 39 ids and {0, 1} labels from a numpy
     seed, the 10,000,384 x 10 table, AdamW lr 1e-3 with 100 warm-up
     steps), 4 steps, each counted from zero: 3 ``embedding_bag`` and 2
     ``embedding_bag_backward`` launches and no other kernel, the squared
     table derived again after every step, the loss finite and falling;
     step time, rows/s, peak memory and the device's idle share.  The same
     cell at a small table (5,120 rows, 7 fields) on the card and on the
     CPU from one set of weights: 3 steps, losses and parameters within
     1e-7.  A bf16 training state through ``launch/train.py --dtype
     bfloat16 --ckpt-dir``: the reduced gemma2-2b trains 4 steps, its step-4
     checkpoint restored into a fresh CUDA template equals the driver's
     final state bit for bit, and ``--resume`` from step 2 trains steps 3
     and 4.  The transformer family through its drivers:
     ``launch/serve.py`` (batch 4, prompt 32, 16 greedy tokens) and
     ``launch/train.py`` (3 steps at batch 8, seq 256) for gemma2-2b at
     full width (bf16, 26 layers, d = 2304, vocab 256,000; weights from a
     torch seed) and for the reduced mixtral-8x7b and grok-1-314b (the MoE
     dispatch on the card), none launching a kernel; prefill and decode
     times, decode tokens/s, train tokens/s and peak memory, and the
     device's idle share over a profiled gemma2-2b train step and decode
     step.  The two
     reduced MoE configs also run on the card and the CPU from the same
     float32 weights: loss within rtol 1e-5, prefill and 4 decode steps'
     logits within rtol 1e-5, atol 1e-5.
  B. Each kernel against its plain version on the card, on the inputs the
     main paths give it (``matrix_ingest_edges``: the kMatrix batch and the
     P = 1 gMatrix batch, plus a turnstile batch and one whose cells pass
     2^24; ``matrix_lookup_edges``: the gMatrix evaluation queries; the
     rectangle ``matrix_ingest`` on the rectangles ``ops.dispatch_rectangles``
     builds from the kMatrix batch and on the gMatrix batch's
     ``node_cells``, ``matrix_lookup`` on the queries' ``node_cells``; the
     kMatrix and gMatrix closures for ``reach_closure`` and their
     squarings for ``reach_step``, every bag of phase G for
     ``embedding_bag``, both backward launches of a phase-L FM train step
     for ``embedding_bag_backward``, bit-equal to its plain version run on
     CPU copies of the inputs and a second call bit-equal to the first,
     with the kernels a call launches from the profiler (five, none a
     fill; an empty list fails), no global float atomic in the library's SASS, a bare
     ``torch.zeros`` of the 400 MB gradient timed once, and the library
     call ``F.embedding_bag``'s autograd backward, which covers only the
     Σv term of the ``emb`` launch) plus one wide shape each for
     the sketch kernels
     (``reach_step`` also at phase D's 2 MB table): bit-equal results, and
     times
     of the kernel, the plain version and one PyTorch library call computing
     the same function, beside the least time the card could take
     (``bound_ms``).  ``ms`` keys are CUDA-event times of back-to-back calls
     after warm-up (host launch overhead included); ``device_ms`` keys are
     the launched kernels' own time from ``torch.profiler``.
  M. GNNs: the four GNN architectures at their full configs (the
     registry's: GatedGCN 16 x 70, GraphCast 16 x 512 with bf16 latents,
     NequIP 5 x 32 at l_max 2, EquiformerV2 12 x 128 at l_max 6; remat on;
     weights from a torch seed, the JAX init's constant leaves perturbed)
     through ``build_gnn_cell`` at ``full_graph_sm`` (3,072 x 10,752
     padded), ``molecule`` (128 graphs, 4,096 x 8,192) and ``minibatch_lg``
     (the 232,965-node CSR of average degree 492, 1,024 seeds, fanout
     (15, 10): 170,496 x 168,960), 3 timed steps and one profiled step
     each (EquiformerV2 at ``minibatch_lg``, all 12 layers, 1 timed step
     and the profiled one), and NequIP at ``ogb_products`` (2,449,408 x
     61,859,328, 943 chunks), 1 timed step and one profiled; the other
     three are cut there with the reckoned size of the tensor that rules
     them out, printed beside the cell.  Per cell: the losses (finite,
     the last below the first), no kernel launched (counts zeroed before
     the cell, read after), the median step time (host clock, the loss
     read back), nodes and edges per second, the peak memory and the
     device's idle share over the profiled step (which must record device
     time).  Then one NequIP energy+gradient step at ``minibatch_lg`` with
     the messages in 3 chunks (``chunked_edge_aggregate``) and all at once
     (``aggregate_unchunked``), each twice: the chunked peak must be the
     lower and the losses equal within 1e-4; then the same step once each
     way in float64, where the atomics' order no longer shows: losses
     within 1e-12 relative and every gradient leaf within 1e-10 of the
     leaf's largest |g|.  The four smoke
     configs on the card and on the CPU from one set of weights: every
     gradient leaf of the first step within 1e-5 of the leaf's largest
     |g|, then 3 train steps (losses within 1e-5 relative, parameters
     within 2 x the summed learning rates + 1e-6 |p|); and ``python -m
     repro_torch.launch.smoke --all`` runs on the card (10 lines).  It
     runs after B, so that B's profiler sessions follow the same phases
     as before the GNNs came.

  N. The shardings slice (``launch/shardings.py``, the transformer's
     mesh-only variants, ``configs/registry.build_cell``,
     ``launch/dryrun.py``).  N1: ``python -m repro_torch.launch.dryrun``
     in child processes on fake ranks (the "fake" process group, rank 0 of
     256 or 512; tensors without storage: a PLAN for 256 and 512 cards, no
     work on this card) for mixtral-8x7b ``train_4k``, nequip
     ``ogb_products`` and fm ``train_batch`` on both production meshes,
     and ``--sketch --both-meshes``; each record's per-rank argument and
     peak GiB against this card's memory and its collective bytes; a
     record with ``ok: false`` fails.  The children start first and run
     on the host while N2 runs.  N2: four gloo ranks on ``cuda:0``, a (2,
     2) ("data", "model") mesh, float32: one train step of mixtral-8x7b
     (full width: d 4096, d_ff 14,336, 8 experts top-2, vocab 32,000;
     depth cut to 1 layer) and of gemma2-2b (d 2304, vocab 256,000, tied
     embedding through the sharded lookup; depth cut to 2 layers, one
     local + global period), batch 8 x seq 512, ``seq_parallel=("data",)``,
     ``zero3_gather``, mixtral ``moe_groups=2``; then the FM
     ``serve_bulk`` cell table-parallel over the full 10,000,384-row
     table, every rank launching ``embedding_bag`` 3 times on its rows.
     Each is held against the same computation unsharded in this process
     on the card, run first (the LMs twice) and handed to the ranks: the
     losses within 1e-5 relative, every gradient block within max(1e-5,
     3 x the largest gap between the two unsharded runs) of its leaf's
     largest |g|, FM logits within rtol 1e-5, atol 1e-6.  Per model: the
     step time (first and second step), each rank's peak memory and
     ``collective_stats()`` by kind (calls, bytes, seconds, host-carried
     share).  The blocks reach the ranks by CUDA IPC, and ``run_ranks``
     has each rank release them before it exits: after each model this
     process's allocated memory is back at its level before the model's
     blocks were built.
  O. The analysis gate and the examples, all started at once in child
     processes: ``python -m repro_torch.analysis --gate`` must exit 0;
     three ``query_serve`` runs at phase I's flags on ``cuda``, each under
     ``python -m repro_torch.analysis.witness chip_smoke --o-child OUT``
     (this script as the witnessed child: it runs query_serve, counts its
     launches and saves the final front): the kMatrix with
     ``--ingest-dedup``, the gMatrix with ``--shards 4``, and the kMatrix
     with ``--runtime-backend socket --serve 127.0.0.1:0`` (the network
     tier's guarded fields).  Each must report 0 lock-order cycles, 0
     unlocked publishes and 0 fronts written after publish, with its
     lock sites and ordered edges; its final front (sharded: the merged
     one) bit-equal to phase H's replays on the card and the CPU; its
     edges the stream's; ``reach_closure`` launches equal to its closure
     misses, ``matrix_lookup_edges`` only for the gMatrix.  The children's
     ``matrix_ingest_edges``, ``reach_closure`` and ``matrix_lookup_edges``
     launches join the kernels line.  Then the five examples on ``cuda``
     at their own sizes (``python -m repro_torch.examples.<name>``;
     ``train_lm`` cut to ``--steps 30``) must exit 0.

The last lines are one ``{"kernels": [...]}`` JSON object and then
``{"ok": true, "device": {...}}``.  Each kernel's ``launches`` is summed
over the paths that run it, each path counted from zero just before it
runs (``launches_by_path``), in every process that launches a kernel:
this process; phase J's worker processes and phase O's witnessed children,
from their reports; phase N2's ranks, from their returns.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # float32 outside the tensor cores
BF16_FLOPS = 989e12  # bf16 on the tensor cores, which B2 runs

SLICE_FLAGS = ["--dataset", "cit-HepPh", "--scale", "1.0", "--budget-kb", "512",
               "--depth", "7", "--batch-size", "8192", "--partitioner", "banded",
               "--eval-queries", "10000", "--sketch-backend", "width_class"]
REACH_PAIRS = 10_000
# phase D's sparse sets: the first edges of the stream's first batch, chosen
# on the CPU so that about half of the 10,000 pairs are reachable (300:
# 4,356; 4,000: 4,965), each fed to an empty twin of a phase-D sketch
REACH_PREFIX = {"kmatrix": 300, "gmatrix": 4000}
# phase D's third closure: a gMatrix table too wide for one block (w = 273)
WIDE_REACH_FLAGS = [*SLICE_FLAGS, "--sketch", "gmatrix", "--budget-kb", "2048"]
FM_CELLS = ("serve_p99", "serve_bulk", "retrieval_cand")
FM_BAGS = {"serve": 3, "retrieval": 6}  # embedding_bag launches per step
FM_RTOL, FM_ATOL = 1e-5, 1e-6
# phase F's runs: the four baselines, and kMatrix in the flat layout, whose
# partitions keep their planned widths (the width-class layout of phase C
# rounds them down to powers of two and so holds fewer counters)
COMPARED = {kind: ["--sketch", kind]
            for kind in ("countmin", "gsketch", "tcm", "gmatrix")}
COMPARED["kmatrix-flat"] = ["--sketch", "kmatrix", "--sketch-backend", "flat"]
# phase H: the JAX query_serve driver's defaults, on the card
SERVE_FLAGS = ["--dataset", "cit-HepPh", "--scale", "1.0", "--budget-kb", "256",
               "--depth", "5", "--qps", "2000", "--n-requests", "8000",
               "--batch-max", "512", "--publish-every", "4",
               "--warm-batches", "4", "--device", "cuda"]
SERVE_KINDS = ("kmatrix", "gmatrix")
SERVE_CHECKED = 1000  # requests whose answers are gated
SERVE_HELD = 200  # requests asked again of a held snapshot
SERVE_PROFILED = 600  # requests of the profiled run (0.3 s offered)
# phase I: the same runs with ingest in runtime workers, then 4 shards
BG_FLAGS = [*SERVE_FLAGS, "--background-ingest", "--publish-policy",
            "every:4", "--queue-capacity", "64", "--backpressure", "block"]
STREAM_EDGES = 421_578  # cit-HepPh, weight > 0
RESUME_EVERY = 4  # batches between checkpoints of the resumed shards
RESUME_OFFSETS = (12, 20, 28, 36)  # per shard, multiples of RESUME_EVERY
DRAIN_SHARDS = (1, 2, 4)
DRAIN_REPEATS = 3  # thread drains at each K, for the spread
PROCESS_DRAINS = 3  # process-backend drains at each K (phase J)
# least card memory a worker process's CUDA context takes (a context on an
# H100 holds ~500 MiB), the evidence that each worker runs on the card
# where nvidia-smi cannot list the sandbox's own pids
CONTEXT_MIB = 250
LATENCY_BIN_S = 0.5  # width of the arrival windows of the latency timeline
# phase K: the flat kMatrix of phase F on two meshes of ranks on the one
# card; (2, 2): cap = 2,048 * cf / 2 >= the 2,048-edge slice, so a2a
# cannot drop; (2, 4) at cf = 2: cap = 512 of a 1,024-edge slice
DIST_MESHES = (((2, 2), (("dp", None), ("allgather", None), ("a2a", 2.0),
                         ("a2a", 4.0))),
               ((2, 4), (("a2a", 2.0),)))
DIST_QUERIES = 10_000
# phase L: the FM train cell at full width (JAX's train_batch: 65,536 x 39,
# AdamW lr 1e-3, 100 warm-up steps), 3 bag and 2 backward launches a step
FM_TRAIN_STEPS = 4
FM_TRAIN_BAGS, FM_TRAIN_BACKWARDS = 3, 2
# card vs CPU after 3 small-table steps: the bags and the backward give the
# CPU's bits, the loss's elementwise ops and mean may differ in a last bit,
# which Adam carries into updates far below lr (<= 3e-5 here)
FM_TRAIN_LOSS_TOL, FM_TRAIN_PARAM_TOL = 1e-7, 1e-7
# reduced transformers, card vs CPU on the same float32 weights (cuBLAS
# and the CPU sum the products in other orders; TF32 off)
LM_RTOL, LM_ATOL = 1e-5, 1e-5
LM_REFERENCE = ("mixtral-8x7b", "grok-1-314b")
_SERVE = ["--batch", "4", "--prompt-len", "32", "--gen", "16"]
LM_SERVE_RUNS = ((["--arch", "gemma2-2b", *_SERVE], "gemma2-2b"),
                 (["--arch", "mixtral-8x7b", "--reduced", *_SERVE],
                  "mixtral-8x7b reduced"),
                 (["--arch", "grok-1-314b", "--reduced", *_SERVE],
                  "grok-1-314b reduced"))
_TRAIN = ["--steps", "3", "--batch", "8", "--seq", "256", "--log-every", "1"]
LM_TRAIN_RUNS = ((["--arch", "gemma2-2b", *_TRAIN], "gemma2-2b", 8, 256),
                 (["--arch", "mixtral-8x7b", "--reduced", *_TRAIN],
                  "mixtral-8x7b reduced", 8, 256),
                 (["--arch", "grok-1-314b", "--reduced", *_TRAIN],
                  "grok-1-314b reduced", 8, 256))
# phase M: the four GNNs at their full configs (the registry's), a few
# train steps per cell, then one profiled step; NequIP alone at
# ogb_products (the other three's one-layer tensors pass 80 GB, see
# GNN_OGB_CUTS); each cell's weights perturbed off the JAX init's constant
# leaves (registry.perturb_constant_leaves)
GNN_ARCHS = ("gatedgcn", "graphcast", "nequip", "equiformer-v2")
GNN_SHAPE_NAMES = ("full_graph_sm", "molecule", "minibatch_lg")
GNN_STEPS = 3
# one timed step and the profiled one where a step takes tens of seconds:
# NequIP at ogb_products (~40 s a step, ~110 s to profile one) and the
# 12-layer EquiformerV2 at minibatch_lg (~30 s a step)
GNN_LONG_STEPS = 1
GNN_LONG_CELLS = {("equiformer-v2", "minibatch_lg")}
# the reckoned size of the tensor that rules each model out at ogb_products
# (2,449,408 x 61,859,328 padded)
GNN_OGB_CUTS = {
    "gatedgcn": "one (E, 70) f32 edge stream is 17.3 GB, and 16 checkpointed "
                "layers save 16 of them (277 GB)",
    "graphcast": "one (E, 512) bf16 edge latent is 63.3 GB",
    "equiformer-v2": "h is (N, 49, 128) f32, 61.4 GB",
}
# NequIP at minibatch_lg, one energy+gradient step: chunked in 3 chunks
# against every message at once; the energy sums 169,984 per-atom terms by
# float atomics in a varying order (two runs of one path differ by ~3e-5
# of the loss), so the float32 losses agree within 1e-4.  In float32 the
# gradients of two runs of one path differ by 7e-7 to 2e-5 of a leaf's
# largest |g| from run to run, as much as chunked and plain do, so no
# float32 bound tells the two apart; the gradients are compared in
# float64, where that order moves the loss and the gradients by a few
# ulps: losses within 1e-12 relative, every gradient leaf within 1e-10 of
# its largest |g|
GNN_CHUNKED_CHUNKS = 3
GNN_CHUNKED_LOSS_REL = 1e-4
GNN_CHUNKED_F64_LOSS_REL, GNN_CHUNKED_F64_GRAD_REL = 1e-12, 1e-10
# card vs CPU at the smoke sizes from one set of weights: every gradient
# leaf of the first step within 1e-5 of the leaf's largest |g| (float32
# against float64 on the CPU differs by at most 3e-6 there), then 3 steps:
# losses within 1e-5 of their size, parameters within 2 * (lr_1 + lr_2 +
# lr_3) + 1e-6 |p| (an element whose gradient is rounding noise moves by
# up to lr either way a step; tests/test_torch_gnn_train.py states the
# same rule)
GNN_CPU_STEPS = 3
GNN_GRAD_REL = 1e-5
GNN_LOSS_REL = 1e-5


# phase N: the dry run's cells (N1) and the mesh-only variants on 4 ranks
N_DRYRUN_CELLS = (("mixtral-8x7b", "train_4k"), ("nequip", "ogb_products"),
                  ("fm", "train_batch"))
N_MESH = (2, 2)
N_BATCH, N_SEQ = 8, 512
N_STEPS = 2  # both timed; the first's gradients, both losses gated
N_LMS = (("mixtral-8x7b", 1, 2), ("gemma2-2b", 2, 1))  # arch, layers, groups
# two unsharded runs agree bit for bit on the card, so the gradient blocks'
# tolerance is float32 reassociation's: the sharded path sums d_ff and the
# vocab in other orders (worst seen at full width 6.6e-6 of a leaf's max)
N_GRAD_REL = 3e-5
N_LOSS_REL = 1e-5


# phase O: the analysis gate, three witnessed query_serve runs in child
# processes (phase I's flags), and the five examples at their own sizes;
# train_lm cut to 30 of its 300 steps
O_CHILD = "--o-child"  # chip_smoke.py's mode as a witnessed child
O_RUNS = (("kmatrix --ingest-dedup", ["--sketch", "kmatrix", "--ingest-dedup"]),
          ("gmatrix --shards 4", ["--sketch", "gmatrix", "--shards", "4"]),
          ("kmatrix socket --serve", ["--sketch", "kmatrix", "--runtime-backend",
                                      "socket", "--serve", "127.0.0.1:0"]))
O_KERNELS = ("matrix_ingest_edges", "reach_closure", "matrix_lookup_edges",
             "kmatrix_lookup_edges", "kmatrix_node_out")
O_EXAMPLES = (("quickstart", []), ("sketch_queries", []),
              ("query_serving", []), ("background_ingest", []),
              ("train_lm", ["--steps", "30"]))
O_TIMEOUT_S = 300


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profiled(torch, fn, iters: int, synced: bool = False):
    """Device rows of ``key_averages()`` over ``iters`` calls of ``fn()``
    (each followed by a synchronise if ``synced``).  The profiler traces
    a first cycle of ``iters`` calls and throws it away, since a session
    that records from its start was seen to lose its first calls."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    cycles = []  # the profiler clears its events when a cycle ends
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: cycles.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            for _ in range(iters):
                fn()
                if synced:
                    torch.cuda.synchronize()
            torch.cuda.synchronize()
            prof.step()
    return cycles[-1] if cycles else []


def _per_call_us(event, iters: int) -> float:
    """A kernel row's device time per call: its mean duration times the
    whole number of launches per call its count shows."""
    us = _self_device_us(event)
    if us <= 0 or event.count == 0:
        return 0.0
    return us / event.count * max(1, round(event.count / iters))


def device_ms(torch, fn, iters: int = 20, attempts: int = 3):
    """Device time per call of ``fn()`` from ``torch.profiler``: the summed
    duration of the kernels it launched, per call.  Unlike ``time_ms`` it
    excludes the host's launch overhead.  A session that records no
    device time at all (seen now and then) is run again; None when every
    attempt records none."""
    for _ in range(attempts):
        total_us = sum(_per_call_us(e, iters)
                       for e in _profiled(torch, fn, iters))
        if total_us > 0:
            return total_us / 1e3
    return None


def _self_device_us(event) -> float:
    """Device time of a kernel row of ``key_averages()``; 0 for host-side
    rows, whose own device-time column repeats their kernels' time."""
    from torch.autograd import DeviceType

    if getattr(event, "device_type", None) != DeviceType.CUDA:
        return 0.0
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failures: list[str] = []

    def check(self, cond: bool, what: str) -> None:
        status = "ok" if cond else "FAIL"
        print(f"  [{status}] {what}")
        if not cond:
            self.failures.append(what)

    def phase(self, name: str, fn, *args):
        print(f"== {name}", flush=True)
        try:
            return fn(*args)
        except Exception:  # a phase that raises fails the run, reported here
            traceback.print_exc(file=sys.stdout)
            self.failures.append(f"{name}: raised")
            return None


KERNEL_NAMES = ("matrix_ingest", "matrix_ingest_edges", "matrix_lookup",
                "matrix_lookup_edges", "kmatrix_lookup_edges",
                "kmatrix_node_out", "reach_step", "reach_closure",
                "embedding_bag", "embedding_bag_backward")
LAUNCHES_COUNTED_IN = (
    "every process of the run that launches a kernel: this process; phase "
    "J's worker child processes and listen host, and phase O's witnessed "
    "query_serve children, from their reports; phase N2's four ranks, from "
    "their returns")


def _wrappers() -> dict:
    from repro_torch import kernels

    return {name: getattr(kernels, name) for name in KERNEL_NAMES}


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0 (just before a path)."""
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    """Every kernel wrapper's launch count (just after a path)."""
    from repro_torch.kernels import launch_counts

    return launch_counts()


QUERY_KERNELS = {"gmatrix": ("matrix_lookup_edges",),
                 "kmatrix": ("kmatrix_lookup_edges", "kmatrix_node_out")}


def _query_launches(launches: dict) -> dict:
    return {k: launches[k] for names in QUERY_KERNELS.values() for k in names}


def _query_launches_fit(kind: str, lookups: dict) -> bool:
    """A served kMatrix launches both of its query kernels and no gMatrix
    lookup; a served gMatrix the reverse."""
    return all((n >= 1) == (k in QUERY_KERNELS[kind]) for k, n in lookups.items())


def same_state(a, b) -> bool:
    """Whether two sketches hold identical leaves and layout, wherever they
    live (export_state copies every leaf to the host)."""
    from repro_torch import interop

    al, ast_ = interop.export_state(a)
    bl, bst = interop.export_state(b)
    return ast_ == bst and sorted(al) == sorted(bl) and all(
        al[k].dtype == bl[k].dtype and (al[k] == bl[k]).all() for k in al)


def phase_build(smoke):
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build_all()
    print(f"  built {sorted(report) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f}s wall")
    for name, info in report.items():
        print(f"  {name}: nvcc {info['seconds']:.2f}s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    line = card_line()
    print(line)
    return line


def phase_slice(smoke):
    torch = smoke.torch
    from repro_torch.core import EdgeBatch
    from repro_torch.core import kmatrix as km
    from repro_torch.core import kmatrix_accel as kma
    from repro_torch.core.metrics import exact_edge_frequencies, lookup_exact
    from repro_torch.launch import stream_ingest
    from repro_torch.streams import sample_stream

    parser = stream_ingest.build_parser()
    # warm-up on a small stream: first-call costs stay out of the timed run
    stream_ingest.inline_main(parser.parse_args(
        ["--scale", "0.03", "--eval-queries", "100", "--device", "cuda"]))

    reset_launches()
    run = stream_ingest.inline_main(
        parser.parse_args([*SLICE_FLAGS, "--device", "cuda"]))
    launches = read_launches()
    sk = run["sketch"]
    classes = sum(1 for n in sk.class_counts if n)
    print(f"  classes widths={sk.class_widths} counts={sk.class_counts} "
          f"conn_w={sk.conn_w} capacity="
          f"{kma.dispatch_capacity(sk, 8192)} overflow={int(sk.overflow)}")
    print(f"  launches on the main path: {launches}")
    smoke.check(type(sk).__name__ == "KMatrixAccel", "width-class sketch")
    smoke.check(run["batches"] == 52, f"52 batches (got {run['batches']})")
    smoke.check(launches["matrix_ingest_edges"] == run["batches"],
                f"matrix_ingest_edges launches == batches ({run['batches']}; "
                f"{classes} classes, one launch each batch)")
    smoke.check(launches["matrix_ingest"] == 0,
                "no rectangle matrix_ingest launch on the main path")
    smoke.check(launches["reach_step"] == launches["reach_closure"] == 0,
                "no reach_step or reach_closure launch in ingest")
    smoke.check(launches["matrix_lookup"] == launches["matrix_lookup_edges"] == 0,
                "no matrix_lookup launch (the width-class queries have their own)")
    smoke.check(launches["kmatrix_lookup_edges"] == 1
                and launches["kmatrix_node_out"] == 0,
                "one kmatrix_lookup_edges launch (the ARE's queries)")
    smoke.check(launches["embedding_bag"] == 0, "no embedding_bag launch")
    rate = run["n_edges"] / run["ingest_seconds"] / 1e6
    print(f"  ingest: {run['n_edges']} edges in {run['ingest_seconds']:.4f}s "
          f"= {rate:.3f} M edges/s end to end (cuda); ARE={run['ARE']!r}")

    stream = run["stream"]
    qs, qd, _ = sample_stream(stream, 10_000, seed=99)
    src, dst, w = stream.all_edges_numpy()
    true = lookup_exact(exact_edge_frequencies(src, dst, w), qs, qd)
    est = kma.edge_freq(sk, torch.as_tensor(qs, device="cuda"),
                        torch.as_tensor(qd, device="cuda")).cpu().numpy()
    smoke.check(bool((est >= true).all()),
                "estimates never undercount (one-sided error)")
    smoke.check(math.isfinite(run["ARE"]) and run["ARE"] >= 0, "ARE finite, >= 0")

    # the flat layout on the card, from the same (empty) layout
    flat = kma.to_flat_layout(kma.empty_like(sk))
    for i in range(stream.num_batches):
        km.ingest(flat, EdgeBatch.from_numpy(*stream.batch_numpy(i),
                                             device="cuda"))
    twin = kma.to_flat_layout(sk)
    smoke.check(torch.equal(twin.pool, flat.pool)
                and torch.equal(twin.conn, flat.conn),
                "flat-layout ingest on cuda == width-class ingest (bit-exact)")

    # the plain versions on the CPU
    cpu = stream_ingest.inline_main(
        parser.parse_args([*SLICE_FLAGS, "--device", "cpu"]))
    smoke.check(same_state(sk, cpu["sketch"]),
                "cuda sketch == cpu plain sketch: pools, conn, overflow, "
                "routes, hashes")
    smoke.check(cpu["ARE"] == run["ARE"],
                f"ARE cuda == cpu ({run['ARE']!r} vs {cpu['ARE']!r})")
    _forced_overflow(smoke, sk, cpu["sketch"], stream)
    return {"run": run, "cpu": cpu, "launches": launches, "rate": rate}


def _forced_overflow(smoke, sk, sk_cpu, stream, capacity: int = 128):
    """The main path's stream at a forced dispatch capacity, so that the
    overflow tally is nonzero: the edge ingest on the card, its plain
    version on the CPU and the rectangle dispatch on the card."""
    from repro_torch.core import EdgeBatch
    from repro_torch.core import kmatrix_accel as kma
    from repro_torch.kernels import ops

    edges, rect, cpu = (kma.empty_like(sk), kma.empty_like(sk),
                        kma.empty_like(sk_cpu))
    for i in range(stream.num_batches):
        arrays = stream.batch_numpy(i)
        batch = EdgeBatch.from_numpy(*arrays, device="cuda")
        kma.ingest(edges, batch, capacity=capacity)
        ops.rectangle_ingest(rect, batch, capacity=capacity)
        kma.ingest(cpu, EdgeBatch.from_numpy(*arrays, device="cpu"),
                   capacity=capacity)
    tally = int(edges.overflow)
    print(f"  capacity {capacity}: overflow tally {tally} (edge ingest), "
          f"{int(rect.overflow)} (rectangles), {int(cpu.overflow)} (cpu)")
    smoke.check(tally > 0, f"capacity {capacity}: a nonzero overflow tally")
    smoke.check(same_state(edges, cpu),
                f"capacity {capacity}: cuda edge ingest == cpu plain "
                "(pools, conn, overflow)")
    smoke.check(same_state(edges, rect),
                f"capacity {capacity}: cuda edge ingest == rectangle dispatch "
                "(pools, conn, overflow)")
    smoke.check(same_state(edges.replace(overflow=sk.overflow), sk),
                f"capacity {capacity}: the counters do not depend on capacity")


def phase_compare(smoke, sl):
    """The paper's Fig. 7 at 512 KB on the card: every baseline, and the
    flat-layout kMatrix, through the driver at the slice's flags, on cuda
    and on the CPU."""
    from repro_torch.launch import stream_ingest

    parser = stream_ingest.build_parser()
    runs, cpus, launches = {}, {}, {}
    for kind, flags in COMPARED.items():
        # warm-up: the kind's first-call costs stay out of the timed run
        stream_ingest.inline_main(parser.parse_args(
            ["--scale", "0.03", "--eval-queries", "100", *flags,
             "--device", "cuda"]))
        reset_launches()
        run = stream_ingest.inline_main(parser.parse_args(
            [*SLICE_FLAGS, *flags, "--device", "cuda"]))
        launches[kind] = read_launches()
        cpu = stream_ingest.inline_main(parser.parse_args(
            [*SLICE_FLAGS, *flags, "--device", "cpu"]))
        rate = run["n_edges"] / run["ingest_seconds"] / 1e6
        print(f"  {kind:12s} [{type(run['sketch']).__name__}] "
              f"counters={run['sketch'].num_counters} ARE={run['ARE']!r} "
              f"ingest={rate:.3f} M edges/s end to end (cuda, "
              f"{run['ingest_seconds']:.4f}s) launches={launches[kind]}")
        smoke.check(run["batches"] == 52 and run["n_edges"] == 421_578,
                    f"{kind}: 52 batches, 421,578 edges")
        smoke.check(same_state(run["sketch"], cpu["sketch"]),
                    f"{kind}: cuda counters == cpu plain counters")
        smoke.check(run["ARE"] == cpu["ARE"] and math.isfinite(run["ARE"]),
                    f"{kind}: ARE cuda == cpu ({run['ARE']!r})")
        matrix = kind in ("tcm", "gmatrix")
        expect = {k: 0 for k in KERNEL_NAMES}
        expect["matrix_ingest_edges"] = run["batches"] if matrix else 0
        expect["matrix_lookup_edges"] = 1 if matrix else 0
        smoke.check(launches[kind] == expect,
                    f"{kind}: launches {launches[kind]} == {expect}")
        runs[kind], cpus[kind] = run, cpu
        runs[kind]["rate"] = rate
    smoke.check(same_state(runs["tcm"]["sketch"].replace(kind="gmatrix"),
                           runs["gmatrix"]["sketch"]),
                "tcm and gmatrix tables identical (same seed, as in JAX)")
    are = {"kmatrix": sl["run"]["ARE"],
           **{k: r["ARE"] for k, r in runs.items()}}
    rates = {"kmatrix": sl["rate"], **{k: r["rate"] for k, r in runs.items()}}
    order = sorted(are, key=are.get)
    print("  ARE at 512 KB, lower is better (Fig. 7; printed, not gated): "
          + " < ".join(f"{k} {are[k]:.4f}" for k in order))
    print(f"  summary: {json.dumps({'ARE': are, 'M_edges_per_s': rates})}")
    return {"runs": runs, "cpu": cpus, "launches": launches}


def _reach_path(smoke, label, sk, sk_cpu, n, answer):
    """Close ``sk``'s adjacency layers on the card and answer REACH_PAIRS
    pairs of vertex ids below ``n`` through ``answer(sketch, src, dst)``;
    hold closure and answers against the CPU plain version.  Returns the
    path's reach_step and reach_closure launches, its pairs and its answers
    (on the host)."""
    torch = smoke.torch
    from repro_torch.core import queries as q
    from repro_torch.kernels.reach_closure import CLOSURE_MAX_W

    import numpy as np

    rng = np.random.default_rng(7)
    qs = torch.as_tensor(rng.integers(0, n, REACH_PAIRS).astype("int32"))
    qd = torch.as_tensor(rng.integers(0, n, REACH_PAIRS).astype("int32"))
    reset_launches()
    answers = answer(sk, qs.cuda(), qd.cuda())
    torch.cuda.synchronize()
    launches = {k: read_launches()[k] for k in ("reach_step", "reach_closure")}
    w = q.closure_layers(sk).shape[-1]
    steps = q._closure_steps(w, None)
    # one launch for the whole closure where a layer fits one block, else
    # one reach_step launch per squaring
    expect = ({"reach_step": 0, "reach_closure": 1} if w <= CLOSURE_MAX_W
              else {"reach_step": steps, "reach_closure": 0})
    print(f"  {label}: launches {launches} (w={w}, {steps} squarings, "
          f"one block holds w <= {CLOSURE_MAX_W})")
    smoke.check(launches == expect, f"{label}: launches {launches} == {expect}")
    ref = answer(sk_cpu, qs, qd)
    smoke.check(torch.equal(answers.cpu(), ref),
                f"{label}: {REACH_PAIRS} reachability answers == cpu plain "
                f"({int(ref.sum())} reachable)")
    closure = q.build_closure(q.closure_layers(sk))
    smoke.check(torch.equal(closure.cpu(),
                            q.build_closure(q.closure_layers(sk_cpu))),
                f"{label}: kernel closure == cpu plain closure")
    plain = q.build_closure(q.closure_layers(sk), backend="plain")
    smoke.check(torch.equal(plain, closure),
                f"{label}: plain closure on cuda == kernel")
    return {"launches": launches, "pairs": (qs, qd), "answers": answers.cpu()}


def _sparse_reach(smoke, label, run, cpu, prefix, n, answer):
    """``_reach_path`` on empty twins of ``run``'s sketch (on the card) and
    of ``cpu``'s (on the CPU) fed only the first ``prefix`` edges of the
    stream's first batch: sparse enough that both answers are common, so
    that a closure answering "reachable" (or "not") everywhere fails."""
    from repro_torch.core import EdgeBatch

    src, dst, w = run["stream"].batch_numpy(0)
    w = w.copy()
    w[prefix:] = 0
    twins = [r["module"].ingest(r["module"].empty_like(r["sketch"]),
                                EdgeBatch.from_numpy(src, dst, w, device=dev))
             for r, dev in ((run, "cuda"), (cpu, "cpu"))]
    path = _reach_path(smoke, label, *twins, n, answer)
    yes = int(path["answers"].sum())
    smoke.check(min(yes, REACH_PAIRS - yes) >= REACH_PAIRS // 10,
                f"{label}: both answers common: {yes} reachable and "
                f"{REACH_PAIRS - yes} not, each >= {REACH_PAIRS // 10}")
    return path


def _checkpoint_round_trip(smoke, sl):
    """The driver's checkpoint path on the card: a run at the slice's flags
    that saves every 26 batches, then ``--resume`` from the batch-26
    checkpoint (the batch-52 one removed first).  Both runs must equal the
    uninterrupted phase-C sketch."""
    from repro_torch.checkpoint import store
    from repro_torch.core import kmatrix_accel as kma
    from repro_torch.launch import stream_ingest

    full = sl["run"]["sketch"]
    parser = stream_ingest.build_parser()
    with tempfile.TemporaryDirectory(prefix="kmatrix_ckpt_") as ckpt:
        flags = [*SLICE_FLAGS, "--device", "cuda", "--ckpt-dir", ckpt,
                 "--steps-per-ckpt", "26"]
        saved = stream_ingest.inline_main(parser.parse_args(flags))
        smoke.check(same_state(saved["sketch"], full)
                    and saved["ARE"] == sl["run"]["ARE"],
                    "run saving every 26 batches == phase-C sketch and ARE")
        meta = store.read_meta(ckpt, 26)
        smoke.check(meta["extra"] == {"stream_offset": 26, "seed": 0},
                    f"checkpoint 26 holds stream offset 26 ({meta['extra']})")
        last, _ = store.restore(ckpt, kma.empty_like(full), step=52)
        smoke.check(same_state(last, full),
                    "checkpoint 52 restores the phase-C sketch (bit-exact)")
        shutil.rmtree(Path(ckpt) / f"step_{52:010d}")
        resumed = stream_ingest.inline_main(
            parser.parse_args([*flags, "--resume"]))
    sk = resumed["sketch"]
    smoke.check(resumed["batches"] == 26 and sk.conn.device.type == "cuda",
                f"--resume ingested batches 26-51 on cuda "
                f"(got {resumed['batches']} batches)")
    smoke.check(same_state(sk, full) and resumed["ARE"] == sl["run"]["ARE"],
                "26 batches + save + --resume + 26 batches == uninterrupted "
                "52-batch sketch and ARE (bit-exact)")


def phase_reach(smoke, sl, cmp):
    from repro_torch.core import queries as q
    from repro_torch.launch import stream_ingest

    n = sl["run"]["stream"].spec.n_nodes
    parser = stream_ingest.build_parser()
    wide_runs = {dev: stream_ingest.inline_main(parser.parse_args(
        [*WIDE_REACH_FLAGS, "--device", dev])) for dev in ("cuda", "cpu")}
    wide = {dev: r["sketch"] for dev, r in wide_runs.items()}
    smoke.check(same_state(wide["cuda"], wide["cpu"]),
                "gmatrix 2 MB: cuda table == cpu plain table")
    paths = {
        "kmatrix": _reach_path(
            smoke, "kmatrix conn", sl["run"]["sketch"], sl["cpu"]["sketch"],
            n, q.kmatrix_reachability),
        "gmatrix": _reach_path(
            smoke, "gmatrix table", cmp["runs"]["gmatrix"]["sketch"],
            cmp["cpu"]["gmatrix"]["sketch"], n, q.reachability),
        "gmatrix 2MB": _reach_path(
            smoke, "gmatrix 2 MB table", wide["cuda"], wide["cpu"], n,
            q.reachability),
        "kmatrix sparse": _sparse_reach(
            smoke, f"kmatrix conn, first {REACH_PREFIX['kmatrix']} edges",
            sl["run"], sl["cpu"], REACH_PREFIX["kmatrix"], n,
            q.kmatrix_reachability),
        "gmatrix 2MB sparse": _sparse_reach(
            smoke, f"gmatrix 2 MB table, first {REACH_PREFIX['gmatrix']} "
            "edges", wide_runs["cuda"], wide_runs["cpu"],
            REACH_PREFIX["gmatrix"], n, q.reachability),
    }
    _checkpoint_round_trip(smoke, sl)
    return {"launches": {k: v["launches"] for k, v in paths.items()},
            "paths": paths, "wide": wide["cuda"]}


# ------------------------------------------------------------ phase P --

def _write_snap(path, stream) -> None:
    """``stream``'s edges as a SNAP edge list: ``#`` header lines, then one
    tab-separated ``src dst`` pair per line."""
    import numpy as np

    src, dst, _ = stream.all_edges_numpy()
    header = (f"Directed graph: {stream.spec.name}, the generator's matched "
              f"stream\nNodes: {stream.spec.n_nodes} Edges: {len(src)}\n"
              "FromNodeId\tToNodeId")
    np.savetxt(path, np.stack([src, dst], axis=1), fmt="%d", delimiter="\t",
               header=header, comments="# ")


def phase_file(smoke, sl, cmp, reach):
    """The paper pipeline fed from an edge-list file: phase C's stream
    written as a SNAP file, read back by ``FileStream`` and driven through
    ``stream_ingest.run_pipeline`` on the card for the width-class kMatrix
    and the 512 KB gMatrix; both must equal phases C, D and F's results."""
    torch = smoke.torch
    from repro_torch.core import matrix_sketch as ms
    from repro_torch.core import queries as q
    from repro_torch.launch import stream_ingest
    from repro_torch.streams import FileStream, sample_stream

    t_phase = time.perf_counter()
    stream = sl["run"]["stream"]
    with tempfile.TemporaryDirectory(prefix="kmatrix_file_") as tmp:
        path = Path(tmp) / "cit-HepPh.txt"
        t0 = time.perf_counter()
        _write_snap(path, stream)
        t1 = time.perf_counter()
        fs = FileStream(str(path), batch_size=8192)
        t2 = time.perf_counter()
        size = path.stat().st_size
    print(f"  file: {size} bytes written in {t1 - t0:.3f}s, read by "
          f"FileStream in {t2 - t1:.3f}s; spec {fs.spec}")
    same = fs.num_batches == stream.num_batches == 52 and all(
        a.dtype == b.dtype and a.tobytes() == b.tobytes()
        for i in range(fs.num_batches)
        for a, b in zip(fs.batch_numpy(i), stream.batch_numpy(i)))
    smoke.check(same and fs.spec.n_edges == STREAM_EDGES,
                f"the file's {fs.num_batches} batches == the generator's, "
                "array for array (421,578 edges)")

    parser = stream_ingest.build_parser()
    launches, timings = {}, {}
    reset_launches()
    run = stream_ingest.run_pipeline(
        parser.parse_args([*SLICE_FLAGS, "--device", "cuda"]), fs)
    launches["kmatrix"] = read_launches()
    timings["kmatrix ingest_s"] = run["ingest_seconds"]
    expect = {k: 0 for k in KERNEL_NAMES}
    expect["matrix_ingest_edges"] = 52
    expect["kmatrix_lookup_edges"] = 1  # the ARE's queries
    smoke.check(launches["kmatrix"] == expect,
                f"file-fed kmatrix: launches {launches['kmatrix']} == {expect}")
    smoke.check(run["batches"] == 52 and run["n_edges"] == STREAM_EDGES,
                "file-fed kmatrix: 52 batches, 421,578 edges")
    smoke.check(type(run["sketch"]).__name__ == "KMatrixAccel"
                and same_state(run["sketch"], sl["run"]["sketch"]),
                "file-fed width-class kmatrix == phase C's sketch (same_state)")
    smoke.check(run["ARE"] == sl["run"]["ARE"],
                f"file-fed ARE == phase C's ({run['ARE']!r} vs "
                f"{sl['run']['ARE']!r})")

    seen = reach["paths"]["kmatrix"]
    qs, qd = seen["pairs"]
    reset_launches()
    answers = q.kmatrix_reachability(run["sketch"], qs.cuda(), qd.cuda())
    torch.cuda.synchronize()
    launches["kmatrix reachability"] = read_launches()
    expect = {k: 0 for k in KERNEL_NAMES}
    expect["reach_closure"] = 1
    smoke.check(launches["kmatrix reachability"] == expect,
                f"file-fed kmatrix reachability: launches "
                f"{launches['kmatrix reachability']} == {expect}")
    smoke.check(torch.equal(answers.cpu(), seen["answers"]),
                f"file-fed kmatrix: {REACH_PAIRS} reachability answers == "
                f"phase D's ({int(seen['answers'].sum())} reachable)")

    gm_f = cmp["runs"]["gmatrix"]
    reset_launches()
    gm = stream_ingest.run_pipeline(parser.parse_args(
        [*SLICE_FLAGS, "--sketch", "gmatrix", "--device", "cuda"]), fs)
    es, ed = (torch.as_tensor(x, device="cuda")
              for x in sample_stream(fs, 10_000, seed=99)[:2])
    est = ms.edge_freq(gm["sketch"], es, ed)
    torch.cuda.synchronize()
    launches["gmatrix"] = read_launches()
    timings["gmatrix ingest_s"] = gm["ingest_seconds"]
    expect = {k: 0 for k in KERNEL_NAMES}
    expect["matrix_ingest_edges"] = 52
    expect["matrix_lookup_edges"] = 2  # the ARE's queries, then est
    smoke.check(launches["gmatrix"] == expect,
                f"file-fed gmatrix: launches {launches['gmatrix']} == {expect}")
    smoke.check(same_state(gm["sketch"], gm_f["sketch"]),
                "file-fed gmatrix 512 KB table == phase F's (same_state)")
    smoke.check(torch.equal(est, ms.edge_freq(gm_f["sketch"], es, ed)),
                "file-fed gmatrix: 10,000 edge estimates through "
                "matrix_lookup_edges == phase F's table's")
    smoke.check(gm["ARE"] == gm_f["ARE"],
                f"file-fed gmatrix ARE == phase F's ({gm['ARE']!r})")
    seconds = time.perf_counter() - t_phase
    print(f"  phase P: {seconds:.2f}s; "
          f"{json.dumps({'launches': launches, **timings})}")
    return {"launches": launches, "seconds": seconds}


def _count_phase_p(kernels: list, launches: dict) -> None:
    """Phase P's paths in the kernels line (they run after D, the line is
    built in B)."""
    for row in kernels:
        for path, counts in launches.items():
            row["launches_by_path"][f"P file-fed {path}"] = counts[row["name"]]
            row["launches"] += counts[row["name"]]


def _profile_loop(smoke, stream, sk, ingest, label, show_top):
    """One pass of the ingest loop over ``stream`` under the profiler:
    host time per batch of making, copying and issuing it, and the device
    time of what the ingest launched."""
    torch = smoke.torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import EdgeBatch

    n = stream.num_batches
    t = {"make": 0.0, "copy": 0.0, "issue": 0.0}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall0 = time.perf_counter()
        for i in range(n):
            t0 = time.perf_counter()
            arrays = stream.batch_numpy(i)
            t1 = time.perf_counter()
            batch = EdgeBatch.from_numpy(*arrays, device="cuda")
            t2 = time.perf_counter()
            ingest(sk, batch)
            t3 = time.perf_counter()
            t["make"] += t1 - t0
            t["copy"] += t2 - t1
            t["issue"] += t3 - t2
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall0
    events = prof.key_averages()
    device_ms = sum(_self_device_us(e) for e in events) / 1e3
    row = {**{f"{k}_ms": v / n * 1e3 for k, v in t.items()},
           "wall_ms": wall / n * 1e3, "device_busy_ms": device_ms / n,
           "idle_share": 1 - device_ms / (wall * 1e3)}
    print(f"  {label}, per batch (host clock, profiler on): {json.dumps(row)}")
    if show_top:
        top = sorted(events, key=_self_device_us, reverse=True)[:8]
        for e in top:
            if _self_device_us(e) > 0:
                print(f"    device {_self_device_us(e) / n:9.2f} us/batch  "
                      f"x{e.count / n:5.1f}  {e.key[:90]}")
        top = sorted(events, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:8]
        for e in top:
            print(f"    host   {e.self_cpu_time_total / n:9.2f} us/batch  "
                  f"x{e.count / n:5.1f}  {e.key[:90]}")
    return row


def phase_profile(smoke, sl):
    """Where one batch's time goes on the main path, for the edge ingest
    and the rectangle dispatch in turn (rectangles, edges, edges,
    rectangles), on fresh sketches; both must end equal."""
    from repro_torch.core import kmatrix_accel as kma
    from repro_torch.kernels import ops

    stream = sl["run"]["stream"]
    designs = {"edges": kma.ingest, "rectangles": ops.rectangle_ingest}
    rows = {name: [] for name in designs}
    finals = {}
    for turn, name in enumerate(("rectangles", "edges", "edges", "rectangles")):
        sk = kma.empty_like(sl["run"]["sketch"])
        rows[name].append(_profile_loop(smoke, stream, sk, designs[name],
                                        f"{name} (turn {turn + 1})",
                                        show_top=turn < 2))
        finals[name] = sk
    smoke.check(same_state(finals["edges"], finals["rectangles"])
                and same_state(finals["edges"], sl["run"]["sketch"]),
                "profiled edge ingest == rectangle dispatch == phase C sketch")
    summary = {name: {k: statistics.mean(r[k] for r in runs) for k in runs[0]}
               for name, runs in rows.items()}
    print(f"  summary, mean of two turns each: {json.dumps(summary)}")
    return summary


def _capture_bags(torch, fn):
    """``fn()``'s result and, for every bag the FM took in it, ``(table,
    idx, weights, out)``: the Σv and Σv² bags of ``sum_and_square_bags``
    and the ``lin`` bag of ``embedding_bag``, in that order.  The tensors
    are the call's own (nothing on the path writes to them afterwards),
    not copies."""
    from repro_torch.models.recsys import fm as fm_mod

    calls = []
    real_bag, real_pair = fm_mod.embedding_bag, fm_mod.sum_and_square_bags

    def record(table, idx, weights=None):
        out = real_bag(table, idx, weights)
        calls.append((table, idx, weights, out))
        return out

    def record_pair(table, squared, idx, weights=None):
        out = real_pair(table, squared, idx, weights)
        calls.extend([(table, idx, weights, out[0]),
                      (squared, idx, weights, out[1])])
        return out

    fm_mod.embedding_bag, fm_mod.sum_and_square_bags = record, record_pair
    try:
        result = fn()
    finally:
        fm_mod.embedding_bag, fm_mod.sum_and_square_bags = real_bag, real_pair
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return result, calls


def _latencies_ms(torch, fn, n: int = 30, warmup: int = 3) -> list:
    """Latency of ``n`` single calls of ``fn()``: CUDA events around each
    call, the device idle before it (synchronised), so a call's time
    includes the host issuing it."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _device_breakdown(torch, fn, iters: int = 10):
    """Device time per call of ``fn()`` (each call synchronised, as a
    served request is) and its largest device operations, from
    ``torch.profiler``."""
    events = [e for e in _profiled(torch, fn, iters, synced=True)
              if _per_call_us(e, iters) > 0]
    busy = sum(_per_call_us(e, iters) for e in events) / 1e3
    top = sorted(events, key=lambda e: _per_call_us(e, iters), reverse=True)
    return busy, [(e.key[:70], _per_call_us(e, iters), e.count / iters)
                  for e in top[:6]]


def phase_fm(smoke, card):
    """The FM serving path at full width on the card, against the CPU."""
    torch = smoke.torch
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.models.recsys import fm as fm_mod

    cfg = registry._fm_config()
    t_phase = t0 = time.perf_counter()
    params = fm_mod.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    cpu_params = fm_mod.FM(cfg, params.emb.cpu(), params.lin.cpu(),
                           params.bias.cpu())
    mb = (params.emb.numel() + params.lin.numel()) * 4 / 1e6
    print(f"  {cfg}: emb {list(params.emb.shape)}, lin "
          f"{list(params.lin.shape)} ({mb:.1f} MB f32), made on cuda and "
          f"copied to the CPU in {time.perf_counter() - t0:.2f}s")
    smoke.check(cfg.table_rows == 10_000_384 and cfg.n_fields == 39
                and cfg.embed_dim == 10, "full width: 39 fields, k = 10, "
                "10,000,384 rows")
    rng = np.random.default_rng(0)
    launches, bags, summary = {}, {}, {}
    for name in FM_CELLS:
        cell = registry.build_fm_cell(name, params, rng, device="cuda")
        kind = RECSYS_SHAPES[name].kind
        reset_launches()
        out, calls = _capture_bags(torch, cell.run)
        launches[name] = read_launches()
        expect = {k: 0 for k in KERNEL_NAMES}
        expect["embedding_bag"] = FM_BAGS[kind]
        smoke.check(launches[name] == expect,
                    f"{name}: launches {launches[name]} == {expect}")
        what = "scores" if kind == "retrieval" else "logits"
        smoke.check(tuple(out.shape) == (cell.rows,)
                    and bool(torch.isfinite(out).all()),
                    f"{name}: {cell.rows} finite {what}")
        t1 = time.perf_counter()
        ref, cpu_calls = _capture_bags(torch, lambda: cell.step_fn(
            cpu_params, *(x.cpu() for x in cell.inputs)))
        cpu_s = time.perf_counter() - t1
        smoke.check(len(calls) == len(cpu_calls) and all(
            torch.equal(c[3].cpu(), r[3]) for c, r in zip(calls, cpu_calls)),
            f"{name}: {len(calls)} bag outputs bit-equal to the CPU plain "
            f"path ({cpu_s:.2f}s on the CPU)")
        err = float((out.cpu() - ref).abs().max())
        smoke.check(torch.allclose(out.cpu(), ref, rtol=FM_RTOL, atol=FM_ATOL),
                    f"{name}: within rtol {FM_RTOL}, atol {FM_ATOL} of the "
                    f"CPU path (max abs diff {err!r})")
        lat = sorted(_latencies_ms(torch, cell.run))
        med = statistics.median(lat)
        busy, top = _device_breakdown(torch, cell.run)
        summary[name] = {"rows": cell.rows, "median_ms": med,
                         "p10_ms": lat[len(lat) // 10],
                         "p90_ms": lat[len(lat) * 9 // 10],
                         "max_ms": lat[-1],
                         "rows_per_s": cell.rows / med * 1e3,
                         "device_busy_ms": busy, "idle_share": 1 - busy / med,
                         "cpu_check_s": cpu_s}
        print(f"  {name}: {json.dumps(summary[name])} ({card})")
        for key, us, count in top:
            print(f"    device {us:9.2f} us/call  x{count:4.1f}  {key}")
        bags[name] = calls
    fm_launches = {k: sum(v[k] for v in launches.values())
                   for k in KERNEL_NAMES}
    print(f"  launches on the FM path: {fm_launches}; phase G "
          f"{time.perf_counter() - t_phase:.1f}s")
    return {"launches": fm_launches, "bags": bags, "summary": summary}


def _counter_tensors(sk) -> list:
    """The counter tensors of a sketch (what ingest and merge write)."""
    out = list(getattr(sk, "pools", ()))
    return out + [getattr(sk, f) for f in ("pool", "conn", "overflow", "table")
                  if hasattr(sk, f)]


def _serve_run(smoke, kind):
    """One tenant's query_serve run on the card, launch-counted and gated."""
    torch = smoke.torch
    from repro_torch import interop
    from repro_torch.launch import query_serve
    from repro_torch.obs import get_hub, reset_hub
    from repro_torch.serving import QueryEngine, gates
    from repro_torch.serving import engine as eng
    from repro_torch.serving.snapshot import Snapshot

    args = query_serve.parse_args([*SERVE_FLAGS, "--sketch", kind])
    t0 = time.perf_counter()
    reset_hub()  # the engine's per-family group counts and times
    reset_launches()
    run = query_serve._run(args)
    torch.cuda.synchronize()
    launches = read_launches()
    run_s = time.perf_counter() - t0
    by_family = {labels["family"]: {"groups": hs["count"], "ms": hs["sum"] * 1e3}
                for name, labels, hs in get_hub().state()["hists"]
                if name == "repro_engine_group_seconds"}
    summary, tenant, stats = run["summary"], run["tenant"], run["engine"].stats
    final, stream, mod = tenant.snapshot, tenant.stream, tenant.mod
    print(f"  {kind}: achieved_qps={summary['achieved_qps']} offered="
          f"{summary['offered_qps']} p50_ms={summary['p50_ms']} p90_ms="
          f"{summary['p90_ms']} p99_ms={summary['p99_ms']} epochs="
          f"{summary['final_epoch']} closure hits={stats['closure_hits']} "
          f"misses={stats['closure_misses']} ({run_s:.1f}s run)")
    sk = final.sketch
    layout = ({"class_widths": sk.class_widths, "class_counts": sk.class_counts,
               "conn_w": sk.conn_w} if hasattr(sk, "class_widths")
              else {"table": list(sk.table.shape)})
    print(f"  {kind}: {type(sk).__name__} {json.dumps(layout)}, "
          f"{sk.num_counters} counters")
    print(f"  {kind}: launches on the serving path: {launches}")
    print(f"  {kind}: engine groups by family over the run, warm-up ladder "
          f"included (host clock per group, read-back included): "
          f"{json.dumps(dict(sorted(by_family.items())))}")
    batches = stream.num_batches
    smoke.check(batches == 52 and launches["matrix_ingest_edges"] == batches,
                f"{kind}: matrix_ingest_edges launches == batches ({batches})")
    smoke.check(launches["reach_closure"] == stats["closure_misses"] > 0,
                f"{kind}: reach_closure launches == closure misses "
                f"({stats['closure_misses']})")
    smoke.check(launches["reach_step"] == 0, f"{kind}: no reach_step launch")
    lookups = _query_launches(launches)
    smoke.check(_query_launches_fit(kind, lookups),
                f"{kind}: query launches {lookups} (each >= 1 for its own "
                "sketch, 0 for the other's)")
    smoke.check(launches["matrix_ingest"] == launches["matrix_lookup"]
                == launches["embedding_bag"] == 0,
                f"{kind}: no rectangle entry point, no embedding_bag")
    live = sum(int((stream.batch_numpy(i)[2] > 0).sum()) for i in range(batches))
    smoke.check(summary["total_edges"] == final.n_edges == live == 421_578,
                f"{kind}: total_edges {summary['total_edges']} == the "
                f"stream's weight > 0 count ({live})")

    # final state: one replay of the stream on the card and on the CPU
    t1 = time.perf_counter()
    reqs = run["requests"][:SERVE_CHECKED]
    families = {r.family for r in reqs}
    smoke.check(families == {r.family for r in run["requests"]}
                and len(families) == 6,
                f"{kind}: the first {SERVE_CHECKED} requests hold every "
                f"family ({sorted(families)})")
    card_replay = gates.replay_sketch(mod, mod.empty_like(final.sketch),
                                      stream, batches)
    cpu_template = interop.import_state(
        *interop.export_state(mod.empty_like(final.sketch)), device="cpu")
    cpu_replay = gates.replay_sketch(mod, cpu_template, stream, batches)
    direct = eng.direct_answers(final, reqs)
    for where, replay in (("card", card_replay), ("CPU", cpu_replay)):
        verdict = gates.replay_exactness(final, replay, reqs, answers=direct)
        smoke.check(verdict["ok"] and same_state(final.sketch, replay),
                    f"{kind}: final front == one replay of the stream on the "
                    f"{where} (counters and {len(reqs)} direct answers): "
                    f"{verdict}")
    # answers: the engine on the final snapshot
    got = [r.value for r in QueryEngine().execute(final, reqs)]
    cpu_snap = Snapshot(final.tenant_id + "/cpu", final.epoch, cpu_replay,
                        final.kind, final.n_edges)
    on_cpu = [r.value for r in QueryEngine().execute(cpu_snap, reqs)]
    smoke.check(gates.mismatched_indices(got, direct) == []
                and gates.mismatched_indices(got, on_cpu) == [],
                f"{kind}: engine answers on the final snapshot == direct "
                f"answers on the card == the CPU engine's on the CPU replay")

    # the device time of one edge group (the min bucket, 64 point queries)
    # of this layout: one kmatrix_lookup_edges launch for the kMatrix, one
    # matrix_lookup_edges launch for the gMatrix
    pairs = [(r.src, r.dst) for r in run["requests"] if r.family == "edge_freq"]
    qs, qd = (torch.as_tensor([p[i] for p in pairs[:64]], dtype=torch.int32,
                              device=tenant.device) for i in (0, 1))
    group_ms = device_ms(torch, lambda: mod.edge_freq(final.sketch, qs, qd))
    n_groups = sum(by_family.get(f, {"groups": 0})["groups"]
                   for f in ("edge_freq", "path_weight", "subgraph_weight"))
    edge_groups = {"groups": n_groups, "device_ms_per_group": group_ms,
                   "device_ms": None if group_ms is None else group_ms * n_groups}
    print(f"  {kind}: edge, path and subgraph groups: {json.dumps(edge_groups)}")

    # isolation: a held snapshot under 4 more batches and a publish
    held = final
    host = {k: v.copy() for k, v in interop.export_state(held.sketch)[0].items()}
    ask = reqs[:SERVE_HELD]
    before = [r.value for r in QueryEngine().execute(held, ask)]
    for i in range(4):
        tenant.buffer.ingest(stream.batch(i, device=tenant.device))
    new = tenant.publish()
    after = interop.export_state(held.sketch)[0]
    again = [r.value for r in QueryEngine().execute(held, ask)]
    smoke.check(new.epoch == held.epoch + 1
                and new.n_edges == held.n_edges + 4 * stream.batch_size
                and all((after[k] == host[k]).all() for k in host)
                and gates.mismatched_indices(before, again) == [],
                f"{kind}: held epoch {held.epoch} keeps its counters and its "
                f"answers to {len(ask)} requests after 4 more batches and "
                f"epoch {new.epoch}")
    ptrs = {t.untyped_storage().data_ptr() for t in _counter_tensors(held.sketch)}
    smoke.check(not ptrs & {t.untyped_storage().data_ptr()
                            for t in _counter_tensors(new.sketch)},
                f"{kind}: the new front shares no counter storage with the "
                "held one")
    print(f"  {kind}: gates {time.perf_counter() - t1:.1f}s")
    return {"summary": summary, "launches": launches, "run_s": run_s,
            "families": by_family, "edge_groups": edge_groups,
            "replays": {"card": card_replay, "CPU": cpu_replay}}


def _serve_profile(smoke, kind):
    """A shorter run of the same driver with ``torch.profiler`` over the
    load window: the device's busy and idle share, the top operations."""
    torch = smoke.torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import query_serve

    args = query_serve.parse_args([*SERVE_FLAGS, "--sketch", kind,
                                   "--n-requests", str(SERVE_PROFILED)])
    _, tenant = query_serve.open_tenant(args)
    engine, requests = query_serve.warm_engine(args, tenant)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report, _ = query_serve.run_load(
            args, engine, lambda: tenant.snapshot, requests,
            between_batches=query_serve.live_ingest(args, tenant))
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    events = prof.key_averages()
    busy = sum(_self_device_us(e) for e in events) / 1e3
    row = {"requests": report.n_requests, "batches": report.n_batches,
           "ingested_batches": tenant.offset, "window_ms": window * 1e3,
           "device_busy_ms": busy, "idle_share": 1 - busy / (window * 1e3),
           "achieved_qps": report.achieved_qps, "p50_ms": report.p50_ms,
           "p99_ms": report.p99_ms}
    print(f"  {kind}, load window under the profiler: {json.dumps(row)}")
    for e in sorted(events, key=_self_device_us, reverse=True)[:8]:
        if _self_device_us(e) > 0:
            print(f"    device {_self_device_us(e) / 1e3:9.3f} ms  "
                  f"x{e.count:6d}  {e.key[:90]}")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        print(f"    host   {e.self_cpu_time_total / 1e3:9.3f} ms  "
              f"x{e.count:6d}  {e.key[:90]}")
    smoke.check(busy > 0, f"{kind}: the profiled load window ran on the device")
    return row


def phase_serving(smoke, card):
    """The online serving tier on the card: two tenants through the port's
    query_serve driver, gated against replays, the CPU and a held snapshot."""
    from repro_torch.launch import query_serve

    t0 = time.perf_counter()
    # warm-up on a small stream: first-call costs stay out of the timed runs
    query_serve._run(query_serve.parse_args(
        ["--scale", "0.03", "--n-requests", "200", "--device", "cuda"]))
    out = {kind: _serve_run(smoke, kind) for kind in SERVE_KINDS}
    for kind in SERVE_KINDS:
        out[kind]["profile"] = _serve_profile(smoke, kind)
    print(f"  {card}; phase H {time.perf_counter() - t0:.1f}s")
    return out


# ------------------------------------------------------------ phase I --

def _counting_ingests():
    """Wrap ``SnapshotBuffer.ingest`` to count its calls (every thread) and
    note when the last one returned; returns the box and the function that
    restores the method."""
    import threading

    from repro_torch.serving.snapshot import SnapshotBuffer

    box, lock, orig = {"n": 0, "last": None}, threading.Lock(), \
        SnapshotBuffer.ingest

    def counted(self, batch, count=None):
        out = orig(self, batch, count)
        with lock:
            box["n"] += 1
            box["last"] = time.perf_counter()
        return out

    SnapshotBuffer.ingest = counted

    def restore():
        SnapshotBuffer.ingest = orig

    return box, restore


class _LoadClock:
    """The load generator's ``time`` module, every ``perf_counter`` reading
    it takes noted: the first is its start, and the first after a served
    batch returns is that batch's end as the generator counts it."""

    def __init__(self, real):
        self._real, self.readings = real, []

    def perf_counter(self) -> float:
        t = self._real.perf_counter()
        self.readings.append(t)
        return t

    def __getattr__(self, name):
        return getattr(self._real, name)


class _TimedEngine:
    """The engine as the load generator sees it, each served batch's host
    time noted (start, end, requests, the index of the generator's next
    clock reading)."""

    def __init__(self, engine, log: list, clock: _LoadClock):
        self._engine, self._log, self._clock = engine, log, clock

    def execute(self, snapshot, batch):
        t = time.perf_counter()
        out = self._engine.execute(snapshot, batch)
        self._log.append((t, time.perf_counter(), len(batch),
                          len(self._clock.readings)))
        return out

    def __getattr__(self, name):
        return getattr(self._engine, name)


def _timeline():
    """Note the served batches (through ``query_serve.run_load``), the load
    generator's own clock readings, and when each stream pump finished;
    returns the box and the restore function."""
    from repro_torch.launch import query_serve
    from repro_torch.runtime.supervisor import StreamPump
    from repro_torch.serving import loadgen

    box = {"batches": [], "pumps_done": [], "clock": None}
    orig_load, orig_pump = query_serve.run_load, StreamPump.run

    def run_load(args, engine, *rest, **kw):
        clock = box["clock"] = _LoadClock(loadgen.time)
        loadgen.time = clock
        try:
            return orig_load(args, _TimedEngine(engine, box["batches"], clock),
                             *rest, **kw)
        finally:
            loadgen.time = clock._real

    def pump_run(self):
        try:
            orig_pump(self)
        finally:
            box["pumps_done"].append(time.perf_counter())

    query_serve.run_load, StreamPump.run = run_load, pump_run

    def restore():
        query_serve.run_load, StreamPump.run = orig_load, orig_pump

    return box, restore


def _latency_split(batches, qps, ingest_done, pumps_done, clock) -> dict:
    """Each request's latency from the served batches (arrival i / qps from
    the load generator's start), split at the last buffer ingest: the
    requests that arrived while the stream was still being ingested, and
    those after; and p99 per arrival window.

    The start and each batch's end are the load generator's own clock
    readings (``_LoadClock``), so a request's latency is the one it
    reported.  The engine's own return time cannot stand in for the end:
    another thread may hold the GIL for milliseconds before the generator
    reads its clock (a process or in-process socket worker encoding
    frames)."""
    import numpy as np

    t0 = clock.readings[0]
    ends = np.repeat([clock.readings[b[3]] for b in batches],
                     [b[2] for b in batches])
    arrival = np.arange(ends.size) * (1.0 / qps)
    lat = ((ends - t0) - arrival) * 1e3
    cut = ingest_done - t0

    def pcts(x):
        return ({"n": int(x.size), "p50_ms": float(np.percentile(x, 50)),
                 "p99_ms": float(np.percentile(x, 99))} if x.size
                else {"n": 0})

    host = np.array([b[1] - b[0] for b in batches]) * 1e3
    bins = (arrival // LATENCY_BIN_S).astype(int)
    return {
        "served_batches": len(batches),
        "requests_per_batch": float(ends.size / len(batches)),
        "host_ms_per_batch": {"mean": float(host.mean()),
                              "p50": float(np.percentile(host, 50)),
                              "max": float(host.max())},
        "host_ms_per_request": float(host.sum() / ends.size),
        "ingest_done_s": cut,
        "pumps_done_s": (max(pumps_done) - t0) if pumps_done else None,
        "arrived_while_ingesting": pcts(lat[arrival < cut]),
        "arrived_after": pcts(lat[arrival >= cut]),
        "p99_ms_by_window": [float(np.percentile(lat[bins == b], 99))
                             for b in range(bins.max() + 1)],
        "p99_ms_recomputed": float(np.percentile(lat, 99)),
    }


def _bg_run(smoke, label, flags):
    """One query_serve run in a background mode on the card: its launches
    counted from zero, its buffer ingests counted, its served batches and
    engine groups timed on the host, its line printed."""
    torch = smoke.torch
    from repro_torch.launch import query_serve
    from repro_torch.obs import get_hub, reset_hub

    args = query_serve.parse_args([*BG_FLAGS, *flags])
    ingests, restore = _counting_ingests()
    timeline, restore_timeline = _timeline()
    reset_hub()  # the engine's per-family group counts and times
    reset_launches()
    t0 = time.perf_counter()
    try:
        run = query_serve._run(args)
        torch.cuda.synchronize()
    finally:
        restore()
        restore_timeline()
    launches = read_launches()
    by_family = {labels["family"]: {"groups": hs["count"], "ms": hs["sum"] * 1e3}
                 for name, labels, hs in get_hub().state()["hists"]
                 if name == "repro_engine_group_seconds"}
    summary = run["summary"]
    epochs = summary.get("final_epochs", summary.get("final_epoch"))
    stats = run["engine"].stats
    misses = (stats.get("sharded_closure_misses", 0)
              + stats["closure_misses"])
    hits = stats.get("sharded_closure_hits", 0) + stats["closure_hits"]
    print(f"  {label}: achieved_qps={summary['achieved_qps']} offered="
          f"{summary['offered_qps']} p50_ms={summary['p50_ms']} p99_ms="
          f"{summary['p99_ms']} ingest_edges_per_s="
          f"{summary['ingest_edges_per_s']} publishes="
          f"{summary.get('publishes', '-')} epochs={epochs} closure "
          f"hits={hits} misses={misses} buffer_ingests={ingests['n']} "
          f"launches={json.dumps(launches)} "
          f"({time.perf_counter() - t0:.1f}s run)")
    print(f"  {label}: engine groups by family over the run, warm-up ladder "
          f"included (host clock per group, read-back included; sharded: "
          f"one group per shard): {json.dumps(dict(sorted(by_family.items())))}")
    split = _latency_split(timeline["batches"], args.qps, ingests["last"],
                           timeline["pumps_done"], timeline["clock"])
    print(f"  {label}: served batches and latency against the ingest "
          f"(seconds from the load generator's start): {json.dumps(split)}")
    kind = args.sketch
    smoke.check(abs(split["p99_ms_recomputed"] - summary["p99_ms"]) < 1.0,
                f"{label}: p99 recomputed from the served batches "
                f"{split['p99_ms_recomputed']:.3f} ms == the summary's "
                f"{summary['p99_ms']} (within 1 ms)")
    smoke.check(launches["matrix_ingest_edges"] == ingests["n"] > 0,
                f"{label}: matrix_ingest_edges launches == buffer ingests "
                f"({ingests['n']})")
    smoke.check(launches["reach_closure"] == misses > 0,
                f"{label}: reach_closure launches == closure misses "
                f"({misses})")
    smoke.check(launches["reach_step"] == launches["matrix_ingest"]
                == launches["matrix_lookup"] == launches["embedding_bag"]
                == 0, f"{label}: no reach_step, no rectangle entry point, "
                "no embedding_bag")
    lookups = _query_launches(launches)
    smoke.check(_query_launches_fit(kind, lookups),
                f"{label}: query launches {lookups} (each >= 1 for its own "
                "sketch, 0 for the other's)")
    smoke.check(summary["total_edges"] == STREAM_EDGES,
                f"{label}: total_edges {summary['total_edges']} == "
                f"{STREAM_EDGES}")
    return {**run, "launches": launches, "ingests": ingests["n"],
            "misses": misses, "families": by_family, "timeline": split}


def _same_counters(a, b) -> bool:
    """Counters (pools and conn, or the table) and layout equal; the
    overflow tally is left out: coalesced and shard dispatches have other
    batch sizes than a replay's."""
    from repro_torch import interop
    from repro_torch.serving import gates

    return (gates.layout_counters_equal(a, b)
            and interop.export_state(a)[1] == interop.export_state(b)[1])


def _bg_gates(smoke, label, run, replays):
    from repro_torch.serving import QueryEngine, gates
    from repro_torch.serving import engine as eng

    summary, final = run["summary"], run["tenant"].snapshot
    smoke.check(summary["unaccounted_edges"] == summary["dropped_edges"] == 0
                and summary["worker_state"] == "stopped",
                f"{label}: unaccounted_edges 0, dropped_edges 0, worker "
                f"{summary['worker_state']}")
    for where, replay in replays.items():
        smoke.check(_same_counters(final.sketch, replay),
                    f"{label}: final front == phase H's replay on the "
                    f"{where}")
    reqs = run["requests"][:SERVE_CHECKED]
    got = [r.value for r in QueryEngine().execute(final, reqs)]
    smoke.check(gates.mismatched_indices(got, eng.direct_answers(final, reqs))
                == [], f"{label}: engine answers to {len(reqs)} requests on "
                "the final snapshot == direct answers on the card")


def _cpu_shard_snapshot(sharded):
    """The sharded tenant's shard views replayed on the CPU through the
    plain versions, as one ShardedSnapshot."""
    from repro_torch import interop
    from repro_torch.serving import ShardedSnapshot, gates
    from repro_torch.serving.snapshot import Snapshot

    parts = []
    for shard in sharded.shards:
        sk = shard.snapshot.sketch
        template = interop.import_state(
            *interop.export_state(shard.mod.empty_like(sk)), device="cpu")
        replay = gates.replay_sketch(shard.mod, template, shard.stream,
                                     shard.stream.num_batches)
        parts.append(Snapshot(shard.snapshot.tenant_id + "/cpu",
                              shard.snapshot.epoch, replay,
                              shard.snapshot.kind, shard.snapshot.n_edges))
    return ShardedSnapshot(sharded.key.tenant_id + "/cpu", sharded.plan,
                           tuple(parts))


def _sharded_gates(smoke, label, run, replays):
    from repro_torch.serving import (QueryEngine, ShardedQueryEngine, gates,
                                     sharded_direct_answers)

    summary, st = run["summary"], run["tenant"]
    smoke.check(summary["conservation_ok"]
                and sum(summary["per_shard_published"]) == STREAM_EDGES
                and summary["dropped_edges"] == 0,
                f"{label}: conservation_ok, per_shard_published "
                f"{summary['per_shard_published']} sums to {STREAM_EDGES}")
    merged = st.merged_snapshot()
    for where, replay in replays.items():
        smoke.check(_same_counters(merged.sketch, replay),
                    f"{label}: merged_snapshot() == phase H's replay on the "
                    f"{where}")
    snap, reqs = st.snapshot, run["requests"][:SERVE_CHECKED]
    got = [r.value for r in ShardedQueryEngine(QueryEngine()).execute(
        snap, reqs)]
    on_cpu = [r.value for r in ShardedQueryEngine(QueryEngine()).execute(
        _cpu_shard_snapshot(st), reqs)]
    smoke.check(gates.mismatched_indices(
        got, sharded_direct_answers(snap, reqs)) == []
        and gates.mismatched_indices(got, on_cpu) == [],
        f"{label}: ShardedQueryEngine answers to {len(reqs)} requests == "
        "sharded_direct_answers on the card == the CPU engine on a CPU "
        "replay of the shard views")


def _sharded_resume(smoke, replays):
    """Crash and resume, sharded: the kMatrix shards taken to different
    offsets from pre-filled queues, stopped crash-like, restored into a new
    registry from their checkpoints and drained."""
    torch = smoke.torch
    from repro_torch.runtime import QueueItem, Runtime
    from repro_torch.serving import (SketchRegistry, attach_shards,
                                     read_shard_manifest, sharded_conservation)

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_shards_")
    try:
        reset_launches()
        reg = SketchRegistry(depth=5, scale=1.0, device="cuda")
        st = reg.open_sharded("cit-HepPh", "kmatrix", 256, n_shards=4)
        rt = Runtime(queue_capacity=64, publish_policy="every:4",
                     checkpoint_dir=ckpt, checkpoint_every=RESUME_EVERY)
        handles = attach_shards(rt, st)
        rt.start(pumps=False)
        for h, n in zip(handles, RESUME_OFFSETS):
            for i in range(n):
                h.queue.put(QueueItem.from_arrays(
                    i, *h.tenant.stream.batch_numpy(i)), timeout=60)
        deadline = time.monotonic() + 300
        while not all(h.worker.metrics.checkpoints >= n // RESUME_EVERY
                      and h.worker.metrics.ingested_batches >= n
                      for h, n in zip(handles, RESUME_OFFSETS)):
            if time.monotonic() > deadline:
                raise TimeoutError("shards did not reach their offsets")
            time.sleep(0.01)
        rt.stop(drain=False, timeout=60)
        crashed = [s.offset for s in st.shards]
        manifest = read_shard_manifest(ckpt)

        reg_b = SketchRegistry(depth=5, scale=1.0, device="cuda")
        st_b = reg_b.open_sharded("cit-HepPh", "kmatrix", 256,
                                  n_shards=manifest["n_shards"],
                                  shard_seed=manifest["shard_seed"])
        rt_b = Runtime(queue_capacity=64, publish_policy="every:4",
                       checkpoint_dir=ckpt)
        handles_b = attach_shards(rt_b, st_b, restore=True)
        restored = [s.offset for s in st_b.shards]
        rt_b.start()
        rt_b.join_pumps(300)
        rt_b.stop(drain=True, timeout=300)
        torch.cuda.synchronize()
        launches = read_launches()
        cons = sharded_conservation(handles_b, st_b.stream.spec.n_edges)
        print(f"  resume: crashed at offsets {crashed}, restored at "
              f"{restored}; {json.dumps(cons)}; launches "
              f"{json.dumps(launches)}")
        smoke.check(crashed == restored == list(RESUME_OFFSETS),
                    f"resume: each shard restored at the offset it crashed "
                    f"at ({list(RESUME_OFFSETS)})")
        smoke.check(cons["conservation_ok"]
                    and cons["published_edges"] == STREAM_EDGES,
                    "resume: conservation over the restored shards")
        merged = st_b.merged_snapshot()
        for where, replay in replays.items():
            smoke.check(_same_counters(merged.sketch, replay),
                        f"resume: merged front == phase H's replay on the "
                        f"{where}")
        other = SketchRegistry(depth=5, scale=1.0, device="cuda").open_sharded(
            "cit-HepPh", "kmatrix", 256, n_shards=4, shard_seed=1)
        try:
            attach_shards(Runtime(checkpoint_dir=ckpt), other, restore=True)
            refused = ""
        except ValueError as exc:
            refused = str(exc)
        smoke.check("manifest" in refused,
                    "resume: the manifest refuses --shard-seed 1 "
                    f"({refused[:60]!r})")
        return launches
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def _drain_rates(smoke):
    """``measure_sharded_ingest`` DRAIN_REPEATS times at each K, each on a
    fresh sharded tenant: every drain's rate and worker dispatches (buffer
    ingests less the warm-up's), then the spread at each K."""
    from repro_torch.serving import SketchRegistry, measure_sharded_ingest
    from repro_torch.serving import sharding

    rows, warm = [], sharding.warm_ingest_shapes

    def warm_counted(tenant):
        box["warm"] = warm(tenant)
        return box["warm"]

    for k in DRAIN_SHARDS:
        rates = []
        for rep in range(DRAIN_REPEATS):
            st = SketchRegistry(depth=5, scale=1.0, device="cuda").open_sharded(
                "cit-HepPh", "kmatrix", 256, n_shards=k)
            box, restore = _counting_ingests()
            sharding.warm_ingest_shapes = warm_counted
            try:
                out = measure_sharded_ingest(st)
            finally:
                restore()
                sharding.warm_ingest_shapes = warm
            dispatches = box["n"] - box["warm"]
            print(f"  drain K={k} #{rep}: {out['edges_per_s']} edges/s over "
                  f"{out['wall_s']} s, {dispatches} worker dispatches, "
                  f"conserved={out['conserved']}")
            smoke.check(out["conserved"] and out["queued_edges"] == STREAM_EDGES,
                        f"drain K={k} #{rep}: every queued edge published")
            rates.append(out["edges_per_s"])
            rows.append({**out, "dispatches": dispatches})
        print(f"  drain K={k} over {DRAIN_REPEATS} drains: edges/s min "
              f"{min(rates)} median {statistics.median(rates)} max "
              f"{max(rates)}")
    return rows


def _sharded_profile(smoke):
    """A 600-request window of the sharded kMatrix run under
    ``torch.profiler`` (the worker threads' kernels included): the device's
    busy and idle share and the top operations."""
    torch = smoke.torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import query_serve

    box, orig = {}, query_serve.run_load

    def profiled(*args, **kwargs):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            box["window"] = time.perf_counter() - t0
        box["prof"], box["report"] = prof, out[0]
        return out

    query_serve.run_load = profiled
    try:
        query_serve._run(query_serve.parse_args(
            [*BG_FLAGS, "--sketch", "kmatrix", "--shards", "4",
             "--n-requests", str(SERVE_PROFILED)]))
    finally:
        query_serve.run_load = orig
    events = box["prof"].key_averages()
    busy = sum(_self_device_us(e) for e in events) / 1e3
    report, window = box["report"], box["window"]
    row = {"requests": report.n_requests, "batches": report.n_batches,
           "window_ms": window * 1e3, "device_busy_ms": busy,
           "idle_share": 1 - busy / (window * 1e3),
           "achieved_qps": report.achieved_qps, "p50_ms": report.p50_ms,
           "p99_ms": report.p99_ms}
    print(f"  sharded kmatrix, load window under the profiler: "
          f"{json.dumps(row)}")
    for e in sorted(events, key=_self_device_us, reverse=True)[:8]:
        if _self_device_us(e) > 0:
            print(f"    device {_self_device_us(e) / 1e3:9.3f} ms  "
                  f"x{e.count:6d}  {e.key[:90]}")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        print(f"    host   {e.self_cpu_time_total / 1e3:9.3f} ms  "
              f"x{e.count:6d}  {e.key[:90]}")
    smoke.check(busy > 0, "sharded kmatrix: the profiled window ran on the "
                "device")
    return row


def phase_background(smoke, card, serve):
    """Background and sharded serving on the card, gated against phase H's
    replays of the full stream (after a full drain every mode's final front
    must equal them)."""
    t0 = time.perf_counter()
    out, launches = {}, {}
    for kind in SERVE_KINDS:
        replays = serve[kind]["replays"]
        run = _bg_run(smoke, f"background {kind}", ["--sketch", kind])
        _bg_gates(smoke, f"background {kind}", run, replays)
        launches[f"background {kind}"] = run["launches"]
        out[f"background {kind}"] = run["summary"]
        if kind == "kmatrix":
            dedup = _bg_run(smoke, "background kmatrix dedup",
                            ["--sketch", kind, "--ingest-dedup"])
            _bg_gates(smoke, "background kmatrix dedup", dedup, replays)
            smoke.check(_same_counters(dedup["tenant"].snapshot.sketch,
                                       run["tenant"].snapshot.sketch),
                        "background kmatrix: --ingest-dedup pools and conn "
                        "== the run without it")
            launches["background kmatrix dedup"] = dedup["launches"]
            out["background kmatrix dedup"] = dedup["summary"]
    for kind in SERVE_KINDS:
        label = f"sharded {kind}"
        run = _bg_run(smoke, label, ["--sketch", kind, "--shards", "4"])
        _sharded_gates(smoke, label, run, serve[kind]["replays"])
        launches[label] = run["launches"]
        out[label] = run["summary"]
    launches["sharded kmatrix resume"] = _sharded_resume(
        smoke, serve["kmatrix"]["replays"])
    out["drain"] = _drain_rates(smoke)
    out["profile"] = _sharded_profile(smoke)
    print(f"  {card}; phase I {time.perf_counter() - t0:.1f}s")
    return {"runs": out, "launches": launches}


# ------------------------------------------------------------ phase J --

def _worker_watch():
    """Note every remote worker handle made (process and socket), when it
    started and when its ``ready`` frame arrived; returns the box and the
    function that restores the patched methods."""
    from repro_torch.net import backend as net_backend
    from repro_torch.runtime import backend as rt_backend

    box = {"workers": [], "ready_at": {}}
    classes = (rt_backend.ProcessWorker, net_backend.SocketWorker)
    starts = [cls.start for cls in classes]
    dispatches = (rt_backend.dispatch_parent_message,
                  net_backend.dispatch_parent_message)

    def started(orig):
        def start(self):
            box["workers"].append((self, time.perf_counter()))
            return orig(self)
        return start

    def dispatch(h, msg):
        if msg[0] == "ready":
            box["ready_at"].setdefault(id(h), time.perf_counter())
        return dispatches[0](h, msg)

    for cls, orig in zip(classes, starts):
        cls.start = started(orig)
    rt_backend.dispatch_parent_message = dispatch
    net_backend.dispatch_parent_message = dispatch

    def restore():
        for cls, orig in zip(classes, starts):
            cls.start = orig
        rt_backend.dispatch_parent_message = dispatches[0]
        net_backend.dispatch_parent_message = dispatches[1]

    return box, restore


def compute_apps() -> dict:
    """``{pid: used_memory in MiB}`` of the processes ``nvidia-smi`` lists
    on the card.  In a sandbox with a PID namespace of its own the card
    lists the whole sandbox as one process, under a pid of the host's."""
    proc = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    apps = {}
    for line in proc.stdout.strip().splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            apps[int(pid)] = int(mem.split()[0]) if mem.split() else 0
    return apps


def _while_loaded():
    """Read the card's compute apps at the end of each run's load window,
    while the run's workers are still alive (the runtime stops them after
    the load returns); returns the box and the restore function."""
    from repro_torch.launch import query_serve

    box, orig = {"apps": []}, query_serve.run_load

    def run_load(*args, **kwargs):
        out = orig(*args, **kwargs)
        box["apps"].append(compute_apps())
        return out

    query_serve.run_load = run_load

    def restore():
        query_serve.run_load = orig

    return box, restore


def _remote_run(smoke, label, flags, extra_pids=()):
    """One background or sharded query_serve run with remote workers:
    phase I's run and launch checks (the parent's launches: the warm
    batches, the closures, the lookups), each worker on the card while the
    run is live — its pid among the card's compute apps, or, where the
    card lists the sandbox as one process, the card's compute memory grown
    by at least a CUDA context per worker — and each worker's
    spawn-to-ready time."""
    from repro_torch.obs import get_hub

    before = compute_apps()  # this process only: no worker is up yet
    watch, restore_watch = _worker_watch()
    apps, restore_apps = _while_loaded()
    try:
        run = _bg_run(smoke, label, flags)
    finally:
        restore_watch()
        restore_apps()
    seen = apps["apps"][-1] if apps["apps"] else {}
    workers = []
    for w, t_start in watch["workers"]:
        proc = getattr(w, "process", None)
        ready = watch["ready_at"].get(id(w))
        workers.append({"pid": proc.pid if proc is not None else None,
                        "spawn_to_ready_s": (None if ready is None
                                             else ready - t_start)})
    pids = [w["pid"] for w in workers if w["pid"] is not None]
    pids += list(extra_pids)
    grown = sum(seen.values()) - sum(before.values())
    print(f"  {label}: workers {json.dumps(workers)}; the card's compute "
          f"apps (pid: MiB) before the run {json.dumps(before)}, while live "
          f"{json.dumps(seen)}: {grown} MiB more for {len(pids)} worker "
          "processes")
    listed = bool(pids) and all(pid in seen for pid in pids)
    smoke.check(listed or (set(seen) == set(before)
                           and grown >= CONTEXT_MIB * len(pids) > 0),
                f"{label}: every worker process ({pids}) is on the card: "
                + (f"listed ({[seen.get(pid) for pid in pids]} MiB)" if listed
                   else f"the sandbox is one listed process, whose memory "
                   f"grew {grown} MiB >= {CONTEXT_MIB} MiB per worker"))
    smoke.check(all(w["spawn_to_ready_s"] is not None for w in workers),
                f"{label}: every worker sent ready")
    publish_bytes = sum(v for n, _, v in get_hub().state()["counters"]
                        if n == "publish_bytes")
    return {**run, "workers": workers, "apps": seen,
            "publish_bytes": publish_bytes}


def _report_dir(root: str, label: str) -> str:
    """A fresh directory under ``root`` for one run's launch reports."""
    path = os.path.join(root, label.replace(" ", "_"))
    os.makedirs(path)
    return path


def _child_launches(smoke, label: str, path: str, children: int) -> dict:
    """The kernel launches that one run's worker processes reported in
    ``path`` (``LAUNCH_REPORT_ENV``: each leaves its session's launches and
    its buffer's ingest calls when it stops), summed; this process's own
    report, if any, is left out, since its launches are counted here.
    Every child launched ``matrix_ingest_edges`` at least once for each
    batch its buffer ingested on the card."""
    reports = []
    for name in sorted(os.listdir(path)):
        if name.endswith(".json"):
            with open(os.path.join(path, name)) as f:
                rep = json.load(f)
            if rep["pid"] != os.getpid():
                reports.append(rep)
    pairs = [(r["launches"]["matrix_ingest_edges"], r["buffer_ingests"])
             for r in reports]
    smoke.check(len(reports) == children
                and all(n >= ingests > 0 for n, ingests in pairs),
                f"{label}: {len(reports)} of {children} worker processes "
                "reported, each launching matrix_ingest_edges at least once "
                "for each batch its buffer ingested on the card "
                f"(launches, ingests: {pairs})")
    return {k: sum(r["launches"][k] for r in reports) for k in KERNEL_NAMES}


def _listen_host(reports: str):
    """A ``stream_ingest --listen`` worker host subprocess on the card,
    leaving its launch reports in ``reports``; returns it and its address."""
    from repro_torch.runtime.backend import LAUNCH_REPORT_ENV

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           LAUNCH_REPORT_ENV: reports}
    host = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.stream_ingest",
         "--listen", "127.0.0.1:0", "--max-sessions", "1",
         "--idle-timeout-s", "300"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    line = json.loads(host.stdout.readline())
    return host, line["listening"]


def _wire_answers(smoke, label, run):
    """The first SERVE_CHECKED requests asked over the wire of a query
    server on the run's final snapshot, against the direct answers."""
    from repro_torch.net.query_server import QueryClient, QueryServer
    from repro_torch.serving import gates
    from repro_torch.serving import engine as eng

    final, reqs = run["tenant"].snapshot, run["requests"][:SERVE_CHECKED]
    server = QueryServer(run["engine"], lambda: final).start()
    try:
        client = QueryClient(server.address)
        values, epoch = client.query(reqs, timeout_s=120)
        client.close()
    finally:
        server.stop()
    smoke.check(epoch == final.epoch and gates.mismatched_indices(
        values, eng.direct_answers(final, reqs)) == [],
        f"{label}: {len(reqs)} answers over the wire at epoch {epoch} == "
        "the direct answers on the final snapshot")


def _scrape_after_load():
    """Scrape the front-end once with ``python -m repro_torch.obs.dashboard
    --connect HOST:PORT --once`` when the load is done and the server still
    up; returns the box and the restore function."""
    import os

    from repro_torch.serving.loadgen import NetLoadGen

    box, orig = {}, NetLoadGen.run

    def run(self, address, *args, **kwargs):
        out = orig(self, address, *args, **kwargs)
        box["scrape"] = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.dashboard", "--connect",
             "{}:{}".format(*address), "--once"], capture_output=True,
            text=True, timeout=120, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        return out

    NetLoadGen.run = run

    def restore():
        NetLoadGen.run = orig

    return box, restore


def _serve_net(smoke, kind, phase_h):
    """``query_serve --background-ingest --serve 127.0.0.1:0 --connections
    4``: the front-end's line beside phase H's in-process numbers, and the
    answers over the wire; the kMatrix's front-end is scraped once by the
    dashboard."""
    torch = smoke.torch
    from repro_torch.launch import query_serve

    label = f"serve {kind}"
    box, restore = _scrape_after_load() if kind == "kmatrix" else ({}, None)
    reset_launches()
    t0 = time.perf_counter()
    try:
        run = query_serve._run(query_serve.parse_args(
            [*BG_FLAGS, "--sketch", kind, "--serve", "127.0.0.1:0",
             "--connections", "4"]))
    finally:
        if restore is not None:
            restore()
    torch.cuda.synchronize()
    launches = read_launches()
    if kind == "kmatrix":
        scrape = box.get("scrape")
        text = scrape.stdout if scrape is not None else ""
        print("  dashboard scrape of the front-end:\n    "
              + "\n    ".join(text.strip().splitlines()
                              or [scrape.stderr.strip() if scrape else "none"]))
        panel = text.partition("ingest (per shard)")[2]
        smoke.check(scrape is not None and scrape.returncode == 0
                    and "/kmatrix/" in panel,
                    "dashboard --connect --once on the kMatrix front-end: "
                    "exit 0 and the kMatrix tenant's ingest panel")
    s, h = run["summary"], phase_h["summary"]
    row = {k: s[k] for k in ("achieved_qps", "p50_ms", "p99_ms", "shed",
                             "shed_rate", "aborted", "answer_epoch",
                             "final_epoch")}
    row["server_stats"] = s["server_stats"]
    print(f"  {label}: {json.dumps(row)} (phase H in process: "
          f"achieved_qps={h['achieved_qps']} p50_ms={h['p50_ms']} "
          f"p99_ms={h['p99_ms']}); launches {json.dumps(launches)} "
          f"({time.perf_counter() - t0:.1f}s run)")
    smoke.check(s["unaccounted_edges"] == 0 and s["aborted"] == 0
                and s["total_edges"] == STREAM_EDGES
                and s["server_stats"]["offered_requests"]
                == s["server_stats"]["admitted_requests"]
                + s["server_stats"]["shed_overload"]
                + s["server_stats"]["shed_rate_limited"]
                + s["server_stats"]["shed_too_large"],
                f"{label}: conservation, no aborted request, the admission "
                "ledger balances")
    _wire_answers(smoke, label, run)
    return {**run, "launches": launches}


def _process_drains(smoke):
    """``measure_sharded_ingest(backend="process")`` PROCESS_DRAINS times
    at each K: the drain over K spawn children, each in its own
    interpreter with its own CUDA context (which leave their launch
    reports where ``LAUNCH_REPORT_ENV`` points)."""
    from repro_torch.serving import SketchRegistry, measure_sharded_ingest

    rows = []
    for k in DRAIN_SHARDS:
        rates = []
        for rep in range(PROCESS_DRAINS):
            st = SketchRegistry(depth=5, scale=1.0, device="cuda").open_sharded(
                "cit-HepPh", "kmatrix", 256, n_shards=k)
            out = measure_sharded_ingest(st, backend="process")
            print(f"  process drain K={k} #{rep}: {out['edges_per_s']} "
                  f"edges/s over {out['wall_s']} s, "
                  f"conserved={out['conserved']}")
            smoke.check(out["conserved"]
                        and out["queued_edges"] == STREAM_EDGES,
                        f"process drain K={k} #{rep}: every queued edge "
                        "published")
            rates.append(out["edges_per_s"])
            rows.append(out)
        print(f"  process drain K={k} over {PROCESS_DRAINS} drains: edges/s "
              f"min {min(rates)} median {statistics.median(rates)} max "
              f"{max(rates)}")
    return rows


def phase_network(smoke, card, serve, bg):
    """The network tier on the card: the process and socket backends, a
    ``--listen`` worker host, an in-process worker host carrying the launch
    gate, the TCP front-end, the drain by backend, and the publish bytes,
    delta against full; gated against phase H's replays."""
    from repro_torch.kernels import build
    from repro_torch.net.ingest_server import WorkerServer
    from repro_torch.runtime.backend import LAUNCH_REPORT_ENV

    t0 = time.perf_counter()
    built = sorted(p.name for p in build.BUILD_DIR.iterdir())
    out, launches, children = {}, {}, {}
    reports_dir = tempfile.TemporaryDirectory(prefix="phase-j-launches-")
    reports = reports_dir.name

    def reported(label, n_children, run_fn, path=None):
        """``run_fn()`` with the worker processes it spawns (they inherit
        this environment) leaving their launch reports in a directory of
        its own; the children's launches go to ``children[label]``."""
        path = path or _report_dir(reports, label)
        os.environ[LAUNCH_REPORT_ENV] = path
        try:
            result = run_fn()
        finally:
            del os.environ[LAUNCH_REPORT_ENV]
        children[label] = _child_launches(smoke, label, path, n_children)
        return result

    def gated(label, flags, sharded=False, kind="kmatrix", path=None, **kw):
        run = reported(label, 4 if sharded else 1, lambda: _remote_run(
            smoke, label, ["--sketch", kind, *flags], **kw), path)
        gate = _sharded_gates if sharded else _bg_gates
        gate(smoke, label, run, serve[kind]["replays"])
        launches[label] = run["launches"]
        out[label] = {"summary": run["summary"], "workers": run["workers"],
                      "publish_bytes": run["publish_bytes"]}
        return run

    for kind in SERVE_KINDS:
        gated(f"process {kind}", ["--runtime-backend", "process"], kind=kind)
    full = gated("process kmatrix full", ["--runtime-backend", "process",
                                          "--publish-mode", "full"])
    delta = out["process kmatrix"]["publish_bytes"]
    print(f"  publish bytes adopted, process kmatrix: delta {delta}, full "
          f"{full['publish_bytes']} ({full['publish_bytes'] / max(delta, 1):.2f}x)")
    for kind in SERVE_KINDS:
        gated(f"process sharded {kind}", ["--runtime-backend", "process",
                                          "--shards", "4"],
              sharded=True, kind=kind)
    gated("socket kmatrix", ["--runtime-backend", "socket"])

    host_reports = _report_dir(reports, "listen gmatrix")
    host, address = _listen_host(host_reports)
    try:
        gated("listen gmatrix", ["--runtime-backend", f"socket:{address}"],
              kind="gmatrix", path=host_reports, extra_pids=(host.pid,))
        rest, err = host.communicate(timeout=120)
    finally:
        if host.poll() is None:
            host.kill()
            host.communicate()
    print(f"  listen host (pid {host.pid}): exit {host.returncode}, "
          f"{rest.strip().splitlines()[-1] if rest.strip() else err[-300:]}")
    smoke.check(host.returncode == 0, "listen host: one stopped session, "
                "exit 0")

    # the launch gate over real loopback TCP: an in-process worker host,
    # whose launches and buffer ingests this process counts
    server = WorkerServer("127.0.0.1", 0)
    import threading

    thread = threading.Thread(target=server.serve_forever, kwargs=dict(
        max_sessions=1, idle_timeout_s=300), daemon=True)
    thread.start()
    try:
        label = "worker host in process"
        run = _bg_run(smoke, label, ["--sketch", "kmatrix", "--runtime-backend",
                                     "socket:{}:{}".format(*server.address)])
        _bg_gates(smoke, label, run, serve["kmatrix"]["replays"])
        thread.join(300)
        smoke.check(server.session_results == ["stopped"]
                    and run["ingests"] > 4,
                    f"{label}: one stopped session; its buffer ingests "
                    f"({run['ingests']}, the parent's 4 warm batches "
                    "included) each launched matrix_ingest_edges")
        launches[label] = run["launches"]
        out[label] = {"summary": run["summary"]}
    finally:
        server.stop()

    for kind in SERVE_KINDS:
        run = _serve_net(smoke, kind, serve[kind])
        launches[f"serve {kind}"] = run["launches"]
        out[f"serve {kind}"] = run["summary"]
    out["process drains"] = reported(
        "process drains", PROCESS_DRAINS * sum(DRAIN_SHARDS),
        lambda: _process_drains(smoke))
    reports_dir.cleanup()
    now = sorted(p.name for p in build.BUILD_DIR.iterdir())
    smoke.check(now == built, f"no kernel was built during phase J (build "
                f"directory {len(built)} entries before, {len(now)} after)")
    print(f"  worker children's launches by run: {json.dumps(children)}")
    print(f"  {card}; phase J {time.perf_counter() - t0:.1f}s")
    return {"runs": out, "launches": launches, "children": children}


# ------------------------------------------------------------ phase K --

def _card_memory_mib() -> int:
    proc = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return int(proc.stdout.split()[0])


def _k_rank(rank, world, shape, modes, leaves, static, n_queries):
    """One rank of phase K: every mode of its mesh over the full stream,
    each timed on the host clock (a barrier, the 52 batches, one
    synchronise), then its query and the mesh's summed state."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import interop
    from repro_torch.distributed import (
        collective_stats, group, make_dp_edge_freq, make_dp_ingest,
        make_pp_edge_freq, make_pp_ingest, reset_collective_stats,
        stacked_state)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.streams import make_stream, sample_stream

    dev = group.rank_device()
    if dev.type != "cuda":
        raise RuntimeError(f"rank {rank} runs on {dev}, not on the card")
    sk = interop.import_state(leaves, static, device=dev)
    mesh = make_mesh(shape, ("data", "model"))
    stream = make_stream("cit-HepPh", batch_size=8192, scale=1.0)
    batches = torch.as_tensor(np.stack([np.stack(stream.batch_numpy(i))
                                        for i in range(stream.num_batches)]),
                              device=dev)
    qs, qd, _ = sample_stream(stream, n_queries, seed=99)
    qs, qd = torch.as_tensor(qs, device=dev), torch.as_tensor(qd, device=dev)
    out = {"rank": rank, "coord": mesh.get_coordinate(), "modes": {}}
    for mode, cf in modes:
        if mode == "dp":
            ingest, query = make_dp_ingest(sk, mesh), make_dp_edge_freq(sk, mesh)
            axes = ("data",)
        else:
            ingest, _ = make_pp_ingest(sk, mesh, mode=mode,
                                       capacity_factor=cf or 2.0)
            query, axes = make_pp_edge_freq(sk, mesh), None
        # one warm batch into scratch state: first-call costs stay out
        ingest(torch.zeros_like(sk.pool), torch.zeros_like(sk.conn),
               *batches[0])
        pool, conn = torch.zeros_like(sk.pool), torch.zeros_like(sk.conn)
        dropped = torch.zeros((), dtype=torch.int32, device=dev)
        torch.cuda.synchronize(dev)
        dist.barrier()
        reset_collective_stats()
        t0 = time.perf_counter()
        for s, t, w in batches:
            res = ingest(pool, conn, s, t, w)
            if mode != "dp":
                dropped += res[2]
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        stats = collective_stats()
        t0 = time.perf_counter()
        est = query(pool, conn, qs, qd).cpu()
        query_s = time.perf_counter() - t0
        sp, sc = stacked_state(pool, conn, mesh, axes)
        n_rows = sp.shape[0] // sk.depth
        rec = {"wall_s": wall, "query_s": query_s, "stats": stats,
               "dropped": int(dropped), "on": str(pool.device),
               "batches": int(batches.shape[0])}
        if rank == 0:
            rec["est"] = est.numpy()
            rec["pool"] = sp.view(n_rows, *sk.pool.shape).sum(
                0, dtype=torch.int32).cpu().numpy()
            rec["conn"] = sc.view(n_rows, *sk.conn.shape).sum(
                0, dtype=torch.int32).cpu().numpy()
        out["modes"][f"{mode} cf={cf}" if cf else mode] = rec
    out["max_allocated"] = torch.cuda.max_memory_allocated(dev)
    return out


def _dist_mesh(smoke, shape, modes, template, replay):
    """Spawn ``shape``'s ranks on the card once, run every mode in them,
    and gate each against the single-card replay."""
    import threading

    from repro_torch.distributed import choose_topology, run_ranks

    n = math.prod(shape)
    topology = choose_topology(n, "cuda")
    print(f"  mesh {shape}: {topology.describe()}; staged by the port "
          "through pinned host buffers: none (gloo takes the CUDA tensors)")
    before = _card_memory_mib()
    peak, stop = [before], threading.Event()

    def sample():
        while not stop.wait(0.5):
            peak.append(_card_memory_mib())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    held = _allocated(smoke.torch)  # the job itself is on the host
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(_k_rank, n, shape, modes, *template, DIST_QUERIES,
                          device="cuda", timeout_s=600)
    finally:
        stop.set()
        sampler.join(10)
    wall = time.perf_counter() - t0
    _ranks_released(smoke, f"mesh {shape}", held)
    grown = max(peak) - before
    print(f"  mesh {shape}: {n} ranks in {wall:.1f}s (spawn, stream, every "
          f"mode); the card's memory {before} MiB before, +{grown} MiB at "
          f"the peak: {grown / n:.0f} MiB per rank (a CUDA context each); "
          f"max allocated per rank {max(r['max_allocated'] for r in ranks)} B")
    smoke.check(all(rec["on"].startswith("cuda") for r in ranks
                    for rec in r["modes"].values())
                and grown >= CONTEXT_MIB * n,
                f"mesh {shape}: every rank's state on the card, the card's "
                f"memory grown {grown} MiB >= {CONTEXT_MIB} MiB per rank")
    coords = [tuple(r["coord"]) for r in ranks]
    smoke.check(coords == [divmod(r, shape[1]) for r in range(n)],
                f"mesh {shape}: rank r at row-major coordinate {coords}")
    rows = {}
    for mode, cf in modes:
        label = f"{mode} cf={cf}" if cf else mode
        recs = [r["modes"][label] for r in ranks]
        head = recs[0]
        nb = head["batches"]
        wall = max(r["wall_s"] for r in recs)
        per = {name: {k: sum(r["stats"][name][k] for r in recs) / nb
                      for k in ("calls", "bytes", "host_bytes", "seconds")}
               for name in head["stats"]}
        # the host's time inside the collectives, per batch, mean over ranks
        coll_ms = {k: v["seconds"] / n * 1e3 for k, v in per.items()}
        dropped = head["dropped"]
        true_drops = replay["positive"] - int(head["pool"][0].sum())
        row = {"mesh": list(shape), "mode": label,
               "wall_ms_per_batch": wall / nb * 1e3,
               "M_edges_per_s": STREAM_EDGES / wall / 1e6,
               "query_ms": max(r["query_s"] for r in recs) * 1e3,
               "collective_bytes_per_batch": {k: v["bytes"] for k, v in per.items()},
               "host_carried_bytes_per_batch": sum(v["host_bytes"] for v in per.values()),
               "collective_calls_per_batch": {k: v["calls"] for k, v in per.items()},
               "collective_ms_per_batch": coll_ms,
               "collective_share_of_wall": sum(coll_ms.values()) / (wall / nb * 1e3),
               "dropped": dropped, "true_dropped": true_drops,
               "ARE": replay["are"](head["est"])}
        rows[label] = row
        print(f"  {json.dumps(row)}")
        exact = label in ("dp", "allgather") or shape == (2, 2)
        same = ((head["est"] == replay["est"]).all()
                and (head["pool"] == replay["pool"]).all()
                and (head["conn"] == replay["conn"]).all())
        if exact:
            smoke.check(same and dropped == 0,
                        f"mesh {shape} {label}: estimates of {DIST_QUERIES} "
                        "queries, summed pools and conns bit-equal to the "
                        "single-card replay, 0 drops")
        else:
            smoke.check(bool((head["est"] <= replay["est"]).all())
                        and (head["conn"] == replay["conn"]).all(),
                        f"mesh {shape} {label}: every estimate <= the "
                        "replay's, conn equal to the replay's")
        if label.startswith("a2a"):
            smoke.check(dropped == true_drops,
                        f"mesh {shape} {label}: reported drops {dropped} == "
                        f"positive weight in - layer-0 mass = {true_drops}")
    return rows


def phase_distributed(smoke, card):
    """The distributed kMatrix on the card: a (2, 2) mesh in DP, PP
    allgather and PP a2a at cf = 2 and 4, and a (2, 4) mesh in PP a2a at
    cf = 2, each rank a process of its own on the one card, gated against
    a single-card replay of the same stream."""
    torch = smoke.torch
    from repro_torch import interop
    from repro_torch.core import kmatrix, vertex_stats_from_sample
    from repro_torch.core.metrics import (average_relative_error,
                                          exact_edge_frequencies, lookup_exact)
    from repro_torch.core.types import EdgeBatch
    from repro_torch.serving.registry import build_sketch
    from repro_torch.streams import make_stream, sample_stream

    t0 = time.perf_counter()
    stream = make_stream("cit-HepPh", batch_size=8192, scale=1.0)
    ssrc, sdst, sw = sample_stream(stream, 30_000, seed=1)
    sk, _ = build_sketch("kmatrix", 512 * 1024,
                         vertex_stats_from_sample(ssrc, sdst, sw), 7, 0,
                         "banded", backend="flat", device="cuda")
    template = interop.export_state(sk)
    replay, positive = kmatrix.empty_like(sk), 0
    for i in range(stream.num_batches):
        src, dst, w = stream.batch_numpy(i)
        positive += int(w[w > 0].sum())
        kmatrix.ingest(replay, EdgeBatch.from_numpy(src, dst, w, device="cuda"))
    qs, qd, _ = sample_stream(stream, DIST_QUERIES, seed=99)
    est = kmatrix.edge_freq(replay, torch.as_tensor(qs, device="cuda"),
                            torch.as_tensor(qd, device="cuda")).cpu().numpy()
    true = torch.as_tensor(lookup_exact(
        exact_edge_frequencies(*stream.all_edges_numpy()), qs, qd))

    def are(e) -> float:
        return float(average_relative_error(torch.as_tensor(e), true))

    replay_info = {"est": est, "pool": replay.pool.cpu().numpy(),
                   "conn": replay.conn.cpu().numpy(), "positive": positive,
                   "are": are}
    print(f"  single-card replay: flat kMatrix pool {tuple(sk.pool.shape)}, "
          f"conn {tuple(sk.conn.shape)}, {len(sk.route.widths)} partitions, "
          f"{positive} edges, ARE {are(est)}")
    rows = {}
    for shape, modes in DIST_MESHES:
        rows[shape] = _dist_mesh(smoke, shape, modes, template, replay_info)
    print(f"  {card}; phase K {time.perf_counter() - t0:.1f}s")
    return rows


# ------------------------------------------------------------ phase L --

def _capture_backward(fn):
    """``fn()``'s result and, for every ``embedding_bag_backward`` call made
    in it, ``(grad_out, idx, num_rows, table, grad_sq)``.  The run is not a
    counted one: the recorder stands where the wrapper counts."""
    import importlib

    eb = importlib.import_module("repro_torch.kernels.embedding_bag")

    calls = []
    real = eb.embedding_bag_backward

    def record(grad_out, idx, num_rows, table=None, grad_sq=None):
        calls.append((grad_out, idx, num_rows, table, grad_sq))
        return real(grad_out, idx, num_rows, table, grad_sq)

    record.launches = 0
    eb.embedding_bag_backward = record
    try:
        result = fn()
    finally:
        eb.embedding_bag_backward = real
    return result, calls


def _fm_train_steps(smoke, cell, steps: int, label: str) -> dict:
    """``steps`` runs of an FM train cell, each counted from zero: 3
    ``embedding_bag`` and 2 ``embedding_bag_backward`` launches a step on the
    card, and the squared table derived again after each step."""
    torch = smoke.torch
    params = cell.params.params
    on_card = params.emb.is_cuda
    losses, step_ms, launches = [], [], []
    for _ in range(steps):
        version = params.emb._version
        reset_launches()
        t0 = time.perf_counter()
        metrics = cell.run()
        loss = float(metrics["loss"])  # reads back: the step has ended
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(read_launches())
        losses.append(loss)
        with torch.no_grad():
            fresh = params.squared_table()
            rederived = (params.emb._version != version and
                         torch.equal(fresh, params.emb * params.emb))
        smoke.check(rederived, f"{label}: emb updated in place and the squared "
                    "table derived again after the step")
    if on_card:
        expect = {k: 0 for k in KERNEL_NAMES}
        expect.update(embedding_bag=FM_TRAIN_BAGS, embedding_bag_backward=
                      FM_TRAIN_BACKWARDS)
        smoke.check(all(x == expect for x in launches),
                    f"{label}: launches per step {launches[-1]} == {expect}")
    smoke.check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
                f"{label}: losses finite and falling {losses}")
    total = {k: sum(x[k] for x in launches) for k in KERNEL_NAMES}
    return {"losses": losses, "step_ms": step_ms, "launches": total}


def _lm_reference_check(smoke, name: str):
    """A reduced config on the card against the CPU on the same weights (made
    on the CPU, copied to the card): the loss, and prefill plus decode
    logits, fed the same tokens on both."""
    torch = smoke.torch
    import numpy as np

    from repro_torch.configs.lm import LM_CONFIGS, reduced
    from repro_torch.models.transformer import model as tmodel

    cfg = reduced(LM_CONFIGS[name])
    cpu = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def to_card(x):
        if isinstance(x, dict):
            return {k: to_card(v) for k, v in x.items()}
        if isinstance(x, list):
            return [to_card(v) for v in x]
        return x.detach().to("cuda").requires_grad_(True)

    card = to_card(cpu)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 48)).astype(np.int32)
    out = {}
    for dev, params in (("cpu", cpu), ("cuda", card)):
        t = torch.as_tensor(toks).to(dev)
        loss, _ = tmodel.lm_loss(cfg, params, t, t)
        cache = tmodel.init_cache(cfg, 2, 48, dtype=torch.float32, device=dev)
        logits, cache = tmodel.prefill(cfg, params, t[:, :40], cache)
        steps = [logits]
        for i in range(40, 44):
            logits, cache = tmodel.decode_step(cfg, params, t[:, i:i + 1], cache)
            steps.append(logits)
        out[dev] = (float(loss.detach()), torch.cat(steps, 1).cpu())
    err = float((out["cpu"][1] - out["cuda"][1]).abs().max())
    smoke.check(abs(out["cpu"][0] - out["cuda"][0]) <= LM_RTOL * abs(out["cpu"][0])
                and torch.allclose(out["cuda"][1], out["cpu"][1], rtol=LM_RTOL,
                                   atol=LM_ATOL),
                f"{cfg.name}: loss {out['cuda'][0]!r} on the card, "
                f"{out['cpu'][0]!r} on the CPU; prefill + 4 decode logits "
                f"within rtol {LM_RTOL}, atol {LM_ATOL} (max abs diff {err!r})")


def _leaf_bits(torch, t):
    """A tensor's raw words on the host, for a bit-for-bit comparison."""
    t = t.detach().cpu()
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    return t


def _lm_checkpoint_round_trip(smoke):
    """A bf16 training state through ``launch/train.py --ckpt-dir``: the
    reduced gemma2-2b in bfloat16 trains 4 steps and checkpoints at 2 and 4;
    the step-4 checkpoint restored into a fresh CUDA template equals the
    driver's final state bit for bit, leaf by leaf; then ``--resume`` from
    step 2 trains steps 3 and 4 on the card."""
    torch = smoke.torch
    from repro_torch.checkpoint import store
    from repro_torch.configs.lm import LM_CONFIGS, reduced
    from repro_torch.launch import train
    from repro_torch.models.transformer import model as tmodel
    from repro_torch.training import AdamWConfig, init_train_state
    from repro_torch.training.optimizer import tree_leaves

    argv = ["--arch", "gemma2-2b", "--reduced", "--dtype", "bfloat16",
            "--steps", "4", "--batch", "2", "--seq", "32", "--log-every", "1",
            "--ckpt-every", "2"]
    with tempfile.TemporaryDirectory() as ckpt:
        reset_launches()
        res = train.main([*argv, "--ckpt-dir", ckpt])
        state = res["state"]
        cfg = dataclasses.replace(reduced(LM_CONFIGS["gemma2-2b"]),
                                  dtype="bfloat16")
        params = tmodel.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(7), "cuda")
        template = init_train_state(params, AdamWConfig(
            lr_peak=3e-3, warmup_steps=5, total_steps=4))
        restored, meta = store.restore(ckpt, template)
        want, got = tree_leaves(state), tree_leaves(restored)
        bf16 = sum(x.dtype == torch.bfloat16 for x in got)
        same = len(want) == len(got) and all(
            a.dtype == b.dtype and b.is_cuda
            and torch.equal(_leaf_bits(torch, a), _leaf_bits(torch, b))
            for a, b in zip(want, got))
        smoke.check(meta["step"] == 4 and not meta["filled_from_template"]
                    and bf16 > 0 and same,
                    f"bf16 checkpoint (reduced gemma2-2b, {len(got)} leaves, "
                    f"{bf16} bfloat16) restored into a CUDA template bit for "
                    "bit")
        shutil.rmtree(os.path.join(ckpt, "step_0000000004"))
        resumed = train.main([*argv, "--ckpt-dir", ckpt, "--resume"])
        launches = read_launches()
    diff = max(abs(a - b) for a, b in zip(resumed["losses"], res["losses"][2:]))
    smoke.check(len(resumed["losses"]) == 2 and all(
        math.isfinite(x) for x in resumed["losses"]) and not any(
        launches.values()), f"train --resume from the bf16 step-2 checkpoint: "
        f"steps 3-4 losses {resumed['losses']} (uninterrupted {res['losses'][2:]}, "
        f"max |diff| {diff!r}), no kernel launches")


def _lm_idle(smoke, cfg, batch: int, seq: int):
    """Device busy time and idle share of one train step of ``cfg``
    (torch.profiler over steps of a fresh state, each synchronised)."""
    torch = smoke.torch
    import numpy as np

    from repro_torch.launch.train import synthetic_lm_batch
    from repro_torch.models.transformer import model as tmodel
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step
    from repro_torch.training.steps import lm_loss_fn

    opt = AdamWConfig(lr_peak=3e-3, warmup_steps=5, total_steps=10)
    box = {"state": init_train_state(tmodel.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), "cuda"), opt)}
    step = make_train_step(lm_loss_fn(cfg), opt)
    data = synthetic_lm_batch(np.random.default_rng(5), batch, seq, cfg.vocab)

    def run():
        box["state"], metrics = step(box["state"], data)
        return metrics["loss"]

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy, top = _device_breakdown(torch, run, iters=1)
    del box["state"]
    return wall, busy, top


def _decode_idle(smoke, cfg, batch: int, prompt: int, iters: int = 4):
    """Device busy time and idle share of one decode step of ``cfg`` after a
    prefill (torch.profiler over synchronised steps, as a served token)."""
    torch = smoke.torch

    from repro_torch.models.transformer import model as tmodel

    params = tmodel.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(2), "cuda",
        requires_grad=False)
    steps = 1 + 2 * iters + 1  # the profiler's warm call, two cycles, one timed
    cache = tmodel.init_cache(cfg, batch, prompt + steps, dtype=torch.float32,
                              device="cuda")
    toks = torch.zeros((batch, prompt), dtype=torch.int32, device="cuda")
    logits, cache = tmodel.prefill(cfg, params, toks, cache)
    box = {"cache": cache, "next": torch.argmax(logits, -1).to(torch.int32)}

    def step():
        logits, box["cache"] = tmodel.decode_step(cfg, params, box["next"],
                                                  box["cache"])
        box["next"] = torch.argmax(logits, -1).to(torch.int32)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy, top = _device_breakdown(torch, step, iters=iters)
    return wall, busy, top


def phase_train(smoke, card):
    """Training on the card: the FM train_batch cell at full width with its
    counted launches, the same steps on the CPU at a small config, and the
    transformer family through its drivers (gemma2-2b at full width, the
    reduced MoE configs)."""
    torch = smoke.torch
    import numpy as np

    from repro_torch import interop
    from repro_torch.configs import registry
    from repro_torch.configs.lm import LM_CONFIGS, reduced
    from repro_torch.launch import serve, train
    from repro_torch.models.recsys import fm as fm_mod

    t_phase = time.perf_counter()
    out = {"launches": {}}
    # -- the FM train cell at full width ----------------------------------
    cfg = registry._fm_config()
    params = fm_mod.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                "cuda", requires_grad=True)
    torch.cuda.reset_peak_memory_stats()
    cell = registry.build_fm_cell("train_batch", params,
                                  np.random.default_rng(0), device="cuda")
    ids = cell.inputs[0]["ids"]
    smoke.check(tuple(ids.shape) == (65_536, 39) and cfg.table_rows == 10_000_384,
                "FM train_batch at full width: 65,536 x 39 ids, 10,000,384 rows")
    run = _fm_train_steps(smoke, cell, FM_TRAIN_STEPS, "fm train_batch")
    out["launches"]["fm train"] = run["launches"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(run["step_ms"][1:])
    busy, top = _device_breakdown(torch, cell.run, iters=3)
    fm_row = {"steps": FM_TRAIN_STEPS, "losses": run["losses"],
              "step_ms": run["step_ms"], "median_step_ms": med,
              "rows_per_s": 65_536 / med * 1e3, "peak_gib": peak,
              "device_busy_ms": busy, "idle_share": 1 - busy / med}
    print(f"  fm train_batch: {json.dumps(fm_row)} ({card})")
    for key, us, count in top:
        print(f"    device {us:9.2f} us/call  x{count:4.1f}  {key}")
    _, calls = _capture_backward(cell.run)
    torch.cuda.synchronize()
    out["backward_calls"] = calls
    out["fm"] = fm_row
    # -- the same cell on the CPU and the card at a small table -----------
    small = fm_mod.FMConfig(total_vocab=5_000, n_fields=7)
    rng = np.random.default_rng(2)
    np_params = {"emb": (rng.normal(size=(small.table_rows, 10)) * 0.01
                         ).astype(np.float32),
                 "lin": (rng.normal(size=(small.table_rows, 1)) * 0.01
                         ).astype(np.float32), "bias": np.float32(0.0)}
    runs = {}
    for dev in ("cpu", "cuda"):
        p = interop.fm_params_from_jax(small, np_params, device=dev,
                                       requires_grad=True)
        c = registry.build_fm_cell("train_batch", p, np.random.default_rng(3),
                                   device=dev)
        runs[dev] = (_fm_train_steps(smoke, c, 3, f"fm small on {dev}"), p)
    (r_cpu, p_cpu), (r_card, p_card) = runs["cpu"], runs["cuda"]
    perr = max(float((getattr(p_card, k).detach().cpu()
                      - getattr(p_cpu, k).detach()).abs().max())
               for k in ("emb", "lin", "bias"))
    lerr = max(abs(a - b) for a, b in zip(r_cpu["losses"], r_card["losses"]))
    smoke.check(lerr <= FM_TRAIN_LOSS_TOL and perr <= FM_TRAIN_PARAM_TOL,
                f"fm small (5,120 x 10, 7 fields, 3 steps): card vs CPU losses "
                f"within {FM_TRAIN_LOSS_TOL} (max {lerr!r}), params within "
                f"{FM_TRAIN_PARAM_TOL} (max {perr!r})")
    # -- the transformer family through its drivers -----------------------
    lm = {}
    for name in LM_REFERENCE:
        _lm_reference_check(smoke, name)
    for argv, label in LM_SERVE_RUNS:
        reset_launches()
        t0 = time.perf_counter()
        res = serve.main(argv)
        launches = read_launches()
        toks = res["tokens"]
        arch = LM_CONFIGS[argv[argv.index("--arch") + 1]]
        vocab = (reduced(arch) if "--reduced" in argv else arch).vocab
        smoke.check(toks.shape == (4, 16) and toks.min() >= 0
                    and toks.max() < vocab, f"serve {label}: 4 x 16 tokens in "
                    f"[0, {vocab})")
        lm[f"serve {label}"] = {
            "prefill_ms": res["prefill_s"] * 1e3,
            "decode_ms": res["decode_s"] * 1e3,
            "decode_tokens_per_s": 64 / res["decode_s"],
            "wall_s": time.perf_counter() - t0}
        out["launches"][f"lm serve {label}"] = launches
    for argv, label, batch, seq in LM_TRAIN_RUNS:
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train.main(argv)
        launches = read_launches()
        losses = res["losses"]
        smoke.check(len(losses) > 0 and all(math.isfinite(x) for x in losses),
                    f"train {label}: {len(losses)} finite losses {losses}")
        step_s = statistics.median(res["step_s"][1:] or res["step_s"])
        lm[f"train {label}"] = {
            "losses": losses, "step_s": res["step_s"], "median_step_s": step_s,
            "tokens_per_s": batch * seq / step_s,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "wall_s": time.perf_counter() - t0}
        out["launches"][f"lm train {label}"] = launches
    wall, busy, top = _lm_idle(smoke, LM_CONFIGS["gemma2-2b"], 8, 256)
    lm["train gemma2-2b"].update(profiled_step_ms=wall, device_busy_ms=busy,
                                 idle_share=1 - busy / wall)
    for key, us, count in top:
        print(f"    train device {us:9.2f} us/call  x{count:4.1f}  {key}")
    wall, busy, top = _decode_idle(smoke, LM_CONFIGS["gemma2-2b"], 4, 32)
    lm["serve gemma2-2b"].update(profiled_decode_ms=wall, device_busy_ms=busy,
                                 idle_share=1 - busy / wall)
    for key, us, count in top:
        print(f"    decode device {us:9.2f} us/call  x{count:4.1f}  {key}")
    for label, row in lm.items():
        print(f"  {label}: {json.dumps(row)} ({card})")
    for label, launches in out["launches"].items():
        if label.startswith("lm "):
            smoke.check(not any(launches.values()),
                        f"{label}: no kernel launches (the transformer "
                        "reaches no TPU kernel)")
    _lm_checkpoint_round_trip(smoke)
    out["lm"] = lm
    print(f"  {card}; phase L {time.perf_counter() - t_phase:.1f}s")
    return out


# ------------------------------------------------------------ phase M --

def _one_profiled_step(torch, fn):
    """Device busy ms of one call of ``fn()`` and its top device operations
    (torch.profiler, device activity only; the profiler's warm-up cycle
    runs a one-element add, so the step itself runs once).  The device
    events are summed straight from the trace (``kineto_results``), which
    stays fast at the ~10^5 kernels of an ``ogb_products`` step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def device_ops(prof) -> dict:
        ops: dict = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                row = ops.setdefault(e.name(), [0, 0])
                row[0] += e.duration_ns()
                row[1] += 1
        return ops

    tiny = torch.zeros(1, device="cuda")
    cycles = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: cycles.append(device_ops(p))
                 ) as prof:
        tiny += 1
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
        prof.step()
    ops = cycles[-1] if cycles else {}
    busy = sum(ns for ns, _ in ops.values()) / 1e6
    top = sorted(ops.items(), key=lambda kv: kv[1][0], reverse=True)[:5]
    return busy, [(name[:60], ns / 1e6, count) for name, (ns, count) in top]


def _gnn_cell(smoke, arch, shape_name, cfg, steps: int, card: str):
    """``steps`` timed train steps of a GNN cell on the card, then one
    profiled step: the losses finite and falling over all of them, no
    kernel launched, the median step time (host clock around ``run()``
    ending in the loss's read-back), nodes and edges per second, the peak
    memory above what the cell found allocated, and the device's idle
    share over the profiled step (its busy time over that step's own
    wall)."""
    torch = smoke.torch
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.configs.shapes import GNN_SHAPES

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = registry.init_gnn_params(
        arch, cfg, gen, registry.gnn_d_in(arch, cfg, GNN_SHAPES[shape_name]),
        "cuda")
    registry.perturb_constant_leaves(params, gen)
    cell = registry.build_gnn_cell(arch, shape_name, params,
                                   np.random.default_rng(0), "cuda", cfg=cfg)
    g = cell.inputs[0]["graph"]
    build_s = time.perf_counter() - t0
    reset_launches()
    losses, step_ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(cell.run()["loss"]))
        step_ms.append((time.perf_counter() - t1) * 1e3)
    box = {}

    def profiled():
        t1 = time.perf_counter()
        box["loss"] = float(cell.run()["loss"])
        box["ms"] = (time.perf_counter() - t1) * 1e3

    busy, top = _one_profiled_step(torch, profiled)
    losses.append(box["loss"])
    launches = read_launches()
    med = statistics.median(step_ms[1:] or step_ms)
    row = {"arch": arch, "shape": shape_name, "n_layers": cfg.n_layers,
           "nodes": g.n_nodes, "edges": g.n_edges, "losses": losses,
           "step_ms": step_ms, "median_step_ms": med,
           "nodes_per_s": g.n_nodes / med * 1e3,
           "edges_per_s": g.n_edges / med * 1e3,
           "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
           "base_gib": base / 2**30,
           "profiled_step_ms": box["ms"], "device_busy_ms": busy,
           "idle_share": 1 - busy / box["ms"],
           "build_s": build_s, "wall_s": time.perf_counter() - t0}
    label = f"{arch} {shape_name}"
    smoke.check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
                f"{label}: losses finite and falling {losses}")
    smoke.check(not any(launches.values()),
                f"{label}: no kernel launches (the GNNs reach no TPU kernel)")
    smoke.check(busy > 0, f"{label}: the profiled step recorded device time")
    print(f"  {label}: {json.dumps(row)} ({card})")
    for key, ms, count in top:
        print(f"    device {ms:10.3f} ms  x{count:6d}  {key}")
    del cell, params, g
    torch.cuda.empty_cache()
    return row


def _rel_diffs(torch, a, b) -> list:
    """Per leaf, max |a - b| over the largest |b| of that leaf (0 where both
    are all zeros)."""
    out = []
    for x, y in zip(a, b):
        x, y = x.detach().cpu(), y.detach().cpu()
        m = float(y.abs().max())
        d = float((x - y).abs().max())
        out.append(d / m if m > 0 else (0.0 if d == 0 else math.inf))
    return out


def _gnn_card_vs_cpu(smoke, arch):
    """Three train steps at the smoke size (``synthetic_graph(24, 64, 13)``,
    the JAX smoke's reduced config) on the card and on the CPU from one set
    of weights and one batch: every leaf's gradient at the first step, then
    the losses and parameters of the three steps."""
    torch = smoke.torch
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.configs.shapes import GNNShape
    from repro_torch.launch.smoke import gnn_smoke_config
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.training.optimizer import tree_leaves, tree_map

    cfg = gnn_smoke_config(arch)
    shape = GNNShape("smoke", "full", 24, 64, 13)
    gen = torch.Generator().manual_seed(3)
    cpu = registry.init_gnn_params(arch, cfg, gen, 13, "cpu")
    registry.perturb_constant_leaves(cpu, gen)
    card = tree_map(lambda x: x.detach().to("cuda").requires_grad_(True), cpu)
    loss_fn = registry.gnn_loss_fn(arch, cfg)
    step = make_train_step(loss_fn, registry.FM_TRAIN_OPT)
    runs = {}
    for dev, params in (("cpu", cpu), ("cuda", card)):
        batch = registry.gnn_batch(arch, shape, np.random.default_rng(4), dev,
                                   cfg=cfg)
        grads = torch.autograd.grad(loss_fn(params, batch)[0],
                                    tree_leaves(params), allow_unused=True,
                                    materialize_grads=True)
        state = init_train_state(params, registry.FM_TRAIN_OPT)
        losses, lrs = [], []
        for _ in range(GNN_CPU_STEPS):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            lrs.append(float(m["lr"]))
        runs[dev] = (grads, losses, lrs)
    (g_cpu, l_cpu, lrs), (g_card, l_card, _) = runs["cpu"], runs["cuda"]
    grel = _rel_diffs(torch, g_card, g_cpu)
    worst = max(range(len(grel)), key=grel.__getitem__)
    smoke.check(max(grel) <= GNN_GRAD_REL,
                f"{arch} smoke size, first step: every one of {len(grel)} "
                f"gradient leaves card vs CPU within {GNN_GRAD_REL} of the "
                f"leaf's largest |g| (worst {grel[worst]:.3e}, leaf {worst} "
                f"{tuple(g_cpu[worst].shape)})")
    lerr = max(abs(a - b) for a, b in zip(l_cpu, l_card))
    atol = 2 * sum(lrs)
    excess = max(float(((a.detach().cpu() - b.detach()).abs()
                        - 1e-6 * b.detach().abs()).max())
                 for a, b in zip(tree_leaves(card), tree_leaves(cpu)))
    smoke.check(lerr <= GNN_LOSS_REL * max(abs(x) for x in l_cpu)
                and excess <= atol,
                f"{arch} smoke size, {GNN_CPU_STEPS} steps: card vs CPU losses "
                f"{l_card} / {l_cpu} (max |diff| {lerr!r}, within "
                f"{GNN_LOSS_REL} of their size), params within {atol:.1e} + "
                f"1e-6 |p| (max excess {excess:.3e})")


def _chunked_vs_plain(smoke, card):
    """One NequIP energy+gradient step at minibatch_lg (full config) with
    the messages in 3 chunks (``chunked_edge_aggregate``) and all at once
    (``aggregate_unchunked``), each twice in float32: peak memory, time
    and loss of each; then once each way in float64: the losses and every
    gradient leaf chunked against plain."""
    torch = smoke.torch
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.models.gnn import nequip
    from repro_torch.training.optimizer import tree_leaves, tree_map

    shape = GNN_SHAPES["minibatch_lg"]
    n_edges = -(-registry.sampled_subgraph_sizes(shape)[1] // 512) * 512
    cfg = dataclasses.replace(registry.archs()["nequip"].config,
                              edge_chunk=n_edges // GNN_CHUNKED_CHUNKS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = registry.init_gnn_params("nequip", cfg, gen, shape.d_feat, "cuda")
    registry.perturb_constant_leaves(params, gen)
    batch = registry.gnn_batch("nequip", shape, np.random.default_rng(0),
                               "cuda", cfg=cfg)
    g = batch["graph"]
    out, grads = {}, {}
    for chunked in (True, False, True, False):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        e = nequip.energy(cfg, params, g, g.positions, chunked=chunked)
        loss = torch.mean((e - batch["energy"]) ** 2)
        grad = torch.autograd.grad(loss, tree_leaves(params))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        out.setdefault(chunked, []).append(
            {"ms": ms, "peak_gib": peak, "loss": float(loss.detach()),
             "grad_norm": float(torch.sqrt(sum((x * x).sum() for x in grad)))})
        grads.setdefault(chunked, []).append([x.cpu() for x in grad])
        del e, loss, grad
    ch, pl = out[True][-1], out[False][-1]
    print(f"  nequip minibatch_lg energy+gradient: chunked "
          f"({GNN_CHUNKED_CHUNKS} chunks) {json.dumps(out[True])}; plain "
          f"{json.dumps(out[False])} ({card})")
    smoke.check(ch["peak_gib"] < pl["peak_gib"]
                and abs(ch["loss"] - pl["loss"])
                <= GNN_CHUNKED_LOSS_REL * abs(pl["loss"]),
                f"chunked peak {ch['peak_gib']:.3f} GiB below the plain "
                f"{pl['peak_gib']:.3f} GiB, same loss ({ch['loss']!r} / "
                f"{pl['loss']!r})")
    # float32 gradients, shown: each path's two runs differ by the float
    # atomics' order, and chunked against plain by as much
    noise = max(max(_rel_diffs(torch, *grads[c])) for c in (True, False))
    cross = max(_rel_diffs(torch, grads[True][-1], grads[False][-1]))
    print(f"  float32 gradients: chunked vs plain up to {cross:.3e} of a "
          f"leaf's largest |g|; two runs of one path up to {noise:.3e}")
    del grads
    torch.cuda.empty_cache()

    def f64(x):
        return x.double() if torch.is_floating_point(x) else x

    p64 = tree_map(lambda x: f64(x.detach()).requires_grad_(x.requires_grad),
                   params)
    g64 = g.replace(**{f.name: f64(getattr(g, f.name))
                       for f in dataclasses.fields(g)
                       if isinstance(getattr(g, f.name), torch.Tensor)})
    target = f64(batch["energy"])
    loss64, grads64 = {}, {}
    for chunked in (True, False):
        e = nequip.energy(cfg, p64, g64, g64.positions, chunked=chunked)
        loss = torch.mean((e - target) ** 2)
        grads64[chunked] = [x.cpu() for x in
                            torch.autograd.grad(loss, tree_leaves(p64))]
        loss64[chunked] = float(loss.detach())
        del e, loss
    lrel = abs(loss64[True] - loss64[False]) / abs(loss64[False])
    cross = _rel_diffs(torch, grads64[True], grads64[False])
    worst = max(range(len(cross)), key=cross.__getitem__)
    smoke.check(lrel <= GNN_CHUNKED_F64_LOSS_REL
                and cross[worst] <= GNN_CHUNKED_F64_GRAD_REL,
                f"chunked vs plain in float64: losses within "
                f"{GNN_CHUNKED_F64_LOSS_REL} relative ({lrel:.3e}), every one "
                f"of {len(cross)} gradient leaves within "
                f"{GNN_CHUNKED_F64_GRAD_REL} of the leaf's largest |g| (worst "
                f"{cross[worst]:.3e}, leaf {worst})")
    del p64, g64, target, grads64, params, batch, g
    torch.cuda.empty_cache()
    return out


def _smoke_all_on_card(smoke):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.smoke",
                           "--all"], capture_output=True, text=True, env=env,
                          timeout=600, cwd=ROOT)
    ok = [line for line in proc.stdout.splitlines()
          if line.startswith("[smoke OK]")]
    for line in ok:
        print(f"    {line}")
    smoke.check(proc.returncode == 0 and len(ok) == 10
                and all("'device': 'cuda'" in line for line in ok),
                f"python -m repro_torch.launch.smoke --all on the card: exit "
                f"{proc.returncode}, {len(ok)} [smoke OK] lines "
                f"({time.perf_counter() - t0:.1f}s){proc.stderr[-2000:]}")


def phase_gnn(smoke, card):
    """The GNN family on the card: full-config train cells at
    full_graph_sm, molecule and minibatch_lg, NequIP at ogb_products, the
    chunked aggregation against the plain one, the card against the CPU at
    the smoke size, and the smoke CLI's --all."""
    torch = smoke.torch

    from repro_torch.configs import registry

    t_phase = time.perf_counter()
    # the 12-layer EquiformerV2 at minibatch_lg peaks near 75 GiB, and its
    # second step failed on the default fixed-segment pool, whose free
    # memory lay in pieces smaller than one (N, 49, 128) f32 layer tensor:
    # the phase grows its segments instead (the allocator's
    # expandable_segments), from an empty cache, and restores the default
    # after
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        rows = []
        for shape_name in GNN_SHAPE_NAMES:
            for arch in GNN_ARCHS:
                steps = (GNN_LONG_STEPS
                         if (arch, shape_name) in GNN_LONG_CELLS else GNN_STEPS)
                rows.append(_gnn_cell(smoke, arch, shape_name,
                                      registry.archs()[arch].config, steps,
                                      card))
        for arch, why in GNN_OGB_CUTS.items():
            print(f"  {arch} ogb_products: not run (cut: {why})")
        rows.append(_gnn_cell(smoke, "nequip", "ogb_products",
                              registry.archs()["nequip"].config,
                              GNN_LONG_STEPS, card))
        chunked = _chunked_vs_plain(smoke, card)
        for arch in GNN_ARCHS:
            _gnn_card_vs_cpu(smoke, arch)
        _smoke_all_on_card(smoke)
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    print(f"  {card}; phase M {time.perf_counter() - t_phase:.1f}s")
    return {"cells": rows, "chunked": chunked}


def _bench_ingest(smoke, pool, hi, hj, wt, label):
    torch = smoke.torch
    from repro_torch.kernels import matrix_ingest, matrix_ingest_plain

    d, p, w, _ = pool.shape
    out_k = matrix_ingest(pool.clone(), hi, hj, wt)
    out_p = matrix_ingest_plain(pool.clone(), hi, hj, wt)
    torch.cuda.synchronize()
    err = int((out_k.long() - out_p.long()).abs().max())
    smoke.check(torch.equal(out_k, out_p), f"matrix_ingest {label} bit-equal")
    rows = torch.arange(d, device="cuda").view(d, 1, 1).expand_as(hi)
    parts = torch.arange(p, device="cuda").view(1, p, 1).expand_as(hi)
    hil, hjl = hi.long(), hj.long()
    vals = wt[None].expand_as(hi)
    acc_k, acc_p, acc_l = pool.clone(), pool.clone(), pool.clone()
    ms = time_ms(torch, lambda: matrix_ingest(acc_k, hi, hj, wt))
    plain_ms = time_ms(torch, lambda: matrix_ingest_plain(acc_p, hi, hj, wt))
    library_ms = time_ms(torch, lambda: acc_l.index_put_(
        (rows, parts, hil, hjl), vals, accumulate=True))
    dev = {"device_ms": device_ms(torch, lambda: matrix_ingest(acc_k, hi, hj, wt)),
           "plain_device_ms": device_ms(
               torch, lambda: matrix_ingest_plain(acc_p, hi, hj, wt)),
           "library_device_ms": device_ms(torch, lambda: acc_l.index_put_(
               (rows, parts, hil, hjl), vals, accumulate=True))}
    live = int((wt != 0).sum())
    # bytes this call's data needs: wt once, hi/hj of the live slots, and a
    # read and a write of each pool cell they add to (the pool is updated
    # in place, so untouched cells need not move)
    ok = (wt != 0)[None] & (hi >= 0) & (hi < w) & (hj >= 0) & (hj < w)
    cells = ((rows * p + parts) * w + hil) * w + hjl
    touched = int(torch.unique(cells[ok]).numel())
    nbytes = wt.numel() * 4 + 2 * d * live * 4 + 2 * touched * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"shape": f"pool{list(pool.shape)} hi{list(hi.shape)}",
           "live_slots": live, "cells_touched": touched,
           "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, **dev}
    print(f"  matrix_ingest {label}: {json.dumps(row)}")
    return row


def _reach_bound(nbytes: float, flops: float) -> dict:
    """B2's bound: bytes over the memory rate against operations over the
    rate of the arithmetic it runs (bf16 on the tensor cores), with the
    float32 figure beside it."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_fp32_ms": max(bytes_ms, flops / FP32_FLOPS * 1e3)}


def _bench_reach(smoke, reach, label):
    torch = smoke.torch
    from repro_torch.kernels import reach_step, reach_step_plain

    d, w, _ = reach.shape
    out_k, out_p = reach_step(reach), reach_step_plain(reach)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    smoke.check(torch.equal(out_k, out_p), f"reach_step {label} bit-equal")
    # bf16 holds 0/1 exactly and the clamp makes any rounding of the sum
    # irrelevant: the honest yardstick for a tensor-core kernel
    half = reach.bfloat16()
    smoke.check(torch.equal(torch.clamp(torch.bmm(half, half), max=1).float(),
                            out_p), f"reach_step {label}: bf16 bmm exact too")
    ms = time_ms(torch, lambda: reach_step(reach))
    plain_ms = time_ms(torch, lambda: reach_step_plain(reach))
    library_ms = time_ms(torch, lambda: torch.bmm(reach, reach))
    dev = {"device_ms": device_ms(torch, lambda: reach_step(reach)),
           "plain_device_ms": device_ms(torch, lambda: reach_step_plain(reach)),
           "library_device_ms": device_ms(torch, lambda: torch.bmm(reach, reach)),
           "library_bf16_ms": time_ms(torch, lambda: torch.bmm(half, half)),
           "library_bf16_device_ms": device_ms(
               torch, lambda: torch.bmm(half, half))}
    row = {"shape": f"reach{list(reach.shape)}", "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           **_reach_bound(2 * reach.numel() * 4, 2 * d * w ** 3), **dev}
    print(f"  reach_step {label}: {json.dumps(row)}")
    return row


def _squarings_taken(torch, table, n_steps: int) -> list:
    """Per layer, the squarings the early-stopping closure runs: up to and
    including the first that leaves the layer unchanged, at most n_steps."""
    from repro_torch.kernels.reach_closure import closure_start, reach_step_plain

    reach = closure_start(table)
    taken = torch.zeros(table.shape[0], dtype=torch.int64, device=table.device)
    active = torch.ones_like(taken, dtype=torch.bool)
    for _ in range(n_steps):
        nxt = reach_step_plain(reach)
        taken += active
        active &= (nxt != reach).flatten(1).any(1)
        reach = nxt
    return taken.tolist()


def _bench_closure(smoke, table, n_steps, label):
    torch = smoke.torch
    from repro_torch.kernels import reach_closure, reach_closure_plain
    from repro_torch.kernels.reach_closure import closure_start

    d, w, _ = table.shape
    out_k = reach_closure(table, n_steps)
    out_p = reach_closure_plain(table, n_steps)
    torch.cuda.synchronize()
    err = int((out_k.int() - out_p.int()).abs().max())
    smoke.check(torch.equal(out_k, out_p), f"reach_closure {label} bit-equal")
    taken = _squarings_taken(torch, table, n_steps)
    start = closure_start(table)
    half = start.bfloat16()

    def cascade(x):
        """The library yardstick: n_steps torch.bmm calls (no clamp)."""
        for _ in range(n_steps):
            y = torch.bmm(x, x)
        return y

    ms = time_ms(torch, lambda: reach_closure(table, n_steps))
    plain_ms = time_ms(torch, lambda: reach_closure_plain(table, n_steps))
    library_ms = time_ms(torch, lambda: cascade(start))
    dev = {"device_ms": device_ms(torch, lambda: reach_closure(table, n_steps)),
           "plain_device_ms": device_ms(
               torch, lambda: reach_closure_plain(table, n_steps)),
           "library_device_ms": device_ms(torch, lambda: cascade(start)),
           "library_bf16_ms": time_ms(torch, lambda: cascade(half)),
           "library_bf16_device_ms": device_ms(torch, lambda: cascade(half))}
    # the counters read once and the closure written once (one byte each);
    # the squarings this data needs
    row = {"shape": f"table{list(table.shape)} n_steps={n_steps}",
           "squarings_taken": taken, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           **_reach_bound(table.numel() * 4 + out_k.numel(),
                          sum(taken) * 2 * w ** 3), **dev}
    print(f"  reach_closure {label}: {json.dumps(row)}")
    return row


def _bench_lookup(smoke, pool, hi, hj, label):
    torch = smoke.torch
    from repro_torch.kernels import matrix_lookup, matrix_lookup_plain

    d, p, w, _ = pool.shape
    c = hi.shape[2]
    out_k = matrix_lookup(pool, hi, hj)
    out_p = matrix_lookup_plain(pool, hi, hj)
    torch.cuda.synchronize()
    err = int((out_k.long() - out_p.long()).abs().max())
    smoke.check(torch.equal(out_k, out_p), f"matrix_lookup {label} bit-equal")
    ms = time_ms(torch, lambda: matrix_lookup(pool, hi, hj))
    plain_ms = time_ms(torch, lambda: matrix_lookup_plain(pool, hi, hj))
    dev = {"device_ms": device_ms(torch, lambda: matrix_lookup(pool, hi, hj)),
           "plain_device_ms": device_ms(
               torch, lambda: matrix_lookup_plain(pool, hi, hj)),
           "library_device_ms": None}
    # bytes this call's data needs: hi and hj once, out once, and each pool
    # cell the queries address once
    rows = torch.arange(d, device="cuda").view(d, 1, 1)
    parts = torch.arange(p, device="cuda").view(1, p, 1)
    cells = ((rows * p + parts) * w + hi.long()) * w + hj.long()
    gathered = int(torch.unique(cells).numel())
    nbytes = 2 * hi.numel() * 4 + p * c * 4 + gathered * 4
    row = {"shape": f"pool{list(pool.shape)} hi{list(hi.shape)}",
           "cells_gathered": gathered, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms,
           "library_ms": None, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", **dev}
    print(f"  matrix_lookup {label}: {json.dumps(row)}")
    return row


def _bench_bag(smoke, table, idx, weights, label):
    torch = smoke.torch
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag, embedding_bag_plain

    b, f = idx.shape
    d = table.shape[1]
    out_k = embedding_bag(table, idx, weights)
    out_p = embedding_bag_plain(table, idx, weights)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max()) if out_k.numel() else 0.0
    smoke.check(torch.equal(out_k, out_p), f"embedding_bag {label} bit-equal")
    ms = time_ms(torch, lambda: embedding_bag(table, idx, weights))
    plain_ms = time_ms(torch, lambda: embedding_bag_plain(table, idx, weights))

    def library():
        return F.embedding_bag(idx, table, mode="sum",
                               per_sample_weights=weights)

    library_ms = time_ms(torch, library)
    dev = {"device_ms": device_ms(torch, lambda: embedding_bag(table, idx, weights)),
           "plain_device_ms": device_ms(
               torch, lambda: embedding_bag_plain(table, idx, weights)),
           "library_device_ms": device_ms(torch, library)}
    # bytes this call's data needs: idx (and weights) once, out once, and
    # each distinct row it gathers once; beside them the 32-byte sectors
    # those rows span, which is what the card moves for them
    rows = torch.unique(idx).long()
    first = rows * d * 4 // 32
    span = (rows * d * 4 + d * 4 - 1) // 32 - first + 1
    steps = torch.arange(int(span.max()), device="cuda")
    cover = first[:, None] + steps[None, :]
    sectors = int(torch.unique(cover[steps[None, :] < span[:, None]]).numel())
    fixed = idx.numel() * 4 * (1 if weights is None else 2) + b * d * 4
    nbytes = fixed + rows.numel() * d * 4
    row = {"shape": f"table{list(table.shape)} idx{list(idx.shape)}"
                    f"{'' if weights is None else ' weighted'}",
           "rows_gathered": rows.numel(), "sectors_gathered": sectors,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "sector_bound_ms": (fixed + sectors * 32) / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", **dev}
    print(f"  embedding_bag {label}: {json.dumps(row)}")
    return row


def _same_bits(torch, a, b) -> bool:
    """Whether two float32 tensors hold the same bits (-0.0 and NaN too)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _kernels_per_call(torch, fn, iters: int = 5, attempts: int = 3) -> list:
    """(name, launches per call, device us per call) of every kernel that
    ``fn()`` launches, from ``torch.profiler``; a session that records no
    device time is run again, as in ``device_ms`` ([] when none does)."""
    for _ in range(attempts):
        rows = [(e.key, e.count / iters, _per_call_us(e, iters))
                for e in _profiled(torch, fn, iters) if _self_device_us(e) > 0]
        if rows:
            return sorted(rows, key=lambda r: -r[2])
    return []


def _no_float_atomics(smoke) -> None:
    """The built library's SASS holds no global float atomic or reduction
    (``cuobjdump`` from the toolkit, where it has one)."""
    from repro_torch.kernels import build

    tool = shutil.which("cuobjdump") or str(
        Path(build.nvcc_path()).with_name("cuobjdump"))
    if not Path(tool).exists():
        print("  float atomics in the SASS: not checked (no cuobjdump)")
        return
    proc = subprocess.run([tool, "-sass", str(build.library_path(
        "embedding_bag"))], capture_output=True, text=True, timeout=120)
    floats = [ln.strip() for ln in proc.stdout.splitlines()
              if ("RED" in ln or "ATOM" in ln) and "ATOMS" not in ln
              and "F32" in ln]
    smoke.check(proc.returncode == 0 and not floats,
                "embedding_bag's library: no global float atomic or reduction "
                f"in its SASS ({len(floats)} found)")


def _bench_bag_backward(smoke, call, label):
    """``embedding_bag_backward`` on one call of the FM train step: bit-equal
    to its plain version run on CPU copies of the inputs, and a second call
    bit-equal to the first; the kernels a call launches (no fill among
    them).  Library: ``F.embedding_bag(mode="sum")``'s autograd backward,
    which covers the Σv term only."""
    torch = smoke.torch
    import torch.nn.functional as F

    from repro_torch.kernels import (embedding_bag_backward,
                                     embedding_bag_backward_plain)

    grad_out, idx, num_rows, table, grad_sq = call
    b, f = idx.shape
    d = grad_out.shape[1]

    def kernel():
        return embedding_bag_backward(grad_out, idx, num_rows, table, grad_sq)

    def plain():
        return embedding_bag_backward_plain(grad_out, idx, num_rows, table,
                                            grad_sq)

    out_k, again = kernel(), kernel()
    torch.cuda.synchronize()
    out_k, again = out_k.cpu(), again.cpu()
    cpu = [t.detach().cpu() if isinstance(t, torch.Tensor) else t
           for t in call]
    out_p = embedding_bag_backward_plain(cpu[0], cpu[1], num_rows, cpu[3],
                                         cpu[4])
    err = float((out_k - out_p).abs().max())
    smoke.check(_same_bits(torch, out_k, out_p),
                f"embedding_bag_backward {label} bit-equal to the plain "
                f"version on the CPU (max abs diff {err!r})")
    smoke.check(_same_bits(torch, out_k, again),
                f"embedding_bag_backward {label}: two calls give the same bits")
    del out_k, again, out_p, cpu
    per_call = _kernels_per_call(torch, kernel)
    for name, n, us in per_call:
        print(f"    {label} device {us:9.2f} us/call  x{n:4.1f}  {name}")
    fills = [name for name, _, _ in per_call
             if any(w in name.lower() for w in ("fill", "memset", "zero"))]
    smoke.check(bool(per_call) and not fills
                and all("bwd_" in name for name, _, _ in per_call),
                f"embedding_bag_backward {label}: {len(per_call)} kernels a "
                f"call, every one the port's, no fill ({fills})")
    ms = time_ms(torch, kernel)
    plain_ms = time_ms(torch, plain, iters=5, warmup=1)
    weight = torch.zeros((num_rows, d), dtype=torch.float32, device="cuda",
                         requires_grad=True)
    bag = F.embedding_bag(idx, weight, mode="sum")

    def library():
        return torch.autograd.grad(bag, weight, grad_out, retain_graph=True)[0]

    library_ms = time_ms(torch, library)
    dev = {"device_ms": device_ms(torch, kernel),
           "plain_device_ms": device_ms(torch, plain, iters=5),
           "library_device_ms": device_ms(torch, library)}
    # bytes this call's data needs: idx and grad_out (and grad_sq, and each
    # distinct table row it gathers) read once, the dense gradient written
    # once
    rows = int(torch.unique(idx).numel())
    nbytes = idx.numel() * 4 + b * d * 4 + num_rows * d * 4
    if table is not None:
        nbytes += b * d * 4 + rows * d * 4
    row = {"shape": f"grad{[num_rows, d]} idx{list(idx.shape)}"
                    f"{' + squared term' if table is not None else ''}",
           "rows_hit": rows, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_covers": ("the Σv term only" if table is not None
                              else "the whole function"),
           "kernels_per_call": len(per_call),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           **dev}
    if table is not None:
        # the earlier design cleared the gradient first: a bare fill of it
        def zeros():
            return torch.zeros((num_rows, d), dtype=torch.float32,
                               device="cuda")

        row["zeros_ms"] = time_ms(torch, zeros)
        row["zeros_device_ms"] = device_ms(torch, zeros)
        print(f"  a bare torch.zeros of the [{num_rows}, {d}] gradient "
              f"({num_rows * d * 4 / 1e6:.0f} MB): {row['zeros_ms']:.4f} ms, "
              f"device {row['zeros_device_ms']} ms")
    print(f"  embedding_bag_backward {label}: {json.dumps(row)}")
    return row


def _route_reads(torch, keys, v) -> tuple[int, int]:
    """Distinct key and part entries that ``sketch::route`` reads for the
    ids ``v``: the keys its left binary searches probe (and the final
    compare), the parts of the keys found."""
    n = keys.shape[0]
    if n == 0 or v.numel() == 0:
        return 0, 0
    lo = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
    hi = torch.full_like(lo, n)
    probed = []
    while bool((lo < hi).any()):
        active = lo < hi
        mid = (lo + hi) >> 1
        probed.append(mid[active])
        less = active & (keys[mid.clamp(max=n - 1)] < v)
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    at = lo.clamp(max=n - 1)
    probed.append(at[lo < n])
    found = (lo < n) & (keys[at] == v)
    return (int(torch.unique(torch.cat(probed)).numel()),
            int(torch.unique(at[found]).numel()))


def _edge_updates(torch, sk, batch):
    """The counter updates one edge-ingest launch makes: per counter
    tensor, its flat cell indices (int64[d, n]) and the weights added
    there, as the kernel addresses them."""
    from repro_torch.common.hashing import fastrange, mix

    d = sk.depth
    layer = torch.arange(d, device=batch.src.device)[:, None]
    hs, ht = (mix(sk.hashes.a, sk.hashes.b, x) for x in (batch.src, batch.dst))
    w = batch.weight
    if not hasattr(sk, "pools"):  # P = 1: every nonzero weight
        e = (w != 0).nonzero().squeeze(1)
        cells = (layer * sk.w + fastrange(hs[:, e], sk.w)) * sk.w \
            + fastrange(ht[:, e], sk.w)
        return [(sk.table, cells, w[e].expand(d, -1))]
    p = sk.route.lookup(batch.src).long()
    cls, row = sk.part_class[p], sk.part_index[p].long()
    out = []
    for c, pool in enumerate(sk.pools):
        e = ((w > 0) & (cls == c)).nonzero().squeeze(1)
        n_c, w_c = pool.shape[1], pool.shape[-1]
        cells = ((layer * n_c + row[e]) * w_c + fastrange(hs[:, e], w_c)) \
            * w_c + fastrange(ht[:, e], w_c)
        out.append((pool, cells, w[e].expand(d, -1)))
    if sk.conn_w > 0:
        e = (w != 0).nonzero().squeeze(1)
        cw = sk.conn_w
        cells = (layer * cw + fastrange(hs[:, e], cw)) * cw \
            + fastrange(ht[:, e], cw)
        out.append((sk.conn, cells, w[e].expand(d, -1)))
    return out


def _bench_ingest_edges(smoke, sk, batch, label, capacity=None):
    """``matrix_ingest_edges`` on one batch into a fresh copy of ``sk``'s
    layout (routed for the kMatrix, P = 1 for TCM / gMatrix) against its
    plain version: every leaf (pools, conn, overflow) bit-equal."""
    torch = smoke.torch
    import importlib

    from repro_torch import interop
    from repro_torch.core import kmatrix_accel as kma
    from repro_torch.core import matrix_sketch as ms
    from repro_torch.kernels import matrix_ingest_edges, matrix_ingest_edges_plain

    routed = hasattr(sk, "pools")
    empty = kma.empty_like if routed else ms.empty_like
    if routed and capacity is None:
        capacity = kma.dispatch_capacity(sk, batch.size)

    def args(s):
        if not routed:
            return ((s.table.unsqueeze(1),), s.hashes.a, s.hashes.b, batch.src,
                    batch.dst, batch.weight), {}
        return ((s.pools, s.hashes.a, s.hashes.b, batch.src, batch.dst,
                 batch.weight),
                dict(route=s.route, part_class=s.part_class,
                     part_index=s.part_index, conn=s.conn,
                     overflow=s.overflow, capacity=capacity))

    out_k, out_p = empty(sk), empty(sk)
    a, kw = args(out_k)
    matrix_ingest_edges(*a, **kw)
    a, kw = args(out_p)
    matrix_ingest_edges_plain(*a, **kw)
    torch.cuda.synchronize()
    lk, lp = interop.export_state(out_k)[0], interop.export_state(out_p)[0]
    err = max(int(abs(lk[k].astype("int64") - lp[k].astype("int64")).max())
              if lk[k].size else 0 for k in lk)
    smoke.check(err == 0 and sorted(lk) == sorted(lp),
                f"matrix_ingest_edges {label} bit-equal (pools, conn, overflow)")
    acc_k, acc_p = empty(sk), empty(sk)
    ka, kkw = args(acc_k)
    pa, pkw = args(acc_p)
    updates = _edge_updates(torch, sk, batch)
    # the library yardstick: one accumulating index_put_ of every update
    # into one flat buffer of all the counters (the hashing, routing and
    # tally it leaves out are most of the function)
    sizes = [t.numel() for t, _, _ in updates]
    base = [sum(sizes[:i]) for i in range(len(sizes))]
    flat = torch.zeros(sum(sizes), dtype=torch.int32, device="cuda")
    idx = torch.cat([(c + o).reshape(-1) for (_, c, _), o in zip(updates, base)])
    vals = torch.cat([v.reshape(-1) for _, _, v in updates])

    def kernel():
        matrix_ingest_edges(*ka, **kkw)

    def plain():
        matrix_ingest_edges_plain(*pa, **pkw)

    def library():
        flat.index_put_((idx,), vals, accumulate=True)

    ms_, plain_ms, library_ms = (time_ms(torch, f) for f in (kernel, plain, library))
    dev = {"device_ms": device_ms(torch, kernel),
           "plain_device_ms": device_ms(torch, plain),
           "library_device_ms": device_ms(torch, library)}
    if routed and label.endswith("batch 0"):
        # the launch plan's measurement: layers a thread adds
        mod = importlib.import_module("repro_torch.kernels.matrix_ingest")
        keep = mod.LAYERS_PER_THREAD
        try:
            by_layers = {}
            for n in sorted({1, 2, sk.depth}):
                mod.LAYERS_PER_THREAD = n
                by_layers[n] = device_ms(torch, kernel)
        finally:
            mod.LAYERS_PER_THREAD = keep
        dev["device_ms_by_layers_per_thread"] = by_layers
    # bytes this call's data needs: src, dst and weight once, the hash
    # parameters, the route keys and parts the searches read, each used
    # partition's class and row, one 32-byte sector per updated counter
    # sector (a read-modify-write in L2)
    b, d = batch.size, sk.depth
    nbytes = 12 * b + 16 * d
    if routed:
        live = batch.src[batch.weight > 0]
        keys_read, parts_read = _route_reads(torch, sk.route.keys, live)
        used = int(torch.unique(sk.route.lookup(live)).numel())
        nbytes += 4 * (keys_read + parts_read) + 8 * used
    sectors = sum(int(torch.unique(c // 8).numel()) for _, c, _ in updates)
    nbytes += 32 * sectors
    row = {"shape": f"B={b} d={d} " + (
               " ".join(f"pool{list(p.shape)}" for p in sk.pools)
               + f" conn{list(sk.conn.shape)} capacity={capacity}"
               if routed else f"table{list(sk.table.shape)}"),
           "updates": int(vals.numel()), "sectors_updated": sectors,
           "overflow": int(out_k.overflow) if routed else None,
           "max_abs_err": err, "ms": ms_, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "library_call": "index_put_(accumulate=True) on precomputed flat "
                           "cells: the scatter only",
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", **dev}
    print(f"  matrix_ingest_edges {label}: {json.dumps(row)}")
    return row


def _bench_lookup_edges(smoke, table, a, b, src, dst, label):
    torch = smoke.torch
    from repro_torch.common.hashing import fastrange, mix
    from repro_torch.kernels import matrix_lookup_edges, matrix_lookup_edges_plain

    d, w, _ = table.shape
    out_k = matrix_lookup_edges(table, a, b, src, dst)
    out_p = matrix_lookup_edges_plain(table, a, b, src, dst)
    torch.cuda.synchronize()
    err = int((out_k.long() - out_p.long()).abs().max()) if out_k.numel() else 0
    smoke.check(torch.equal(out_k, out_p), f"matrix_lookup_edges {label} bit-equal")
    cells = (fastrange(mix(a, b, src), w).long() * w
             + fastrange(mix(a, b, dst), w))  # int64[d, n], within each layer
    flat = table.view(d, -1)

    def library():
        """The yardstick: gather + amin on precomputed cells (no hashing)."""
        return torch.gather(flat, 1, cells).amin(0)

    smoke.check(torch.equal(library(), out_p),
                f"matrix_lookup_edges {label}: gather + amin agrees")
    ms_ = time_ms(torch, lambda: matrix_lookup_edges(table, a, b, src, dst))
    plain_ms = time_ms(torch, lambda: matrix_lookup_edges_plain(table, a, b, src, dst))
    library_ms = time_ms(torch, library)
    dev = {"device_ms": device_ms(
               torch, lambda: matrix_lookup_edges(table, a, b, src, dst)),
           "plain_device_ms": device_ms(
               torch, lambda: matrix_lookup_edges_plain(table, a, b, src, dst)),
           "library_device_ms": device_ms(torch, library)}
    # bytes this call's data needs: src and dst once, out once, the hash
    # parameters, and each 32-byte sector of the table the queries address
    layer = torch.arange(d, device="cuda")[:, None]
    sectors = int(torch.unique((layer * w * w + cells) // 8).numel())
    nbytes = 12 * src.numel() + 16 * d + 32 * sectors
    row = {"shape": f"table{list(table.shape)} n={src.numel()}",
           "sectors_gathered": sectors, "max_abs_err": err, "ms": ms_,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_call": "torch.gather + amin on precomputed cells: the "
                           "lookup without its hashing",
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", **dev}
    print(f"  matrix_lookup_edges {label}: {json.dumps(row)}")
    return row


def _bench_kmatrix_query(smoke, sk, ids, label):
    """``kmatrix_lookup_edges`` (``ids`` a (src, dst) pair) or
    ``kmatrix_node_out`` (``ids`` one tensor) on the width-class sketch
    ``sk``: bit-equal to the plain version, then timed beside it and beside
    the nearest library calls on cells worked out in advance."""
    torch = smoke.torch
    from repro_torch.common.hashing import fastrange, mix
    from repro_torch.kernels import (
        kmatrix_lookup_edges,
        kmatrix_lookup_edges_plain,
        kmatrix_node_out,
        kmatrix_node_out_plain,
    )

    edges = len(ids) == 2
    name = "kmatrix_lookup_edges" if edges else "kmatrix_node_out"
    kernel, plain = ((kmatrix_lookup_edges, kmatrix_lookup_edges_plain) if edges
                     else (kmatrix_node_out, kmatrix_node_out_plain))
    kw = dict(route=sk.route, part_class=sk.part_class, part_index=sk.part_index)
    a, b = sk.hashes.a, sk.hashes.b
    out_k = kernel(sk.pools, a, b, *ids, **kw)
    out_p = plain(sk.pools, a, b, *ids, **kw)
    torch.cuda.synchronize()
    err = int((out_k.long() - out_p.long()).abs().max()) if out_k.numel() else 0
    smoke.check(torch.equal(out_k, out_p), f"{name} {label} bit-equal")
    # the pools side by side, [d, cells], and each query's partition start
    d = sk.depth
    flat = torch.cat([p.reshape(d, -1) for p in sk.pools], 1)
    sizes = [p[0].numel() for p in sk.pools]
    class_start = torch.as_tensor([sum(sizes[:c]) for c in range(len(sizes))],
                                  device="cuda")
    widths = torch.as_tensor(sk.class_widths, device="cuda")
    part = sk.route.lookup(ids[0])
    cls = sk.part_class[part].long()
    w = widths[cls]
    start = class_start[cls] + sk.part_index[part].long() * w * w
    hi = fastrange(mix(a, b, ids[0]), w).long()  # [d, n]
    if edges:
        cells = start + hi * w + fastrange(mix(a, b, ids[1]), w).long()

        def library():
            """The yardstick: gather + amin on cells worked out in advance
            (no routing, no hashing)."""
            return torch.gather(flat, 1, cells).amin(0)
        addressed = cells.reshape(d, -1)
        library_call = ("torch.gather + amin on cells worked out in advance: "
                        "the query without its routing and hashing")
    else:
        wmax = max(sk.class_widths)
        cols = torch.arange(wmax, device="cuda")
        row_cells = (start + hi * w)[..., None] + cols  # [d, n, wmax]
        keep = cols < w[:, None]
        row_cells = torch.where(keep, row_cells, 0).view(d, -1)

        def library():
            """The yardstick: gather, masked int32 row sum, amin on cells
            worked out in advance (no routing, no hashing)."""
            vals = torch.gather(flat, 1, row_cells).view(d, -1, wmax)
            return torch.where(keep, vals, 0).sum(-1, dtype=torch.int32).amin(0)
        addressed = torch.where(keep, (start + hi * w)[..., None] + cols,
                                -1).view(d, -1)
        library_call = ("torch.gather + masked sum + amin on row cells worked "
                        "out in advance: the query without its routing and "
                        "hashing")
    smoke.check(torch.equal(library(), out_p),
                f"{name} {label}: the library calls agree")
    call = lambda: kernel(sk.pools, a, b, *ids, **kw)  # noqa: E731
    call_plain = lambda: plain(sk.pools, a, b, *ids, **kw)  # noqa: E731
    dev = {"device_ms": device_ms(torch, call),
           "plain_device_ms": device_ms(torch, call_plain),
           "library_device_ms": device_ms(torch, library)}
    # bytes the data needs: ids and answers once, the hash parameters, and
    # each 32-byte sector of the pools the queries address (the route
    # search's keys not counted: a lower bound)
    layer = torch.arange(d, device="cuda")[:, None] * flat.shape[1]
    sectors = int(torch.unique((layer + addressed)[addressed >= 0] // 8).numel())
    n = ids[0].numel()
    nbytes = 4 * (len(ids) + 1) * n + 16 * d + 32 * sectors
    row = {"shape": f"classes {list(sk.class_widths)} x {list(sk.class_counts)}"
                    f" d={d} n={n}",
           "sectors_gathered": sectors, "max_abs_err": err,
           "ms": time_ms(torch, call), "plain_ms": time_ms(torch, call_plain),
           "library_ms": time_ms(torch, library), "library_call": library_call,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", **dev}
    print(f"  {name} {label}: {json.dumps(row)}")
    return row


def _random_ints(torch, gen, hi, shape):
    return torch.randint(0, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int32)


def _summary(name, source, replaces, launches, main, rows):
    """One kernel's entry of the kernels line: ``main``'s numbers (a row, or
    a dict summed over rows), its launches per path, and every shape.
    ``kernel_ms`` repeats ``ms`` under the name earlier lines used."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "launches_counted_in": LAUNCHES_COUNTED_IN,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "exact": all(r["max_abs_err"] == 0 for r in rows),
            **{k: main[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "device_ms", "plain_device_ms", "library_device_ms")},
            **{k: main[k] for k in ("bound_fp32_ms", "library_bf16_ms",
                                    "library_bf16_device_ms") if k in main},
            "kernel_ms": main["ms"],
            "shapes": [{k: r[k] for k in ("label", "shape", "ms", "device_ms",
                                          "plain_ms", "bound_ms")}
                       for r in rows]}


def phase_kernels(smoke, sl, cmp, reach, fm, serve, bg, net, train):
    torch = smoke.torch
    import numpy as np

    from repro_torch.core import EdgeBatch
    from repro_torch.core import kmatrix_accel as kma
    from repro_torch.core import matrix_sketch as ms
    from repro_torch.core import queries as q
    from repro_torch.kernels import ops, reach_step_plain
    from repro_torch.kernels.reach_closure import CLOSURE_MAX_W, closure_start
    from repro_torch.streams import sample_stream

    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 bmm yardstick
    gen = torch.Generator(device="cuda").manual_seed(0)
    sk, stream = sl["run"]["sketch"], sl["run"]["stream"]
    gm = cmp["runs"]["gmatrix"]["sketch"]
    batch = EdgeBatch.from_numpy(*stream.batch_numpy(0), device="cuda")

    def labelled(row, label):
        row["label"] = label
        return row

    # matrix_ingest_edges: batch 0 of the main path into the kMatrix and
    # the gMatrix, the same batch at a forced capacity (a nonzero tally),
    # and with turnstile weights, and with weights whose cells pass 2^24
    b = batch.size
    rng = np.random.default_rng(3)
    turnstile = batch.replace(weight=torch.as_tensor(
        rng.integers(-2, 4, b).astype(np.int32), device="cuda"))
    heavy = batch.replace(weight=torch.as_tensor(
        rng.integers(1, 1 << 22, b).astype(np.int32), device="cuda"))
    edge_rows = [labelled(_bench_ingest_edges(smoke, *args), args[2])
                 for args in ((sk, batch, "kmatrix batch 0"),
                              (sk, batch, "kmatrix batch 0 capacity 128", 128),
                              (sk, turnstile, "kmatrix turnstile batch"),
                              (sk, heavy, "kmatrix cells above 2^24"),
                              (gm, batch, "gmatrix P=1 batch 0"),
                              (gm, turnstile, "gmatrix P=1 turnstile batch"),
                              (gm, heavy, "gmatrix P=1 cells above 2^24"))]
    smoke.check(edge_rows[1]["overflow"] > 0 and edge_rows[0]["overflow"] == 0,
                "the forced capacity's tally is nonzero, the default's zero")

    # matrix_ingest (rectangles): those the TPU's dispatch builds from the
    # kMatrix batch 0, and the gMatrix batch's node_cells at P = 1
    rects = ops.dispatch_rectangles(sk, batch, kma.dispatch_capacity(sk, b)).rects
    smoke.check(all(r is not None for r in rects),
                "one rectangle set per class (every class holds a partition)")
    kmat = [labelled(_bench_ingest(smoke, torch.zeros_like(pool), *r,
                                   f"kmatrix class {i}"), f"kmatrix class {i}")
            for i, (pool, r) in enumerate(zip(sk.pools, rects))]
    d = gm.depth
    cells = [ms.node_cells(gm, x).view(d, 1, b) for x in (batch.src, batch.dst)]
    smoke.check(tuple(gm.table.shape) == (7, 136, 136), "gmatrix table [7, 136, 136]")
    p1 = labelled(_bench_ingest(smoke, torch.zeros_like(gm.table).unsqueeze(1),
                                *cells, batch.weight.view(1, b), "gmatrix P=1"),
                  "gmatrix P=1")
    d, p, w, c = 7, 64, 128, 8192
    wt = torch.zeros((p, c), dtype=torch.int32, device="cuda")
    wt[:, : c // p] = 1  # one batch of 8192 edges over 64 partitions
    wide = labelled(_bench_ingest(
        smoke, torch.zeros((d, p, w, w), dtype=torch.int32, device="cuda"),
        _random_ints(torch, gen, w, (d, p, c)),
        _random_ints(torch, gen, w, (d, p, c)), wt, "wide"), "wide")

    # matrix_lookup_edges: gMatrix's evaluation queries, then a wide table
    qs, qd = (torch.as_tensor(x, device="cuda")
              for x in sample_stream(stream, 10_000, seed=99)[:2])
    look_edges = [labelled(_bench_lookup_edges(
        smoke, gm.table, gm.hashes.a, gm.hashes.b, qs, qd, "gmatrix queries"),
        "gmatrix queries")]
    look_edges.append(labelled(_bench_lookup_edges(
        smoke, _random_ints(torch, gen, 1 << 20, (7, 2048, 2048)), gm.hashes.a,
        gm.hashes.b, _random_ints(torch, gen, 1 << 30, (1_000_000,)),
        _random_ints(torch, gen, 1 << 30, (1_000_000,)), "wide"), "wide"))

    # kmatrix_lookup_edges / kmatrix_node_out on the main path's sketch at
    # the serving cell's shapes (an edge group of 512, a heavy sweep's
    # chunk of 4,096 ids), then the evaluation's 10,000 queries as ids
    kq_edges = [labelled(_bench_kmatrix_query(smoke, sk, pair, label), label)
                for pair, label in (((qs[:512], qd[:512]), "512 edge queries"),
                                    ((qs, qd), "10,000 edge queries"))]
    kq_node = [labelled(_bench_kmatrix_query(smoke, sk, (ids,), label), label)
               for ids, label in (
                   (torch.arange(4096, dtype=torch.int32, device="cuda"),
                    "heavy chunk of 4,096 ids"), (qs, "10,000 ids"))]

    # matrix_lookup (given cells): the same queries' node_cells, a wide shape
    cells = [ms.node_cells(gm, x).view(gm.depth, 1, -1) for x in (qs, qd)]
    look = [labelled(_bench_lookup(smoke, gm.table.unsqueeze(1), *cells,
                                   "gmatrix queries"), "gmatrix queries")]
    pool = _random_ints(torch, gen, 1 << 20, (d, p, w, w))
    look.append(labelled(_bench_lookup(
        smoke, pool, _random_ints(torch, gen, w, (d, p, c)),
        _random_ints(torch, gen, w, (d, p, c)), "wide"), "wide"))

    # reach_closure: the kMatrix and gMatrix closures of phase D;
    # reach_step: every squaring of the kMatrix closure, the gMatrix
    # table's first, the 2 MB table's first (the path that launches it),
    # then a wide one
    close_rows, reach_rows = [], []
    for label, layers in (("kmatrix conn", q.closure_layers(sk)),
                          ("gmatrix table", q.closure_layers(gm)),
                          ("gmatrix 2MB table", q.closure_layers(reach["wide"]))):
        n = layers.shape[-1]
        if n <= CLOSURE_MAX_W:
            close_rows.append(labelled(_bench_closure(
                smoke, layers, q._closure_steps(n, None), label), label))
        r = closure_start(layers)
        steps = q._closure_steps(n, None) if label == "kmatrix conn" else 1
        for step in range(1, steps + 1):
            reach_rows.append(labelled(_bench_reach(
                smoke, r, f"{label} step {step}"), f"{label} step {step}"))
            r = reach_step_plain(r)
    wide_r = (torch.rand((7, 1024, 1024), generator=gen, device="cuda")
              < 0.002).float()
    reach_rows.append(labelled(_bench_reach(
        smoke, torch.clamp(wide_r + torch.eye(1024, device="cuda"), max=1.0),
        "wide"), "wide"))

    # embedding_bag: every bag of phase G's cells, as the FM called them
    bag_rows = {}
    for cell, calls in fm["bags"].items():
        names = ("emb", "emb_sq", "lin")
        for i, (table, idx, weights, _) in enumerate(calls):
            part = ("query " if cell == "retrieval_cand" and i < 3 else
                    "candidates " if cell == "retrieval_cand" else "")
            label = f"{cell} {part}{names[i % 3]}"
            bag_rows[label] = labelled(_bench_bag(smoke, table, idx, weights,
                                                  label), label)

    # embedding_bag_backward: both launches of a phase-L FM train step
    _no_float_atomics(smoke)
    bwd_rows = []
    for call in train["backward_calls"]:
        label = "fm train emb" if call[3] is not None else "fm train lin"
        bwd_rows.append(labelled(_bench_bag_backward(smoke, call, label), label))
    bwd_rows.sort(key=lambda r: r["label"])  # emb first: the main row

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
            "plain_device_ms", "library_device_ms")

    def summed(rows):
        """One step's numbers: its launches summed."""
        out = {k: (None if any(r[k] is None for r in rows)
                   else sum(r[k] for r in rows)) for k in keys}
        out["bound_by"] = "bytes"
        return out

    # one batch of the kMatrix path: its launches summed over the classes
    batch_sum = summed(kmat)
    # one serve_p99 forward: its three bags
    p99 = summed([r for k, r in bag_rows.items() if k.startswith("serve_p99")])
    served = {**{f"serve {k}": v["launches"] for k, v in serve.items()},
              **bg["launches"],
              **{f"network {k}": v for k, v in net["launches"].items()},
              **{f"network {k} (worker processes)": v
                 for k, v in net["children"].items()}}
    by_path = {"kmatrix": sl["launches"],
               **{k: v for k, v in cmp["launches"].items()},
               "fm": fm["launches"], **served, **train["launches"]}
    return [
        _summary("matrix_ingest", "src/repro_torch/kernels/csrc/matrix_ingest.cu",
                 "src/repro/kernels/matrix_ingest.py:56",
                 {k: v["matrix_ingest"] for k, v in by_path.items()},
                 batch_sum, kmat + [p1, wide]),
        _summary("matrix_ingest_edges",
                 "src/repro_torch/kernels/csrc/matrix_ingest.cu",
                 "src/repro/kernels/matrix_ingest.py:56",
                 {k: v["matrix_ingest_edges"] for k, v in by_path.items()},
                 edge_rows[0], edge_rows),
        _summary("matrix_lookup", "src/repro_torch/kernels/csrc/matrix_lookup.cu",
                 "src/repro/kernels/matrix_lookup.py:43",
                 {k: v["matrix_lookup"] for k, v in by_path.items()},
                 look[0], look),
        _summary("matrix_lookup_edges",
                 "src/repro_torch/kernels/csrc/matrix_lookup.cu",
                 "src/repro/kernels/matrix_lookup.py:43",
                 {k: v["matrix_lookup_edges"] for k, v in by_path.items()},
                 look_edges[0], look_edges),
        _summary("kmatrix_lookup_edges",
                 "src/repro_torch/kernels/csrc/matrix_lookup.cu",
                 "none: src/repro/core/kmatrix_accel.py edge_freq (gathers "
                 "outside any kernel)",
                 {k: v["kmatrix_lookup_edges"] for k, v in by_path.items()},
                 kq_edges[0], kq_edges),
        _summary("kmatrix_node_out",
                 "src/repro_torch/kernels/csrc/matrix_lookup.cu",
                 "none: src/repro/core/kmatrix_accel.py node_out_freq "
                 "(gathers outside any kernel)",
                 {k: v["kmatrix_node_out"] for k, v in by_path.items()},
                 kq_node[0], kq_node),
        _summary("reach_step", "src/repro_torch/kernels/csrc/reach_closure.cu",
                 "src/repro/kernels/reach_closure.py:39",
                 {**{f"{k} reachability": v["reach_step"]
                     for k, v in reach["launches"].items()},
                  "fm": fm["launches"]["reach_step"],
                  **{k: v["reach_step"] for k, v in served.items()}},
                 next(r for r in reach_rows if r["label"].startswith("gmatrix 2MB")),
                 reach_rows),
        _summary("reach_closure", "src/repro_torch/kernels/csrc/reach_closure.cu",
                 "src/repro/kernels/reach_closure.py:39",
                 {**{f"{k} reachability": v["reach_closure"]
                     for k, v in reach["launches"].items()},
                  "fm": fm["launches"]["reach_closure"],
                  **{k: v["reach_closure"] for k, v in served.items()}},
                 close_rows[0], close_rows),
        _summary("embedding_bag", "src/repro_torch/kernels/csrc/embedding_bag.cu",
                 "src/repro/kernels/embedding_bag.py:38",
                 {k: v["embedding_bag"] for k, v in by_path.items()},
                 p99, list(bag_rows.values())),
        {**_summary("embedding_bag_backward",
                    "src/repro_torch/kernels/csrc/embedding_bag.cu",
                    "src/repro/kernels/embedding_bag.py:38",
                    {k: v["embedding_bag_backward"] for k, v in by_path.items()},
                    bwd_rows[0], bwd_rows),
         "check": "bit-equal to the plain version on CPU copies of the "
                  "inputs; two calls give the same bits",
         "kernels_per_call": bwd_rows[0]["kernels_per_call"],
         "library_covers": bwd_rows[0]["library_covers"]},
    ]


# ------------------------------------------------------------ phase N --

def _n1_start(out_dir: str) -> list:
    """Start the dry-run children of N1, each writing its own records."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = [[f"{a}:{s}:{mp}", "--arch", a, "--shape", s]
            + (["--multi-pod"] if mp else [])
            for a, s in N_DRYRUN_CELLS for mp in (False, True)]
    runs.append(["sketch", "--sketch", "--both-meshes"])
    procs = []
    for i, (label, *flags) in enumerate(runs):
        out = os.path.join(out_dir, f"dryrun_{i}.jsonl")
        procs.append((label, out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *flags,
             "--out", out], cwd=out_dir, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return procs


def _n1_collect(smoke, procs, t0: float) -> list:
    torch = smoke.torch
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    records = []
    for label, out, proc in procs:
        try:
            text, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
        recs = []
        if os.path.exists(out):
            with open(out) as f:
                recs = [json.loads(line) for line in f if line.strip()]
        smoke.check(proc.returncode == 0 and recs and all(r["ok"] for r in recs),
                    f"N1 dry run {label}: exit {proc.returncode}, "
                    f"{len(recs)} records, every one ok")
        if proc.returncode != 0:
            print("\n".join("    " + ln for ln in text.splitlines()[-15:]))
        records += recs
    print(f"  N1: a plan on fake ranks (256 and 512), nothing ran on the "
          f"card; its memory {card_bytes / 2**30:.2f} GiB")
    for r in records:
        if not r["ok"]:
            continue
        m = r["memory"]
        print(f"  N1 {r['arch']} {r['shape']} on {r['mesh']}: per rank "
              f"arguments {m['argument_bytes'] / 2**30:.3f} GiB, peak "
              f"{m['peak_bytes'] / 2**30:.3f} GiB "
              f"({m['peak_bytes'] / card_bytes:.1%} of the card), "
              f"collectives {r['collectives']['total_bytes'] / 2**30:.3f} GiB "
              f"{json.dumps(r['collectives']['counts'])}, "
              f"{r['flops'] / 1e12:.2f} TFLOP traced, "
              f"model {r['model_flops'] / 1e12:.2f} TFLOP, trace {r['trace_s']}s")
    print(f"  N1 wall {time.perf_counter() - t0:.1f}s (children in parallel)")
    return records


def _n_lm_cfg(name: str, layers: int, groups: int, mesh: bool):
    from repro_torch.configs import lm

    cfg = dataclasses.replace(lm.LM_CONFIGS[name], n_layers=layers,
                              dtype="float32", moe_groups=groups)
    if mesh:
        cfg = dataclasses.replace(cfg, seq_parallel=("data",), zero3_gather=True)
    return cfg


def _n_tokens(name: str, vocab: int):
    """(tokens, labels), independent draws."""
    import numpy as np

    rng = np.random.default_rng(sum(map(ord, name)))
    return rng.integers(0, vocab, (2, N_BATCH, N_SEQ)).astype(np.int32)


def _n_reference(smoke, name, layers, groups):
    """The unsharded step's loss and gradients on the card, twice, the
    largest gap between the two runs (relative to each leaf's max |g|),
    and every rank's blocks of the parameters and the first run's
    gradients (the full tensors freed)."""
    torch = smoke.torch
    from repro_torch.launch import shardings as sh
    from repro_torch.models.transformer import model as tm
    from repro_torch.training.steps import lm_loss_fn

    cfg = _n_lm_cfg(name, layers, groups, mesh=False)
    gen = torch.Generator(device="cuda").manual_seed(23)
    params = tm.init_params(cfg, gen, "cuda")
    tok, lab = torch.as_tensor(_n_tokens(name, cfg.vocab), device="cuda")
    keys = [k for k, _ in sh.tree_items(params)]
    leaves = [v for _, v in sh.tree_items(params)]
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = lm_loss_fn(cfg)(params, {"tokens": tok, "labels": lab})
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs.append((float(loss.detach()), grads, time.perf_counter() - t0))
        del loss
    gap = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(runs[0][1], runs[1][1]))
    print(f"  N2 {name} unsharded ({sum(p.numel() for p in leaves) / 1e9:.3f} "
          f"B params, f32, {layers} layer(s)): loss {runs[0][0]:.6f} / "
          f"{runs[1][0]:.6f}, fwd+bwd {runs[0][2]:.2f}s / {runs[1][2]:.2f}s, "
          f"largest gap between the two runs {gap:.3g} of a leaf's max |g|, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    mesh = sh.MeshShape(("data", "model"), N_MESH)
    specs = sh.lm_param_specs(params, mesh)
    spec_of = dict(sh.tree_items(specs))
    grads, loss0 = dict(zip(keys, runs[0][1])), runs[0][0]
    del runs
    gmax = {k: float(g.abs().max()) for k, g in grads.items()}
    plain = sh.tree_map(lambda _k, v: v.detach(), params)
    blocks = []
    for r in range(math.prod(N_MESH)):
        coord = dict(zip(mesh.mesh_dim_names, divmod(r, N_MESH[1])))
        blocks.append((sh.shard_tree(plain, specs, mesh, coord),
                       {k: sh.local_block(g, spec_of[k], mesh, coord)
                        for k, g in grads.items()}))
    del plain
    # the unsharded AdamW step on the first run's gradients, and the second
    # step's loss, as the ranks take them
    from repro_torch.configs.registry import lm_opt_cfg
    from repro_torch.training import init_train_state
    from repro_torch.training.optimizer import adamw_update, tree_unflatten

    opt_cfg = lm_opt_cfg()
    opt_m = adamw_update(opt_cfg, tree_unflatten(
        params, [grads[k] for k in keys]), init_train_state(params, opt_cfg).opt,
        params)[2]
    del grads
    with torch.no_grad():
        loss1 = float(lm_loss_fn(cfg)(params, {"tokens": tok, "labels": lab})[0])
    print(f"  N2 {name} unsharded AdamW step: grad norm "
          f"{float(opt_m['grad_norm']):.6f}, the next step's loss {loss1:.6f}")
    del params, leaves
    torch.cuda.empty_cache()
    return {"blocks": blocks, "gmax": gmax, "loss": loss0, "gap": gap,
            "vocab": cfg.vocab, "grad_norm": float(opt_m["grad_norm"]),
            "loss1": loss1}


def _n_lm_rank(mesh, dev, coord, job):
    """One LM of N2 on this rank: N_STEPS train steps on its blocks, the
    first step's gradient blocks held against the unsharded ones."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.distributed import group, mesh_ops
    from repro_torch.launch import shardings as sh
    from repro_torch.training import init_train_state
    from repro_torch.training.steps import lm_loss_fn, mesh_grads, mesh_update

    name, layers, groups, blocks, gmax, tokens = job
    cfg = _n_lm_cfg(name, layers, groups, mesh=True)
    # this rank's blocks, cut by the parent and shared on the card: the
    # rank trains them in place
    local, grads_ref = blocks[dist.get_rank()]
    state = init_train_state(local, registry.lm_opt_cfg())
    specs = sh.lm_param_specs(local, mesh)
    for leaf in sh.tree_items(local):
        leaf[1].requires_grad_(True)
    tok, lab = (sh.local_block(torch.as_tensor(t, device=dev),
                               sh.P(("data",), None), mesh) for t in tokens)
    del local
    rec = {"steps_s": [], "gaps": {}, "on": str(tok.device), "losses": []}
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(N_STEPS):
        torch.cuda.synchronize(dev)
        dist.barrier()
        group.reset_collective_stats()
        t0 = time.perf_counter()
        with mesh_ops.use_mesh(mesh):
            loss, _, grads = mesh_grads(lm_loss_fn(cfg), state.params,
                                        {"tokens": tok, "labels": lab},
                                        specs, mesh)
            if i == 0:  # the check's time stays out of the step's
                torch.cuda.synchronize(dev)
                t_grad = time.perf_counter() - t0
                for (k, _), g in zip(sh.tree_items(specs), grads):
                    rec["gaps"][k] = float((g - grads_ref[k]).abs().max()
                                           / max(gmax[k], 1e-30))
                rec["loss"] = float(loss)
                t0 = time.perf_counter() - t_grad
            else:
                rec["losses"].append(float(loss))
            state, opt_m = mesh_update(registry.lm_opt_cfg(), state, grads,
                                       specs, mesh)
            if i == 0:
                rec["grad_norm"] = float(opt_m["grad_norm"])
        torch.cuda.synchronize(dev)
        rec["steps_s"].append(time.perf_counter() - t0)
        del grads
    del state, grads_ref
    rec["stats"] = group.collective_stats()  # the last step's
    rec["peak"] = torch.cuda.max_memory_allocated(dev)
    return rec


def _n_fm_rank(mesh, dev, coord, job):
    """The table-parallel FM ``serve_bulk`` on this rank's rows, and each of
    the run's three bags against its plain version on the same inputs."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import group, mesh_ops
    from repro_torch.kernels import embedding_bag, embedding_bag_plain
    from repro_torch.launch import shardings as sh
    from repro_torch.models.recsys import fm as fm_mod

    cfg = fm_mod.FMConfig(n_fields=39, embed_dim=10, total_vocab=10_000_000)
    full, ids, logits_ref = job
    specs = sh.fm_param_specs(full, mesh)
    local = sh.tree_map(lambda _k, t, p: sh.local_block(t, p, mesh), full, specs)
    ids_l = sh.local_block(ids, sh.P(("data",), None), mesh)
    tables = fm_mod.TableRows().of(local)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad(), mesh_ops.use_mesh(mesh):
        fm_mod.forward(cfg, tables, ids_l, mesh)  # warm; squares the rows once
        torch.cuda.synchronize(dev)
        dist.barrier()
        group.reset_collective_stats()
        embedding_bag.launches = 0
        t0 = time.perf_counter()
        logits = fm_mod.forward(cfg, tables, ids_l, mesh)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = embedding_bag.launches
        # the run's bags again, kernel against plain: these launches are
        # not the main path's and are not counted
        idx, w = fm_mod.table_parallel_rows(cfg, ids_l, tables.emb.shape[0],
                                            mesh)
        bags = []
        for name, table in (("emb", tables.emb), ("emb*emb", tables.squared_table()),
                            ("lin", tables.lin)):
            got, want = embedding_bag(table, idx, w), embedding_bag_plain(table, idx, w)
            bags.append({"table": name, "equal": bool(torch.equal(got, want)),
                         "max_abs_err": float((got - want).abs().max()),
                         "shape": f"table{list(table.shape)} idx{list(idx.shape)} "
                                  "weighted 0/1"})
        stats = group.collective_stats()
    ref = logits_ref[sh.block_slices(logits_ref.shape, sh.P(("data",)), mesh,
                                     coord)]
    out = {"launches": launches, "s": wall, "rows": int(local["emb"].shape[0]),
           "on": str(local["emb"].device), "bags": bags,
           "close": bool(torch.allclose(logits, ref, rtol=1e-5, atol=1e-6)),
           "max_abs": float((logits - ref).abs().max()), "stats": stats,
           "peak": torch.cuda.max_memory_allocated(dev)}
    return out


def _n_rank(rank, world, kind, job):
    """One rank of N2 on a (2, 2) mesh: an LM's steps or the FM."""
    from repro_torch.distributed import group
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_mesh

    dev = group.rank_device()
    if dev.type != "cuda":
        raise RuntimeError(f"rank {rank} runs on {dev}, not on the card")
    mesh = make_mesh(N_MESH, ("data", "model"))
    coord = sh.mesh_coord(mesh)
    run = _n_lm_rank if kind == "lm" else _n_fm_rank
    return {"coord": coord, **run(mesh, dev, coord, job)}


def _allocated(torch) -> int:
    """This process's allocated card memory once its garbage is collected
    (earlier phases leave cycles that hold card tensors)."""
    import gc

    gc.collect()
    return torch.cuda.memory_allocated()


def _ranks_released(smoke, label: str, before: int) -> None:
    """After a ``run_ranks`` job, once the caller has dropped the job: this
    process's allocated memory is back at ``before`` (``_allocated`` just
    before the job's blocks were built).  A block that a rank still held
    when it exited stays allocated here (and PyTorch warns at this
    process's exit that a producer ended before its shared CUDA tensors
    were released)."""
    import gc

    torch = smoke.torch
    gc.collect()  # the caller's job first, then what it still shared
    torch.cuda.ipc_collect()
    after = torch.cuda.memory_allocated()
    torch.cuda.empty_cache()  # the next ranks get what this process freed
    smoke.check(after == before,
                f"{label}: this process's allocated memory after the ranks "
                f"{after} B == {before} B before the job's blocks were built")


def _n_stats_line(stats: dict) -> str:
    return ", ".join(
        f"{k} {v['calls']} calls {v['bytes'] / 2**20:.1f} MiB "
        f"{v['seconds']:.3f}s host-carried "
        f"{v['host_bytes'] / max(v['bytes'], 1):.0%}"
        for k, v in stats.items() if v["calls"])


def _count_phase_n(kernels: list, fms: list) -> None:
    """Phase N2's ``embedding_bag`` launches in the kernels line: the four
    ranks' main-path launches, from their returns, and the bit-equality of
    their calls against the plain version."""
    row = next(k for k in kernels if k["name"] == "embedding_bag")
    n = sum(f["launches"] for f in fms)
    row["launches_by_path"]["N2 fm serve_bulk, table-parallel (4 ranks)"] = n
    row["launches"] += n
    bags = [b for f in fms for b in f["bags"]]
    row["max_abs_err"] = max(row["max_abs_err"], *(b["max_abs_err"] for b in bags))
    row["exact"] = row["exact"] and all(b["equal"] for b in bags)


def phase_mesh(smoke, card):
    """N1: the dry run's plan on fake ranks, in child processes; N2: the
    mesh-only variants at full width on 4 gloo ranks of the card."""
    torch = smoke.torch
    import numpy as np

    from repro_torch.distributed import choose_topology, run_ranks
    from repro_torch.models.recsys import fm as fm_mod

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase-n-")
    procs = _n1_start(tmp)

    n = math.prod(N_MESH)
    print(f"  N2 mesh {N_MESH}: {choose_topology(n, 'cuda').describe()}; "
          "each reference is handed to the ranks on the card")
    out = {}
    try:
        for name, layers, groups in N_LMS:
            before = _allocated(torch)
            ref = _n_reference(smoke, name, layers, groups)
            job = (name, layers, groups, ref.pop("blocks"), ref["gmax"],
                   _n_tokens(name, ref["vocab"]))
            t1 = time.perf_counter()
            print(f"  N2 {name}: this process holds "
                  f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (the ranks' "
                  "blocks and reference gradient blocks)")
            ranks = run_ranks(_n_rank, n, "lm", job, device="cuda",
                              timeout_s=900)
            print(f"  N2 {name}: ranks {time.perf_counter() - t1:.1f}s (spawn, "
                  f"{N_STEPS} steps)")
            del job
            _ranks_released(smoke, f"N2 {name}", before)
            smoke.check([tuple(r["coord"].values()) for r in ranks]
                        == [divmod(r, N_MESH[1]) for r in range(n)],
                        f"N2 {name}: rank r at row-major coordinate, the "
                        "blocks it was handed")
            tol = max(N_GRAD_REL, 3 * ref["gap"])
            worst, leaf = max((g, k) for r in ranks for k, g in r["gaps"].items())
            smoke.check(all(abs(r["loss"] - ref["loss"]) <= N_LOSS_REL
                            * abs(ref["loss"]) for r in ranks)
                        and all(r["on"].startswith("cuda") for r in ranks),
                        f"N2 {name}: every rank's loss "
                        f"{[round(r['loss'], 6) for r in ranks]} within "
                        f"{N_LOSS_REL} of the unsharded {ref['loss']:.6f}, on "
                        "the card")
            smoke.check(worst <= tol,
                        f"N2 {name}: every gradient block within {tol:.3g} of "
                        f"its leaf's max |g| (worst {worst:.3g} at {leaf}, "
                        f"{len(ranks[0]['gaps'])} leaves x {n} ranks)")
            smoke.check(all(abs(r["grad_norm"] - ref["grad_norm"])
                            <= N_LOSS_REL * ref["grad_norm"]
                            and abs(r["losses"][0] - ref["loss1"])
                            <= N_LOSS_REL * abs(ref["loss1"]) for r in ranks),
                        f"N2 {name}: every rank's global grad norm "
                        f"{[round(r['grad_norm'], 6) for r in ranks]} (from its "
                        f"blocks) and second step's loss "
                        f"{[round(r['losses'][0], 6) for r in ranks]} within "
                        f"{N_LOSS_REL} of the unsharded step's "
                        f"{ref['grad_norm']:.6f} and {ref['loss1']:.6f}")
            for i, r in enumerate(ranks):
                print(f"  N2 {name} rank {i} {r['coord']}: steps "
                      f"{', '.join(f'{t:.2f}s' for t in r['steps_s'])}, peak "
                      f"{r['peak'] / 2**30:.2f} GiB; {_n_stats_line(r['stats'])}")
            out[name] = ranks
        cfg_fm = fm_mod.FMConfig(n_fields=39, embed_dim=10,
                                 total_vocab=10_000_000)
        before = _allocated(torch)
        fm = fm_mod.init_params(cfg_fm, torch.Generator(device="cuda")
                                .manual_seed(29), "cuda")
        ids = torch.as_tensor(np.random.default_rng(31).integers(
            0, 1 << 30, (262_144, 39), dtype=np.int32), device="cuda")
        with torch.no_grad():
            logits = fm_mod.forward(cfg_fm, fm, ids)
        job = ({"bias": fm.bias.detach(), "emb": fm.emb.detach(),
                "lin": fm.lin.detach()}, ids, logits)
        fms = run_ranks(_n_rank, n, "fm", job, device="cuda", timeout_s=600)
        del job, fm, ids, logits
        _ranks_released(smoke, "N2 fm serve_bulk", before)
        smoke.check(all(f["launches"] == 3 and f["on"].startswith("cuda")
                        for f in fms),
                    f"N2 fm serve_bulk: every rank launched embedding_bag 3 "
                    f"times on its {fms[0]['rows']} rows of the card "
                    f"({[f['launches'] for f in fms]})")
        smoke.check(all(f["close"] for f in fms),
                    "N2 fm serve_bulk: table-parallel logits within rtol "
                    "1e-5, atol 1e-6 of the unsharded cell's (max |diff| "
                    f"{max(f['max_abs'] for f in fms):.3g})")
        smoke.check(all(b["equal"] for f in fms for b in f["bags"]),
                    "N2 fm serve_bulk: every rank's 3 embedding_bag calls "
                    "bit-equal to embedding_bag_plain on the same table "
                    f"block, shifted ids and 0/1 weights ({fms[0]['bags'][0]['shape']})")
        for i, f in enumerate(fms):
            print(f"  N2 fm rank {i} {f['coord']}: forward {f['s'] * 1e3:.2f} "
                  f"ms, peak {f['peak'] / 2**30:.2f} GiB; "
                  f"{_n_stats_line(f['stats'])}")
        out["fm"] = fms
        out["dryrun"] = _n1_collect(smoke, procs, t0)
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  {card}; phase N {time.perf_counter() - t0:.1f}s")
    return out


# ------------------------------------------------------------ phase O --

def _o_child(out: str, flags: list) -> int:
    """A phase O child (run under ``python -m repro_torch.analysis.witness
    chip_smoke --o-child OUT FLAGS...``): one ``query_serve`` run with
    ``FLAGS``, launch-counted; its final front (sharded: the merged one),
    launches and summary go to ``OUT``."""
    import torch

    from repro_torch import interop
    from repro_torch.launch import query_serve

    args = query_serve.parse_args(flags)
    reset_launches()
    run = query_serve._run(args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    launches = read_launches()
    tenant = run["tenant"]
    final = tenant.merged_snapshot() if args.shards > 1 else tenant.snapshot
    leaves, static = interop.export_state(final.sketch)
    torch.save({"leaves": leaves, "static": static, "launches": launches,
                "summary": run["summary"]}, out)
    return 0


def _o_start(cmd: list, log: str, env: dict):
    with open(log, "w") as f:
        return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f,
                                stderr=subprocess.STDOUT, text=True)


def _o_wait_all(procs: dict, timeout_s: float) -> dict:
    """{key: (exit code or "timeout", output, seconds from start to exit)}
    of phase O's children (``procs``: key -> (process, log, start time));
    a child still running at the deadline is killed."""
    deadline = time.monotonic() + timeout_s
    ended: dict = {}
    while len(ended) < len(procs) and time.monotonic() < deadline:
        for key, (proc, _log, started) in procs.items():
            if key not in ended and proc.poll() is not None:
                ended[key] = (proc.returncode, time.perf_counter() - started)
        time.sleep(0.1)
    out = {}
    for key, (proc, log, started) in procs.items():
        if key not in ended:
            proc.kill()
            proc.wait()
            ended[key] = ("timeout", time.perf_counter() - started)
        with open(log) as f:
            out[key] = (ended[key][0], f.read(), ended[key][1])
    return out


def _witness_line(text: str):
    lines = [ln for ln in text.splitlines() if ln.startswith("lock witness: ")]
    return json.loads(lines[-1][len("lock witness: "):]) if lines else None


def _o_run_gates(smoke, label, flags, rc, text, state_path, replays):
    """One witnessed run's gates: a clean witness, the front against phase
    H's replays, its edges and launches."""
    from repro_torch import interop

    rep = _witness_line(text)
    smoke.check(rc == 0 and rep is not None and rep["rc"] == 0,
                f"O {label}: exit {rc} under the witness")
    if rc != 0 or rep is None or not os.path.exists(state_path):
        print(text[-3000:])
        return None
    smoke.check(rep["cycles"] == rep["unlocked_publishes"]
                == rep["fronts_written"] == 0
                and rep["sites"] > 0 and rep["edges"] > 0,
                f"O {label}: witness sites {rep['sites']}, edges "
                f"{rep['edges']}, cycles {rep['cycles']}, unlocked publishes "
                f"{rep['unlocked_publishes']}, fronts written after publish "
                f"{rep['fronts_written']}")
    import torch

    state = torch.load(state_path, weights_only=False)
    summary, launches = state["summary"], state["launches"]
    kind = flags[flags.index("--sketch") + 1]
    front = interop.import_state(state["leaves"], state["static"],
                                 device="cuda")
    for where, replay in replays[kind].items():
        smoke.check(_same_counters(front, replay),
                    f"O {label}: final front == phase H's replay on the "
                    f"{where}")
    smoke.check(summary["total_edges"] == STREAM_EDGES
                and summary["dropped_edges"] == 0,
                f"O {label}: total_edges {summary['total_edges']} == "
                f"{STREAM_EDGES}, none dropped")
    misses = (summary.get("engine_sharded_closure_misses", 0)
              + summary["engine_closure_misses"])
    lookups = _query_launches(launches)
    smoke.check(launches["reach_closure"] == misses > 0
                and _query_launches_fit(kind, lookups),
                f"O {label}: reach_closure launches == closure misses "
                f"({misses}), query launches {lookups}")
    print(f"  O {label}: achieved_qps={summary['achieved_qps']} p50_ms="
          f"{summary['p50_ms']} p99_ms={summary['p99_ms']} witness "
          f"{json.dumps(rep)} launches "
          f"{json.dumps({k: launches[k] for k in O_KERNELS})}")
    return {"label": label, "witness": rep, "summary": summary,
            "launches": {k: launches[k] for k in O_KERNELS}}


def phase_analysis(smoke, card, replays):
    """O: ``python -m repro_torch.analysis --gate``, three ``query_serve``
    runs under the lock witness in child processes, and the five examples
    on the card, all started at once."""
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)])}
    tmp = tempfile.mkdtemp(prefix="phase-o-")
    py = sys.executable
    jobs = {"gate": [py, "-m", "repro_torch.analysis", "--gate", "--root",
                     str(ROOT)]}
    states = {}
    for i, (label, flags) in enumerate(O_RUNS):
        states[label] = os.path.join(tmp, f"run{i}.pt")
        jobs[label] = [py, "-m", "repro_torch.analysis.witness", "chip_smoke",
                       O_CHILD, states[label], *BG_FLAGS, *flags]
    for name, args in O_EXAMPLES:
        jobs[name] = [py, "-m", f"repro_torch.examples.{name}", *args]
    procs, out = {}, {"runs": []}
    try:
        for key, cmd in jobs.items():
            log = os.path.join(tmp, f"{len(procs)}.log")
            procs[key] = (_o_start(cmd, log, env), log, time.perf_counter())
        done = _o_wait_all(procs, O_TIMEOUT_S)
        rc, text, secs = done["gate"]
        smoke.check(rc == 0 and "analysis gate: clean" in text,
                    f"O1 python -m repro_torch.analysis --gate: exit {rc} "
                    f"({secs:.1f}s)")
        if rc != 0:
            print(text[-3000:])
        for label, flags in O_RUNS:
            rc, text, secs = done[label]
            print(f"  O {label}: {secs:.1f}s")
            run = _o_run_gates(smoke, label, flags, rc, text, states[label],
                               replays)
            if run is not None:
                out["runs"].append(run)
        for name, _args in O_EXAMPLES:
            rc, text, secs = done[name]
            lines = text.strip().splitlines()
            smoke.check(rc == 0, f"O python -m repro_torch.examples.{name}"
                        f"{' ' + ' '.join(_args) if _args else ''} on the "
                        f"card: exit {rc} ({secs:.1f}s; last line: "
                        f"{lines[-1] if lines else ''!r})")
            if rc != 0:
                print(text[-3000:])
    finally:
        for proc, _log, _t in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  {card}; phase O {time.perf_counter() - t0:.1f}s")
    return out


def _count_phase_o(kernels: list, runs: list) -> None:
    """Phase O's witnessed children's launches in the kernels line, from
    their reports (the way phase N2's ranks' are)."""
    for name in O_KERNELS:
        row = next(k for k in kernels if k["name"] == name)
        for run in runs:
            n = run["launches"][name]
            row["launches_by_path"][f"O {run['label']} (witnessed child)"] = n
            row["launches"] += n


def main() -> int:
    if sys.argv[1:2] == [O_CHILD]:
        return _o_child(sys.argv[2], sys.argv[3:])
    try:
        import torch
    except ImportError:
        print("error: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"error: the port's package is missing: {exc}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smoke = Smoke(torch)
    t0 = time.perf_counter()
    card = smoke.phase("A. build kernels", phase_build, smoke)
    fm = smoke.phase("G. recsys serving", phase_fm, smoke, card) if card else None
    sl = smoke.phase("C. slice", phase_slice, smoke) if card else None
    cmp = (smoke.phase("F. the paper's comparison", phase_compare, smoke, sl)
           if sl else None)
    reach = (smoke.phase("D. reachability", phase_reach, smoke, sl, cmp)
             if cmp else None)
    filed = (smoke.phase("P. a file-fed stream", phase_file, smoke, sl, cmp,
                         reach) if reach is not None else None)
    if reach is not None:
        smoke.phase("E. where the ingest time goes", phase_profile, smoke, sl)
    serve = (smoke.phase("H. online serving", phase_serving, smoke, card)
             if card else None)
    bg = (smoke.phase("I. background and sharded serving", phase_background,
                      smoke, card, serve) if serve else None)
    net = (smoke.phase("J. the network tier", phase_network, smoke, card,
                       serve, bg) if bg else None)
    if card:
        smoke.phase("K. distributed sketching", phase_distributed, smoke, card)
    train = (smoke.phase("L. training", phase_train, smoke, card)
             if card else None)
    kernels = (smoke.phase("B. kernels vs plain", phase_kernels, smoke, sl,
                           cmp, reach, fm, serve, bg, net, train)
               if reach is not None and fm is not None and serve is not None
               and bg is not None and net is not None and train is not None
               else None)
    if kernels and filed:
        _count_phase_p(kernels, filed["launches"])
    # phase O holds its fronts against phase H's replays (256 KB each)
    replays = {k: serve[k]["replays"] for k in SERVE_KINDS} if serve else None
    # the GNN cells want the card's memory: drop what the earlier phases
    # hold (phase B's inputs among it) first
    del sl, cmp, reach, filed, fm, serve, bg, net, train
    if card:
        smoke.phase("M. GNNs", phase_gnn, smoke, card)
        mesh = smoke.phase("N. the shardings slice", phase_mesh, smoke, card)
        if kernels and mesh:
            _count_phase_n(kernels, mesh["fm"])
    if replays:
        gate = smoke.phase("O. the analysis gate and the examples",
                           phase_analysis, smoke, card, replays)
        if kernels and gate:
            _count_phase_o(kernels, gate["runs"])
    print(f"total {time.perf_counter() - t0:.1f}s")
    if smoke.failures or not kernels:
        print("FAILED: " + "; ".join(smoke.failures or ["phase missing"]))
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
