"""Factorization Machine [Rendle, ICDM'10]: the recsys serving path.

The port of ``repro/models/recsys/fm.py``.  Config: 39 sparse fields,
embed_dim 10, 2-way FM interactions through the O(n*k) sum-square identity

    sum_{i<j} <v_i, v_j> x_i x_j = 0.5 * ( (sum_i v_i)^2 - sum_i v_i^2 )

The hot path is the embedding lookup over a table of 10,000,384 rows.
Every lookup is a bag of the ``embedding_bag`` kernel, the JAX package's
``forward_with_kernel``: Σv over ``emb``, Σv² over ``emb * emb`` and the
first-order term over ``lin``, so 3 launches per ``forward`` and 6 per
``retrieval_scores``.  Bags run at the tables' own widths (D = 10 and
D = 1); the TPU kernel's 128-lane padding, 5.1 GB per padded table at
full width, has no counterpart here.

The squared table.  ``forward_with_kernel`` squares the whole table on
every call: at full width 800 MB of traffic for a bag that itself needs
well under a megabyte.  ``FM`` derives ``emb * emb`` once, under
``torch.no_grad()``, into a non-persistent buffer (the same bits as the
JAX package's product), and derives it again whenever ``emb`` has changed
since: when its version counter (bumped by every in-place update through
``emb`` or a view of it) or its storage differs from the ones the buffer
was made from.  Writes through ``emb.data`` bypass the version counter,
as they bypass autograd, and are not seen.

Training.  The JAX package differentiates ``forward``'s plain gather; the
port's forward is the bag kernel, so its parameters (when they require
grad) train through the bags' backward, ``embedding_bag_backward``: one
launch gives ``emb``'s gradient through the Σv and Σv² bags (the squared
table's gradient, 2 v ḡ per gathered row, folded in, so ``emb * emb`` is
never formed under autograd), one more at D = 1 gives ``lin``'s, and
``bias``'s is a plain sum: 3 bag launches and 2 backward launches a step.
The optimizer updates ``emb`` in place through the parameter itself, so
the next forward derives the squared table again.

Vocab: per-field sizes follow a Criteo-like power law (few huge id fields,
many small categoricals), hashed into a single fused table with per-field
offsets: one bag for all fields.

Table-parallel.  On a mesh (``mesh=``) the tables' rows are split over
"model" (``TableRows``: this rank's rows): each model rank shifts the
fused rows into its range, weights the others 0, runs the same three
bags on its rows, and the bags are summed over "model".  The weighted
bags train through the same backward kernel.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from repro_torch.distributed import mesh_ops
from repro_torch.kernels.embedding_bag import embedding_bag, sum_and_square_bags
from repro_torch.models.common import normal_init


@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str = "fm"
    n_fields: int = 39
    embed_dim: int = 10
    total_vocab: int = 10_000_000  # fused table rows (Criteo-scale)
    interaction: str = "fm-2way"

    def field_vocabs(self) -> np.ndarray:
        """Per-field vocab sizes, power-law distributed, summing ~total."""
        ranks = np.arange(1, self.n_fields + 1, dtype=np.float64)
        w = ranks**-1.2
        sizes = np.maximum((w / w.sum() * self.total_vocab).astype(np.int64), 4)
        return sizes

    def field_offsets(self) -> np.ndarray:
        sizes = self.field_vocabs()
        return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)

    @property
    def table_rows(self) -> int:
        # padded to a multiple of 512 so the row dim shards on any mesh axis
        raw = int(self.field_vocabs().sum())
        return -(-raw // 512) * 512


class FM(nn.Module):
    """The FM's parameters: ``emb`` f32[rows, k] (2nd-order factors),
    ``lin`` f32[rows, 1] (1st-order weights) and ``bias`` f32[], the JAX
    package's params dict as a module, plus the squared-table buffer.
    The parameters require grad only when ``requires_grad`` (training);
    serving leaves them without."""

    def __init__(self, cfg: FMConfig, emb: torch.Tensor, lin: torch.Tensor,
                 bias: torch.Tensor, *, requires_grad: bool = False):
        super().__init__()
        rows, k = cfg.table_rows, cfg.embed_dim
        for name, t, shape in (("emb", emb, (rows, k)), ("lin", lin, (rows, 1)),
                               ("bias", bias, ())):
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {list(shape)} for {cfg}, "
                                 f"got {list(t.shape)}")
        self.cfg = cfg
        self.emb = nn.Parameter(emb, requires_grad=requires_grad)
        self.lin = nn.Parameter(lin, requires_grad=requires_grad)
        self.bias = nn.Parameter(bias, requires_grad=requires_grad)
        self.register_buffer("emb_sq", None, persistent=False)
        self._emb_sq_of = None

    def squared_table(self) -> torch.Tensor:
        """``emb * emb``, derived again only when ``emb`` has changed."""
        emb = self.emb
        made_of = (id(emb), emb.untyped_storage().data_ptr(), emb._version)
        if self.emb_sq is None or self._emb_sq_of != made_of:
            with torch.no_grad():
                self.emb_sq = emb * emb
            self._emb_sq_of = made_of
        return self.emb_sq

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return forward(self.cfg, self, ids)


class TableRows:
    """This model rank's rows of the FM's tables on a mesh, read by
    ``_score`` as it reads an ``FM``: ``of(params)`` takes the rank's
    ``emb`` and ``lin`` rows and ``bias`` from a params dict (the
    tensors themselves, so a gradient reaches them), and the squared
    table is derived as ``FM`` derives it, again only when ``emb`` has
    changed.  Hold one across calls to keep the squared table."""

    def __init__(self):
        self.emb = self.lin = self.bias = None
        self.emb_sq, self._emb_sq_of = None, None

    def of(self, params: dict) -> "TableRows":
        self.emb, self.lin, self.bias = (params["emb"], params["lin"],
                                         params["bias"])
        return self

    squared_table = FM.squared_table


def init_params(cfg: FMConfig, generator: torch.Generator, device="cuda",
                *, requires_grad: bool = False) -> FM:
    """Random FM parameters on ``device`` (``generator`` lives there too)."""
    rows = cfg.table_rows
    return FM(cfg,
              normal_init(generator, (rows, cfg.embed_dim), 0.01, device=device),
              normal_init(generator, (rows, 1), 0.01, device=device),
              torch.zeros((), dtype=torch.float32, device=device),
              requires_grad=requires_grad)


@functools.cache
def _field_tables(cfg: FMConfig, device: torch.device):
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():  # cached: real even inside a planning trace
        offs = torch.as_tensor(cfg.field_offsets(), dtype=torch.int32,
                               device=device)
        sizes = torch.as_tensor(cfg.field_vocabs(), dtype=torch.int32,
                                device=device)
        return offs[None, :], sizes[None, :]


def _flat_ids(cfg: FMConfig, ids: torch.Tensor) -> torch.Tensor:
    """Per-field ids -> fused table rows. ids: int32[B, F].  The floor mod
    puts every row in [0, table_rows), the bags' precondition."""
    offs, sizes = _field_tables(cfg, ids.device)
    return offs + torch.remainder(ids, sizes)


def table_parallel_rows(cfg: FMConfig, ids: torch.Tensor, n_rows: int,
                        mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows int32[B, F], weights f32[B, F]) of this model rank's bags: the
    fused rows of ``ids`` shifted into the rank's ``n_rows`` rows, weight
    1; the rows other ranks hold at row 0, weight 0."""
    rows = _flat_ids(cfg, ids) - mesh_ops.axis_index(mesh, "model") * n_rows
    mine = (rows >= 0) & (rows < n_rows)
    return (torch.where(mine, rows, 0).to(torch.int32),
            mine.to(torch.float32))


def _score(cfg: FMConfig, params, ids: torch.Tensor, mesh=None):
    """(logits [B], Σv [B, k]) of int32[B, F] ids: three bags.  With
    ``mesh``: ``params`` holds this model rank's rows (``TableRows``), the
    ids outside them weighted 0, the bags summed over "model"."""
    if mesh is None:
        rows, weights = _flat_ids(cfg, ids), None
    else:
        rows, weights = table_parallel_rows(cfg, ids, params.emb.shape[0], mesh)
    sum_v, sum_sq = sum_and_square_bags(params.emb, params.squared_table(),
                                        rows, weights)
    lin = embedding_bag(params.lin, rows, weights)
    if mesh is not None:
        k = sum_v.shape[1]
        bags = mesh_ops.psum(torch.cat([sum_v, sum_sq, lin], dim=-1), "model",
                             mesh)
        sum_v, sum_sq, lin = bags[:, :k], bags[:, k:2 * k], bags[:, 2 * k:]
    pairwise = 0.5 * (sum_v * sum_v - sum_sq).sum(dim=-1)
    return params.bias + lin[:, 0] + pairwise, sum_v


def forward(cfg: FMConfig, params, ids: torch.Tensor, mesh=None
            ) -> torch.Tensor:
    """Logits [B] for a batch of multi-field categorical rows int32[B, F]
    (``mesh``: table-parallel, ``params`` a ``TableRows``)."""
    return _score(cfg, params, ids, mesh)[0]


def forward_with_kernel(cfg: FMConfig, params, ids: torch.Tensor
                        ) -> torch.Tensor:
    """The JAX package's name for the forward through the bag kernel.  The
    port's ``forward`` is that path already (three ``embedding_bag``
    launches on a CUDA tensor), so this is ``forward`` without a mesh."""
    return forward(cfg, params, ids)


def bce_loss(cfg: FMConfig, params, ids: torch.Tensor, labels: torch.Tensor,
             mesh=None) -> torch.Tensor:
    """The batch's mean BCE; with ``mesh``, this rank's share of the whole
    batch's (the ranks' shares sum to it)."""
    logits = forward(cfg, params, ids, mesh)
    per = (torch.clamp(logits, min=0) - logits * labels
           + torch.log1p(torch.exp(-torch.abs(logits))))
    if mesh is None:
        return torch.mean(per)
    return per.sum() / (per.numel()
                        * mesh_ops.axis_size(mesh, mesh.mesh_dim_names))


def retrieval_scores(cfg: FMConfig, params, query_ids: torch.Tensor,
                     cand_ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """Score ONE query against N candidate items without a Python loop.

    query_ids: int32[Fq] user-side fields; cand_ids: int32[N, Fc] item-side
    fields.  FM decomposes: score(u, c) = fm(u) + fm(c) + <Σv(u), Σv(c)>,
    so candidate scoring is one matrix-vector product over the candidates'
    Σv, which the bags of fm(c) already computed (the JAX package gathers
    them a second time; the numbers are the same).
    """
    q, vq = _score(cfg, params, query_ids[None, :], mesh)  # (1,), (1, k)
    c, vc = _score(cfg, params, cand_ids, mesh)  # (N,), (N, k)
    cross = torch.matmul(vc, vq[0])  # (N,)
    return q + c + cross
