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

Vocab: per-field sizes follow a Criteo-like power law (few huge id fields,
many small categoricals), hashed into a single fused table with per-field
offsets: one bag for all fields.  Serving only: training, and a backward
for the kernel, come in a later slice (ROADMAP.md, item 16).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.embedding_bag import embedding_bag
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
    The parameters do not require grad: there is no backward yet."""

    def __init__(self, cfg: FMConfig, emb: torch.Tensor, lin: torch.Tensor,
                 bias: torch.Tensor):
        super().__init__()
        rows, k = cfg.table_rows, cfg.embed_dim
        for name, t, shape in (("emb", emb, (rows, k)), ("lin", lin, (rows, 1)),
                               ("bias", bias, ())):
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {list(shape)} for {cfg}, "
                                 f"got {list(t.shape)}")
        self.cfg = cfg
        self.emb = nn.Parameter(emb, requires_grad=False)
        self.lin = nn.Parameter(lin, requires_grad=False)
        self.bias = nn.Parameter(bias, requires_grad=False)
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


def init_params(cfg: FMConfig, generator: torch.Generator,
                device="cuda") -> FM:
    """Random FM parameters on ``device`` (``generator`` lives there too)."""
    rows = cfg.table_rows
    return FM(cfg,
              normal_init(generator, (rows, cfg.embed_dim), 0.01, device=device),
              normal_init(generator, (rows, 1), 0.01, device=device),
              torch.zeros((), dtype=torch.float32, device=device))


@functools.cache
def _field_tables(cfg: FMConfig, device: torch.device):
    offs = torch.as_tensor(cfg.field_offsets(), dtype=torch.int32, device=device)
    sizes = torch.as_tensor(cfg.field_vocabs(), dtype=torch.int32, device=device)
    return offs[None, :], sizes[None, :]


def _flat_ids(cfg: FMConfig, ids: torch.Tensor) -> torch.Tensor:
    """Per-field ids -> fused table rows. ids: int32[B, F].  The floor mod
    puts every row in [0, table_rows), the bags' precondition."""
    offs, sizes = _field_tables(cfg, ids.device)
    return offs + torch.remainder(ids, sizes)


def _score(cfg: FMConfig, params: FM, ids: torch.Tensor):
    """(logits [B], Σv [B, k]) of int32[B, F] ids: three bags."""
    rows = _flat_ids(cfg, ids)
    sum_v = embedding_bag(params.emb, rows)
    sum_sq = embedding_bag(params.squared_table(), rows)
    lin = embedding_bag(params.lin, rows)[:, 0]
    pairwise = 0.5 * (sum_v * sum_v - sum_sq).sum(dim=-1)
    return params.bias + lin + pairwise, sum_v


def forward(cfg: FMConfig, params: FM, ids: torch.Tensor) -> torch.Tensor:
    """Logits [B] for a batch of multi-field categorical rows int32[B, F]."""
    return _score(cfg, params, ids)[0]


def bce_loss(cfg: FMConfig, params: FM, ids: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    logits = forward(cfg, params, ids)
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def retrieval_scores(cfg: FMConfig, params: FM, query_ids: torch.Tensor,
                     cand_ids: torch.Tensor) -> torch.Tensor:
    """Score ONE query against N candidate items without a Python loop.

    query_ids: int32[Fq] user-side fields; cand_ids: int32[N, Fc] item-side
    fields.  FM decomposes: score(u, c) = fm(u) + fm(c) + <Σv(u), Σv(c)>,
    so candidate scoring is one matrix-vector product over the candidates'
    Σv, which the bags of fm(c) already computed (the JAX package gathers
    them a second time; the numbers are the same).
    """
    q, vq = _score(cfg, params, query_ids[None, :])  # (1,), (1, k)
    c, vc = _score(cfg, params, cand_ids)  # (N,), (N, k)
    cross = torch.matmul(vc, vq[0])  # (N,)
    return q + c + cross
