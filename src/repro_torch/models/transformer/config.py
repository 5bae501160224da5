"""Transformer family configuration covering all five assigned LM archs.

The port's copy of ``repro/models/transformer/config.py``.
``seq_parallel``, ``zero3_gather`` and ``moe_groups`` act on a mesh
installed with ``mesh_ops.use_mesh`` (``model.py`` says how); off a mesh
the model runs its plain path and ``moe_groups`` splits the tokens into
dispatch groups as the JAX package does."""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # Attention pattern: cycled over layers, e.g. ("local","global") for
    # Gemma-2 alternation, ("local",)*5+("global",) for Gemma-3 5:1.
    layer_pattern: tuple[str, ...] = ("global",)
    window: int = 4096
    attn_softcap: float | None = None
    final_softcap: float | None = None
    qk_norm: bool = False
    # MoE (n_experts == 0 -> dense FFN)
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    # MoE dispatch groups: set to the data-shard count so routing argsorts
    # stay shard-local (see moe.moe_ffn_grouped). 1 = single global group.
    moe_groups: int = 1
    # misc
    act: str = "gelu"
    gated_mlp: bool = True  # GeGLU/SwiGLU when True
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embed: bool = True
    embed_scale: bool = False  # Gemma multiplies embeddings by sqrt(d_model)
    post_norms: bool = False  # Gemma-2/3 post-attn/post-ffn RMSNorms
    dtype: str = "bfloat16"
    remat: bool = True
    # Megatron-style sequence parallelism: the scan carry (and thus the
    # per-layer saved residual stack) is sharded (batch over these DP axes,
    # seq over "model") instead of model-replicated — 16x less HBM for
    # saved activations at the cost of per-layer gather collectives.
    # None = off (CPU tests); e.g. ("data",) or ("pod", "data").
    seq_parallel: tuple | None = None
    # ZeRO-3 gather-at-use for FFN/expert weights (stored sharded over all
    # axes, constrained to model-only at the einsum). On for all dry-run
    # cells; off in CPU tests (no mesh context).
    zero3_gather: bool = False
    # hillclimb knobs (see EXPERIMENTS.md §Perf)
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    ce_chunk: int = 512

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def q_per_kv(self) -> int:
        assert self.n_heads % self.n_kv_heads == 0
        return self.n_heads // self.n_kv_heads

    def layer_kinds(self) -> tuple[bool, ...]:
        """is_local flag per layer."""
        p = self.layer_pattern
        return tuple(p[i % len(p)] == "local" for i in range(self.n_layers))

    @property
    def is_pure_global(self) -> bool:
        return all(not x for x in self.layer_kinds())

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head \
            + self.n_heads * self.d_head * d
        if self.is_moe:
            per_expert = (3 if self.gated_mlp else 2) * d * f
            ffn = self.n_experts * per_expert + d * self.n_experts  # + router
        else:
            ffn = (3 if self.gated_mlp else 2) * d * f
        norms = d * (4 if self.post_norms else 2)
        if self.qk_norm:
            norms += 2 * self.d_head
        layer = attn + ffn + norms
        embed = v * d * (1 if self.tie_embed else 2)
        return self.n_layers * layer + embed + d

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        per_expert = (3 if self.gated_mlp else 2) * d * f
        inactive = (self.n_experts - self.top_k) * per_expert * self.n_layers
        return self.param_count() - inactive
