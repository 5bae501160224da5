"""The five assigned LM-transformer architecture configs: the port's copy
of ``repro/configs/lm.py``, verbatim.

Every config cites its source; numbers come verbatim from the assignment
table. ``reduced()`` returns the same topology at smoke-test scale (same
layer pattern / MoE / softcap structure, tiny dims) for CPU tests.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.transformer.config import TransformerConfig

# [arXiv:2408.00118; hf] — local+global alternating, logit softcaps.
GEMMA2_2B = TransformerConfig(
    name="gemma2-2b",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=9216,
    vocab=256_000,
    layer_pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    gated_mlp=True,
    tie_embed=True,
    embed_scale=True,
    post_norms=True,
)

# [arXiv:2403.17297; hf] — GQA, pure global attention.
INTERNLM2_20B = TransformerConfig(
    name="internlm2-20b",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab=92_544,
    layer_pattern=("global",),
    act="silu",
    gated_mlp=True,
    tie_embed=False,
    rope_theta=1_000_000.0,
)

# [hf:google/gemma-3-1b-pt; unverified] — 5:1 local:global, qk-norm, 128k ctx.
GEMMA3_27B = TransformerConfig(
    name="gemma3-27b",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=21504,
    vocab=262_144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    qk_norm=True,
    act="gelu",
    gated_mlp=True,
    tie_embed=True,
    embed_scale=True,
    post_norms=True,
    rope_theta=1_000_000.0,
)

# [arXiv:2401.04088; hf] — 8 experts top-2, sliding-window attention.
MIXTRAL_8X7B = TransformerConfig(
    name="mixtral-8x7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=32_000,
    layer_pattern=("local",),
    window=4096,
    n_experts=8,
    top_k=2,
    act="silu",
    gated_mlp=True,
    tie_embed=False,
    rope_theta=1_000_000.0,
)

# [hf:xai-org/grok-1; unverified] — 8 experts top-2, attn softcap, global.
GROK1_314B = TransformerConfig(
    name="grok-1-314b",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=32768,
    vocab=131_072,
    layer_pattern=("global",),
    attn_softcap=30.0,
    final_softcap=30.0,
    n_experts=8,
    top_k=2,
    act="gelu",
    gated_mlp=True,
    tie_embed=True,
)

LM_CONFIGS = {
    c.name: c
    for c in (GEMMA2_2B, INTERNLM2_20B, GEMMA3_27B, MIXTRAL_8X7B, GROK1_314B)
}


def reduced(cfg: TransformerConfig) -> TransformerConfig:
    """Smoke-test scale: same structure (pattern/MoE/softcaps), tiny dims.

    n_layers is chosen so the scan sees >=1 full period AND, when the
    pattern doesn't divide, a remainder tail (exercising the tail path
    exactly like gemma3-27b's 62 = 10*6 + 2 does at full scale).
    """
    per = len(cfg.layer_pattern)
    n_layers = per + max(per // 2, 1) if per > 1 else 2
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab=512,
        window=32,
        n_experts=4 if cfg.is_moe else 0,
        # Dropless at smoke scale (cap >= t * top_k): capacity drops depend
        # on the co-batched token set, so train-forward (s tokens), prefill
        # (s-1) and decode (1) would disagree on which assignments drop and
        # the decode-vs-forward parity tests would compare different models.
        capacity_factor=4.0 if cfg.is_moe else cfg.capacity_factor,
        attn_chunk_q=16,
        attn_chunk_kv=32,
        ce_chunk=32,
        dtype="float32",
        remat=False,
    )
