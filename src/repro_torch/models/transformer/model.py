"""Transformer model: init, train forward, prefill and decode.

The port of ``repro/models/transformer/model.py``.  Parameters keep the
JAX package's tree layout, a dict of tensors, so checkpoints and
``interop`` map one to one:

  {"embed": (V, D), "layers": [per dicts of leaves stacked (n_per, ...)],
   "tail": [dicts, one per layer past the last whole pattern period],
   "ln_final": (D,), "lm_head": (D, V) unless tied}

where ``per`` is the length of the layer pattern and ``n_per`` the number
of whole periods.  Where the JAX package scans over the stacked periods,
the port runs a Python loop over the layers; each stacked leaf is
unbound once per forward, so its gradient is one stack of the layers'.
With ``cfg.remat`` each layer runs under ``torch.utils.checkpoint`` (the
JAX package's per-layer ``jax.checkpoint``).  The loss is a chunked
cross-entropy, each chunk checkpointed, so at most one chunk's
(B, chunk, V) logits are held.

On one card the port runs the plain MoE dispatch and the plain embedding;
``seq_parallel`` and ``zero3_gather`` (the JAX package's sharding
constraints, its sharded-embedding ``custom_vjp`` and its shard_map MoE)
exist for a mesh and are refused here.

Serving: ``prefill`` and ``decode_step`` run without autograd and write
the KV cache in place; ``KVCache.length`` is a Python int.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import (
    ACTIVATIONS,
    dense_init,
    normal_init,
    rms_norm,
    softcap,
)
from repro_torch.models.transformer.attention import (
    apply_rope,
    blockwise_attention,
    decode_attention,
    qk_rms_norm,
)
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.models.transformer.moe import moe_ffn_grouped
from repro_torch.training.optimizer import tree_leaves


def _period(cfg: TransformerConfig) -> int:
    return len(cfg.layer_pattern)


def _dtype(cfg: TransformerConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_single_device(cfg: TransformerConfig) -> None:
    if cfg.seq_parallel is not None or cfg.zero3_gather:
        raise NotImplementedError(
            f"{cfg.name}: seq_parallel and zero3_gather need a mesh; the "
            "shardings slice is not ported yet (ROADMAP.md, §A)")


def _mm(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with JAX's type promotion (bf16 with f32 gives f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# ---------------------------------------------------------------- params --

def init_layer(cfg: TransformerConfig, generator: torch.Generator,
               lead: tuple = (), device="cuda") -> dict:
    """One layer's parameters, each with the leading dims ``lead`` (the
    stacked periods, or none for a tail layer)."""
    d, h, kv, dh, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff
    dt = _dtype(cfg)

    def zeros(*shape):
        return torch.zeros((*lead, *shape), dtype=dt, device=device)

    def dense(d_in, d_out, *mid, dtype=dt):
        return normal_init(generator, (*lead, *mid, d_in, d_out),
                           1.0 / math.sqrt(d_in), dtype, device)

    p = {
        "ln_attn": zeros(d),
        "wq": dense(d, h * dh),
        "wk": dense(d, kv * dh),
        "wv": dense(d, kv * dh),
        "wo": dense(h * dh, d),
        "ln_mlp": zeros(d),
    }
    if cfg.qk_norm:
        p["q_norm"] = zeros(dh)
        p["k_norm"] = zeros(dh)
    if cfg.post_norms:
        p["ln_post_attn"] = zeros(d)
        p["ln_post_mlp"] = zeros(d)
    fin = 2 * f if cfg.gated_mlp else f
    if cfg.is_moe:
        p["router"] = dense(d, cfg.n_experts, dtype=torch.float32)
        p["w_in"] = dense(d, fin, cfg.n_experts)
        p["w_out"] = dense(f, d, cfg.n_experts)
    else:
        p["w_in"] = dense(d, fin)
        p["w_out"] = dense(f, d)
    return p


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device="cuda", *, requires_grad: bool = True) -> dict:
    """Random parameters in the JAX tree layout on ``device`` (the
    generator lives there too); leaves require grad unless
    ``requires_grad`` is False (serving)."""
    _check_single_device(cfg)
    per = _period(cfg)
    n_per = cfg.n_layers // per
    rem = cfg.n_layers - n_per * per
    dt = _dtype(cfg)
    params = {
        # 1/sqrt(d) keeps tied-head logits ~unit-scale at init; the Gemma
        # embed_scale (sqrt(d) on the input side) restores unit embeddings.
        "embed": normal_init(generator, (cfg.vocab, cfg.d_model),
                             cfg.d_model ** -0.5, dt, device),
        "layers": [init_layer(cfg, generator, (n_per,), device)
                   for _ in range(per)],
        "tail": [init_layer(cfg, generator, (), device) for _ in range(rem)],
        "ln_final": torch.zeros((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embed:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab, dt,
                                       device)
    if requires_grad:
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
    return params


def _layer_params(cfg: TransformerConfig, params: dict) -> list[dict]:
    """Every layer's parameter dict in order: the stacked periods unbound
    (one unbind per leaf), then the tail."""
    per = _period(cfg)
    n_per = cfg.n_layers // per
    stacked = []
    for j in range(per):
        leaf = params["layers"][j]
        cols = {k: v.unbind(0) for k, v in leaf.items()}
        stacked.append([{k: cols[k][i] for k in leaf} for i in range(n_per)])
    out = [stacked[j][i] for i in range(n_per) for j in range(per)]
    return out + list(params["tail"])


# --------------------------------------------------------------- forward --

def _attn_block(cfg: TransformerConfig, p: dict, x, positions, is_local: bool,
                cache=None, cache_len: int = 0):
    """(out, (k, v)): the layer's keys and values, or with a cache the
    cache views written in place."""
    b, s, d = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    y = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    q = _mm("bsd,dh->bsh", y, p["wq"]).reshape(b, s, h, dh)
    k = _mm("bsd,dh->bsh", y, p["wk"]).reshape(b, s, kv, dh)
    v = _mm("bsd,dh->bsh", y, p["wv"]).reshape(b, s, kv, dh)
    if cfg.qk_norm:
        q = qk_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = qk_rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.window if is_local else None

    if cache is None or s > 1:
        # training, or prefill: blockwise attention over the prompt
        out = blockwise_attention(
            q, k, v, window=window, attn_cap=cfg.attn_softcap,
            chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    if cache is not None:
        k_cache, v_cache = cache
        k_cache[:, cache_len:cache_len + s] = k.to(k_cache.dtype)
        v_cache[:, cache_len:cache_len + s] = v.to(v_cache.dtype)
        if s == 1:  # decode: one token against the whole cache
            out = decode_attention(q, k_cache, v_cache, cache_len + s,
                                   window=window, attn_cap=cfg.attn_softcap)
        k, v = k_cache, v_cache

    out = out.reshape(b, s, h * dh)
    out = _mm("bsh,hd->bsd", out, p["wo"])
    if cfg.post_norms:
        out = rms_norm(out, p["ln_post_attn"], cfg.norm_eps)
    return out, (k, v)


def _ffn_block(cfg: TransformerConfig, p: dict, x):
    """(out, aux_loss)."""
    b, s, d = x.shape
    y = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    if cfg.is_moe:
        out, aux = moe_ffn_grouped(
            y.reshape(b * s, d), p["router"], p["w_in"], p["w_out"],
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            act=cfg.act, gated=cfg.gated_mlp, groups=cfg.moe_groups)
        out = out.reshape(b, s, d)
    else:
        h = _mm("bsd,df->bsf", y, p["w_in"])
        if cfg.gated_mlp:
            g, u = torch.chunk(h, 2, dim=-1)
            h = ACTIVATIONS[cfg.act](g) * u
        else:
            h = ACTIVATIONS[cfg.act](h)
        out = _mm("bsf,fd->bsd", h, p["w_out"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.post_norms:
        out = rms_norm(out, p["ln_post_mlp"], cfg.norm_eps)
    return out, aux


def _layer(cfg, p, x, positions, is_local, cache=None, cache_len: int = 0):
    attn_out, new_cache = _attn_block(cfg, p, x, positions, is_local, cache,
                                      cache_len)
    x = x + attn_out
    ffn_out, aux = _ffn_block(cfg, p, x)
    return x + ffn_out, aux, new_cache


def embed_tokens(cfg: TransformerConfig, params, tokens):
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _train_layer(cfg, is_local, x, p, positions):
    out, aux, _ = _layer(cfg, p, x, positions, is_local)
    return out, aux


def forward_hidden(cfg: TransformerConfig, params, tokens, positions):
    """Token ids -> (final hidden states (B, S, D), summed aux loss)."""
    _check_single_device(cfg)
    x = embed_tokens(cfg, params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, is_local in zip(_layer_params(cfg, params), cfg.layer_kinds()):
        fn = functools.partial(_train_layer, cfg, is_local)
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(fn, x, p, positions, use_reentrant=False)
        else:
            x, a = fn(x, p, positions)
        aux = aux + a
    x = rms_norm(x, params["ln_final"], cfg.norm_eps)
    return x, aux


def _head(cfg: TransformerConfig, params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embed else params["lm_head"]


def logits_from_hidden(cfg: TransformerConfig, params, hidden):
    logits = _mm("bsd,dv->bsv", hidden, _head(cfg, params))
    return softcap(logits, cfg.final_softcap)


def _chunk_ce(cfg, h_c, l_c, m_c, w):
    logits = softcap(_mm("bsd,dv->bsv", h_c, w).float(), cfg.final_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1, l_c[..., None])[..., 0]
    return torch.sum((lse - true) * m_c)


def chunked_ce_loss(cfg: TransformerConfig, params, hidden, labels,
                    mask=None):
    """Mean cross entropy over the (masked) positions, one sequence chunk
    at a time; each chunk is checkpointed, so (B, S, V) logits are never
    held for more than one chunk."""
    b, s, d = hidden.shape
    chunk = min(cfg.ce_chunk, s)
    n = -(-s // chunk)
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)
    w = _head(cfg, params)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        sl = slice(i * chunk, min((i + 1) * chunk, s))
        args = (cfg, hidden[:, sl], labels[:, sl].long(), mask[:, sl], w)
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_ce, *args, use_reentrant=False)
        else:
            total = total + _chunk_ce(*args)
    return total / torch.clamp(mask.sum(), min=1.0)


def lm_loss(cfg: TransformerConfig, params, tokens, labels,
            aux_weight: float = 0.01):
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)[None, :]
    hidden, aux = forward_hidden(cfg, params, tokens, positions)
    ce = chunked_ce_loss(cfg, params, hidden, labels)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# --------------------------------------------------------------- serving --

class KVCache(NamedTuple):
    k: torch.Tensor  # (n_per, per, B, S_max, KV, Dh)
    v: torch.Tensor
    k_tail: torch.Tensor  # (rem, B, S_max, KV, Dh), possibly rem == 0
    v_tail: torch.Tensor
    length: int


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    per = _period(cfg)
    n_per = cfg.n_layers // per
    rem = cfg.n_layers - n_per * per
    shape = (n_per, per, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    tail_shape = (rem, batch, max_len, cfg.n_kv_heads, cfg.d_head)

    def zeros(s):
        return torch.zeros(s, dtype=dtype, device=device)

    return KVCache(zeros(shape), zeros(shape), zeros(tail_shape),
                   zeros(tail_shape), 0)


def _cache_views(cfg: TransformerConfig, cache: KVCache):
    """(k, v) views of every layer's cache, in layer order."""
    per = _period(cfg)
    n_per = cfg.n_layers // per
    views = [(cache.k[i, j], cache.v[i, j]) for i in range(n_per)
             for j in range(per)]
    return views + [(cache.k_tail[j], cache.v_tail[j])
                    for j in range(cache.k_tail.shape[0])]


def _run_cached(cfg, params, tokens, cache: KVCache, positions):
    _check_single_device(cfg)
    x = embed_tokens(cfg, params, tokens)
    for p, is_local, kv in zip(_layer_params(cfg, params), cfg.layer_kinds(),
                               _cache_views(cfg, cache)):
        x, _, _ = _layer(cfg, p, x, positions, is_local, cache=kv,
                         cache_len=cache.length)
    return rms_norm(x, params["ln_final"], cfg.norm_eps)


@torch.no_grad()
def prefill(cfg: TransformerConfig, params, tokens, cache: KVCache):
    """Run the prompt (B, s) through the model, writing the cache from
    position 0; returns (next-token logits (B, 1, V), cache)."""
    s = tokens.shape[1]
    cache = cache._replace(length=0)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None, :]
    x = _run_cached(cfg, params, tokens, cache, positions)
    logits = logits_from_hidden(cfg, params, x[:, -1:])
    return logits, cache._replace(length=s)


@torch.no_grad()
def decode_step(cfg: TransformerConfig, params, tokens, cache: KVCache):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache)."""
    positions = torch.full((tokens.shape[0], 1), cache.length,
                           dtype=torch.int32, device=tokens.device)
    x = _run_cached(cfg, params, tokens, cache, positions)
    logits = logits_from_hidden(cfg, params, x)
    return logits, cache._replace(length=cache.length + 1)
