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

On a mesh.  Inside ``mesh_ops.use_mesh(mesh)``, a config with
``zero3_gather`` runs the JAX package's mesh-only variants as each rank's
own code, on the blocks that ``launch/shardings.py`` gives the rank
(``lm_param_specs``; tokens split over the data axes):

  * attention weights are gathered over "model" at use;
  * ``_gather_weight``: the FFN / expert weights, stored ZeRO-split over
    every axis, are gathered to a d_ff slice per model rank
    (``moe.local_ffn_weights``) and the partial outputs summed over
    "model"; MoE dispatch runs one group per data rank;
  * ``_ShardedEmbedLookup``: each model rank looks up its own vocab rows
    and the ranks' rows are summed; its backward scatters only those rows
    (peak (V / n_model, D));
  * ``seq_parallel``: between layers the residual stream is this rank's
    block of the sequence ("model"); attention gathers the keys and
    values, the FFN the normed tokens;
  * the chunked cross-entropy is vocab-parallel.

There the loss is this rank's SHARE: the ranks' shares sum to the loss,
and the collectives' adjoints (``mesh_ops``) give every rank the gradient
of that sum.  Off a mesh the same configs run the plain path, as the JAX
package's do without an abstract mesh.

Serving: ``prefill`` and ``decode_step`` run without autograd and write
the KV cache in place; ``KVCache.length`` is a Python int.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import mesh_ops
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
    decode_attention_sharded,
    qk_rms_norm,
)
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.models.transformer.moe import local_ffn_weights, moe_ffn_grouped
from repro_torch.training.optimizer import tree_leaves


def _period(cfg: TransformerConfig) -> int:
    return len(cfg.layer_pattern)


def _dtype(cfg: TransformerConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _mesh(cfg: TransformerConfig):
    """The installed mesh when ``cfg`` asks for the mesh variants, else
    None (off a mesh they are the plain path)."""
    if not cfg.zero3_gather and cfg.seq_parallel is None:
        return None
    mesh = mesh_ops.current_mesh()
    if mesh is None:
        return None
    if not cfg.zero3_gather:
        raise ValueError(f"{cfg.name}: on a mesh the FFN weights are stored "
                         "ZeRO-split (launch/shardings.py); set zero3_gather")
    if "model" not in mesh.mesh_dim_names:
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no 'model' axis")
    return mesh


def _batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


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
                cache=None, cache_len: int = 0, mesh=None, sp: bool = False,
                cache_axes=("model",)):
    """(out, (k, v)): the layer's keys and values, or with a cache the
    cache views written in place.  On a mesh the weights are gathered over
    "model"; ``sp``: ``x`` is this rank's block of the sequence; with a
    cache, prefill writes this rank's head_dim block of the cache and
    decode reads a cache cut over ``cache_axes`` on the sequence."""
    if mesh is not None:
        p = dict(p, **{k: mesh_ops.gather(p[k], "model", -1, mesh)
                       for k in ("wq", "wk", "wv")},
                 wo=mesh_ops.gather(p["wo"], "model", -2, mesh))
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

    out = None
    if sp:  # this rank's queries against the whole sequence's keys
        q_offset = mesh_ops.axis_index(mesh, "model") * s
        k = mesh_ops.gather(k, "model", 1, mesh)
        v = mesh_ops.gather(v, "model", 1, mesh)
        out = blockwise_attention(
            q, k, v, window=window, attn_cap=cfg.attn_softcap,
            chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
            q_offset=q_offset)
    elif cache is None or s > 1:
        # training, or prefill: blockwise attention over the prompt
        out = blockwise_attention(
            q, k, v, window=window, attn_cap=cfg.attn_softcap,
            chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    if cache is not None and mesh is not None:
        out, (k, v) = _sharded_cache(cfg, mesh, q, k, v, cache, cache_len,
                                     window, cache_axes, out)
    elif cache is not None:
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


def _sharded_cache(cfg, mesh, q, k, v, cache, cache_len, window, cache_axes,
                   out):
    """The cache writes and the decode read on a mesh: prefill writes this
    rank's head_dim block of the prompt's keys and values; decode writes
    the new position where this rank's block of the sequence holds it and
    attends with a distributed softmax."""
    k_cache, v_cache = cache
    s = k.shape[1]
    if s > 1:
        dh = k_cache.shape[-1]
        lo = mesh_ops.axis_index(mesh, "model") * dh
        k_cache[:, cache_len:cache_len + s] = k[..., lo:lo + dh].to(k_cache.dtype)
        v_cache[:, cache_len:cache_len + s] = v[..., lo:lo + dh].to(v_cache.dtype)
        return out, (k_cache, v_cache)
    s_local = k_cache.shape[1]
    offset = mesh_ops.axis_index(mesh, cache_axes) * s_local
    if offset <= cache_len < offset + s_local:
        k_cache[:, cache_len - offset] = k[:, 0].to(k_cache.dtype)
        v_cache[:, cache_len - offset] = v[:, 0].to(v_cache.dtype)
    out = decode_attention_sharded(q, k_cache, v_cache, cache_len + 1,
                                   window=window, attn_cap=cfg.attn_softcap,
                                   offset=offset, axes=cache_axes, mesh=mesh)
    return out, (k_cache, v_cache)


def _ffn_block_sharded(cfg: TransformerConfig, p: dict, y, mesh, sp: bool):
    """The FFN on a mesh: this model rank's d_ff slice of the weights over
    every token of the rank's data shard (``sp``: gathered over "model"),
    the partial outputs summed over "model" (``sp``: this rank's block of
    the sequence kept)."""
    if sp:
        y = mesh_ops.gather(y, "model", 1, mesh)
    b, s, d = y.shape
    if cfg.is_moe:
        if cfg.moe_groups not in (1, mesh_ops.axis_size(mesh, _batch_axes(mesh))):
            raise ValueError(f"{cfg.name}: on a mesh MoE dispatch runs one "
                             "group per data rank; moe_groups must be 1 or "
                             "the data ranks' count")
        out, aux = moe_ffn_grouped(
            y.reshape(b * s, d), p["router"], p["w_in"], p["w_out"],
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            act=cfg.act, gated=cfg.gated_mlp, mesh=mesh)
        out = out.reshape(b, s, d)
    else:
        w_in, w_out = local_ffn_weights(p["w_in"], p["w_out"], cfg.gated_mlp,
                                        mesh)
        h = _mm("bsd,df->bsf", y, w_in)
        if cfg.gated_mlp:
            g, u = torch.chunk(h, 2, dim=-1)
            h = ACTIVATIONS[cfg.act](g) * u
        else:
            h = ACTIVATIONS[cfg.act](h)
        out = mesh_ops.psum(_mm("bsf,fd->bsd", h, w_out), "model", mesh)
        aux = torch.zeros((), dtype=torch.float32, device=y.device)
    if sp:
        out = mesh_ops.block(out, mesh, "model", 1)
    return out, aux


def _ffn_block(cfg: TransformerConfig, p: dict, x, mesh=None, sp: bool = False):
    """(out, aux_loss)."""
    b, s, d = x.shape
    y = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    if mesh is not None:
        out, aux = _ffn_block_sharded(cfg, p, y, mesh, sp)
    elif cfg.is_moe:
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


def _layer(cfg, p, x, positions, is_local, cache=None, cache_len: int = 0,
           mesh=None, sp: bool = False, cache_axes=("model",)):
    attn_out, new_cache = _attn_block(cfg, p, x, positions, is_local, cache,
                                      cache_len, mesh, sp, cache_axes)
    x = x + attn_out
    ffn_out, aux = _ffn_block(cfg, p, x, mesh, sp)
    return x + ffn_out, aux, new_cache


class _ShardedEmbedLookup(torch.autograd.Function):
    """This model rank's vocab rows of ``embed[tokens]`` (zeros for the
    other ranks' tokens), the JAX package's ``_sharded_embed_lookup``.
    The backward scatters the gradient into this rank's rows only: its
    peak is (V / n_model, D), never the whole table's."""

    @staticmethod
    def forward(ctx, embed, tokens, offset):
        rows = embed.shape[0]
        idx = tokens.long() - offset
        valid = (idx >= 0) & (idx < rows)
        idx = torch.where(valid, idx, 0)
        ctx.save_for_backward(idx, valid)
        ctx.rows = rows
        return torch.where(valid[..., None], embed[idx], 0)

    @staticmethod
    def backward(ctx, g):
        idx, valid = ctx.saved_tensors
        d = g.shape[-1]
        g = torch.where(valid[..., None], g, 0).reshape(-1, d)
        out = torch.zeros((ctx.rows, d), dtype=g.dtype, device=g.device)
        return out.index_add_(0, idx.reshape(-1), g), None, None


def embed_tokens(cfg: TransformerConfig, params, tokens):
    mesh = _mesh(cfg)
    if mesh is not None:  # the vocab is split over "model"
        rows = params["embed"].shape[0]
        offset = mesh_ops.axis_index(mesh, "model") * rows
        x = mesh_ops.psum(_ShardedEmbedLookup.apply(params["embed"], tokens,
                                                    offset), "model", mesh)
    else:
        x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _train_layer(cfg, is_local, mesh, sp, x, p, positions):
    out, aux, _ = _layer(cfg, p, x, positions, is_local, mesh=mesh, sp=sp)
    return out, aux


def forward_hidden(cfg: TransformerConfig, params, tokens, positions):
    """Token ids -> (final hidden states (B, S, D), summed aux loss).  With
    ``seq_parallel`` on a mesh the states are this rank's block of the
    sequence (B, S / n_model, D)."""
    mesh = _mesh(cfg)
    sp = mesh is not None and cfg.seq_parallel is not None
    x = embed_tokens(cfg, params, tokens)
    if sp:  # the JAX package's _seq_shard: S over "model" between layers
        x = mesh_ops.block(x, mesh, "model", 1)
        positions = mesh_ops.block(positions, mesh, "model", 1)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, is_local in zip(_layer_params(cfg, params), cfg.layer_kinds()):
        fn = functools.partial(_train_layer, cfg, is_local, mesh, sp)
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


def _chunk_ce_vocab_parallel(cfg, mesh, h_c, l_c, m_c, w):
    """``_chunk_ce`` with the head's vocab split over "model": each rank's
    log-sum-exp over its columns, combined over the ranks, and the true
    logit from the rank that holds it."""
    logits = softcap(_mm("bsd,dv->bsv", h_c, w).float(), cfg.final_softcap)
    v_local = logits.shape[-1]
    lse = torch.logsumexp(mesh_ops.gather(
        torch.logsumexp(logits, dim=-1)[None], "model", 0, mesh), dim=0)
    idx = l_c - mesh_ops.axis_index(mesh, "model") * v_local
    valid = (idx >= 0) & (idx < v_local)
    true = torch.gather(logits, -1, torch.where(valid, idx, 0)[..., None])[..., 0]
    true = mesh_ops.psum(torch.where(valid, true, 0.0), "model", mesh)
    return torch.sum((lse - true) * m_c)


def chunked_ce_loss(cfg: TransformerConfig, params, hidden, labels,
                    mask=None):
    """Mean cross entropy over the (masked) positions, one sequence chunk
    at a time; each chunk is checkpointed, so (B, S, V) logits are never
    held for more than one chunk.  On a mesh: vocab-parallel over this
    rank's data shard (``hidden`` gathered over "model" when it is a block
    of the sequence), and the result is this rank's share."""
    mesh = _mesh(cfg)
    if mesh is not None and hidden.shape[1] != labels.shape[1]:
        hidden = mesh_ops.gather(hidden, "model", 1, mesh)
    b, s, d = hidden.shape
    chunk = min(cfg.ce_chunk, s)
    n = -(-s // chunk)
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)
    w = _head(cfg, params)
    chunk_fn = (_chunk_ce if mesh is None
                else functools.partial(_chunk_ce_vocab_parallel, cfg, mesh))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        sl = slice(i * chunk, min((i + 1) * chunk, s))
        args = (hidden[:, sl], labels[:, sl].long(), mask[:, sl], w)
        if mesh is None:
            args = (cfg, *args)
        if torch.is_grad_enabled():
            total = total + checkpoint(chunk_fn, *args, use_reentrant=False)
        else:
            total = total + chunk_fn(*args)
    if mesh is None:
        return total / torch.clamp(mask.sum(), min=1.0)
    # the model ranks of a data shard hold the same sum: each takes 1/n of it
    count = mesh_ops.psum(mask.sum().detach(), _batch_axes(mesh), mesh)
    return total / torch.clamp(count, min=1.0) / mesh_ops.axis_size(mesh, "model")


def lm_loss(cfg: TransformerConfig, params, tokens, labels,
            aux_weight: float = 0.01):
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)[None, :]
    hidden, aux = forward_hidden(cfg, params, tokens, positions)
    ce = chunked_ce_loss(cfg, params, hidden, labels)
    mesh = _mesh(cfg)
    if mesh is not None:  # every rank of the mesh holds its group's aux
        aux = aux / mesh_ops.axis_size(mesh, mesh.mesh_dim_names)
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


def _run_cached(cfg, params, tokens, cache: KVCache, positions,
                cache_axes=("model",)):
    mesh = _mesh(cfg)
    x = embed_tokens(cfg, params, tokens)
    for p, is_local, kv in zip(_layer_params(cfg, params), cfg.layer_kinds(),
                               _cache_views(cfg, cache)):
        x, _, _ = _layer(cfg, p, x, positions, is_local, cache=kv,
                         cache_len=cache.length, mesh=mesh,
                         cache_axes=cache_axes)
    return rms_norm(x, params["ln_final"], cfg.norm_eps)


def _logits(cfg, params, x):
    """``logits_from_hidden``; on a mesh the vocab blocks are gathered."""
    logits = logits_from_hidden(cfg, params, x)
    mesh = _mesh(cfg)
    if mesh is not None:
        logits = mesh_ops.gather(logits, "model", -1, mesh)
    return logits


@torch.no_grad()
def prefill(cfg: TransformerConfig, params, tokens, cache: KVCache):
    """Run the prompt (B, s) through the model, writing the cache from
    position 0; returns (next-token logits (B, 1, V), cache)."""
    s = tokens.shape[1]
    cache = cache._replace(length=0)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None, :]
    x = _run_cached(cfg, params, tokens, cache, positions)
    logits = _logits(cfg, params, x[:, -1:])
    return logits, cache._replace(length=s)


@torch.no_grad()
def decode_step(cfg: TransformerConfig, params, tokens, cache: KVCache, *,
                cache_axes=("model",)):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache).  On a
    mesh the cache's sequence is cut over ``cache_axes`` (every axis for
    the batch-1 long-context cells)."""
    positions = torch.full((tokens.shape[0], 1), cache.length,
                           dtype=torch.int32, device=tokens.device)
    x = _run_cached(cfg, params, tokens, cache, positions, cache_axes)
    logits = _logits(cfg, params, x)
    return logits, cache._replace(length=cache.length + 1)
