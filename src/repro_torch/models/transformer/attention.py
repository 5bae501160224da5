"""GQA attention: RoPE, logit softcap, sliding-window/global, QK-norm.

The port of ``repro/models/transformer/attention.py``, plain PyTorch (the
JAX package runs no Pallas kernel here; its attention is ``jnp``, and so
is this one).  Layouts are the JAX package's: q (B, S, H, Dh), k and v
(B, S, KV, Dh).

Training and prefill attention are blockwise and never form (S, S)
scores: a loop over query chunks, and

  * global layers: an online softmax over KV chunks (the FlashAttention
    recurrence), skipping chunks that lie wholly in the causal future;
  * local (sliding-window) layers: each query chunk attends to one
    (window + chunk_q) KV slab, so compute is O(S * window).

The softcap applies before the mask, as in the JAX package;
``scaled_dot_product_attention`` has no softcap.  Decode (q_len == 1)
attends to the whole cache at once.  Scores and softmax are float32
whatever the model's dtype; the probabilities meet v in v's dtype on the
sliding-window and decode paths and in float32 on the global path, as in
the JAX package.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import rms_norm, softcap

NEG_INF = -1e30


def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, d_head, 2, dtype=torch.float32,
                            device=device) / d_head
    return 1.0 / (theta ** exponent)  # (d_head/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh), positions: broadcastable to (..., S).  Rotates
    the two halves of each head (the JAX package's split-halves RoPE)."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs  # (..., S, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _scores(q, k, scale, cap):
    """q: (B, Tq, KV, G, Dh), k: (B, Tk, KV, Dh) -> (B, KV, G, Tq, Tk),
    float32 (the JAX package's ``preferred_element_type``)."""
    s = torch.einsum("bqkgd,btkd->bkgqt", q.float(), k.float())
    return softcap(s * scale, cap)


def _mask(q_pos, k_pos, window):
    """(Tq, Tk) additive mask: causal, plus sliding window when window>0."""
    ok = k_pos[None, :] <= q_pos[:, None]
    if window is not None and window > 0:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return torch.where(ok, 0.0, NEG_INF)


def _pad_seq(x, before: int, after: int):
    """Zero-pad dim 1 of a (B, S, ...) tensor."""
    if before == 0 and after == 0:
        return x
    shape = list(x.shape)
    parts = []
    if before:
        parts.append(x.new_zeros([shape[0], before, *shape[2:]]))
    parts.append(x)
    if after:
        parts.append(x.new_zeros([shape[0], after, *shape[2:]]))
    return torch.cat(parts, dim=1)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int | None, attn_cap: float | None,
                        chunk_q: int, chunk_kv: int,
                        q_offset: int = 0) -> torch.Tensor:
    """Causal attention of q (B, Sq, H, Dh) over k, v (B, S, KV, Dh) ->
    (B, Sq, H, Dh); ``window`` None is global.  The queries sit at
    positions ``q_offset`` .. ``q_offset + Sq - 1`` of the keys' sequence
    (a rank's block of a sequence-parallel stream; 0 and Sq == S
    otherwise)."""
    b, sq, h, dh = q.shape
    s = k.shape[1]
    kv = k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(dh)
    chunk_q = min(chunk_q, sq)
    nq = -(-sq // chunk_q)
    sq_pad = nq * chunk_q
    qp = _pad_seq(q, 0, sq_pad - sq).reshape(b, nq, chunk_q, kv, g, dh)
    dev = q.device

    if window is not None and window > 0:
        # ---- sliding window: one KV slab per query chunk ------------------
        slab = window + chunk_q
        after = max(0, q_offset + sq_pad - s)
        kpad = _pad_seq(k, slab, after)
        vpad = _pad_seq(v, slab, after)
        outs = []
        for i in range(nq):
            start = q_offset + i * chunk_q
            # the slab holds positions [start - window, start + Tq - 1];
            # position x lives at index x + slab of the padded arrays
            k_i = kpad[:, start + chunk_q:start + chunk_q + slab]
            v_i = vpad[:, start + chunk_q:start + chunk_q + slab]
            s_i = _scores(qp[:, i], k_i, scale, attn_cap)
            q_pos = start + torch.arange(chunk_q, device=dev)
            k_pos = start - window + torch.arange(slab, device=dev)
            valid = (k_pos >= 0) & (k_pos < s)
            s_i = (s_i + _mask(q_pos, k_pos, window)
                   + torch.where(valid, 0.0, NEG_INF))
            p = torch.softmax(s_i, dim=-1)
            outs.append(torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype), v_i))
        out = torch.stack(outs, dim=1).reshape(b, sq_pad, h, dh)
        return out[:, :sq]

    # ---- global causal: online softmax over KV chunks --------------------
    chunk_kv = min(chunk_kv, s)
    nk = -(-s // chunk_kv)
    sk_pad = nk * chunk_kv
    kp = _pad_seq(k, 0, sk_pad - s)
    vp = _pad_seq(v, 0, sk_pad - s)
    outs = []
    for i in range(nq):
        q_i = qp[:, i]
        q0 = q_offset + i * chunk_q
        q_pos = q0 + torch.arange(chunk_q, device=dev)
        m = torch.full((b, kv, g, chunk_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kv, g, chunk_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kv, g, chunk_q, dh), dtype=torch.float32,
                          device=dev)
        for j in range(nk):
            if j * chunk_kv > q0 + chunk_q - 1:
                continue  # wholly in the causal future
            k_j = kp[:, j * chunk_kv:(j + 1) * chunk_kv]
            v_j = vp[:, j * chunk_kv:(j + 1) * chunk_kv]
            s_ij = _scores(q_i, k_j, scale, attn_cap)
            k_pos = j * chunk_kv + torch.arange(chunk_kv, device=dev)
            s_ij = (s_ij + _mask(q_pos, k_pos, None)
                    + torch.where(k_pos < s, 0.0, NEG_INF))
            m_new = torch.maximum(m, s_ij.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s_ij - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p, v_j.float())
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, Tq, KV, G, Dh)
    out = torch.stack(outs, dim=1).reshape(b, sq_pad, kv * g, dh).to(q.dtype)
    return out[:, :sq]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int, *,
                     window: int | None,
                     attn_cap: float | None) -> torch.Tensor:
    """q (B, 1, H, Dh) against the first ``cache_len`` positions of the
    cache (B, S, KV, Dh) -> (B, 1, H, Dh)."""
    b, s, kvh, dh = k_cache.shape
    h = q.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(dh)
    qr = q.reshape(b, 1, kvh, g, dh)
    scores = _scores(qr, k_cache, scale, attn_cap)[..., 0, :]  # (B, KV, G, S)
    pos = torch.arange(s, device=q.device)
    ok = pos < cache_len
    if window is not None and window > 0:
        ok &= pos > cache_len - 1 - window
    scores = torch.where(ok, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, dh)


def decode_attention_sharded(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, cache_len: int, *,
                             window: int | None, attn_cap: float | None,
                             offset: int, axes, mesh) -> torch.Tensor:
    """``decode_attention`` over a cache whose sequence is cut over the
    mesh ``axes``: this rank holds positions ``offset`` .. ``offset +
    S_local - 1``.  A distributed softmax: the ranks' maxima, sums and
    weighted values are combined over ``axes`` (float32 throughout)."""
    from repro_torch.distributed import mesh_ops

    b, s, kvh, dh = k_cache.shape
    h = q.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(dh)
    qr = q.reshape(b, 1, kvh, g, dh)
    scores = _scores(qr, k_cache, scale, attn_cap)[..., 0, :]  # (B, KV, G, S)
    pos = offset + torch.arange(s, device=q.device)
    ok = pos < cache_len
    if window is not None and window > 0:
        ok &= pos > cache_len - 1 - window
    scores = torch.where(ok, scores, NEG_INF)
    m = mesh_ops.pmax(scores.amax(dim=-1), axes, mesh)
    p = torch.exp(scores - m[..., None])
    l = mesh_ops.psum(p.sum(dim=-1), axes, mesh)
    acc = mesh_ops.psum(torch.einsum("bkgt,btkd->bkgd", p, v_cache.float()),
                        axes, mesh)
    out = (acc / l[..., None]).to(v_cache.dtype)
    return out.reshape(b, 1, h, dh)


def qk_rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head RMS norm on q/k (Gemma-3 replaces softcapping with this)."""
    return rms_norm(x, gamma, eps)
