"""Attention: chunked online softmax (flash-style, in plain torch ops) and
attention against a KV cache (port of ``repro.models.attention``).

``flash_attention`` keeps JAX's formulation: q-chunks of ``q_chunk`` rows
(an unrolled loop), each visiting the kv-chunks 0 … i of its causal prefix
with a running (max, denominator, accumulator) in f32, ``NEG_INF`` on the
masked scores, grouped-query heads contracted against the un-repeated K/V.
It is not a kernel: JAX's is plain jnp as well (a hand-written Hopper
attention kernel is later speed work, ROADMAP item 2.6).

``cached_attention`` is a masked softmax over the cache in the cache's
dtype, one chunk of queries against the cached positions. The port takes the
[B, H, C, S] scores in slices of batch rows and query rows so that no slice
holds more than ``SCORE_BYTES`` of f32 scores (each query row's softmax is
the same whatever the slicing; a 4,096-token prefill chunk against a
32,768-token cache would otherwise hold tens of GB of scores on one card),
and each slice reads the cache only up to its last query's position.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30
SCORE_BYTES = 1 << 30          # most f32 scores one slice of cached_attention holds


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embeddings. x [..., S, H, Dh], positions [..., S]."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs          # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                            # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, Dh] → [B, S, KV*n_rep, Dh] (GQA head sharing)."""
    if n_rep == 1:
        return k
    b, s, kv, dh = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, dh).reshape(b, s, kv * n_rep, dh)


def flash_attention(q, k, v, causal: bool = True, q_chunk: int = 1024,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Chunked online-softmax attention, grouped GQA. q [B, Sq, H, Dh], k and
    v [B, Sk, KV, Dh] → [B, Sq, H, Dh] in q's dtype."""
    B, Sq, H, Dh = q.shape
    _, Sk, KV, _ = k.shape
    n_rep = H // KV
    scale = Dh ** -0.5

    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    # pad to chunk multiples; the causal mask already excludes padded kv,
    # padded q rows are sliced off
    q_pad = (-Sq) % q_chunk
    kv_pad = (-Sk) % kv_chunk
    if q_pad:
        q = F.pad(q, (0, 0, 0, 0, 0, q_pad))
    if kv_pad:
        k = F.pad(k, (0, 0, 0, 0, 0, kv_pad))
        v = F.pad(v, (0, 0, 0, 0, 0, kv_pad))
    Sq_p, Sk_p = Sq + q_pad, Sk + kv_pad
    n_q = Sq_p // q_chunk
    prefix_len = Sk - Sq   # already-attended prefix (prefill continuation); 0 in training
    dev = q.device

    def q_block(i):
        qs = q[:, i * q_chunk:(i + 1) * q_chunk]
        qs = (qs.to(torch.float32) * scale).reshape(B, q_chunk, KV, n_rep, Dh)
        hi = min(prefix_len + (i + 1) * q_chunk, Sk_p) if causal else Sk_p
        n_kv = -(-hi // kv_chunk)
        m = torch.full((B, KV, n_rep, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KV, n_rep, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, n_rep, q_chunk, Dh), dtype=torch.float32, device=dev)
        qpos = prefix_len + i * q_chunk + torch.arange(q_chunk, device=dev)
        for j in range(n_kv):
            ks = k[:, j * kv_chunk:(j + 1) * kv_chunk].to(torch.float32)
            vs = v[:, j * kv_chunk:(j + 1) * kv_chunk].to(torch.float32)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qs, ks)
            kpos = j * kv_chunk + torch.arange(kv_chunk, device=dev)
            if causal:
                mask = (qpos[:, None] >= kpos[None, :]) & (kpos[None, :] < Sk)
                s = torch.where(mask, s, NEG_INF)
            elif kv_pad:
                s = torch.where(kpos < Sk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vs)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]    # [B, KV, G, qc, Dh]
        return out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, Dh)

    out = torch.cat([q_block(i) for i in range(n_q)], dim=1)
    return out[:, :Sq].to(q.dtype)


def _scores(qs, ks) -> torch.Tensor:
    """qs [b, n, KV, G, Dh] against ks [b, hi, KV, Dh] → f32 scores [b, KV,
    G, n, hi], the products of the cache's dtype summed in f32 (JAX's
    ``preferred_element_type=jnp.float32``: one bf16 × bf16 matmul with an
    f32 output, no f32 copy of the cache)."""
    b, n, KV, G, Dh = qs.shape
    hi = ks.shape[1]
    q2 = qs.permute(0, 2, 3, 1, 4).reshape(b * KV, G * n, Dh)
    k2 = ks.permute(0, 2, 3, 1).reshape(b * KV, Dh, hi)
    if qs.dtype == torch.float32:
        s = torch.bmm(q2, k2)
    elif qs.device.type == "cpu":                     # no bf16 → f32 bmm there: the
        s = torch.bmm(q2.float(), k2.float())         # same exact products, summed in f32
    else:
        s = torch.bmm(q2, k2, out_dtype=torch.float32)
    return s.reshape(b, KV, G, n, hi)


def cached_attention(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """Chunk attention over a KV cache. q [B, C, H, Dh] (C = 1: decode; C =
    a chunk: chunked prefill), k_cache and v_cache [B, S, KV, Dh] with the C
    new positions already written, ``cache_len`` (an int or a 0-d tensor)
    the valid positions BEFORE this chunk: query i attends the positions
    ≤ cache_len + i. Scores and probabilities are products in the cache's
    dtype, the softmax in f32, the output in q's dtype.

    A slice of query rows reads the cache only up to its last query's
    position: the positions past it are masked for every row of the slice
    (JAX's ``NEG_INF``, an exact 0 after the softmax), so leaving them out
    changes no probability.
    """
    B, C, H, Dh = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    cl = int(cache_len)
    qg = (q * Dh ** -0.5).to(k_cache.dtype).reshape(B, C, KV, G, Dh)
    out = torch.empty((B, C, H, Dh), dtype=q.dtype, device=q.device)
    per_row = H * min(S, cl + C) * 4                  # f32 score bytes of one query row
    rows = max(1, min(C, SCORE_BYTES // per_row))
    bb = max(1, min(B, SCORE_BYTES // (per_row * C))) if rows == C else 1
    for b in range(0, B, bb):
        for r in range(0, C, rows):
            n = min(rows, C - r)
            hi = min(S, cl + r + n)                   # past the slice's last query: masked
            qs = qg[b:b + bb, r:r + n]
            s = _scores(qs, k_cache[b:b + bb, :hi])
            lo = min(hi, cl + r + 1)                  # the first position a row masks
            if lo < hi:
                qpos = cl + r + torch.arange(n, device=q.device)
                kpos = torch.arange(lo, hi, device=q.device)
                s[..., lo:hi].masked_fill_(kpos[None, :] > qpos[:, None], NEG_INF)
            p = torch.softmax(s, dim=-1).to(v_cache.dtype)
            o = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache[b:b + bb, :hi])
            out[b:b + bb, r:r + n] = o.reshape(o.shape[0], n, H, Dh).to(q.dtype)
    return out


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token decode (C=1). ``cache_len`` counts positions INCLUDING the
    freshly-written token, matching the original decode contract."""
    return cached_attention(q, k_cache, v_cache, int(cache_len) - 1)
