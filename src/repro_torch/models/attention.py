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

Across ranks the serving cache is sequence-sharded over "model"
(``sharding.lm_cache_spec``): ``cached_attention_partial`` runs on the
rank's slice of positions and returns its unnormalised output with its
running max and denominator, and ``combine_over_model`` merges the slices
exactly by log-sum-exp, flash-decoding's split-K (JAX gets it implicitly
from GSPMD partitioning the masked softmax over the sharded cache). A query
row with no valid position in a slice (the slice lies wholly past it) enters
the combine with weight 0: max −inf, denominator 0, output 0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as coll

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


def _slices(B, C, H, S, cl, offset=0):
    """The [B, H, C, S] scores of a chunk at ``cl`` against a cache (slice)
    of S positions from ``offset``, in slices of at most ``SCORE_BYTES``:
    (b, bb, r, n, hi) for batch rows [b, b + bb), query rows [r, r + n),
    read up to the slice's position hi (past the slice's last query every
    position is masked for every row of it); hi ≤ 0: the slice lies wholly
    past the rows."""
    per_row = H * max(1, min(S, cl + C - offset)) * 4     # f32 score bytes of a query row
    rows = max(1, min(C, SCORE_BYTES // per_row))
    bb = max(1, min(B, SCORE_BYTES // (per_row * C))) if rows == C else 1
    for b in range(0, B, bb):
        for r in range(0, C, rows):
            n = min(rows, C - r)
            yield b, bb, r, n, min(S, cl + r + n - offset)


def _mask_(s, cl, r, n, offset, hi):
    """``NEG_INF`` on the scores s [.., n, hi] of positions past each query
    row (query r + i sits at cl + r + i; the slice's position j at offset +
    j): only the columns from the slice's first query on can hold any."""
    lo = max(0, min(hi, cl + r + 1 - offset))
    if lo < hi:
        qpos = cl + r + torch.arange(n, device=s.device)
        kpos = offset + torch.arange(lo, hi, device=s.device)
        s[..., lo:hi].masked_fill_(kpos[None, :] > qpos[:, None], NEG_INF)


def cached_attention(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """Chunk attention over a KV cache. q [B, C, H, Dh] (C = 1: decode; C =
    a chunk: chunked prefill), k_cache and v_cache [B, S, KV, Dh] with the C
    new positions already written, ``cache_len`` (an int or a 0-d tensor)
    the valid positions BEFORE this chunk: query i attends the positions
    ≤ cache_len + i. Scores and probabilities are products in the cache's
    dtype, the softmax in f32, the output in q's dtype.

    A slice of query rows reads the cache only up to its last query's
    position (``_slices``): the positions past it are masked for every row
    of the slice (JAX's ``NEG_INF``, an exact 0 after the softmax), so
    leaving them out changes no probability.
    """
    B, C, H, Dh = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    cl = int(cache_len)
    qg = (q * Dh ** -0.5).to(k_cache.dtype).reshape(B, C, KV, G, Dh)
    out = torch.empty((B, C, H, Dh), dtype=q.dtype, device=q.device)
    for b, bb, r, n, hi in _slices(B, C, H, S, cl):
        s = _scores(qg[b:b + bb, r:r + n], k_cache[b:b + bb, :hi])
        _mask_(s, cl, r, n, 0, hi)
        p = torch.softmax(s, dim=-1).to(v_cache.dtype)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache[b:b + bb, :hi])
        out[b:b + bb, r:r + n] = o.reshape(o.shape[0], n, H, Dh).to(q.dtype)
    return out


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token decode (C=1). ``cache_len`` counts positions INCLUDING the
    freshly-written token, matching the original decode contract."""
    return cached_attention(q, k_cache, v_cache, int(cache_len) - 1)


def _pv(p, vs) -> torch.Tensor:
    """p [b, KV, G, n, hi] (f32) against vs [b, hi, KV, Dh] → f32 [b, n, KV·G,
    Dh]: p rounded to the cache's dtype (as ``cached_attention`` rounds its
    probabilities), the products summed in f32."""
    b, KV, G, n, hi = p.shape
    Dh = vs.shape[-1]
    p2 = p.to(vs.dtype).reshape(b * KV, G * n, hi)
    v2 = vs.permute(0, 2, 1, 3).reshape(b * KV, hi, Dh)
    if vs.dtype == torch.float32:
        o = torch.bmm(p2, v2)
    elif vs.device.type == "cpu":
        o = torch.bmm(p2.float(), v2.float())
    else:
        o = torch.bmm(p2, v2, out_dtype=torch.float32)
    return o.reshape(b, KV, G, n, Dh).permute(0, 3, 1, 2, 4).reshape(b, n, KV * G, Dh)


def cached_attention_partial(q, k_slice, v_slice, cache_len, offset: int):
    """``cached_attention`` on one slice of the cache: k_slice and v_slice
    [B, S_loc, KV, Dh] hold the global positions [offset, offset + S_loc)
    (the chunk's own positions already written where they fall in it);
    query i attends the positions ≤ cache_len + i. Returns (o [B, C, H, Dh]
    f32, the unnormalised Σ p·v, m [B, C, H] f32, the row's max score over
    the slice, l [B, C, H] f32, Σ p) with p = exp(score − m) on the valid
    positions; a row with none in the slice gives (0, −inf, 0). The scores
    are taken in ``cached_attention``'s slices (``_slices``)."""
    B, C, H, Dh = q.shape
    _, S, KV, _ = k_slice.shape
    G = H // KV
    cl = int(cache_len)
    dev = q.device
    qg = (q * Dh ** -0.5).to(k_slice.dtype).reshape(B, C, KV, G, Dh)
    o = torch.zeros((B, C, H, Dh), dtype=torch.float32, device=dev)
    m = torch.full((B, C, H), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((B, C, H), dtype=torch.float32, device=dev)
    for b, bb, r, n, hi in _slices(B, C, H, S, cl, offset):
        if hi <= 0:                                    # the slice lies wholly past the rows
            continue
        s = _scores(qg[b:b + bb, r:r + n], k_slice[b:b + bb, :hi])
        _mask_(s, cl, r, n, offset, hi)
        mx = s.amax(dim=-1)                            # [b, KV, G, n]
        valid = mx > NEG_INF / 2
        # a row with no valid position: exp(NEG_INF − 0) = 0 on every score
        p = torch.exp(s - torch.where(valid, mx, torch.zeros_like(mx))[..., None])
        nb = s.shape[0]
        flat = lambda t: t.permute(0, 3, 1, 2).reshape(nb, n, H)
        o[b:b + bb, r:r + n] = _pv(p, v_slice[b:b + bb, :hi])
        m[b:b + bb, r:r + n] = flat(torch.where(valid, mx, torch.full_like(mx, float("-inf"))))
        l[b:b + bb, r:r + n] = flat(p.sum(dim=-1))
    return o, m, l


def combine_over_model(o, m, l, layout, dtype) -> torch.Tensor:
    """The exact attention from every "model" rank's ``cached_attention_partial``
    of its slice: M = pmax(m), then one psum of (o·e^(m−M), l·e^(m−M)) and
    their quotient, in ``dtype``. A slice with no valid position for a row
    (m = −inf) weighs 0; position 0 is valid for every row, so M is finite."""
    mx = coll.pmax(m, layout, "model")
    w = torch.exp(m - mx)
    both = coll.all_reduce_(torch.cat([o * w[..., None], (l * w)[..., None]], dim=-1),
                            layout, "model")
    return (both[..., :-1] / both[..., -1:]).to(dtype)
