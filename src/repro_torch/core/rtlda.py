"""RT-LDA — real-time topic inference for unseen queries (paper §3.2; port of
``repro.core.rtlda``).

RT-LDA replaces sampling with **max** (hill climbing on the collapsed
posterior):

    z_t ← argmax_k  P̂(v|k) · (Θ_kd + α_k)                      (Eq. 2)

The prior part's per-word argmax is precomputed into the 1-nonzero-per-word
cache **R** (Eq. 3); the data part is nonzero only at the query's own topics,
giving the two-term max of Eq. 4: O(len(d)) work per token instead of O(K).
Trial r of a query restarts from a counter-based random init (seed ⊕ r·φ₃₂).

Across ranks (``layout=``, JAX's GSPMD-partitioned ``serve_rt`` cell): P̂
and the R cache are row-sharded over the pod's flattened ring and every
point read of them is the rank's masked read summed over "ring"; each
entry has one owner and the other ranks add +0.0, so the sums, and with
them z and θ, are the one-rank step's bits. A rank returns its "model"
block of pkd's columns (JAX's ``P(None, "model")``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.lda import phi_hat
from repro_torch.dist import collectives as coll, sharding as shd


@dataclasses.dataclass
class RTLDAModel:
    """Frozen serving model: normalized topics + the R cache."""

    pvk: torch.Tensor       # [V, K] f32 — P̂(v|k)
    alpha: torch.Tensor     # [K] f32
    r_topic: torch.Tensor   # [V] int32 — argmax_k P̂(v|k) α_k  (the R cache, Eq. 3)
    r_value: torch.Tensor   # [V] f32   — its value


def build_model(phi, beta, alpha, device="cuda") -> RTLDAModel:
    """The serving model of trained counts ``phi`` [V, K], on ``device``."""
    dev = resolve_device(device)
    phi, beta, alpha = (torch.as_tensor(x).to(dev) for x in (phi, beta, alpha))
    pvk = phi_hat(phi, beta)
    prior = pvk * alpha[None, :]
    # torch.argmax returns the first maximum (jnp.argmax's tie rule); the
    # indices of torch.max(dim=) carry no such promise
    return RTLDAModel(pvk=pvk, alpha=alpha,
                      r_topic=torch.argmax(prior, dim=1).to(torch.int32),
                      r_value=torch.amax(prior, dim=1))


# Serving shape buckets: one batch shape per query length, so a 3-token query
# pays 8-token padding, not 64.
DEFAULT_BUCKETS = (8, 16, 32, 64)


def select_bucket(n_tokens: int, buckets) -> Tuple[int, bool]:
    """Smallest bucket ≥ ``n_tokens``, else the largest (with truncation flag).

    Returns ``(bucket_len, truncated)``; ``truncated`` is True only when the
    query exceeds the largest bucket, in which case the caller must drop the
    tail and say so on the response.
    """
    for b in buckets:
        if n_tokens <= b:
            return int(b), False
    return int(max(buckets)), True


def _topic_counts(z, weight, n_topics: int) -> torch.Tensor:
    """[B, K] f32 with weight[b, j] added at z[b, j] — sums of 1.0 and 0.0,
    exact in any order."""
    B = z.shape[0]
    out = torch.zeros((B, n_topics), dtype=torch.float32, device=z.device)
    rows = torch.arange(B, device=z.device)[:, None].expand_as(z)
    out.index_put_((rows, z.long()), weight, accumulate=True)
    return out


def _ring_read(table: torch.Tensor, rows, cols, layout) -> torch.Tensor:
    """``table[rows, cols]`` (``table[rows]`` where ``cols`` is None) of a
    table whose rows are row-sharded over the ring when ``layout`` is given:
    the rank reads the rows of its block (indices moved into it, +0 where
    another rank owns the row) and the ring sums the reads."""
    if layout is None:
        return table[rows] if cols is None else table[rows, cols]
    n = table.shape[0]
    local = rows - shd.flat_ring_index(layout) * n
    own = (local >= 0) & (local < n)
    local = torch.where(own, local, 0)
    got = table[local] if cols is None else table[local, cols]
    return coll.all_reduce_(torch.where(own, got, 0), layout, "ring")


def rtlda_infer_batch(model: RTLDAModel, word_ids, seed: int, n_iters: int = 5,
                      n_trials: int = 1, layout=None) -> torch.Tensor:
    """Infer P(k|d) for a batch of queries [B, Ld] (−1 padded). Returns [B, K] f32.

    Vectorized Eq. 4: for each token the candidate topics are the current
    assignments of the query's tokens plus the token's R entry, so the cost
    is O(B · Ld² · iters), independent of K apart from the final [B, K] rows.

    ``layout``: a ``RankLayout`` of several ranks, whose ``model.pvk``,
    ``r_topic`` and ``r_value`` are the rank's row blocks over the ring
    (V / ring rows; ``alpha``, ``word_ids`` and ``seed`` replicated). The
    three point reads (the R topic and P̂ at it once, P̂ at the candidates
    every hill step) are summed over "ring": 2 + n_trials · n_iters
    collectives. Returns the rank's [B, K / model] columns of the one-rank
    result, normalised by the whole row's sum.
    """
    if layout is not None and layout.world_size == 1:
        layout = None
    B, Ld = word_ids.shape
    K = model.alpha.shape[0]
    dev = model.pvk.device
    word_ids = torch.as_tensor(word_ids, device=dev)
    valid = word_ids >= 0
    vmask = valid.to(torch.float32)
    w = torch.where(valid, word_ids, 0).long()

    r_top = _ring_read(model.r_topic, w, None, layout).long()          # [B, Ld]
    pvk_at_r = _ring_read(model.pvk, w, r_top, layout)                 # [B, Ld]
    alpha_r = model.alpha[r_top]
    counters = torch.arange(B * Ld, dtype=torch.int64, device=dev).reshape(B, Ld)

    theta = torch.zeros((B, K), dtype=torch.float32, device=dev)
    for t in range(n_trials):
        # trial 0 starts at the R cache (Eq. 3); later trials randomize half
        # the tokens — independent hill-climb restarts, averaged (§3.2)
        if t == 0:
            z = r_top
        else:
            u = prng.uniform01((int(seed) & 0xFFFF_FFFF)
                               ^ ((t * 0x9E3779B9) & 0xFFFF_FFFF), counters, 0)
            z = torch.where(u < 0.5, r_top, ((u * (2 ** 24)).to(torch.int32) % K).long())
        z = torch.where(valid, z, 0)

        for _ in range(n_iters):
            # candidates = the query's own assignments (columns c) plus the
            # token's R entry — exactly the support of Eq. 4
            same = (z[:, None, :] == z[:, :, None]).to(torch.float32)   # [B, c, j]
            cnt = torch.einsum("bcj,bj->bc", same, vmask)               # Θ at z[b,c]
            score_tok = _ring_read(model.pvk, w[:, :, None], z[:, None, :],
                                   layout)                               # P̂(w_bi|z[b,c])
            cand = score_tok * (cnt[:, None, :] - same + model.alpha[z][:, None, :])
            cand = torch.where(valid[:, None, :], cand, -torch.inf)
            best_v = torch.amax(cand, dim=-1)
            best_c = torch.argmax(cand, dim=-1)
            z_cand = torch.gather(z, 1, best_c)

            # the R term of Eq. 4 (with Θ at the R topic, which may be > 0)
            r_cnt = torch.einsum(
                "bij,bj->bi", (z[:, None, :] == r_top[:, :, None]).to(torch.float32),
                vmask)
            r_self = (z == r_top).to(torch.float32)
            r_score = pvk_at_r * (r_cnt - r_self + alpha_r)
            z = torch.where(valid, torch.where(r_score > best_v, r_top, z_cand), 0)
        theta += _topic_counts(z, vmask, K)

    pkd = theta / n_trials + model.alpha[None, :]
    pkd = pkd / pkd.sum(dim=1, keepdim=True)
    if layout is None:
        return pkd
    lo, hi = shd.row_slice(K, layout, "model")
    return pkd[:, lo:hi].contiguous()


def rtlda_infer_dense(model: RTLDAModel, word_ids, n_iters: int = 5) -> torch.Tensor:
    """Dense O(K)-per-token RT-LDA — the baseline that Fig. 5A compares the
    sparse path against. Materializes [B, Ld, K] rows."""
    B, Ld = word_ids.shape
    K = model.alpha.shape[0]
    word_ids = torch.as_tensor(word_ids, device=model.pvk.device)
    valid = word_ids >= 0
    vmask = valid.to(torch.float32)
    w = torch.where(valid, word_ids, 0).long()
    rows = model.pvk[w]                                   # [B, Ld, K]
    z = model.r_topic[w].long()
    for _ in range(n_iters):
        theta = _topic_counts(z, vmask, K)                # [B, K]
        self_oh = torch.nn.functional.one_hot(z, K).to(torch.float32) * vmask[..., None]
        score = rows * (theta[:, None, :] - self_oh + model.alpha[None, None, :])
        z = torch.where(valid, torch.argmax(score, dim=-1), 0)
    pkd = _topic_counts(z, vmask, K) + model.alpha[None, :]
    return pkd / pkd.sum(dim=1, keepdim=True)
