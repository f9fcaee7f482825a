"""Plain reference of RT-LDA serving, in PyTorch (the paper's §3.2 and §5:
P̂ and the R cache, Eq. 3; the hill climb of Eq. 4; the topic features of
Eq. 5), for judging what the port's engine and fleet served.

It imports nothing of the port. P̂ and R are worked out again from the Φ,
β and α the benchmark made. The hill climb's restarts draw from the
counter-based hash (``prng``) keyed by the batch's seed and the token's
place in its padded batch, so the reference takes, for each judged
request, the seed and the place of the batch the program ran it in, as
the harness recorded them at the engine's inference call.

``dtype`` is float32 in every judgement; the control computes the same in
bfloat16.
"""
from __future__ import annotations

import torch

from . import prng


def column_sums(phi, beta: float, block: int = 2048):
    """Σ_v (φ_vk + β) [K] in float64, a block of rows at a time."""
    col = torch.zeros(phi.shape[1], dtype=torch.float64, device=phi.device)
    for lo in range(0, phi.shape[0], block):
        col += phi[lo:lo + block].sum(dim=0, dtype=torch.float64)
    return col + phi.shape[0] * float(beta)


def phi_hat(phi, beta: float, dtype=torch.float32, block: int = 2048):
    """P̂(v|k) = (φ_vk + β) / Σ_v (φ_vk + β) [V, K], the column sums in
    float64, the quotient rounded once to ``dtype``."""
    col = column_sums(phi, beta)
    out = torch.empty(phi.shape, dtype=dtype, device=phi.device)
    for lo in range(0, phi.shape[0], block):
        out[lo:lo + block] = ((phi[lo:lo + block].to(torch.float64) + float(beta))
                              / col[None, :]).to(dtype)
    return out


def pvk_error(pvk_prog, phi, beta: float, block: int = 2048) -> float:
    """Worst relative error of the program's P̂ against the reference's,
    computed in float64 a block of rows at a time."""
    col = column_sums(phi, beta)
    err = torch.zeros((), dtype=torch.float64, device=phi.device)
    for lo in range(0, phi.shape[0], block):
        ref = (phi[lo:lo + block].to(torch.float64) + float(beta)) / col[None, :]
        err = torch.maximum(err, ((pvk_prog[lo:lo + block].to(torch.float64) - ref).abs()
                                  / ref).max())
    return float(err)


def r_cache_blocks(pvk, alpha, block: int = 2048):
    """Eq. 3's R cache: for each word the topic of its largest P̂(v|k)·α_k
    (the first on a tie) and that value, a block of rows at a time."""
    tops, vals = [], []
    a = alpha[None, :].to(pvk.dtype)
    for lo in range(0, pvk.shape[0], block):
        prior = pvk[lo:lo + block] * a
        tops.append(torch.argmax(prior, dim=1))
        vals.append(torch.amax(prior, dim=1))
    return torch.cat(tops), torch.cat(vals)


def r_cache_gap(pvk, alpha, r_topic_prog, r_value_prog, block: int = 2048) -> float:
    """By how much the prior at the program's R topic lies below the best,
    or its stored value differs from the best, as a share of the best,
    worst word."""
    worst = torch.zeros((), dtype=torch.float64, device=pvk.device)
    for lo in range(0, pvk.shape[0], block):
        prior = (pvk[lo:lo + block] * alpha[None, :]).to(torch.float64)
        best = prior.amax(dim=1)
        at = prior.gather(1, r_topic_prog[lo:lo + block].long()[:, None])[:, 0]
        val = r_value_prog[lo:lo + block].to(torch.float64)
        worst = torch.maximum(worst, torch.maximum((best - at) / best,
                                                   (val - best).abs() / best).max())
    return float(worst)


def infer(pvk, alpha, r_topic, r_value, words, row, seed, n_iters: int, n_trials: int):
    """Eq. 4's hill climb for n queries, each as the program ran it: ``words``
    [n, Ld] (−1 padded) at row ``row`` [n] of a batch of width Ld run with
    batch seed ``seed`` [n]. Trial 0 starts every token at its R topic; a
    later trial t restarts half the tokens, drawn from
    hash(seed ⊕ t·φ₃₂, row·Ld + j, 0), at a uniform topic. Each step moves a
    token to the best of its query's topics and its R topic under
    P̂(w|k)·(n_k¬ + α_k), the first best on a tie. Returns P(k|d) [n, K]:
    the trials' mean topic counts plus α, normalised."""
    n, Ld = words.shape
    K = alpha.shape[0]
    dt = pvk.dtype
    dev = pvk.device
    valid = words >= 0
    vmask = valid.to(dt)
    w = torch.where(valid, words, 0).long()
    a = alpha.to(dt)
    r_top = r_topic[w].long()
    pvk_at_r = pvk[w, r_top]
    alpha_r = a[r_top]
    counters = row.long()[:, None] * Ld + torch.arange(Ld, device=dev)[None, :]
    theta = torch.zeros((n, K), dtype=dt, device=dev)
    for t in range(n_trials):
        if t == 0:
            z = r_top
        else:
            salt = (seed.long() ^ ((t * prng.GOLDEN) & prng.M32))[:, None]
            u = prng.uniform01(salt, counters, 0)
            z = torch.where(u < 0.5, r_top, ((u * (2 ** 24)).to(torch.int32) % K).long())
        z = torch.where(valid, z, 0)
        for _ in range(n_iters):
            same = (z[:, None, :] == z[:, :, None]).to(dt)            # [n, c, j]
            cnt = torch.einsum("bcj,bj->bc", same, vmask)
            score = pvk[w[:, :, None], z[:, None, :]]
            cand = score * (cnt[:, None, :] - same + a[z][:, None, :])
            cand = torch.where(valid[:, None, :], cand, -torch.inf)
            best_v = torch.amax(cand, dim=-1)
            z_cand = torch.gather(z, 1, torch.argmax(cand, dim=-1))
            r_cnt = torch.einsum("bij,bj->bi", (z[:, None, :] == r_top[:, :, None]).to(dt),
                                 vmask)
            r_score = pvk_at_r * (r_cnt - (z == r_top).to(dt) + alpha_r)
            z = torch.where(valid, torch.where(r_score > best_v, r_top, z_cand), 0)
        rows = torch.arange(n, device=dev)[:, None].expand_as(z)
        theta.index_put_((rows, z), vmask, accumulate=True)
    pkd = theta / n_trials + a[None, :]
    return pkd / pkd.sum(dim=1, keepdim=True)


def flips(pkd_prog, pkd_ref, n_tokens, alpha_sum: float):
    """Whether a request's served P(k|d) departs from the reference's by a
    quarter of one token's weight or more in some topic (a token of the
    hill climb on another topic moves half a token's weight, over two
    trials; rounding moves ~1e-7 of it)."""
    scale = (n_tokens.to(torch.float64) + alpha_sum)
    d = (pkd_prog.to(torch.float64) - pkd_ref.to(torch.float64)).abs().amax(dim=1)
    return d * scale >= 0.25


def features(pvk, pkd, top_n: int):
    """Eq. 5 as the control computes it: P(v|d) = Σ_k P̂(v|k) P(k|d) [n, V]
    in P̂'s type, and its top_n ids and weights."""
    pvd = pkd.to(pvk.dtype) @ pvk.T
    w, ids = torch.sort(pvd, dim=1, descending=True, stable=True)
    return pvd, ids[:, :top_n], w[:, :top_n]


def features_exact(phi, beta: float, pkd, block: int = 2048):
    """Eq. 5 in float64 from the counts: P(v|d) [n, V] with P̂ exact to
    float64, a block of words at a time (a float32 product over K = 10⁵
    terms is itself off by ~10⁻³ of a small entry)."""
    col = column_sums(phi, beta)
    pk = pkd.to(torch.float64)
    out = torch.empty((pk.shape[0], phi.shape[0]), dtype=torch.float64, device=phi.device)
    for lo in range(0, phi.shape[0], block):
        p = (phi[lo:lo + block].to(torch.float64) + float(beta)) / col[None, :]
        out[:, lo:lo + block] = pk @ p.T
    return out


def feature_gaps(pvd_ref, ids_prog, w_prog, top_n: int):
    """How far each request's served features lie from Eq. 5 on its served
    P(k|d) [n]: the worst of a served weight's distance from P(v|d) at its
    id and of how far that P(v|d) falls below the top_n-th largest, as a
    share of the row's largest P(v|d)."""
    ref = pvd_ref.to(torch.float64)
    top = torch.topk(ref, top_n, dim=1).values
    at = ref.gather(1, ids_prog.long())
    short = (top[:, -1:] - at).clamp(min=0)
    werr = (w_prog.to(torch.float64) - at).abs()
    return torch.maximum(short, werr).amax(dim=1) / top[:, 0]
