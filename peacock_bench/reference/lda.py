"""Plain reference of collapsed-Gibbs LDA training, in PyTorch, for judging
what the port's ``Trainer`` produced (the paper's §3.1, Eq. 1; LightLDA's
alias-MH cycle; Minka's fixed point for α; the collapsed word LL).

It imports nothing of the port. It takes the corpus that the benchmark
made, and of the program only what it judges: the token stacks (which
token sits in which slot, under which local row of Φ), the assignments z
before and after an epoch, Φ, Ψ, α, the LL, and for the alias sampler the
proposal tables. Counts are worked out again from z as sorted (row · K +
topic) keys, so no [V, K] plane is made.

``dtype`` is float32 in every judgement; the control runs the same
functions in bfloat16, the precision below the configuration's.
"""
from __future__ import annotations

import torch

from . import prng

MH_SALT = 0x5EED_A11A      # the alias sampler's salt of its seed (LightLDA stream)
OMEGA_BINS = 64            # Ω_kn's counts per doc, the last bin open-ended
DOC_LEN_BINS = 512


# ----------------------------------------------------------------- layout --

def token_layout(word_ids, wl, uid, n_rows: int, vocab: int):
    """Map the program's slots back to the corpus. ``word_ids`` [N] is the
    benchmark's corpus, ``wl`` / ``uid`` the program's flattened stacks
    (−1 = pad). Returns (slot_of_token [N], row_of_word [V], faults): the
    slot that carries each token, each word's local row of Φ (−1 if no
    token), and how many slots break the layout: uids that are not each
    token exactly once, and words not given one row of their own."""
    N, dev = word_ids.shape[0], word_ids.device
    valid = wl >= 0
    slots = torch.nonzero(valid).reshape(-1)
    tok = uid[slots].long()
    faults = int(tok.numel() != N)
    slot_of = torch.full((N,), -1, dtype=torch.int64, device=dev)
    ok = (tok >= 0) & (tok < N)
    faults += int((~ok).sum())
    slot_of[tok[ok]] = slots[ok]
    faults += int((slot_of < 0).sum())
    row_of = torch.full((vocab,), -1, dtype=torch.int64, device=dev)
    got = slot_of >= 0
    w, r = word_ids[got].long(), wl[slot_of[got]].long()
    row_of[w] = r
    faults += int((row_of[w] != r).sum())                  # one row a word
    rows = row_of[row_of >= 0]
    faults += int(rows.numel() - torch.unique(rows).numel())  # one word a row
    faults += int(((rows < 0) | (rows >= n_rows)).sum())
    return slot_of, row_of, faults


def keys_of(a, b, width: int):
    """Sorted distinct keys a·width + b and their counts."""
    keys, cnt = torch.unique(a.long() * width + b.long(), sorted=True, return_counts=True)
    return keys, cnt


def lookup(keys, cnt, key):
    """Count stored under each ``key`` (0 where absent)."""
    if keys.numel() == 0:
        return torch.zeros(key.shape, dtype=cnt.dtype, device=key.device)
    pos = torch.searchsorted(keys, key).clamp(max=keys.numel() - 1)
    return torch.where(keys[pos] == key, cnt[pos], 0)


def dense_rows(keys, cnt, rows, K: int):
    """[len(rows), K] int64 counts of the given rows from sorted keys."""
    lo = torch.searchsorted(keys, rows * K)
    hi = torch.searchsorted(keys, (rows + 1) * K)
    n = hi - lo
    out = torch.zeros((rows.numel(), K), dtype=torch.int64, device=rows.device)
    if int(n.sum()) == 0:
        return out
    which = torch.repeat_interleave(torch.arange(rows.numel(), device=rows.device), n)
    first = torch.repeat_interleave(lo - torch.cumsum(n, 0) + n, n)
    idx = first + torch.arange(which.numel(), device=rows.device)
    out[which, keys[idx] % K] = cnt[idx]
    return out


# ------------------------------------------------------------------ state --

def state_faults(phi, psi, row_tok, z_tok, K: int) -> int:
    """Entries of the program's Φ [rows, K] and Ψ [K] that are not the counts
    of (row, z) and of z over the corpus's tokens."""
    keys, cnt = keys_of(row_tok, z_tok, K)
    flat = phi.reshape(-1)
    bad = int((flat[keys].long() != cnt).sum())
    bad += int(flat.sum(dtype=torch.int64) != row_tok.numel())
    bad += int(flat.min() < 0)
    psi_ref = torch.bincount(z_tok.long(), minlength=K)
    bad += int((psi.reshape(-1).long() != psi_ref).sum())
    return bad


def omega(doc_tok, z_tok, K: int):
    """Ω_kn [K, 64]: the docs in which topic k holds n tokens (n ≥ 1; 63 and
    more share the last bin)."""
    keys, cnt = keys_of(doc_tok, z_tok, K)
    k = keys % K
    n = cnt.clamp(max=OMEGA_BINS - 1)
    out = torch.zeros((K, OMEGA_BINS), dtype=torch.int64, device=doc_tok.device)
    out.index_put_((k, n), torch.ones_like(n), accumulate=True)
    return out


def minka_alpha(alpha, omega_kn, doc_len, n_iters: int, floor: float = 1e-7,
                dtype=torch.float32):
    """Minka's fixed point for the asymmetric prior from the histograms
    (paper Fig. 3 line 4): α_k ← α_k · Σ_n Ω_kn [ψ(n+α_k) − ψ(α_k)] /
    Σ_l H_l [ψ(l+α₀) − ψ(α₀)], floored."""
    dig = torch.special.digamma
    hist = torch.bincount(doc_len.clamp(max=DOC_LEN_BINS - 1), minlength=DOC_LEN_BINS)
    a = alpha.to(dtype)
    ns = torch.arange(omega_kn.shape[1], device=a.device).to(dtype)
    ls = torch.arange(DOC_LEN_BINS, device=a.device).to(dtype)
    om, hf = omega_kn.to(dtype), hist.to(dtype)
    for _ in range(n_iters):
        a0 = a.sum()
        num = (om * (dig(ns[None, :] + a[:, None]) - dig(a)[:, None])).sum(dim=1)
        den = (hf * (dig(ls + a0) - dig(a0))).sum()
        a = torch.clamp(a * num / torch.clamp(den, min=1e-30), min=floor)
    return a.to(torch.float32)


def word_ll(row_tok, z_tok, K: int, V: int, beta: float, dtype=torch.float64):
    """The collapsed word log-likelihood log p(w | z) =
    Σ_k [Σ_v (lnΓ(φ_vk+β) − lnΓ(β)) + lnΓ(Vβ) − lnΓ(ψ_k+Vβ)]; only nonzero
    counts add to the inner sum."""
    _, cnt = keys_of(row_tok, z_tok, K)
    b = torch.tensor(beta, dtype=dtype, device=row_tok.device)
    lg = torch.lgamma
    psi = torch.bincount(z_tok.long(), minlength=K).to(dtype)
    inner = (lg(cnt.to(dtype) + b) - lg(b)).sum()
    vb = V * b
    return float(inner + (lg(vb) - lg(psi + vb)).sum())


# ----------------------------------------------------------- dense draws --

def gibbs_gap(row_tok, doc_tok, z_pre, z_post, uid_tok, alpha, beta: float, V: int,
              seed: int, K: int, block: int = 512, dtype=torch.float32):
    """One epoch of the dense sampler from the state z_pre, every token drawn
    against the same counts with its own assignment removed (¬ivd), by
    Gumbel-max over Eq. 1's K terms. Returns (widest gap, draws): the gap is
    by how far the score of the topic the program drew (``z_post``) lies
    below the best score, worst token, in float32; the draws are the
    reference's own (the control's, in ``dtype``)."""
    dev = z_pre.device
    pk, pc = keys_of(row_tok, z_pre, K)
    dk, dc = keys_of(doc_tok, z_pre, K)
    psi = torch.bincount(z_pre.long(), minlength=K)
    beta_t = torch.tensor(beta, dtype=torch.float32, device=dev)
    vb = V * beta_t
    gap = torch.zeros((), dtype=torch.float32, device=dev)
    draws = torch.empty_like(z_pre)
    for lo in range(0, z_pre.numel(), block):
        sl = slice(lo, lo + block)
        z0 = z_pre[sl].long()
        at = (torch.arange(z0.numel(), device=dev), z0)
        phi_r = dense_rows(pk, pc, row_tok[sl].long(), K).to(torch.float32)
        th_r = dense_rows(dk, dc, doc_tok[sl].long(), K).to(torch.float32)
        ps_r = psi.to(torch.float32).expand(z0.numel(), K).clone()
        for t in (phi_r, th_r, ps_r):
            t[at] -= 1.0
        k = torch.arange(K, dtype=torch.int64, device=dev)
        g = prng.gumbel(seed, uid_tok[sl].long()[:, None], k[None, :], dtype)
        c = lambda x: x.to(dtype)
        s = (torch.log(c(phi_r) + c(beta_t)) - torch.log(c(ps_r) + c(vb))
             + torch.log(c(th_r) + c(alpha)[None, :])) + g
        draws[sl] = torch.argmax(s, dim=1).to(z_pre.dtype)
        if dtype != torch.float32:
            continue
        got = s.gather(1, z_post[sl].long()[:, None])[:, 0]
        best = s.max(dim=1).values
        # a uniform of 1 − 2⁻²⁵ rounds to 1 in float32 and its Gumbel term is
        # +inf: that topic wins, and a draw of it lies 0 below the best
        gap = torch.maximum(gap, torch.where(got == best, 0.0, best - got).max())
    return float(gap), draws


# --------------------------------------------------------- alias sampler --

def pairs(doc_tok, z_tok, n_docs: int, K: int, cap: int):
    """Each doc's (topic, count) pairs in topic order, −1 padded: [D, cap]."""
    keys, cnt = keys_of(doc_tok, z_tok, K)
    d, k = keys // K, keys % K
    first = torch.ones_like(d, dtype=torch.bool)
    first[1:] = d[1:] != d[:-1]
    idx = torch.arange(d.numel(), device=d.device)
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    rank = idx - start
    topic = torch.full((n_docs, cap), -1, dtype=torch.int64, device=d.device)
    count = torch.zeros((n_docs, cap), dtype=torch.int64, device=d.device)
    topic[d, rank] = k
    count[d, rank] = cnt
    return topic, count


def mh_chain(row_tok, doc_tok, z_pre, uid_tok, alpha, beta: float, V: int, seed: int,
             K: int, n_mh: int, tables, n_docs: int, cap: int, dtype=torch.float32,
             sectors: bool = False):
    """The alias sampler's epoch from the state z_pre: ``n_mh`` MH steps a
    token, even steps proposing from the doc (its pairs mixed with the α
    table), odd ones from the stale word table, each accepted against the
    collapsed posterior on the counts with the token removed. ``tables`` =
    (wq, wp, wa, ap, aa), the proposal state the epoch ran against, judged
    by itself in ``table_faults``. Returns (draws, bytes of the distinct
    32-byte sectors the chain reads in the [rows, K] tables, or None)."""
    dev = z_pre.device
    wq, wp, wa, ap, aa = tables
    c = lambda x: x.to(dtype)
    seed2 = int(prng.fmix32((int(seed) ^ MH_SALT) & prng.M32))
    pk, pc = keys_of(row_tok, z_pre, K)
    psi = torch.bincount(z_pre.long(), minlength=K)
    b = c(torch.tensor(beta, dtype=torch.float32, device=dev))
    vb = c(torch.tensor(float(V), dtype=torch.float32, device=dev)) * b
    al = c(alpha)
    asum = c(alpha.sum(dtype=torch.float32))
    tp, ct = pairs(doc_tok, z_pre, n_docs, K, cap)
    w, z0, uid = row_tok.long(), z_pre.long(), uid_tok.long()
    rows_t, rows_c = tp[doc_tok.long()], c(ct[doc_tok.long()])
    total = rows_c.sum(dim=1)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def n_dk(k):
        return torch.where(rows_t == k[:, None], rows_c, zero).sum(dim=1)

    def p_of(k):
        ex = c((k == z0).to(torch.float32))
        ph = c(lookup(pk, pc, w * K + k)) - ex
        ps = c(psi[k]) - ex
        th = n_dk(k) - ex
        return (ph + b) * (th + al[k]) / (ps + vb)

    read = {"phi": [w * K + z0], "wq": [], "wp": [], "wa": []}
    s, p_s = z0, p_of(z0)
    for step in range(n_mh):
        b0 = 4 * step
        u_draw = prng.uniform01(seed2, uid, b0 + 1, dtype)
        u_coin = prng.uniform01(seed2, uid, b0 + 2, dtype)
        jk = (u_draw * K).to(torch.int64).clamp(max=K - 1)
        if step % 2 == 0:
            u_mix = prng.uniform01(seed2, uid, b0, dtype)
            r = u_draw * total
            cum = torch.cumsum(rows_c, dim=1)
            prev = cum - rows_c
            hit = (cum > r[:, None]) & (prev <= r[:, None]) & (rows_c > 0.0)
            t_cnt = torch.where(hit, rows_t, 0).sum(dim=1)
            t_cnt = torch.where(hit.any(dim=1), t_cnt, s)
            t_al = torch.where(u_coin < c(ap)[jk], jk, aa[jk].long())
            t = torch.where(u_mix * (total + asum) < total, t_cnt, t_al)
            q_s, q_t = n_dk(s) + al[s], n_dk(t) + al[t]
        else:
            coin = u_coin < c(wp[w, jk])
            t = torch.where(coin, jk, wa[w, jk].long())
            q_s, q_t = c(wq[w, s]), c(wq[w, t])
            if sectors:
                read["wq"] += [w * K + s, w * K + t]
                read["wp"].append(w * K + jk)
                read["wa"].append((w * K + jk)[~coin])
        if sectors:
            read["phi"].append(w * K + t)
        u_acc = prng.uniform01(seed2, uid, b0 + 3, dtype)
        p_t = p_of(t)
        acc = u_acc < (p_t * q_s) / (p_s * q_t)
        s = torch.where(acc, t, s)
        p_s = torch.where(acc, p_t, p_s)
    n_sec = None
    if sectors:
        n_sec = 32.0 * sum(int(torch.unique(torch.cat(v) // 8).numel())
                           for v in read.values() if v)
    return s.to(z_pre.dtype), n_sec


def table_error(wq, wp, wa, ap, aa, row_of_word, row_tok, z_build, alpha, beta: float,
                V: int, K: int, block: int = 1024):
    """How far the proposal tables lie from what they stand for: the worst
    relative error of wq against (φ+β)/(ψ+Vβ) counted from ``z_build`` (the
    assignments the tables were built from), and the worst L1 distance
    between the distribution a Walker table (prob, alias) draws from,
    (prob_k + Σ_j (1 − prob_j)·[alias_j = k]) / K, and its row normalised,
    over every word's row and the α table. Returns (wq error, L1)."""
    dev = wq.device
    pk, pc = keys_of(row_tok, z_build, K)
    psi = torch.bincount(z_build.long(), minlength=K).to(torch.float32)
    b = torch.tensor(beta, dtype=torch.float32, device=dev)
    den = psi + torch.tensor(float(V), dtype=torch.float32, device=dev) * b
    rows = torch.sort(row_of_word[row_of_word >= 0]).values
    wq_err = torch.zeros((), dtype=torch.float64, device=dev)
    l1 = torch.zeros((), dtype=torch.float64, device=dev)

    def dist_l1(prob, alias, target):
        m = prob.to(torch.float64) / K
        m.scatter_add_(1, alias.long(), (1.0 - prob.to(torch.float64)) / K)
        t = target.to(torch.float64)
        return (m - t / t.sum(dim=1, keepdim=True)).abs().sum(dim=1).max()

    for lo in range(0, rows.numel(), block):
        r = rows[lo:lo + block]
        ref = (dense_rows(pk, pc, r, K).to(torch.float64) + float(beta)) / den.to(torch.float64)
        wq_err = torch.maximum(wq_err, ((wq[r].to(torch.float64) - ref).abs() / ref).max())
        l1 = torch.maximum(l1, dist_l1(wp[r], wa[r], ref))
    l1 = torch.maximum(l1, dist_l1(ap[None, :], aa[None, :], alpha[None, :]))
    return float(wq_err), float(l1)
