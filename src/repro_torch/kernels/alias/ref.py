"""Plain PyTorch versions of the alias-table build and the Metropolis–Hastings
probe (port of ``repro.kernels.alias.ref``).

Both evaluate the same integer and float formulas, in the same order, as the
JAX package's ``ref.py`` and as the CUDA kernels in ``csrc/alias_build.cu``
and ``csrc/mh_resample.cu``: the branch-free Walker sweep and the LightLDA
proposal cycle are built from + − × ÷ and compares only, so the three agree
bit for bit on the same inputs.

The build is Walker/Vose alias construction as a K-step sweep with a
six-scalar carry per row: each step finalizes exactly one slot. The
normalization and the small/large order come from ``ops._prepare``.

The probe runs ``n_mh`` MH steps per token: even steps propose from the
document (its sparse (topic, count) pairs mixed with the α alias table), odd
steps from the stale per-word alias table; each proposal is accepted against
the true collapsed posterior ratio on live counts with exact self-exclusion.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng

_F32 = torch.float32


# --------------------------------------------------------------- build ------


def edge_rows(K: int, seed: int = 1) -> np.ndarray:
    """Test rows [11, K] f32 that hit the CUDA build's tile logic at width K:
    all large but one, all small but one, a 32-slot tile with no small, one
    with no large, sparse larges, sparse smalls, one-hot, all equal, a zero
    tail, a NaN, all zero."""
    rng = np.random.default_rng(seed)
    rows = np.stack([np.full(K, v, np.float32) for v in
                     (2.0, 0.5, 0.1, 5.0, 0.01, 3.0, 0.0, 1.0, 1.0)])
    rows[0, K // 2] = 1e-3
    rows[1, min(7, K - 1)] = 1000.0
    rows[2, 64:96] = 50.0
    rows[3, 32:64] = 0.01
    rows[4, ::97] = 100.0
    rows[5, ::61] = 0.0
    rows[6, min(3, K - 1)] = 5.0
    rows[8, K // 2:] = 0.0
    nan = rng.gamma(0.3, 1.0, K).astype(np.float32)
    nan[K // 3] = np.nan
    return np.concatenate([rows, nan[None], np.zeros((1, K), np.float32)])


def build_alias_ref(wn: torch.Tensor, order: torch.Tensor, ns: torch.Tensor):
    """Batched alias construction. wn [R, K] f32 mean-1 weights, order [R, K]
    int32 small/large partition order, ns [R] int32 small counts — all from
    ``ops._prepare``. Returns (prob [R, K] f32, alias [R, K] int32).

    One Python step per slot over a vector of R rows, in ``_sweep_step``'s op
    order (``repro/kernels/alias/ref.py:39``); the finalized (slot, prob,
    alias) of every step are written in one scatter after the sweep.
    """
    R, K = wn.shape
    dev = wn.device
    rows = torch.arange(R, device=dev)
    order = order.long()
    ns = ns.long()
    last = K - 1

    def order_at(idx):
        return order[rows, idx.clamp(max=last)]

    has_l = ns < K
    first = order_at(ns)
    cur = torch.where(has_l, first, -1)
    curw = torch.where(has_l, wn[rows, first], 0.0)
    i = torch.zeros(R, dtype=torch.int64, device=dev)
    j = torch.ones(R, dtype=torch.int64, device=dev)
    pend = torch.full((R,), -1, dtype=torch.int64, device=dev)
    pendw = torch.zeros(R, dtype=_F32, device=dev)
    slots = torch.empty((K, R), dtype=torch.int64, device=dev)
    vals = torch.empty((K, R), dtype=_F32, device=dev)
    alis = torch.empty((K, R), dtype=torch.int32, device=dev)
    for step in range(K):
        has_pend = pend >= 0
        has_small = i < ns
        oi = order_at(i)
        s_slot = torch.where(has_pend, pend, torch.where(has_small, oi, -1))
        sw = torch.where(has_pend, pendw, torch.where(has_small, wn[rows, oi], 0.0))
        i = torch.where(~has_pend & has_small, i + 1, i)

        use_small = (s_slot >= 0) & (cur >= 0)
        slot = torch.where(s_slot >= 0, s_slot, cur)     # -1 when nothing remains
        slots[step] = slot
        vals[step] = torch.where(use_small, sw.clamp(0.0, 1.0), 1.0)
        alis[step] = torch.where(use_small, cur, slot)

        curw2 = torch.where(use_small, curw - (1.0 - sw), curw)
        demote = use_small & (curw2 < 1.0)
        advance = demote | ((s_slot < 0) & (cur >= 0))
        pend = torch.where(demote, cur, -1)
        pendw = torch.where(demote, curw2, 0.0)
        nl = ns + j
        has_next = nl < K
        onl = order_at(nl)
        cur = torch.where(advance, torch.where(has_next, onl, -1), cur)
        curw = torch.where(advance, torch.where(has_next, wn[rows, onl], 0.0), curw2)
        j = torch.where(advance, j + 1, j)
    # idle steps (slot -1) land in a scratch column K and are dropped; every
    # live step finalizes a distinct slot
    slot_w = torch.where(slots >= 0, slots, K).T
    prob = torch.ones((R, K + 1), dtype=_F32, device=dev)
    prob.scatter_(1, slot_w, vals.T)
    alias = torch.arange(K + 1, dtype=torch.int32, device=dev).repeat(R, 1)
    alias.scatter_(1, slot_w, alis.T)
    return prob[:, :K].contiguous(), alias[:, :K].contiguous()


# --------------------------------------------------------------- probe ------


def mh_resample_ref(
    phi,         # [rows, K] int32 — live word-topic counts
    psi,         # [K] int32       — live topic totals
    doc_topic,   # [D, cap] int32  — sparse Θ pairs (-1 = empty slot)
    doc_count,   # [D, cap] int32
    wq,          # [rows, K] f32   — stale word-proposal weights (ñ+β)/(ψ̃+Vβ)
    wp,          # [rows, K] f32   — word alias probs
    wa,          # [rows, K] int32 — word alias indices
    alpha,       # [K] f32
    ap,          # [K] f32         — α alias probs
    aa,          # [K] int32       — α alias indices
    w,           # [T] int — word ids (rows-local)
    d,           # [T] int — doc ids (local to doc_topic)
    z,           # [T] int — current assignments
    uid,         # [T] int64 holding uint32 token uids (RNG counters)
    seed2: int,  # uint32, pre-salted sampler seed (``ops`` mixes the salt)
    beta,        # [] f32
    alpha_sum,   # [] f32
    vocab_size: int,
    n_mh: int,
    trace=None,
) -> torch.Tensor:
    """n_mh MH steps per token against the true collapsed posterior ratio;
    returns z_new [T] int32. Per token O(cap) per doc proposal, O(1) gathers
    per probe — never O(K).

    ``trace``, a list, receives per step the entries of the [rows, K] tables
    the step reads, as (state s, proposal t, jk, alias-coin rejected) [T]
    tensors, the last None on a doc step: what a byte count of the chain
    needs (``chip_smoke.mh_bytes``)."""
    K = psi.shape[0]
    vb = torch.tensor(float(vocab_size), dtype=_F32, device=beta.device) * beta
    w, d, z0 = w.long(), d.long(), z.long()
    uid = uid.long()
    rows_t = doc_topic[d]                                # [T, cap]
    rows_c = doc_count[d].to(_F32)                       # [T, cap]
    total = rows_c.sum(dim=1)                            # [T]
    zero = torch.zeros((), dtype=_F32, device=phi.device)

    def lookup(k):
        """n_dk INCLUDING the token itself (the raw stored pairs)."""
        return torch.where(rows_t == k[:, None], rows_c, zero).sum(dim=1)

    def p_of(k):
        """True collapsed posterior at k, self-excluded wrt z0 (¬ivd)."""
        ex = (k == z0).to(_F32)
        ph = phi[w, k].to(_F32) - ex
        ps = psi[k].to(_F32) - ex
        th = lookup(k) - ex
        return (ph + beta) * (th + alpha[k]) / (ps + vb)

    s = z0
    p_s = p_of(s)
    for step in range(n_mh):
        b0 = 4 * step
        u_draw = prng.uniform01(seed2, uid, b0 + 1)
        u_coin = prng.uniform01(seed2, uid, b0 + 2)
        jk = (u_draw * K).to(torch.int32).clamp(max=K - 1).long()
        if step % 2 == 0:
            # ----- doc proposal: q_d(k) ∝ n_dk + α_k ------------------------
            u_mix = prng.uniform01(seed2, uid, b0)
            r = u_draw * total
            cum = torch.cumsum(rows_c, dim=1)
            prev = cum - rows_c
            mask = (cum > r[:, None]) & (prev <= r[:, None]) & (rows_c > 0.0)
            t_cnt = torch.where(mask, rows_t, 0).sum(dim=1)
            t_cnt = torch.where(mask.any(dim=1), t_cnt, s)
            t_al = torch.where(u_coin < ap[jk], jk, aa[jk].long())
            use_counts = u_mix * (total + alpha_sum) < total
            t_prop = torch.where(use_counts, t_cnt, t_al)
            q_s = lookup(s) + alpha[s]
            q_t = lookup(t_prop) + alpha[t_prop]
        else:
            # ----- word proposal: stale alias table, O(1) probes ------------
            coin = u_coin < wp[w, jk]
            t_prop = torch.where(coin, jk, wa[w, jk].long())
            q_s = wq[w, s]
            q_t = wq[w, t_prop]
        if trace is not None:
            trace.append((s, t_prop, jk, None if step % 2 == 0 else ~coin))
        u_acc = prng.uniform01(seed2, uid, b0 + 3)
        p_t = p_of(t_prop)
        ratio = (p_t * q_s) / (p_s * q_t)
        acc = u_acc < ratio
        s = torch.where(acc, t_prop, s)
        p_s = torch.where(acc, p_t, p_s)
    return s.to(torch.int32)
