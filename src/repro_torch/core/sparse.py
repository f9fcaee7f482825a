"""Sparse doc-topic bookkeeping for the alias-MH sampler (port of
``repro.core.sparse``).

Θ lives as capped (topic, count) pairs — ``topic [D, cap] int32`` (−1 = empty
slot) and ``count [D, cap] int32`` — instead of a [docs, K] plane, so the
per-token cost touching Θ is O(cap) = O(k_d), never O(K). ``cap`` ≥ the
longest document (:func:`suggest_cap`), so a row never overflows.

* :func:`pairs_from_assignments` builds pairs from (d, z) in one sort and
  segment-sum pass;
* :func:`apply_deltas` is the incremental z-flip update, in two passes
  (free, then allocate);
* :func:`sample_block_mh` is one alias-MH sweep over a token block.

The table builders (:func:`make_word_tables`, :func:`make_alpha_table`)
produce the stale proposal tables the MH probe corrects against.

The JAX version's ``lexsort`` is one stable sort on the int64 key
d·2³² + k; duplicate scatter indices arise only in the scratch row that is
dropped, so ``index_put_`` without accumulate stays deterministic; count
updates are int32 ``index_put_(accumulate=True)``. ``sample_block_mh``
updates ``phi`` and ``psi`` in place.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels.alias import ops as alias_ops

# rows of wq filled at a time: bounds the f32 temporary of the wq pass
# (0.8 GB at K = 100,000) while wq itself is filled in place
TABLE_ROWS = 2048


class AliasTables(NamedTuple):
    """Stale proposal state for one vocab shard: word tables + α table."""

    wq: torch.Tensor   # [rows, K] f32 — proposal weights (ñ_wk+β)/(ψ̃_k+Vβ)
    wp: torch.Tensor   # [rows, K] f32 — Walker probs
    wa: torch.Tensor   # [rows, K] int32 — Walker alias indices
    ap: torch.Tensor   # [K] f32 — α-table probs
    aa: torch.Tensor   # [K] int32 — α-table alias indices


def suggest_cap(doc_lengths, n_topics: int) -> int:
    """Static pair-row pitch: distinct topics per doc never exceed the doc's
    token count (nor K), so ``min(K, max_len)`` is a hard bound."""
    longest = int(np.max(np.asarray(doc_lengths))) if len(doc_lengths) else 1
    return max(1, min(int(n_topics), longest))


# ------------------------------------------------- sorted-segment helper ----


def _first_flags(x: torch.Tensor) -> torch.Tensor:
    """True where x differs from its predecessor, and at position 0."""
    return torch.cat([torch.ones(1, dtype=torch.bool, device=x.device), x[1:] != x[:-1]])


def _segment_totals(d, k, delta, n_docs: int):
    """Aggregate per-(d, k) net deltas with one stable sort.

    Returns (ds, ks, tot, active): sorted doc/topic ids, the inclusive running
    total within each (d, k) segment, and ``active``, True exactly at each
    segment's end when the net total is nonzero and the doc is a real row
    (< n_docs; the ``n_docs`` sentinel parks masked-out entries last).
    """
    key = (d.long() << 32) | k.long()
    order = torch.sort(key, stable=True).indices
    ds, ks, dl = d[order], k[order], delta[order].long()
    idx = torch.arange(ds.shape[0], device=ds.device)
    new_seg = _first_flags(ds) | _first_flags(ks)
    cum = torch.cumsum(dl, dim=0)
    before = cum - dl
    seg_start = torch.cummax(torch.where(new_seg, idx, 0), dim=0).values
    tot = (cum - before[seg_start]).to(torch.int32)
    is_end = torch.cat([new_seg[1:], torch.ones(1, dtype=torch.bool, device=ds.device)])
    active = is_end & (tot != 0) & (ds < n_docs)
    return ds, ks, tot, active


def _doc_rank(ds, flag):
    """Ordinal of each flagged position among the flagged positions of its
    doc (ds sorted by doc)."""
    idx = torch.arange(ds.shape[0], device=ds.device)
    inc = flag.long()
    before = torch.cumsum(inc, dim=0) - inc
    doc_start = torch.cummax(torch.where(_first_flags(ds), idx, 0), dim=0).values
    return before - before[doc_start]


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Column of the first True in each row (0 if none), as ``jnp.argmax``."""
    return torch.argmax(mask.to(torch.uint8), dim=1)


# ----------------------------------------------------------- pair layout ----


def pairs_from_assignments(d, z, valid, n_docs: int, cap: int):
    """Build capped (topic, count) pairs from token assignments.

    d/z [T] int, valid [T] bool → (topic [n_docs, cap] int32 with −1 padding,
    count [n_docs, cap] int32). Slot order within a row is topic order; a
    pair past ``cap`` is dropped, as JAX's ``mode="drop"`` drops it.
    """
    d_s = torch.where(valid, d.long(), n_docs)
    ds, ks, tot, active = _segment_totals(d_s, z, valid.to(torch.int32), n_docs)
    rank = _doc_rank(ds, active)
    keep = active & (rank < cap)
    row = torch.where(keep, ds, n_docs)
    col = torch.where(keep, rank, 0)
    dev = d.device
    topic = torch.full((n_docs + 1, cap), -1, dtype=torch.int32, device=dev)
    count = torch.zeros((n_docs + 1, cap), dtype=torch.int32, device=dev)
    topic[row, col] = ks.to(torch.int32)
    count[row, col] = tot
    # the scratch row takes every masked-out write; real rows never see it
    return topic[:n_docs], count[:n_docs]


def pairs_to_dense(topic, count, n_topics: int) -> torch.Tensor:
    """[D, cap] pairs → dense [D, K] int32 doc-topic counts (tests, oracles)."""
    D, cap = topic.shape
    rows = torch.arange(D, device=topic.device)[:, None].expand(D, cap)
    col = topic.clamp(min=0).long()
    val = torch.where(topic >= 0, count, 0)
    out = torch.zeros((D, n_topics), dtype=torch.int32, device=topic.device)
    out.index_put_((rows, col), val, accumulate=True)
    return out


def pairs_lookup(topic, count, d, k) -> torch.Tensor:
    """n_dk gathered from pairs for token vectors d, k [T] → [T] int32."""
    rows_t, rows_c = topic[d.long()], count[d.long()]
    return torch.where(rows_t == k[:, None], rows_c, 0).sum(dim=1, dtype=torch.int32)


def pairs_topic_histogram(topic, count, n_topics: int, max_count: int = 64) -> torch.Tensor:
    """Ω_kn [K, max_count] int32 (#docs in which topic k occurs n times) read
    off the pairs: what ``dedup.topic_count_histogram`` computes from a dense
    [docs, K] Θ, which at K = 10⁵ and 10⁵ docs does not fit the card."""
    live = topic >= 0
    key = topic[live].long() * max_count + count[live].clamp(max=max_count - 1).long()
    omega = torch.bincount(key, minlength=n_topics * max_count)
    omega = omega.view(n_topics, max_count).to(torch.int32)
    omega[:, 0] = 0
    return omega


def _add_where(x, row, col, ok, val):
    """``x`` [D, cap] int32 plus ``val`` at (row, col) where ``ok``, as a new
    tensor. Each masked-out entry goes to a scratch cell of its own past the
    end: parked on one shared cell, they would form one long run of a
    duplicate index, which the card's sort-based ``index_put_(accumulate=True)``
    walks serially."""
    D, cap = x.shape
    n = row.shape[0]
    flat = torch.cat([x.reshape(-1), x.new_zeros(n)])
    scratch = D * cap + torch.arange(n, device=x.device)
    flat.index_put_((torch.where(ok, row * cap + col, scratch),), val, accumulate=True)
    return flat[:D * cap].view(D, cap)


def apply_deltas(topic, count, d, z_old, z_new, valid):
    """Incremental pair update for one block's z-flips.

    Aggregates the block's (−1 @ (d, z_old), +1 @ (d, z_new)) deltas per
    (doc, topic) and applies them in TWO passes: net-negative deltas first
    (they always match an existing slot; slots whose count reaches zero are
    freed to −1), then net-positive deltas against the freed rows (matching
    slots add in place; first-seen topics claim empty slots by per-doc
    allocation rank). A row at full capacity that loses one topic and gains
    another in the same block must free before it allocates. Returns new
    (topic, count).
    """
    D, cap = topic.shape
    dev = topic.device
    d, z_old, z_new = d.long(), z_old.long(), z_new.long()
    changed = valid & (z_old != z_new)
    act2 = torch.cat([changed, changed])
    dd = torch.where(act2, torch.cat([d, d]), D)
    kk = torch.cat([z_old, z_new])
    sgn = torch.cat([-changed.to(torch.int32), changed.to(torch.int32)])
    ds, ks, tot, active = _segment_totals(dd, kk, sgn, D)
    row_ix = torch.where(ds < D, ds, 0)

    # ---- pass 1: net-negative deltas; free zeroed slots ----------------
    neg = active & (tot < 0)
    rows_t = topic[row_ix]                                    # [N, cap]
    match = (rows_t == ks[:, None]) & (rows_t >= 0)
    ok = neg & match.any(dim=1)
    count = _add_where(count, row_ix, _first_true(match), ok, tot)
    topic = torch.where(count == 0, -1, topic)

    # ---- pass 2: net-positive deltas; match or allocate ----------------
    pos = active & (tot > 0)
    rows_t = topic[row_ix]
    match = (rows_t == ks[:, None]) & (rows_t >= 0)
    found = match.any(dim=1)
    slot_m = _first_true(match)
    is_alloc = pos & ~found
    rank = _doc_rank(ds, is_alloc)
    empty = rows_t < 0
    ecum = torch.cumsum(empty, dim=1)
    tgt = empty & (ecum == (rank + 1)[:, None])
    slot_a = _first_true(tgt)
    has_slot = tgt.any(dim=1)

    ok = pos & (found | (is_alloc & has_slot))
    slot = torch.where(found, slot_m, slot_a)
    topic_p = torch.cat([topic, torch.full((1, cap), -1, dtype=torch.int32, device=dev)])
    topic_p[torch.where(ok & is_alloc, ds, D), slot] = ks.to(torch.int32)
    count = _add_where(count, row_ix, slot, ok, tot)
    # positive deltas cannot zero a slot — no second free pass needed
    return topic_p[:D], count


# --------------------------------------------------------- table builders ---


def make_word_tables(phi, psi, beta, vocab_size: int) -> Tuple[torch.Tensor, ...]:
    """Stale word-proposal tables from a Φ snapshot.

    phi [..., rows, K] int32, psi [K] or [..., K] int32 → (wq, wp, wa), each
    shaped like phi, with wq = (φ+β)/(ψ+Vβ): the LightLDA word proposal
    including its denominator. wq is filled ``TABLE_ROWS`` rows at a time, so
    its temporary stays small at full width; the Walker tables of a whole
    shard are then built in one ``build_alias`` call (one kernel launch on
    the card).
    """
    dev = phi.device
    rows, K = phi.shape[-2:]
    phi3 = phi.reshape(-1, rows, K)
    beta = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    vb = torch.tensor(float(vocab_size), dtype=torch.float32, device=dev) * beta
    den = (psi.to(torch.float32).reshape(-1, K) + vb).expand(phi3.shape[0], K)
    wq = torch.empty(phi3.shape, dtype=torch.float32, device=dev)
    wp = torch.empty_like(wq)
    wa = torch.empty(phi3.shape, dtype=torch.int32, device=dev)
    for s in range(phi3.shape[0]):
        for lo in range(0, rows, TABLE_ROWS):
            sl = slice(lo, min(lo + TABLE_ROWS, rows))
            torch.div(phi3[s, sl].to(torch.float32) + beta, den[s], out=wq[s, sl])
        alias_ops.build_alias(wq[s], out=(wp[s], wa[s]))
    return wq.view(phi.shape), wp.view(phi.shape), wa.view(phi.shape)


def make_alpha_table(alpha):
    """α alias table (ap [K] f32, aa [K] int32), rebuilt whenever α moves."""
    ap, aa = alias_ops.build_alias(alpha[None, :].to(torch.float32))
    return ap[0], aa[0]


def make_tables(phi, psi, alpha, beta, vocab_size: int) -> AliasTables:
    wq, wp, wa = make_word_tables(phi, psi, beta, vocab_size)
    ap, aa = make_alpha_table(alpha)
    return AliasTables(wq, wp, wa, ap, aa)


# ------------------------------------------------------------ block MH ------


def move_counts(phi, psi, w, z_old, z_new, delta):
    """Move ``delta`` [T] int32 of each token's count from z_old to z_new in
    ``phi`` [rows, K] and ``psi`` [K], in place (int32 accumulation, exact in
    any order)."""
    w, zo, zn = w.long(), z_old.long(), z_new.long()
    phi.index_put_((w, zo), -delta, accumulate=True)
    phi.index_put_((w, zn), delta, accumulate=True)
    psi.index_put_((zo,), -delta, accumulate=True)
    psi.index_put_((zn,), delta, accumulate=True)


def sample_block_mh(phi, psi, doc_topic, doc_count, z, w, dloc, token_uid, alpha,
                    beta, seed: int, vocab_size: int, tables: AliasTables,
                    n_mh: int = 4):
    """One alias-MH sweep over a token block, ``sample_block``'s sparse mirror:
    every token sees the block-start counts with exact self-exclusion, and the
    deltas land at block end. ``phi`` [rows, K] and ``psi`` [K] int32 are
    updated in place. Returns (z_new, phi, psi, doc_topic', doc_count')."""
    z_new = alias_ops.mh_resample(
        phi, psi, doc_topic, doc_count, tables.wq, tables.wp, tables.wa, alpha,
        tables.ap, tables.aa, w, dloc, z, token_uid, seed, beta, vocab_size, n_mh)
    move_counts(phi, psi, w, z, z_new, torch.ones_like(z_new))
    doc_topic, doc_count = apply_deltas(
        doc_topic, doc_count, dloc, z, z_new,
        torch.ones(z.shape, dtype=torch.bool, device=z.device))
    return z_new, phi, psi, doc_topic, doc_count
