"""Plain PyTorch versions of EmbeddingBag (port of ``repro.kernels.embedding_bag.ref``).

The padded form is the same gather + weighted ``einsum`` in the table's dtype
as the JAX oracle, with the weights cast to that dtype, so it rounds the
weights where the CUDA kernel (``csrc/embedding_bag.cu``) keeps them in f32:
the two agree within the JAX test's tolerances, and bit for bit for bags of
one row with weight 1.

``embedding_bag_padded_bwd_ref`` is the gradient of the padded form with
respect to the table, by rows, in the order the CUDA kernel
(``csrc/embedding_bag_bwd.cu``) sums: the two agree bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def embedding_bag_padded_ref(table, ids, weights=None, combiner: str = "sum"):
    """Padded multi-hot bags: ids [B, F] (padding rows carry weight 0).

    out[b] = combine_f weights[b,f] * table[ids[b,f]]
    """
    rows = table[ids.long()]                                # [B, F, D]
    if weights is None:
        weights = torch.ones(ids.shape, dtype=table.dtype, device=table.device)
    out = torch.einsum("bfd,bf->bd", rows, weights.to(table.dtype))
    if combiner == "mean":
        denom = torch.clamp(weights.sum(dim=1, keepdim=True), min=1e-9)
        out = out / denom.to(table.dtype)
    return out


def embedding_bag_ragged_ref(table, flat_ids, segment_ids, n_bags: int,
                             weights=None, combiner: str = "sum"):
    """Ragged bags: flat_ids [L], segment_ids [L] (which bag), via
    ``index_select`` + ``index_add_`` (JAX's take + segment_sum).

    For the CPU only: a float ``index_add_`` on a CUDA tensor adds in an order
    that changes from run to run, and no caller in the port runs it there.
    """
    rows = table.index_select(0, flat_ids.long())           # [L, D]
    if weights is not None:
        rows = rows * weights[:, None].to(table.dtype)
    seg = segment_ids.long()
    out = torch.zeros((n_bags, table.shape[1]), dtype=table.dtype,
                      device=table.device).index_add_(0, seg, rows)
    if combiner == "mean":
        ones = torch.ones(flat_ids.shape[0], dtype=table.dtype, device=table.device) \
            if weights is None else weights.to(table.dtype)
        denom = torch.zeros(n_bags, dtype=table.dtype,
                            device=table.device).index_add_(0, seg, ones)
        out = out / torch.clamp(denom, min=1e-9)[:, None]
    return out


def row_runs(ids):
    """Group the flat items n = b·F + f of ids [B, F] by id: (order [N] int64,
    the items sorted by id, stable, so ascending n within an id; rows [U]
    int64, the distinct ids ≥ 0 ascending; starts [U + 1] int64, where each
    row's run begins in ``order`` and, last, N). An id −1 is padding: its
    items sort first and belong to no run, so they add to no row's gradient
    (DIN's history; the caller masks what they read). Ids below −1 are not
    allowed (the plain version checks). Index bookkeeping, on the ids'
    device: one −1 put before the items makes a padding run always there to
    drop, so no host read decides whether there is one (the only sync is
    ``unique_consecutive``'s size)."""
    flat = torch.cat([ids.new_full((1,), -1), ids.reshape(-1)])
    sorted_ids, order = torch.sort(flat, stable=True)    # order[0] = 0, the added −1
    rows, counts = torch.unique_consecutive(sorted_ids, return_counts=True)
    return order[1:] - 1, rows[1:].long(), torch.cumsum(counts, 0) - 1


def bag_denominators(weights, B: int, F: int, device):
    """max(Σ_f w[b, f], 1e-9) [B] f32, summed in the order f = 0 … F−1 (the
    forward kernel's order); F with no weights."""
    if weights is None:
        return torch.full((B,), float(F), dtype=torch.float32, device=device).clamp(min=1e-9)
    denom = torch.zeros(B, dtype=torch.float32, device=device)
    for f in range(F):
        denom = denom + weights[:, f]
    return denom.clamp(min=1e-9)


def embedding_bag_padded_bwd_ref(grad_out, ids, weights=None, combiner: str = "sum",
                                 n_rows: int = None):
    """Gradient of ``embedding_bag_padded_ref`` with respect to the table, by
    rows: grad_out [B, D] (f32 or bf16), ids [B, F], weights [B, F] f32 or
    None (ones) → (rows [U] int64, the distinct ids ascending; row_grad
    [U, D] f32).

    row_grad[u] = Σ over the (b, f) with ids[b, f] = rows[u], in ascending
    (b, f) order, of t = float(grad_out[b]), divided by the bag's
    ``bag_denominators`` under ``mean``, times w[b, f] if there are weights;
    the sum in f32 from 0. Ids −1 are padding and add to no row
    (``row_runs``), ids below −1 raise. The CUDA kernel makes the same
    operations in the same order. ``n_rows``: ids must lie below it (checked
    here).
    """
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner must be 'sum' or 'mean', got {combiner!r}")
    if ids.numel() and int(ids.min()) < -1:
        raise IndexError("padding ids must be -1")
    order, rows, starts = row_runs(ids)
    if rows.numel() and n_rows is not None and int(rows[-1]) >= n_rows:
        raise IndexError(f"ids outside [0, {n_rows})")
    return rows, embedding_bag_bwd_runs_ref(grad_out, order, starts, ids.shape[1], weights,
                                            combiner)


def embedding_bag_bwd_runs_ref(grad_out, order, starts, F: int, weights=None,
                               combiner: str = "sum"):
    """The row sums of ``embedding_bag_padded_bwd_ref`` on runs already
    grouped by ``row_runs`` → row_grad [U, D] f32 (the plain version of the
    CUDA kernel alone)."""
    B, D = grad_out.shape
    dev = grad_out.device
    U = starts.numel() - 1
    g = grad_out.float()
    if combiner == "mean":
        g = g / bag_denominators(weights, B, F, dev)[:, None]
    w = None if weights is None else weights.reshape(-1)
    # the runs longest first, so the runs still adding at depth k are a prefix
    counts = starts[1:] - starts[:-1]
    by_len = torch.argsort(counts, descending=True, stable=True)
    first = starts[:-1][by_len]
    counts_host = counts[by_len].cpu().numpy()
    acc = torch.zeros((U, D), dtype=torch.float32, device=dev)
    depth = int(counts_host[0]) if U else 0
    live = U - np.cumsum(np.bincount(counts_host, minlength=depth + 1))  # runs longer than k
    for k in range(depth):
        a = int(live[k])
        pos = order[first[:a] + k]
        t = g[pos // F]
        if w is not None:
            t = w[pos][:, None] * t
        acc[:a] = acc[:a] + t
    row_grad = torch.empty_like(acc)
    row_grad[by_len] = acc
    return row_grad
