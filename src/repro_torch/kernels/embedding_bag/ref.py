"""Plain PyTorch versions of EmbeddingBag (port of ``repro.kernels.embedding_bag.ref``).

The padded form is the same gather + weighted ``einsum`` in the table's dtype
as the JAX oracle, with the weights cast to that dtype, so it rounds the
weights where the CUDA kernel (``csrc/embedding_bag.cu``) keeps them in f32:
the two agree within the JAX test's tolerances, and bit for bit for bags of
one row with weight 1.
"""
from __future__ import annotations

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
