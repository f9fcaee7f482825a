"""Dispatch of EmbeddingBag by the device of its tensors (port of
``repro.kernels.embedding_bag.ops``).

CPU tensors go to the plain version (``ref.py``); CUDA tensors go to the
hand-written kernel (``kernel.py``), which raises if it cannot launch. There
is no fallback from one to the other. The ragged form stays plain, as in JAX.
"""
from __future__ import annotations

from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import (
    embedding_bag_padded_ref,
    embedding_bag_ragged_ref,
)

# CUDA kernel launches made through ``embedding_bag``; callers reset it to 0
# to count the launches of one run.
launches = 0


def embedding_bag(table, ids, weights=None, combiner: str = "sum"):
    """Padded multi-hot lookup: table [V, D], ids [B, F] int32, weights
    [B, F] f32 or None (ones) → [B, D] in the table's dtype."""
    global launches
    if table.device.type == "cpu":
        return embedding_bag_padded_ref(table, ids, weights, combiner)
    out = embedding_bag_cuda(table, ids, weights, combiner)
    launches += 1
    return out


def embedding_bag_ragged(table, flat_ids, segment_ids, n_bags: int,
                         weights=None, combiner: str = "sum"):
    """Ragged form: index_select + index_add_ (the CPU only; see ``ref``)."""
    return embedding_bag_ragged_ref(table, flat_ids, segment_ids, n_bags, weights,
                                    combiner)
