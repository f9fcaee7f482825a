"""Dispatch of EmbeddingBag by the device of its tensors (port of
``repro.kernels.embedding_bag.ops``), with its gradient.

CPU tensors go to the plain versions (``ref.py``); CUDA tensors go to the
hand-written kernels (``kernel.py``), which raise if they cannot launch.
There is no fallback from one to the other. The ragged form stays plain, as
in JAX.

Where the table needs a gradient, ``embedding_bag`` and ``take_rows`` run
under a ``torch.autograd.Function`` whose backward is ``embedding_bag_bwd``:
the gradient of every touched row, summed in one fixed order (no atomics),
returned as a coalesced sparse COO tensor as ``nn.Embedding(sparse=True)``
returns it; a dense [V, D] gradient is never formed.

Under an active ``dist.analysis.count_cost`` each call is charged the bytes
its kernel must move (``bag_bytes``, ``bwd_bytes``), whichever version runs.
"""
from __future__ import annotations

import torch

from repro_torch.dist import analysis
from repro_torch.kernels.embedding_bag.kernel import embedding_bag_bwd_cuda, embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import (
    embedding_bag_padded_bwd_ref,
    embedding_bag_padded_ref,
    embedding_bag_ragged_ref,
)

# CUDA kernel launches made through ``embedding_bag`` and ``embedding_bag_bwd``;
# callers reset them to 0 to count the launches of one run.
launches = 0
bwd_launches = 0


def bag_bytes(table, ids, weights) -> float:
    """Bytes the bag must move, from shapes alone: each item's table row read
    once (a row that several items share counts once per item), the ids and
    weights read, out [B, D] written in the table's dtype."""
    B, F = ids.shape
    row = table.shape[1] * table.element_size()
    return float(B * F * (row + 4) + (0 if weights is None else B * F * 4) + B * row)


def bwd_bytes(grad_out, ids, weights, rows, row_grad) -> float:
    """Bytes the row gradient must move: grad_out, ids and weights read once,
    the touched rows [U] int64 and their gradient [U, D] f32 written once."""
    ins = (grad_out, ids) + (() if weights is None else (weights,))
    return sum(analysis.tensor_bytes(t) for t in ins + (rows, row_grad))


def _bag(table, ids, weights, combiner):
    global launches
    with analysis.kernel_call("embedding_bag") as charge:
        if table.device.type == "cpu":
            out = embedding_bag_padded_ref(table, ids, weights, combiner)
        else:
            out = embedding_bag_cuda(table, ids, weights, combiner)
            launches += 1
        charge(bag_bytes(table, ids, weights))
    return out


def embedding_bag_bwd(grad_out, ids, weights=None, combiner: str = "sum", n_rows: int = None):
    """Gradient of the padded bag with respect to the table, by rows:
    grad_out [B, D], ids [B, F] int32 → (rows [U] int64 ascending, row_grad
    [U, D] f32); see ``ref.embedding_bag_padded_bwd_ref``. ``n_rows``, the
    table's rows, bounds the ids on the CPU only (a check on the card would
    sync the host)."""
    global bwd_launches
    with analysis.kernel_call("embedding_bag_bwd") as charge:
        if grad_out.device.type == "cpu":
            out = embedding_bag_padded_bwd_ref(grad_out, ids, weights, combiner, n_rows)
        else:
            out = embedding_bag_bwd_cuda(grad_out, ids, weights, combiner)
            bwd_launches += 1
        charge(bwd_bytes(grad_out, ids, weights, *out))
    return out


def _sparse_grad(rows, row_grad, shape, dtype):
    """The table's gradient: a coalesced sparse COO tensor of the table's
    ``shape`` and ``dtype`` (the f32 row sums rounded once) holding the
    touched rows."""
    values = row_grad.to(dtype).reshape((rows.numel(),) + tuple(shape[1:]))
    return torch.sparse_coo_tensor(rows[None], values, tuple(shape), is_coalesced=True,
                                   check_invariants=False)


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, weights, combiner):
        ctx.save_for_backward(ids, weights)
        ctx.combiner, ctx.shape, ctx.dtype = combiner, tuple(table.shape), table.dtype
        return _bag(table, ids, weights, combiner)

    @staticmethod
    def backward(ctx, grad_out):
        if ctx.needs_input_grad[2]:
            raise NotImplementedError("embedding_bag has no gradient with respect to the "
                                      "per-sample weights")
        ids, weights = ctx.saved_tensors
        rows, row_grad = embedding_bag_bwd(grad_out.contiguous(), ids, weights, ctx.combiner,
                                           ctx.shape[0])
        return _sparse_grad(rows, row_grad, ctx.shape, ctx.dtype), None, None, None


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.shape, ctx.dtype = tuple(table.shape), table.dtype
        return _gather(table, ids)

    @staticmethod
    def backward(ctx, grad_out):
        (ids,) = ctx.saved_tensors
        D = ctx.shape[1] if len(ctx.shape) == 2 else 1
        rows, row_grad = embedding_bag_bwd(grad_out.reshape(-1, D).contiguous(),
                                           ids.reshape(-1, 1), None, "sum", ctx.shape[0])
        return _sparse_grad(rows, row_grad, ctx.shape, ctx.dtype), None


def embedding_bag(table, ids, weights=None, combiner: str = "sum"):
    """Padded multi-hot lookup: table [V, D], ids [B, F] int32, weights
    [B, F] f32 or None (ones) → [B, D] in the table's dtype. Differentiable
    in the table (the row gradient ``embedding_bag_bwd``)."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbeddingBag.apply(table, ids, weights, combiner)
    return _bag(table, ids, weights, combiner)


def _gather(table, ids):
    return table.index_select(0, ids.reshape(-1).clamp_min(0).long()).reshape(
        tuple(ids.shape) + tuple(table.shape[1:]))


def take_rows(table, ids):
    """``table[max(ids, 0)]`` (a plain gather, as JAX's ``jnp.take`` of the
    clamped ids): table [V, D] or [V], ids int32 of any shape in [−1, V) →
    [*ids.shape, D] or [*ids.shape]. Its gradient with respect to the table
    is ``embedding_bag_bwd`` with every id a bag of one, in ascending order
    of the flat ids. An id −1 is padding: it reads row 0 and adds nothing to
    the gradient, so the caller must mask what it reads (DIN's history),
    which makes its gradient exactly 0 in JAX too."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _TakeRows.apply(table, ids.to(torch.int32).contiguous())
    return _gather(table, ids)


def embedding_bag_ragged(table, flat_ids, segment_ids, n_bags: int,
                         weights=None, combiner: str = "sum"):
    """Ragged form: index_select + index_add_ (the CPU only; see ``ref``)."""
    return embedding_bag_ragged_ref(table, flat_ids, segment_ids, n_bags, weights,
                                    combiner)
