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
returns it; a dense [V, D] gradient is never formed. Where the table is an
activation or a densely updated weight, ``embedding_bag(..., dense_grad=True)``
and ``gather_rows`` return the same row sums as a dense gradient instead.

``segment_sum`` is the port's deterministic float scatter-add (JAX's
``segment_sum`` / ``.at[ids].add``): each segment's rows summed in f32 in
ascending item order by the row-gradient kernel, then written once into the
distinct rows of a zero output. It and ``gather_rows`` are each other's
transpose, so neither's gradient needs an atomic add. ``gather_segment_sum``
is the two at once over chunks of edges (message passing): each chunk's
sums are added into the touched rows of one accumulator, in both passes.

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


def _dense_grad(rows, row_grad, shape, dtype):
    """The table's gradient as a dense tensor of ``shape`` and ``dtype``: the
    f32 row sums rounded once, copied into the touched rows of zeros (the
    rows are distinct, so the copy is deterministic)."""
    out = torch.zeros((shape[0], row_grad.shape[1]), dtype=dtype, device=row_grad.device)
    return out.index_copy_(0, rows, row_grad.to(dtype)).reshape(shape)


def _sparse_grad(rows, row_grad, shape, dtype):
    """The table's gradient: a coalesced sparse COO tensor of the table's
    ``shape`` and ``dtype`` (the f32 row sums rounded once) holding the
    touched rows."""
    values = row_grad.to(dtype).reshape((rows.numel(),) + tuple(shape[1:]))
    return torch.sparse_coo_tensor(rows[None], values, tuple(shape), is_coalesced=True,
                                   check_invariants=False)


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, weights, combiner, dense):
        ctx.save_for_backward(ids, weights)
        ctx.combiner, ctx.shape, ctx.dtype = combiner, tuple(table.shape), table.dtype
        ctx.dense = dense
        return _bag(table, ids, weights, combiner)

    @staticmethod
    def backward(ctx, grad_out):
        if ctx.needs_input_grad[2]:
            raise NotImplementedError("embedding_bag has no gradient with respect to the "
                                      "per-sample weights")
        ids, weights = ctx.saved_tensors
        rows, row_grad = embedding_bag_bwd(grad_out.contiguous(), ids, weights, ctx.combiner,
                                           ctx.shape[0])
        grad = (_dense_grad if ctx.dense else _sparse_grad)(rows, row_grad, ctx.shape, ctx.dtype)
        return grad, None, None, None, None


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


def embedding_bag(table, ids, weights=None, combiner: str = "sum", dense_grad: bool = False):
    """Padded multi-hot lookup: table [V, D], ids [B, F] int32, weights
    [B, F] f32 or None (ones) → [B, D] in the table's dtype. Differentiable
    in the table (the row gradient ``embedding_bag_bwd``): a sparse COO
    gradient, or with ``dense_grad`` a dense one (``_dense_grad``)."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbeddingBag.apply(table, ids, weights, combiner, dense_grad)
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


def _row_sums(rows, seg, n: int):
    """(u [U] int64 ascending, sums [U, D] f32): the distinct segments of
    ``seg`` and each one's sum of ``rows`` in ascending j, by the
    row-gradient kernel with each row a bag of one (on the CPU its plain
    version, which bounds the ids by ``n``)."""
    global bwd_launches
    ids = seg.reshape(-1, 1)
    if rows.device.type == "cpu":
        return embedding_bag_padded_bwd_ref(rows, ids, None, "sum", n)
    bwd_launches += 1
    return embedding_bag_bwd_cuda(rows, ids, None, "sum")


def _segment_sum(rows, seg, n: int):
    """The forward of ``segment_sum``, outside autograd."""
    with analysis.kernel_call("embedding_bag_bwd") as charge:
        u, sums = _row_sums(rows, seg, n)
        out = torch.zeros((n, rows.shape[1]), dtype=rows.dtype, device=rows.device)
        out.index_copy_(0, u, sums.to(rows.dtype))
        charge(bwd_bytes(rows, seg, None, u, sums) + analysis.tensor_bytes(out))
    return out


def _gather_segment_sum(x, src, dst, n: int, chunk: int):
    """The forward of ``gather_segment_sum``, outside autograd: per chunk of
    edges the rows x[src] gathered, summed by dst (``_row_sums``) and added
    into the touched rows of one accumulator (distinct rows: one
    ``index_copy_``, no atomic add)."""
    out = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    for c in range(0, src.shape[0], chunk):
        s, d = src[c:c + chunk], dst[c:c + chunk]
        with analysis.kernel_call("embedding_bag_bwd") as charge:
            rows = _gather(x, s)
            u, sums = _row_sums(rows, d, n)
            out.index_copy_(0, u, out.index_select(0, u) + sums.to(x.dtype))
            # what the function needs: each edge's source row and both ids
            # read once, the touched accumulator rows read and written once
            # (the messages' round trip through memory is this design's)
            charge(analysis.tensor_bytes(rows) + analysis.tensor_bytes(s)
                   + analysis.tensor_bytes(d) + 2 * u.numel() * x.shape[1] * x.element_size())
    return out


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, seg, n):
        ctx.save_for_backward(seg)
        return _segment_sum(rows, seg, n)

    @staticmethod
    def backward(ctx, grad_out):
        (seg,) = ctx.saved_tensors
        return gather_rows(grad_out, seg), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ids):
        ctx.save_for_backward(ids)
        ctx.n = x.shape[0]
        return _gather(x, ids)

    @staticmethod
    def backward(ctx, grad_out):
        (ids,) = ctx.saved_tensors
        D = grad_out.shape[ids.dim():]
        grad = segment_sum(grad_out.reshape(ids.numel(), -1), ids.reshape(-1), ctx.n)
        return grad.reshape((ctx.n,) + tuple(D)), None


def segment_sum(rows, seg, n: int):
    """out[i] = Σ rows[j] over the j with seg[j] = i (JAX's
    ``segment_sum(rows, seg, n)``): rows [N, D] f32 or bf16, seg [N] int in
    [0, n) (not checked on the card: that would sync the host) → [n, D] in
    the rows' dtype, each sum taken in f32 in ascending j by the row-gradient
    kernel (on the CPU its plain version, the same bits) and rounded once.
    Differentiable in the rows: the gradient is ``gather_rows(grad, seg)``."""
    seg = seg.to(torch.int32).contiguous()
    rows = rows.contiguous()
    if torch.is_grad_enabled() and rows.requires_grad:
        return _SegmentSum.apply(rows, seg, n)
    return _segment_sum(rows, seg, n)


def gather_rows(x, ids):
    """``x[ids]`` with a dense gradient: x [V, ...], ids int of any shape in
    [0, V) → [*ids.shape, ...]. The sibling of ``take_rows`` for a tensor
    that is no embedding table (an activation, or a weight updated densely):
    its gradient with respect to x is ``segment_sum(grad, ids, V)``, a dense
    [V, ...] tensor summed in one fixed order."""
    ids = ids.to(torch.int32).contiguous()
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, ids)
    return _gather(x, ids)


class _GatherSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, dst, n, chunk):
        ctx.save_for_backward(src, dst)
        ctx.v, ctx.chunk = x.shape[0], chunk
        return _gather_segment_sum(x, src, dst, n, chunk)

    @staticmethod
    def backward(ctx, grad_out):
        src, dst = ctx.saved_tensors
        return (gather_segment_sum(grad_out, dst, src, ctx.v, ctx.chunk),
                None, None, None, None)


def gather_segment_sum(x, src, dst, n: int, chunk: int):
    """out[i] = Σ x[src[e]] over the edges e with dst[e] = i (JAX's
    ``acc.at[dst].add(x[src])`` over a ``scan`` of edge chunks): x [V, D],
    src and dst [E] int → [n, D] in x's dtype. The edges go in chunks of
    ``chunk``; each chunk's rows are summed in f32 in ascending e by the
    row-gradient kernel, rounded once and added into one accumulator, so no
    [n, D] tensor is formed a chunk. Differentiable in x: its gradient is
    ``gather_segment_sum(grad, dst, src, V, chunk)``, its own transpose."""
    src = src.to(torch.int32).contiguous()
    dst = dst.to(torch.int32).contiguous()
    x = x.contiguous()
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherSegmentSum.apply(x, src, dst, n, chunk)
    return _gather_segment_sum(x, src, dst, n, chunk)


def embedding_bag_ragged(table, flat_ids, segment_ids, n_bags: int,
                         weights=None, combiner: str = "sum"):
    """Ragged form: index_select + index_add_ (the CPU only; see ``ref``)."""
    return embedding_bag_ragged_ref(table, flat_ids, segment_ids, n_bags, weights,
                                    combiner)
