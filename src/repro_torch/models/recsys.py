"""RecSys models: DLRM, xDeepFM, DIN, AutoInt (port of ``repro.models.recsys``).

Plain functions over a dict of tensors whose keys are the JAX package's
parameter names (``"table"``, ``"bot/w0"``, …). All tables of a model are
concatenated into ONE [padded_rows, dim] tensor with per-field offsets, so a
single gather serves every field.

Tables may be f32 or bf16 (the serving cells store them in bf16); dense
parameters are f32. JAX promotes a bf16 embedding meeting an f32 activation
to f32; here every such meeting casts explicitly.

Across ranks (``ShardedReads``, the forwards' ``reads``): each rank holds a
contiguous row slice of every table (``sharding.row_slice`` over
``"model"``) and a block of the batch (over the ``"dp"`` group). A read
(``lookup_sharded``, ``take_sharded``) is the masked read of the rank's
slice (``bag_ops.embedding_bag_shard``, ``take_rows_shard``) and one sum
over ``"model"`` whose backward is the identity (``collectives.psum``): the
gradient of a slice holds only its rows, summed over every data replica's
items in the global order. ``retrieval_scores_sharded`` merges the ranks'
top-k of their candidate slices.

Training (``repro_torch.configs.base.build_recsys_cell``): every table-like
parameter (``table``, xdeepfm's ``linear_w``, din's ``item_table`` and
``ctx_table``) is read through ``bag_ops.embedding_bag`` or
``bag_ops.take_rows``, once a forward, so its gradient is one coalesced
sparse tensor of the touched rows from the row-gradient kernel
(``embedding_bag_bwd``), and ``sgd_rows_`` updates those rows in place.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.dist import collectives as coll
from repro_torch.kernels.embedding_bag import ops as bag_ops

F32 = torch.float32
# rows of a table drawn at a time by ``init_params`` (2 GiB of f32 at D = 128)
TABLE_CHUNK_ROWS = 1 << 22


# ---------------------------------------------------------------------------
# Embedding substrate
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    vocab_sizes: Tuple[int, ...]      # rows per field
    dim: int

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_rows(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def padded_rows(self) -> int:
        """Row-pad to 256 so the table divides any mesh axis combination."""
        return ((self.total_rows + 255) // 256) * 256

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _offsets_on(spec: EmbeddingSpec, device: torch.device) -> torch.Tensor:
    """``spec.offsets`` as an int32 [1, F] tensor on ``device``, made once per
    (spec, device): a serving call copies nothing from the host."""
    return torch.from_numpy(spec.offsets).to(device)[None, :]


def _flat_ids(spec: EmbeddingSpec, ids: torch.Tensor) -> torch.Tensor:
    """Per-field local ids [B, F] → global table rows [B, F] int32."""
    return (ids.to(torch.int32) + _offsets_on(spec, ids.device)).contiguous()


def lookup(table: torch.Tensor, spec: EmbeddingSpec, ids: torch.Tensor) -> torch.Tensor:
    """ids [B, F] per-field local ids → [B, F, D] in the table's dtype.

    One EmbeddingBag launch with every (sample, field) its own bag of one row
    and weight 1: the bag computes 1.0·row in f32 and rounds back to the
    table's dtype, which is the row exactly, so this equals JAX's
    ``jnp.take`` bit for bit in f32 and in bf16. One id per categorical field
    is the use the TPU kernel was written for."""
    B, F = ids.shape
    flat = _flat_ids(spec, ids).reshape(B * F, 1)
    return bag_ops.embedding_bag(table, flat, None, "sum").reshape(B, F, -1)


def _batch_gather(layout):
    """Concatenation of a [B, ...] tensor's rows over the "dp" group (the
    ranks that split the batch, in their order), or None where the batch is
    whole on the rank (a group of one: nothing to gather)."""
    if len(layout.group("dp")[1]) == 1:
        return None
    return lambda t: coll.all_gather_rows(t, layout, "dp")


def _slice_start(table_shard, layout, axis: str = "model") -> int:
    return coll.group_index(layout, axis) * table_shard.shape[0]


def lookup_sharded(table_shard: torch.Tensor, spec: EmbeddingSpec, ids: torch.Tensor,
                   layout, axis: str = "model") -> torch.Tensor:
    """Row-sharded ``lookup``: the masked read of this rank's slice and one
    sum over ``axis``.

    ``table_shard`` [rows/M, D] is this rank's contiguous row slice
    (``sharding.row_slice`` over ``axis`` of ``layout``, a
    :class:`repro_torch.dist.sharding.RankLayout`); ``ids`` [B, F] are
    per-field local ids, the same on every rank of the group. The
    ``embedding_bag`` kernel reads the ids in the slice (the rest: weight 0,
    an exact zero row) and the sum over ``axis`` reassembles the exact rows,
    since each id lives on one rank: [B, F, D] in the table's dtype, on
    every rank (a collective over ``axis``; the sum runs in the table's
    dtype, as gloo and NCCL reduce bf16, and one row plus zeros is exact).
    Differentiable in the slice: its sparse row gradient, the items of the
    ranks of the "dp" group (which split the batch) summed in one pass; the
    sum's backward is the identity."""
    B, F = ids.shape
    flat = _flat_ids(spec, ids).reshape(B * F, 1)
    rows = bag_ops.embedding_bag_shard(table_shard, flat, _slice_start(table_shard, layout, axis),
                                       gather=_batch_gather(layout))
    return coll.psum(rows, layout, axis).view(B, F, -1)


def take_sharded(table_shard: torch.Tensor, ids: torch.Tensor, layout) -> torch.Tensor:
    """Row-sharded ``bag_ops.take_rows`` (ids of any shape, −1 padding reads
    row 0): ``take_rows_shard`` of this rank's slice over "model" and one sum
    over "model", as ``lookup_sharded``."""
    rows = bag_ops.take_rows_shard(table_shard, ids, _slice_start(table_shard, layout),
                                   gather=_batch_gather(layout))
    return coll.psum(rows, layout, "model")


class LocalReads:
    """The table reads of the forwards where a rank holds whole tables:
    ``lookup`` (an [B, F] id plane of an ``EmbeddingSpec``) and ``take``
    (ids of any shape)."""
    lookup = staticmethod(lookup)
    take = staticmethod(bag_ops.take_rows)


LOCAL_READS = LocalReads()


@dataclasses.dataclass(frozen=True)
class ShardedReads:
    """The table reads of one rank whose tables are row-sharded over
    "model" and whose batch is split over the "dp" group: the forwards'
    ``reads`` across ranks."""
    layout: object

    def lookup(self, table_shard, spec: EmbeddingSpec, ids):
        return lookup_sharded(table_shard, spec, ids, self.layout)

    def take(self, table_shard, ids):
        return take_sharded(table_shard, ids, self.layout)


def multi_hot_lookup(table, spec: EmbeddingSpec, ids, weights=None):
    """Padded multi-hot bags: one bag per row over its F offset ids (sum)."""
    return bag_ops.embedding_bag(table, _flat_ids(spec, ids), weights, "sum")


def _mlp_shapes(dims: Sequence[int]) -> Dict[str, tuple]:
    out = {}
    for i in range(len(dims) - 1):
        out[f"w{i}"] = (dims[i], dims[i + 1])
        out[f"b{i}"] = (dims[i + 1],)
    return out


def _mlp(params, prefix: str, x, n: int, act=torch.relu, final_act=False):
    for i in range(n):
        x = x @ params[f"{prefix}w{i}"] + params[f"{prefix}b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


# ---------------------------------------------------------------------------
# DLRM (MLPerf config) [arXiv:1906.00091]
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str
    embedding: EmbeddingSpec
    n_dense: int = 13
    bot_mlp: Tuple[int, ...] = (13, 512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)

    def param_shapes(self):
        F, D = self.embedding.n_fields, self.embedding.dim
        n_pairs = (F + 1) * F // 2
        top_in = D + n_pairs
        shapes = {"table": (self.embedding.padded_rows, D)}
        shapes.update({f"bot/{k}": v for k, v in _mlp_shapes(self.bot_mlp).items()})
        shapes.update({f"top/{k}": v for k, v in
                       _mlp_shapes((top_in,) + self.top_mlp).items()})
        return shapes


def dlrm_forward(cfg: DLRMConfig, params, dense, sparse_ids, reads=LOCAL_READS):
    emb = reads.lookup(params["table"], cfg.embedding, sparse_ids)      # [B, F, D]
    bot = _mlp(params, "bot/", dense, len(cfg.bot_mlp) - 1, final_act=True)  # [B, D]
    z = torch.cat([bot[:, None, :], emb.to(bot.dtype)], dim=1)         # [B, F+1, D]
    inter = torch.bmm(z, z.transpose(1, 2))                             # [B, F+1, F+1]
    iu, ju = torch.triu_indices(z.shape[1], z.shape[1], 1, device=z.device)
    pairs = inter[:, iu, ju]                                            # [B, n_pairs]
    x = torch.cat([bot, pairs], dim=1)
    return _mlp(params, "top/", x, len(cfg.top_mlp))[:, 0]


# ---------------------------------------------------------------------------
# xDeepFM (CIN) [arXiv:1803.05170]
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str
    embedding: EmbeddingSpec
    cin_layers: Tuple[int, ...] = (200, 200, 200)
    mlp: Tuple[int, ...] = (400, 400)

    def param_shapes(self):
        F, D = self.embedding.n_fields, self.embedding.dim
        shapes = {"table": (self.embedding.padded_rows, D),
                  "linear_w": (self.embedding.padded_rows,)}
        h_prev = F
        for i, h in enumerate(self.cin_layers):
            shapes[f"cin_w{i}"] = (h, h_prev, F)
            h_prev = h
        shapes["cin_out"] = (int(sum(self.cin_layers)), 1)
        dnn_dims = (F * D,) + self.mlp + (1,)
        shapes.update({f"dnn/{k}": v for k, v in _mlp_shapes(dnn_dims).items()})
        return shapes


def xdeepfm_forward(cfg: XDeepFMConfig, params, sparse_ids, reads=LOCAL_READS):
    spec = cfg.embedding
    # every use of x0 meets an f32 weight, so JAX computes from its f32 values
    x0 = reads.lookup(params["table"], spec, sparse_ids).to(F32)        # [B, F, D]
    # linear (first-order) term over raw feature ids
    flat = _flat_ids(spec, sparse_ids)
    linear = reads.take(params["linear_w"], flat).sum(dim=1)
    # CIN
    xl = x0
    pools = []
    for i, h in enumerate(cfg.cin_layers):
        xl = torch.einsum("bid,bjd,hij->bhd", xl, x0, params[f"cin_w{i}"])
        pools.append(xl.sum(dim=2))                                     # [B, h]
    cin = torch.cat(pools, dim=1) @ params["cin_out"]
    # DNN
    dnn = _mlp(params, "dnn/", x0.reshape(x0.shape[0], -1), len(cfg.mlp) + 1)
    return linear + cin[:, 0] + dnn[:, 0]


# ---------------------------------------------------------------------------
# DIN (target attention over user history) [arXiv:1706.06978]
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str
    n_items: int
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: Tuple[int, ...] = (80, 40)
    mlp: Tuple[int, ...] = (200, 80)
    n_context: int = 4       # extra context fields (user profile etc.)
    context_vocab: int = 10_000

    def param_shapes(self):
        D = self.embed_dim
        pad = lambda n: ((n + 255) // 256) * 256
        shapes = {
            "item_table": (pad(self.n_items), D),
            "ctx_table": (pad(self.context_vocab * self.n_context), D),
        }
        attn_dims = (4 * D,) + self.attn_mlp + (1,)
        shapes.update({f"attn/{k}": v for k, v in _mlp_shapes(attn_dims).items()})
        mlp_in = D * (2 + self.n_context)
        shapes.update({f"mlp/{k}": v for k, v in
                       _mlp_shapes((mlp_in,) + self.mlp + (1,)).items()})
        return shapes


def din_forward(cfg: DINConfig, params, target_id, hist_ids, ctx_ids, reads=LOCAL_READS):
    """target_id [B], hist_ids [B, S] (-1 pad), ctx_ids [B, n_context];
    ``reads.take``: the tables' read."""
    valid = hist_ids >= 0
    # the target and the history in one gather, so item_table has one
    # gradient; the padding (-1) reads row 0, as JAX's clamp, and is masked
    # below, so it adds nothing to row 0's gradient (take_rows skips it)
    items = torch.cat([target_id[:, None], hist_ids], dim=1)
    rows = reads.take(params["item_table"], items)                           # [B, 1 + S, D]
    e_t, e_h = rows[:, 0], rows[:, 1:]                                  # [B, D], [B, S, D]
    et_b = e_t[:, None, :].expand(e_h.shape)
    # the difference and product round in the table's dtype, as in JAX
    a_in = torch.cat([et_b, e_h, et_b - e_h, et_b * e_h], dim=-1).to(F32)
    a = _mlp(params, "attn/", a_in, len(cfg.attn_mlp) + 1,
             act=torch.sigmoid)[..., 0]                                 # [B, S]
    a = torch.where(valid, a, torch.zeros((), dtype=a.dtype, device=a.device))
    user = torch.einsum("bs,bsd->bd", a, e_h.to(F32))                   # DIN: no softmax
    ctx_off = torch.arange(cfg.n_context, dtype=torch.int32,
                           device=ctx_ids.device) * cfg.context_vocab
    ctx = reads.take(params["ctx_table"], ctx_ids + ctx_off[None, :])
    x = torch.cat([user, e_t.to(F32), ctx.reshape(ctx_ids.shape[0], -1).to(F32)], dim=1)
    return _mlp(params, "mlp/", x, len(cfg.mlp) + 1)[:, 0]


# ---------------------------------------------------------------------------
# AutoInt (self-attention over field embeddings) [arXiv:1810.11921]
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AutoIntConfig:
    name: str
    embedding: EmbeddingSpec
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32

    def param_shapes(self):
        F, D = self.embedding.n_fields, self.embedding.dim
        shapes = {"table": (self.embedding.padded_rows, D)}
        d_in = D
        for layer in range(self.n_attn_layers):
            for w in ("wq", "wk", "wv", "wres"):
                shapes[f"{w}_{layer}"] = (d_in, self.d_attn)
            d_in = self.d_attn
        shapes["out_w"] = (F * d_in, 1)
        return shapes


def autoint_forward(cfg: AutoIntConfig, params, sparse_ids, reads=LOCAL_READS):
    # every use of x meets an f32 weight, so JAX computes from its f32 values
    x = reads.lookup(params["table"], cfg.embedding, sparse_ids).to(F32)  # [B, F, D]
    H = cfg.n_heads
    for layer in range(cfg.n_attn_layers):
        q = x @ params[f"wq_{layer}"]
        k = x @ params[f"wk_{layer}"]
        v = x @ params[f"wv_{layer}"]
        B, F, Da = q.shape
        dh = Da // H
        qh = q.reshape(B, F, H, dh)
        kh = k.reshape(B, F, H, dh)
        vh = v.reshape(B, F, H, dh)
        s = torch.einsum("bfhd,bghd->bhfg", qh, kh) / math.sqrt(dh)
        att = torch.einsum("bhfg,bghd->bfhd", torch.softmax(s, dim=-1), vh)
        x = torch.relu(att.reshape(B, F, Da) + x @ params[f"wres_{layer}"])
    return (x.reshape(x.shape[0], -1) @ params["out_w"])[:, 0]


# ---------------------------------------------------------------------------
# Retrieval scoring (the retrieval_cand shape): 1 query vs 10⁶ candidates
# ---------------------------------------------------------------------------

def retrieval_scores(user_vec: torch.Tensor, cand_table: torch.Tensor,
                     top_k: int = 100, chunk: int = 131_072):
    """user_vec [B, D] vs cand_table [N, D] → (scores [B, top_k] f32, ids
    [B, top_k] int32) of the global top-k.

    Candidates are streamed in chunks with a running top-k merge, so the
    [B, N] score plane never materializes at once. Ties go to the lower
    position of the merge (the running best, then the chunk in id order), as
    ``lax.top_k``: a stable descending sort. The last chunk is padded to the
    chunk width with -inf scores, as JAX pads the table.
    """
    B, D = user_vec.shape
    N = cand_table.shape[0]
    chunk = min(chunk, N)
    dev = user_vec.device
    best_s = torch.full((B, top_k), -math.inf, dtype=F32, device=dev)
    best_i = torch.zeros((B, top_k), dtype=torch.int32, device=dev)
    for lo in range(0, N, chunk):
        s = user_vec @ cand_table[lo:lo + chunk].T                     # [B, ≤ chunk]
        if s.shape[1] < chunk:
            s = torch.cat([s, s.new_full((B, chunk - s.shape[1]), -math.inf)], dim=1)
        ids = torch.arange(lo, lo + chunk, dtype=torch.int32, device=dev)
        all_s = torch.cat([best_s, s], dim=1)
        all_i = torch.cat([best_i, ids[None, :].expand(B, chunk)], dim=1)
        top_s, pos = torch.sort(all_s, dim=1, descending=True, stable=True)
        best_s, best_i = top_s[:, :top_k], all_i.gather(1, pos[:, :top_k])
    return best_s, best_i


def retrieval_scores_sharded(user_vec: torch.Tensor, cand_shard: torch.Tensor, layout,
                             top_k: int = 100):
    """``retrieval_scores`` with the candidates row-sharded over "model"
    (``cand_shard`` this rank's slice, ``sharding.row_slice``): the rank's
    streamed top-k of its slice with global ids, an all_gather over "model"
    (each rank's min(top_k, slice rows) entries) and one stable descending
    merge in rank order, so ties go to the lower id as in one rank's top-k.
    The same (scores, ids) on every rank; with fewer than ``top_k``
    candidates in all, that many entries (one rank pads with −inf)."""
    lo = _slice_start(cand_shard, layout)
    s, i = retrieval_scores(user_vec, cand_shard, min(top_k, cand_shard.shape[0]))
    all_s = torch.cat(coll.all_gather_v(s.T.contiguous(), layout, "model")).T
    all_i = torch.cat(coll.all_gather_v((i + lo).T.contiguous(), layout, "model")).T
    top_s, pos = torch.sort(all_s, dim=1, descending=True, stable=True)
    return top_s[:, :top_k], all_i.gather(1, pos[:, :top_k])


# ---------------------------------------------------------------------------
# Shared loss / init / table update
# ---------------------------------------------------------------------------

def sgd_rows_(param: torch.Tensor, grad: torch.Tensor, lr: float) -> None:
    """p ← p − lr·g on the rows of the sparse ``grad`` only, in place, in
    ``param``'s dtype: the product lr·g rounds to that dtype, then the
    difference, as JAX's ``tab_p - lr * tab_g`` rounds in bf16 (its weakly
    typed lr is a value of the table's dtype). Equal to the dense update:
    an untouched row has g = 0 and p − lr·0 = p. ``grad``'s rows must be
    distinct (a coalesced tensor, as the row-gradient kernel returns), so
    each row is written once. On a rank of a row-sharded table ``param`` is
    the rank's slice and ``grad`` its rows (``ShardedReads``)."""
    if not (grad.is_sparse and grad.is_coalesced()):
        raise TypeError("sgd_rows_ takes the coalesced sparse gradient of the row-gradient path")
    rows = grad.indices()[0]
    lr_t = torch.tensor(lr, dtype=param.dtype, device=param.device)
    new = param.index_select(0, rows) - grad.values().to(param.dtype) * lr_t
    param.index_copy_(0, rows, new)


def bce_loss(logits, labels):
    """JAX's ``mean(max(l, 0) − l·y + log1p(exp(−|l|)))``, with JAX's
    gradient where a logit is exactly 0 (a row whose last hidden layer is all
    zero, at a zero bias): ``jnp.maximum(l, 0)`` passes nothing to l at the
    tie, as ``relu`` does (``clamp_min`` would pass 1), so such a row's
    gradient is −y on both sides."""
    return torch.mean(
        torch.relu(logits) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def init_params(cfg, generator: torch.Generator, device="cuda",
                table_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Random parameters of ``cfg`` drawn from ``generator`` (which must live
    on ``device``), by the JAX package's rule: biases 0, tables
    N(0, 1/dim), other weights N(0, 2/fan_in). Tables (names ending in
    ``table``) are stored in ``table_dtype``, drawn ``TABLE_CHUNK_ROWS`` rows
    at a time in f32 into a preallocated tensor, so the peak is the table
    plus one f32 chunk; the rest is f32."""
    dev = resolve_device(device)
    out = {}
    for name, s in sorted(cfg.param_shapes().items()):
        if name.split("/")[-1].startswith("b"):
            out[name] = torch.zeros(s, dtype=F32, device=dev)
        elif len(s) == 2 and name.endswith("table"):
            t = torch.empty(s, dtype=table_dtype, device=dev)
            scale = 1.0 / math.sqrt(s[1])
            for lo in range(0, s[0], TABLE_CHUNK_ROWS):
                n = min(TABLE_CHUNK_ROWS, s[0] - lo)
                t[lo:lo + n] = torch.randn((n, s[1]), generator=generator, device=dev) * scale
            out[name] = t
        else:
            fan_in = s[0] if len(s) >= 2 else 1
            out[name] = torch.randn(s, generator=generator, device=dev) * \
                (2.0 / max(fan_in, 1)) ** 0.5
    return out
