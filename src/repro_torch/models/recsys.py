"""RecSys models: DLRM, xDeepFM, DIN, AutoInt (port of ``repro.models.recsys``).

Plain functions over a dict of tensors whose keys are the JAX package's
parameter names (``"table"``, ``"bot/w0"``, …). All tables of a model are
concatenated into ONE [padded_rows, dim] tensor with per-field offsets, so a
single gather serves every field.

Tables may be f32 or bf16 (the serving cells store them in bf16); dense
parameters are f32. JAX promotes a bf16 embedding meeting an f32 activation
to f32; here every such meeting casts explicitly.

``lookup_sharded`` is the row-sharded lookup across ranks: each rank holds a
contiguous row slice of the table, gathers the ids that land in it and one
``all_reduce`` over the ``"model"`` group reassembles the rows.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
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


def lookup_sharded(table_shard: torch.Tensor, spec: EmbeddingSpec, ids: torch.Tensor,
                   layout, axis: str = "model") -> torch.Tensor:
    """Row-sharded lookup: mask + local gather + one ``all_reduce``.

    ``table_shard`` [rows/M, D] is this rank's contiguous row slice
    (``sharding.row_slice`` over ``axis`` of ``layout``, a
    :class:`repro_torch.dist.sharding.RankLayout`); ``ids`` [B, F] are
    per-field local ids, the same on every rank of the group. Rows outside
    the slice contribute zeros and the sum over ``axis`` reassembles the
    exact rows, since each id lives on one rank: [B, F, D] in the table's
    dtype, on every rank. A collective over ``axis``. The JAX package's
    ``jnp.take`` is a plain gather outside any kernel, and so is this
    ``index_select``. The sum runs in the table's dtype (gloo and NCCL
    reduce bf16); one row plus zeros is exact in any dtype.
    """
    from repro_torch.dist import collectives as coll

    rows_local = table_shard.shape[0]
    lo = coll.group_index(layout, axis) * rows_local
    local = _flat_ids(spec, ids).long() - lo
    hit = (local >= 0) & (local < rows_local)
    rows = table_shard.index_select(0, local.clamp(0, rows_local - 1).reshape(-1))
    rows = torch.where(hit[..., None], rows.view(*ids.shape, -1), 0)
    return coll.all_reduce_(rows, layout, axis)


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


def dlrm_forward(cfg: DLRMConfig, params, dense, sparse_ids, table_lookup=lookup):
    emb = table_lookup(params["table"], cfg.embedding, sparse_ids)      # [B, F, D]
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


def xdeepfm_forward(cfg: XDeepFMConfig, params, sparse_ids, table_lookup=lookup):
    spec = cfg.embedding
    # every use of x0 meets an f32 weight, so JAX computes from its f32 values
    x0 = table_lookup(params["table"], spec, sparse_ids).to(F32)        # [B, F, D]
    # linear (first-order) term over raw feature ids
    flat = _flat_ids(spec, sparse_ids)
    linear = params["linear_w"][flat.long()].sum(dim=1)
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


def din_forward(cfg: DINConfig, params, target_id, hist_ids, ctx_ids):
    """target_id [B], hist_ids [B, S] (-1 pad), ctx_ids [B, n_context]."""
    item = params["item_table"]
    e_t = item.index_select(0, target_id.long())                        # [B, D]
    valid = hist_ids >= 0
    e_h = item[hist_ids.clamp_min(0).long()]                            # [B, S, D]
    et_b = e_t[:, None, :].expand(e_h.shape)
    # the difference and product round in the table's dtype, as in JAX
    a_in = torch.cat([et_b, e_h, et_b - e_h, et_b * e_h], dim=-1).to(F32)
    a = _mlp(params, "attn/", a_in, len(cfg.attn_mlp) + 1,
             act=torch.sigmoid)[..., 0]                                 # [B, S]
    a = torch.where(valid, a, torch.zeros((), dtype=a.dtype, device=a.device))
    user = torch.einsum("bs,bsd->bd", a, e_h.to(F32))                   # DIN: no softmax
    ctx_off = torch.arange(cfg.n_context, device=ctx_ids.device) * cfg.context_vocab
    ctx = params["ctx_table"][(ctx_ids.long() + ctx_off[None, :])]
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


def autoint_forward(cfg: AutoIntConfig, params, sparse_ids, table_lookup=lookup):
    # every use of x meets an f32 weight, so JAX computes from its f32 values
    x = table_lookup(params["table"], cfg.embedding, sparse_ids).to(F32)  # [B, F, D]
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


# ---------------------------------------------------------------------------
# Shared loss / init
# ---------------------------------------------------------------------------

def bce_loss(logits, labels):
    return torch.mean(
        torch.clamp_min(logits, 0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
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
