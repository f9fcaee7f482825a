"""Decoder-only LM family: dense (llama-style) + MoE, GQA, RoPE, RMSNorm,
SwiGLU, optional qk-norm (qwen3) (port of ``repro.models.transformer``).

Params are the JAX package's dict tree, the layers stacked ``[L, ...]``
(``{"embed", "layers": {...}, "ln_f"[, "lm_head"]}``), so the sharding specs
(``dist/sharding.lm_param_specs``) and ``convert.lm_params_from_numpy`` map
name for name. JAX scans the stacked layers; the port unbinds them once and
loops, with ``torch.utils.checkpoint`` per layer for ``remat``.

The embedding lookup is ``gather_rows``: its gradient, the row sums of the
token gradients by token id, comes from the row-gradient kernel in one
fixed order and is dense, as the AdamW update of ``embed`` wants it.

Across ranks (``layout=``, a ``RankLayout`` of more than one rank) the
functions take the rank's views by ``sharding.lm_param_specs`` and its
batch rows, and compute what JAX's GSPMD-partitioned cell computes:

- FSDP over "data": each weight is all-gathered over "data" along its
  ``d_model`` dim just before its layer uses it (``layer_weights``, inside
  the layer's checkpoint, so a remat recomputes the gather); the transpose
  of the gather is a reduce-scatter, which sums the data replicas'
  gradients.
- Tensor parallelism over "model" (Megatron): wq/wk/wv/w1/w3 are column
  parallel, wo/w2 row parallel; each parallel region starts with
  ``grad_psum`` (identity forward, sum backward) and ends with ``psum``
  (sum forward, identity backward). Attention splits by heads where both
  ``n_heads`` and ``n_kv_heads`` divide the "model" axis
  (``heads_split``); otherwise the layer's attention weights are gathered
  over "model" as well and attention runs replicated on the model ranks
  (their gradient is each rank's own block). At (1, 16, 16) only
  qwen2-moe (16/16 heads) splits; minicpm-2b (36/36), smollm-135m (9/3),
  qwen3-0.6b (16/8) and phi3.5-moe (32/8) gather. At M = 2 or 4 every arch
  but smollm-135m splits, and ``small_lm`` (4/2) at M = 2.
  Every d_ff divides 16: the FFN always splits.
- The embedding is vocab-parallel (rows over "model"): the rank's rows read
  by ``take_rows_shard`` (its backward the row-gradient kernel), then a
  ``psum`` over "model". The loss is vocab-parallel cross entropy on the
  rank's logit columns (tied ``embed.T`` or ``lm_head``): the max and
  Σexp reduced over "model", the gold logit from the rank that owns it,
  ``tot`` and ``cnt`` summed over "dp" (JAX's loss is the global mean).
- Serving: the cache is sequence-sharded ([L, B/dp, S/M, KV, dh]); the
  chunk's K/V, of every head, are written into the positions the rank's
  slice owns, each slice's attention is combined over "model" by
  log-sum-exp (``attention.combine_over_model``), the logits come back
  vocab-sharded and the next token is the argmax across the model ranks,
  ties to the lowest global index.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.models import attention
from repro_torch.models.moe import MoEConfig, moe_ffn, moe_params_shape


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    remat: bool = True
    q_chunk: int = 1024
    kv_chunk: int = 1024
    loss_chunk: int = 512

    vocab_pad_multiple: int = 256

    @property
    def padded_vocab(self) -> int:
        """Megatron-style padded vocab so embedding rows divide any mesh axis."""
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def n_params(self) -> int:
        """Total parameter count (for 6·N·D model FLOPs)."""
        return int(sum(math.prod(s) for s in leaves(param_shapes(self))))

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts + shared)."""
        if self.moe is None:
            return self.n_params
        m = self.moe
        expert_p = 3 * self.d_model * m.d_ff_expert
        inactive = (m.n_experts - m.top_k) * expert_p * self.n_layers
        return self.n_params - inactive


def leaves(tree):
    """The leaves of a nested dict in sorted key order (``jax.tree.leaves``'s)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, values):
    """A nested dict of ``tree``'s structure holding ``values`` in
    ``leaves`` order (``jax.tree.unflatten``)."""
    it = iter(values)

    def build(t):
        return {k: build(t[k]) for k in sorted(t)} if isinstance(t, dict) else next(it)

    return build(tree)


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict, the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def param_shapes(cfg: LMConfig) -> Dict[str, Any]:
    L, d, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab
    H, KV, dh, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff
    layers: Dict[str, tuple] = {
        "ln1": (L, d), "ln2": (L, d),
        "wq": (L, d, H * dh), "wk": (L, d, KV * dh), "wv": (L, d, KV * dh),
        "wo": (L, H * dh, d),
    }
    if cfg.qk_norm:
        layers.update({"qnorm": (L, dh), "knorm": (L, dh)})
    if cfg.moe is None:
        layers.update({"w1": (L, d, f), "w3": (L, d, f), "w2": (L, f, d)})
    else:
        for k, s in moe_params_shape(cfg.moe, d).items():
            layers[f"moe_{k}"] = (L,) + s
    shapes = {"embed": (V, d), "layers": layers, "ln_f": (d,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, V)
    return shapes


def _is_norm(cfg: LMConfig, s: tuple) -> bool:
    return len(s) == 1 or (len(s) == 2 and s[0] == cfg.n_layers)


def init_params(cfg: LMConfig, generator, device="cuda", dtype=torch.float32, view=None):
    """Norm scales 1, every other leaf N(0, 0.02²) in ``dtype``, drawn from
    ``generator`` leaf by leaf in ``jax.tree.leaves`` order (a large leaf in
    slices along its first dim, so no f32 copy of it is ever whole). JAX
    draws the same law from ``jax.random``; tests carry JAX's draw across
    with ``convert.lm_params_from_numpy``. ``view(path, leaf)`` (path: the
    leaf's keys), if given, is applied to each leaf as soon as it is drawn
    and its result kept (a rank's block: the whole tree is never held)."""
    dev = resolve_device(device)

    def leaf(s):
        if _is_norm(cfg, s):
            return torch.ones(s, dtype=dtype, device=dev)
        out = torch.empty(s, dtype=dtype, device=dev)
        step = max(1, (1 << 28) // max(1, math.prod(s[1:])))
        for i in range(0, s[0], step):
            part = out[i:i + step]
            part.copy_(torch.randn(part.shape, generator=generator, device=dev) * 0.02)
        return out

    def draw(tree, path):
        out = {}
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                out[k] = draw(tree[k], path + (k,))
            else:
                out[k] = leaf(tree[k]) if view is None else view(path + (k,), leaf(tree[k]))
        return out

    return draw(param_shapes(cfg), ())


def _rms_norm(x, scale, eps):
    x32 = x.to(torch.float32)
    n = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (n * scale.to(torch.float32)).to(x.dtype)


def _ffn(cfg: LMConfig, lp, h, layout=None):
    """The block's FFN on h [B, S, d] → (ff, aux); across ranks the rank's
    columns, summed over "model"."""
    B, S, d = h.shape
    if cfg.moe is None:
        tp = layout is not None and layout.model > 1
        if tp:
            h = coll.grad_psum(h, layout, "model")
        ff = (F.silu(h @ lp["w1"]) * (h @ lp["w3"])) @ lp["w2"]
        return (coll.psum(ff, layout, "model") if tp else ff), None
    mp = {kk[len("moe_"):]: vv for kk, vv in lp.items() if kk.startswith("moe_")}
    ff, aux = moe_ffn(mp, h.reshape(B * S, d), cfg.moe, layout)
    return ff.reshape(B, S, d), aux


def _qkv(cfg: LMConfig, lp, h, positions):
    """q, k, v of the heads whose columns ``lp``'s weights hold (all, or the
    rank's)."""
    B, S, _ = h.shape
    dh = cfg.d_head
    q = (h @ lp["wq"]).reshape(B, S, -1, dh)
    k = (h @ lp["wk"]).reshape(B, S, -1, dh)
    v = (h @ lp["wv"]).reshape(B, S, -1, dh)
    if cfg.qk_norm:
        q = _rms_norm(q, lp["qnorm"], cfg.norm_eps)
        k = _rms_norm(k, lp["knorm"], cfg.norm_eps)
    return (attention.rope(q, positions, cfg.rope_theta),
            attention.rope(k, positions, cfg.rope_theta), v)


def heads_split(cfg: LMConfig, layout) -> bool:
    """Whether attention splits by heads over "model": both head counts
    divide the axis (else its weights are gathered over "model")."""
    M = layout.model
    return M > 1 and cfg.n_heads % M == 0 and cfg.n_kv_heads % M == 0


_ATTN = ("wq", "wk", "wv", "wo")


def layer_weights(cfg: LMConfig, lp, layout):
    """One layer's weights for the rank's compute from its views: each gathered
    over "data" along the dims its spec splits there (FSDP; the gradient is
    reduce-scattered back), and where attention does not split by heads the
    attention weights gathered over "model" too (the gradient is the rank's
    own block: every model rank repeats that compute). Where attention splits
    by heads, qnorm and knorm enter through ``grad_psum``: each rank's heads
    give part of their gradient."""
    specs = shd.lm_param_specs(cfg)["layers"]
    split = heads_split(cfg, layout)
    gather_attn = layout.model > 1 and not split
    out = {}
    for name, w in lp.items():
        spec = specs[name][1:]
        if layout.data > 1 and "data" in spec:
            w = coll.gather_dim(w, layout, "data", spec.index("data"))
        if gather_attn and name in _ATTN:
            w = coll.gather_dim(w, layout, "model", spec.index("model"), replicated=True)
        if split and name in ("qnorm", "knorm"):
            w = coll.grad_psum(w, layout, "model")
        out[name] = w
    return out


def _layer(cfg: LMConfig, lp, x, positions, kv_cache=None, cache_len=None, layout=None):
    """One transformer block. x [B, S, d].

    Returns (x, (k_new, v_new), aux) — the fresh K/V for cache construction.
    With ``kv_cache`` (the layer's (k, v) cache, [B, Smax, KV, dh] or the
    rank's slice of it) the chunk's K/V are written into it at ``cache_len``
    and the chunk attends the cache (``_cached_attention``).
    Across ranks (``layout``) ``lp`` holds the rank's views and x its rows.
    """
    B, S, d = x.shape
    if layout is not None:
        lp = layer_weights(cfg, lp, layout)
    split = layout is not None and heads_split(cfg, layout)
    h = _rms_norm(x, lp["ln1"], cfg.norm_eps)
    if split:
        h = coll.grad_psum(h, layout, "model")
    q, k, v = _qkv(cfg, lp, h, positions)
    if kv_cache is None:
        att = attention.flash_attention(q, k, v, causal=True,
                                        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    else:
        att = _cached_attention(cfg, q, k, v, kv_cache, int(cache_len), layout, split)
    o = att.reshape(B, S, -1) @ lp["wo"]
    x = x + (coll.psum(o, layout, "model") if split else o).to(x.dtype)

    ff, aux = _ffn(cfg, lp, _rms_norm(x, lp["ln2"], cfg.norm_eps), layout)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + ff.to(x.dtype), (k, v), aux


def _cached_attention(cfg: LMConfig, q, k, v, kv_cache, cl: int, layout, split: bool):
    """The chunk's K/V written into the positions [cl, cl + C) that the
    cache (one rank's: the whole of it; across ranks: the rank's slice of
    the sequence) owns, and the chunk's attention over the whole cache: one
    slice, or every "model" rank's slice combined by log-sum-exp. Where
    attention splits by heads the cache holds every head, so the ranks'
    q, k, v are gathered over "model" first and the rank keeps its heads'
    output."""
    B, C, _, dh = q.shape
    M = layout.model if layout is not None else 1
    m = layout.model_index if layout is not None else 0
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if split:
        n = (H + 2 * KV) // M
        parts = coll.all_gather(torch.cat([q, k, v], dim=2), layout, "model")
        q, k, v = (parts[:, :, :, a:b].permute(1, 2, 0, 3, 4).reshape(B, C, -1, dh)
                   for a, b in ((0, H // M), (H // M, H // M + KV // M),
                                (H // M + KV // M, n)))
    k_c, v_c = kv_cache
    S_loc = k_c.shape[1]
    off = m * S_loc                                    # the slice's first position
    lo, hi = max(cl, off), min(cl + C, off + S_loc)    # the chunk's positions in it
    if lo < hi:
        k_c[:, lo - off:hi - off] = k[:, lo - cl:hi - cl].to(k_c.dtype)
        v_c[:, lo - off:hi - off] = v[:, lo - cl:hi - cl].to(v_c.dtype)
    if M == 1:
        return attention.cached_attention(q, k_c, v_c, cl)
    o, mx, den = attention.cached_attention_partial(q, k_c, v_c, cl, off)
    att = attention.combine_over_model(o, mx, den, layout, q.dtype)
    return att[:, :, m * (H // M):(m + 1) * (H // M)] if split else att


def unstack(layers) -> list:
    """The stacked ``[L, ...]`` layer dict → one dict a layer (views; the
    gradient of every layer flows back into the stacked leaves at once)."""
    names = sorted(layers)
    return [dict(zip(names, vals)) for vals in zip(*(layers[n].unbind(0) for n in names))]


def embed(cfg: LMConfig, table, tokens, layout=None):
    """The token rows of the embedding in cfg.dtype: one rank's ``gather_rows``,
    or across ranks the rank's vocab rows (``take_rows_shard``, a dense
    gradient) summed over "model"."""
    table = table.to(cfg.dtype)
    if layout is None:
        return bag_ops.gather_rows(table, tokens)
    lo = layout.model_index * table.shape[0]
    x = bag_ops.take_rows_shard(table, tokens, lo, dense_grad=True)
    return coll.psum(x, layout, "model") if layout.model > 1 else x


def forward(cfg: LMConfig, params, tokens, return_kv: bool = False, layout=None):
    """tokens [B, S] → (x [B, S, d] after the final norm, the head [d, V], aux)
    and, with ``return_kv``, the layers' (k, v) stacked [L, B, S, KV, dh].
    Across ranks (``layout``): the rank's views and batch rows, the head its
    vocab columns."""
    B, S = tokens.shape
    x = embed(cfg, params["embed"], tokens, layout)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []

    def body(x, lp):
        x, kv, a = _layer(cfg, lp, x, positions, layout=layout)
        return (x, a) + (kv if return_kv else ())

    for lp in unstack(params["layers"]):
        if cfg.remat and torch.is_grad_enabled():
            names = sorted(lp)
            out = checkpoint(lambda x, *vals: body(x, dict(zip(names, vals))), x,
                             *(lp[n] for n in names), use_reentrant=False)
        else:
            out = body(x, lp)
        x, aux = out[0], aux + out[1]
        if return_kv:
            ks.append(out[2])
            vs.append(out[3])
    x = _rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if return_kv:
        return x, head, aux, (torch.stack(ks), torch.stack(vs))
    return x, head, aux


def lm_loss(cfg: LMConfig, params, tokens, labels, layout=None):
    """Sequence-chunked cross entropy (never materializes [B, S, V] at once).
    Labels −1 are ignored. Across ranks (``layout``): vocab-parallel on the
    rank's logit columns, the global batch's mean on every rank."""
    x, head, aux = forward(cfg, params, tokens, layout=layout)
    B, S, d = x.shape
    c = min(cfg.loss_chunk, S)
    if S % c:  # pad to a chunk multiple with ignored (-1) labels
        pad = c - S % c
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
        S += pad
    tp = layout is not None and layout.model > 1
    if tp:
        x = coll.grad_psum(x, layout, "model")
    head32 = head.to(torch.float32)
    lo = layout.model_index * head.shape[1] if layout is not None else 0
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // c):
        xx, ll = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        logits = xx.to(torch.float32) @ head32
        if tp:
            lse, gold = _vocab_parallel(logits, ll.long() - lo, layout)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            # the gather needs an index in range: −1 reads column 0, masked below
            gold = torch.gather(logits, -1, ll.clamp_min(0).long()[..., None])[..., 0]
        valid = (ll >= 0).to(torch.float32)
        tot = tot + ((lse - gold) * valid).sum()
        cnt = cnt + valid.sum()
    if layout is not None and layout.pods * layout.data > 1:
        tot = coll.psum(tot, layout, "dp")
        cnt = coll.psum(cnt, layout, "dp")
    return tot / torch.clamp(cnt, min=1.0) + aux


def _vocab_parallel(logits, local, layout):
    """(lse, gold) of a chunk's rows from the rank's logit columns [.., V/M]
    (``local``: the labels minus the rank's first column): the max over
    "model", Σexp and the gold logit (0 where another rank owns the label)
    summed over "model" in one ``psum``."""
    mx = coll.pmax(logits.amax(dim=-1), layout, "model")
    hit = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    gold = torch.where(hit, gold, torch.zeros((), dtype=gold.dtype, device=gold.device))
    se = torch.exp(logits - mx[..., None]).sum(dim=-1)
    se, gold = coll.psum(torch.stack([se, gold]), layout, "model").unbind(0)
    return mx + torch.log(se), gold


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None, device="cuda"):
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


@torch.no_grad()
def serve_step(cfg: LMConfig, params, tokens, cache, cache_len, layout=None):
    """Unified serving step: C=1 is decode, C>1 is one Sarathi-style chunked-
    prefill step. tokens [B, C]; cache [L, B, Smax, KV, dh] ×2, updated in
    place (JAX donates it); cache_len (an int or a 0-d tensor) = #valid
    positions before this chunk (the chunk is written at [cache_len, +C)).

    Returns (next_tokens [B, 1] int32, last-position logits [B, V] f32, cache).
    Across ranks (``layout``): the rank's views, batch rows and cache slice
    [L, B/dp, Smax/M, KV, dh]; the logits its vocab columns [B/dp, V/M].
    """
    B, C = tokens.shape
    cl = int(cache_len)
    x = embed(cfg, params["embed"], tokens, layout)                     # [B, C, d]
    positions = (cl + torch.arange(C, device=tokens.device))[None].expand(B, C)

    for i, lp in enumerate(unstack(params["layers"])):
        x, _, _ = _layer(cfg, lp, x, positions, (cache["k"][i], cache["v"][i]), cl, layout)

    x = _rms_norm(x[:, -1], params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x.to(torch.float32) @ head.to(torch.float32)              # [B, V] or [B, V/M]
    if layout is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], logits, cache
    return argmax_over_model(logits, layout)[:, None], logits, cache


def argmax_over_model(logits, layout) -> torch.Tensor:
    """int32 [B]: the global column of the max over every "model" rank's
    columns [B, V/M], ties to the lowest (``jnp.argmax``'s)."""
    V_loc = logits.shape[-1]
    idx = torch.argmax(logits, dim=-1)
    best = torch.gather(logits, -1, idx[:, None])[:, 0]
    idx = idx + layout.model_index * V_loc
    if layout.model == 1:
        return idx.to(torch.int32)
    top = coll.pmax(best, layout, "model")
    far = torch.full_like(idx, layout.model * V_loc)
    first = -coll.pmax(-torch.where(best == top, idx, far), layout, "model")
    return first.to(torch.int32)


def decode_step(cfg: LMConfig, params, tokens, cache, cache_len):
    """One-token decode (the C=1 special case of ``serve_step``)."""
    return serve_step(cfg, params, tokens, cache, cache_len)


@torch.no_grad()
def prefill(cfg: LMConfig, params, tokens, max_len: int):
    """Prefill: full forward, returning last-position logits + populated cache."""
    B, S = tokens.shape
    x, head, _, (k, v) = forward(cfg, params, tokens, return_kv=True)
    logits = x[:, -1].to(torch.float32) @ head.to(torch.float32)
    pad = max_len - S
    if pad > 0:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return logits, {"k": k.to(cfg.dtype), "v": v.to(cfg.dtype)}
