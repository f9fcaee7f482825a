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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
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


def init_params(cfg: LMConfig, generator, device="cuda", dtype=torch.float32):
    """Norm scales 1, every other leaf N(0, 0.02²) in ``dtype``, drawn from
    ``generator`` leaf by leaf in ``jax.tree.leaves`` order (a large leaf in
    slices along its first dim, so no f32 copy of it is ever whole). JAX
    draws the same law from ``jax.random``; tests carry JAX's draw across
    with ``convert.lm_params_from_numpy``."""
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

    def draw(tree):
        return {k: draw(tree[k]) if isinstance(tree[k], dict) else leaf(tree[k])
                for k in sorted(tree)}

    return draw(param_shapes(cfg))


def _rms_norm(x, scale, eps):
    x32 = x.to(torch.float32)
    n = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (n * scale.to(torch.float32)).to(x.dtype)


def _ffn(cfg: LMConfig, lp, h):
    """The block's FFN on h [B, S, d] → (ff, aux)."""
    B, S, d = h.shape
    if cfg.moe is None:
        return (F.silu(h @ lp["w1"]) * (h @ lp["w3"])) @ lp["w2"], None
    mp = {kk[len("moe_"):]: vv for kk, vv in lp.items() if kk.startswith("moe_")}
    ff, aux = moe_ffn(mp, h.reshape(B * S, d), cfg.moe)
    return ff.reshape(B, S, d), aux


def _qkv(cfg: LMConfig, lp, h, positions):
    B, S, _ = h.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (h @ lp["wq"]).reshape(B, S, H, dh)
    k = (h @ lp["wk"]).reshape(B, S, KV, dh)
    v = (h @ lp["wv"]).reshape(B, S, KV, dh)
    if cfg.qk_norm:
        q = _rms_norm(q, lp["qnorm"], cfg.norm_eps)
        k = _rms_norm(k, lp["knorm"], cfg.norm_eps)
    return (attention.rope(q, positions, cfg.rope_theta),
            attention.rope(k, positions, cfg.rope_theta), v)


def _layer(cfg: LMConfig, lp, x, positions, kv_cache=None, cache_len=None):
    """One transformer block. x [B, S, d].

    Returns (x, (k_new, v_new), aux) — the fresh K/V for cache construction.
    """
    B, S, d = x.shape
    h = _rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h, positions)
    if kv_cache is None:
        att = attention.flash_attention(q, k, v, causal=True,
                                        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    else:
        k_c, v_c = kv_cache  # [B, Smax, KV, dh] with fresh k/v already inserted
        att = attention.decode_attention(q, k_c, v_c, cache_len)
    x = x + (att.reshape(B, S, cfg.n_heads * cfg.d_head) @ lp["wo"]).to(x.dtype)

    ff, aux = _ffn(cfg, lp, _rms_norm(x, lp["ln2"], cfg.norm_eps))
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + ff.to(x.dtype), (k, v), aux


def unstack(layers) -> list:
    """The stacked ``[L, ...]`` layer dict → one dict a layer (views; the
    gradient of every layer flows back into the stacked leaves at once)."""
    names = sorted(layers)
    return [dict(zip(names, vals)) for vals in zip(*(layers[n].unbind(0) for n in names))]


def forward(cfg: LMConfig, params, tokens, return_kv: bool = False):
    """tokens [B, S] → (x [B, S, d] after the final norm, the head [d, V], aux)
    and, with ``return_kv``, the layers' (k, v) stacked [L, B, S, KV, dh]."""
    B, S = tokens.shape
    x = bag_ops.gather_rows(params["embed"].to(cfg.dtype), tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []

    def body(x, lp):
        x, kv, a = _layer(cfg, lp, x, positions)
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


def lm_loss(cfg: LMConfig, params, tokens, labels):
    """Sequence-chunked cross entropy (never materializes [B, S, V] at once).
    Labels −1 are ignored."""
    x, head, aux = forward(cfg, params, tokens)
    B, S, d = x.shape
    c = min(cfg.loss_chunk, S)
    if S % c:  # pad to a chunk multiple with ignored (-1) labels
        pad = c - S % c
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
        S += pad
    head32 = head.to(torch.float32)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // c):
        xx, ll = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        logits = xx.to(torch.float32) @ head32
        lse = torch.logsumexp(logits, dim=-1)
        # the gather needs an index in range: −1 reads column 0, masked below
        gold = torch.gather(logits, -1, ll.clamp_min(0).long()[..., None])[..., 0]
        valid = (ll >= 0).to(torch.float32)
        tot = tot + ((lse - gold) * valid).sum()
        cnt = cnt + valid.sum()
    return tot / torch.clamp(cnt, min=1.0) + aux


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
def serve_step(cfg: LMConfig, params, tokens, cache, cache_len):
    """Unified serving step: C=1 is decode, C>1 is one Sarathi-style chunked-
    prefill step. tokens [B, C]; cache [L, B, Smax, KV, dh] ×2, updated in
    place (JAX donates it); cache_len (an int or a 0-d tensor) = #valid
    positions before this chunk (the chunk is written at [cache_len, +C)).

    Returns (next_tokens [B, 1] int32, last-position logits [B, V] f32, cache).
    """
    B, C = tokens.shape
    cl = int(cache_len)
    x = bag_ops.gather_rows(params["embed"].to(cfg.dtype), tokens)      # [B, C, d]
    positions = (cl + torch.arange(C, device=tokens.device))[None].expand(B, C)

    for i, lp in enumerate(unstack(params["layers"])):
        h = _rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, h, positions)
        k_c, v_c = cache["k"][i], cache["v"][i]
        k_c[:, cl:cl + C] = k.to(k_c.dtype)
        v_c[:, cl:cl + C] = v.to(v_c.dtype)
        att = attention.cached_attention(q, k_c, v_c, cl)
        x = x + (att.reshape(B, C, cfg.n_heads * cfg.d_head) @ lp["wo"]).to(x.dtype)
        ff, _ = _ffn(cfg, lp, _rms_norm(x, lp["ln2"], cfg.norm_eps))
        x = x + ff.to(x.dtype)

    x = _rms_norm(x[:, -1], params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x.to(torch.float32) @ head.to(torch.float32)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    return nxt, logits, cache


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
