"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``repro.models.moe``).

Dispatch: flatten the (token, k) pairs, sort them by expert id (stable),
take each pair's position within its expert from a ``searchsorted``, drop
the pairs beyond capacity C = ceil(T·k/E) · capacity_factor, sum the token
activations into an [E·C + 1, d] buffer (the last row takes the dropped
pairs), run a grouped SwiGLU per expert, gather back and combine with the
router gates. JAX's two scatter-adds (``buf.at[slot].add``,
``out.at[t_sorted].add``) are ``segment_sum`` and its gathers
``gather_rows``: the row-gradient kernel sums in one fixed order, forward
and backward, where a CUDA ``index_add_`` would add in an order that changes
from run to run.

The top-k is a stable descending sort of the router's probabilities, so
ties go to the lowest expert, as ``lax.top_k``'s do.

Shared experts (qwen2-moe): a dense SwiGLU over all tokens, summed with the
routed output.

Across ranks (``layout``) the dispatch stays JAX's, global over the
microbatch's T tokens: the rank's token rows are all-gathered over "dp", so
every rank routes all T (the router replicated), and the capacity C, the
dropped pairs (the stable order by expert, then global token) and the
auxiliary loss are the one-rank ones. Under ``moe_shard="expert"`` a
"model" rank runs the slots of its E/M experts (``sharding.lm_param_specs``:
experts over "model"), under ``"ffn"`` its d_ff/M columns of every expert;
the shared experts split as the dense FFN (FSDP over "data", columns then
rows over "model"). The partial outputs of the rank's own rows are summed
over "model". Every rank computes the same auxiliary loss; its gradient is
scaled by 1/dp, because the "dp" ranks' gradients of the gathered tokens
and of the router are summed.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as coll
from repro_torch.kernels.embedding_bag import ops as bag_ops


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0           # total shared-expert hidden width
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_shard: str = "expert"      # "expert" | "ffn"


def moe_params_shape(cfg: MoEConfig, d_model: int):
    """Shapes for one layer's MoE params (see transformer.init_params for dtypes)."""
    e, f = cfg.n_experts, cfg.d_ff_expert
    shapes = {
        "router": (d_model, e),
        "w1": (e, d_model, f),
        "w3": (e, d_model, f),
        "w2": (e, f, d_model),
    }
    if cfg.n_shared_experts:
        fs = cfg.d_ff_shared
        shapes.update({"sw1": (d_model, fs), "sw3": (d_model, fs), "sw2": (fs, d_model)})
    return shapes


def capacity(T: int, cfg: MoEConfig) -> int:
    """C = int(max(1, ceil(T·k / E) · capacity_factor)), JAX's expression."""
    return int(max(1, -(-T * cfg.top_k // cfg.n_experts) * cfg.capacity_factor))


def route(x, router, cfg: MoEConfig):
    """The router: (probs [T, E] f32, gate [T, k] f32 renormalised, expert
    [T, k] int64), the top-k by a stable descending sort."""
    logits = x.to(torch.float32) @ router.to(torch.float32)          # [T, E]
    probs = torch.softmax(logits, dim=-1)
    expert = torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices
    expert = expert[:, :cfg.top_k].contiguous()
    gate = torch.gather(probs, 1, expert)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, expert


def aux_loss(probs, expert, cfg: MoEConfig):
    """The load-balance auxiliary loss (Switch/GShard style) of the T routed
    tokens: weight · E · Σ_e mean prob(e) · share of the pairs sent to e."""
    T, E = probs.shape
    me = probs.mean(dim=0)
    ce = torch.bincount(expert.reshape(-1), minlength=E).to(torch.float32) / (T * cfg.top_k)
    return cfg.router_aux_weight * E * torch.sum(me * ce)


def dispatch(expert, T: int, C: int, E: int):
    """The sort-based dispatch of the flattened (token, k) pairs → (order,
    t_sorted, keep, slot) [T·k]: the pairs in stable order of their expert,
    their tokens, whether each is within capacity, and its row of the
    [E·C + 1, d] buffer (E·C for a dropped pair)."""
    k = expert.shape[1]
    flat_e = expert.reshape(-1)
    flat_t = torch.arange(T, device=expert.device).repeat_interleave(k)
    order = torch.sort(flat_e, stable=True).indices
    e_sorted = flat_e[order]
    t_sorted = flat_t[order]
    pos = torch.arange(T * k, device=expert.device) - torch.searchsorted(
        e_sorted, e_sorted, side="left")
    keep = pos < C
    slot = torch.where(keep, e_sorted * C + pos, torch.full_like(pos, E * C))
    return order, t_sorted, keep, slot


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, scale):
        ctx.scale = scale
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def moe_ffn(params, x, cfg: MoEConfig, layout=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, d] → (out [T, d], aux_loss []). T = flattened tokens. Across
    ranks (``layout``): x is the rank's rows of the microbatch (its "dp"
    block, the same on every "model" rank), ``params`` the rank's views with
    the shared experts' weights gathered over "data" (``transformer``'s
    ``layer_weights``); out is those rows' output."""
    if layout is not None:
        return _moe_ffn_ranks(params, x, cfg, layout)
    T, d = x.shape
    E = cfg.n_experts
    C = capacity(T, cfg)

    probs, gate, expert = route(x, params["router"], cfg)
    aux = aux_loss(probs, expert, cfg)

    # ---- sort-based dispatch -------------------------------------------------
    order, t_sorted, keep, slot = dispatch(expert, T, C, E)
    g_sorted = torch.gather(gate.reshape(-1), 0, order)
    buf = bag_ops.segment_sum(bag_ops.gather_rows(x, t_sorted), slot, E * C + 1)
    h = buf[:E * C].reshape(E, C, d)
    del buf

    # ---- grouped expert SwiGLU ----------------------------------------------
    # one expression, and h dropped before the last GEMM: without autograd
    # (serving) each [E, C, ·] temporary is freed as soon as it is used
    hmid = F.silu(torch.bmm(h, params["w1"])) * torch.bmm(h, params["w3"])
    del h
    out_e = torch.bmm(hmid, params["w2"]).reshape(E * C, d)

    # ---- combine --------------------------------------------------------------
    gathered = bag_ops.gather_rows(out_e, torch.clamp(slot, max=E * C - 1))
    gathered = torch.where(keep[:, None], gathered, torch.zeros((), dtype=gathered.dtype,
                                                                  device=x.device))
    out = bag_ops.segment_sum((gathered.to(torch.float32) * g_sorted[:, None]).to(x.dtype),
                              t_sorted, T)

    if cfg.n_shared_experts:
        shared = (F.silu(x @ params["sw1"]) * (x @ params["sw3"])) @ params["sw2"]
        out = out + shared
    return out, aux


def _moe_ffn_ranks(params, x, cfg: MoEConfig, layout):
    rows, d = x.shape
    n_dp, M = layout.pods * layout.data, layout.model
    xg = coll.all_gather_rows(x, layout, "dp") if n_dp > 1 else x        # [T, d], global order
    T = xg.shape[0]
    E = cfg.n_experts
    C = capacity(T, cfg)

    probs, gate, expert = route(xg, params["router"], cfg)
    aux = aux_loss(probs, expert, cfg)
    if n_dp > 1 and torch.is_grad_enabled() and aux.requires_grad:
        aux = _GradScale.apply(aux, 1.0 / n_dp)

    order, t_sorted, keep, slot = dispatch(expert, T, C, E)
    g_sorted = torch.gather(gate.reshape(-1), 0, order)
    if M > 1:       # the rank's pairs, experts or columns: their partials summed backward
        xg, g_sorted = coll.grad_psum(xg, layout, "model"), coll.grad_psum(g_sorted, layout,
                                                                           "model")
    # the rank's experts [e0, e0 + E_loc): all of them under "ffn"
    E_loc = params["w1"].shape[0]
    e0 = layout.model_index * E_loc if E_loc < E else 0
    mine = keep & (slot >= e0 * C) & (slot < (e0 + E_loc) * C)
    slot = torch.where(mine, slot - e0 * C, torch.full_like(slot, E_loc * C))
    buf = bag_ops.segment_sum(bag_ops.gather_rows(xg, t_sorted), slot, E_loc * C + 1)
    h = buf[:E_loc * C].reshape(E_loc, C, d)
    del buf
    hmid = F.silu(torch.bmm(h, params["w1"])) * torch.bmm(h, params["w3"])
    del h
    out_e = torch.bmm(hmid, params["w2"]).reshape(E_loc * C, d)

    gathered = bag_ops.gather_rows(out_e, torch.clamp(slot, max=E_loc * C - 1))
    gathered = torch.where(mine[:, None], gathered, torch.zeros((), dtype=gathered.dtype,
                                                                   device=x.device))
    out = bag_ops.segment_sum((gathered.to(torch.float32) * g_sorted[:, None]).to(x.dtype),
                              t_sorted, T)
    if n_dp > 1:                                                  # the rank's own rows
        i = coll.group_index(layout, "dp")
        out = out[i * rows:(i + 1) * rows]

    if cfg.n_shared_experts:
        xs = coll.grad_psum(x, layout, "model") if M > 1 else x
        out = out + (F.silu(xs @ params["sw1"]) * (xs @ params["sw3"])) @ params["sw2"]
    if M > 1:
        out = coll.psum(out, layout, "model")
    return out, aux
