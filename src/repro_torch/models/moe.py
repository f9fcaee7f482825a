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
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

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


def moe_ffn(params, x, cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, d] → (out [T, d], aux_loss []). T = flattened tokens."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(T, cfg)

    probs, gate, expert = route(x, params["router"], cfg)
    # load-balance auxiliary loss (Switch/GShard style)
    me = probs.mean(dim=0)
    ce = torch.bincount(expert.reshape(-1), minlength=E).to(torch.float32) / (T * k)
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)

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
