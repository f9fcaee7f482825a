"""GraphSAGE [arXiv:1706.02216], mean aggregator, full-batch and sampled
(port of ``repro.models.gnn``).

Plain functions over a dict of tensors keyed by the JAX package's parameter
names. Message passing keeps JAX's edge-chunk loop and its one carried
accumulator (``gather_segment_sum``): per chunk the messages ``h[src]`` are
gathered and summed by ``dst`` by the row-gradient kernel
(``embedding_bag_bwd``) on the card, and added into the accumulator's
touched rows. The backward is the same function with src and dst swapped,
so it too sums in one fixed order and a step repeats bit for bit; autograd
keeps the edge ids, never a [chunk, d] message tensor. Sampled training's block aggregate, a
mean over each node's padded neighbor row, is the ``embedding_bag`` kernel
(``combiner="mean"``, the valid mask as weights), with a dense gradient
where the table is an activation.

Peacock applicability: none at the core (no huge sharded parameter matrix).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels.embedding_bag import ops as bag_ops


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str
    n_layers: int
    d_in: int
    d_hidden: int
    n_classes: int
    aggregator: str = "mean"
    fanouts: Tuple[int, ...] = (25, 10)     # sampling fanout per layer (outer→inner)
    edge_chunk: int = 1_048_576             # full-batch message chunk


def param_shapes(cfg: SAGEConfig) -> Dict[str, tuple]:
    shapes = {}
    d_prev = cfg.d_in
    for l in range(cfg.n_layers):
        d_out = cfg.d_hidden
        shapes[f"w_self_{l}"] = (d_prev, d_out)
        shapes[f"w_neigh_{l}"] = (d_prev, d_out)
        shapes[f"b_{l}"] = (d_out,)
        d_prev = d_out
    shapes["w_out"] = (d_prev, cfg.n_classes)
    shapes["b_out"] = (cfg.n_classes,)
    return shapes


def init_params(cfg: SAGEConfig, generator, device="cuda") -> Dict[str, torch.Tensor]:
    """Biases 0, matrices N(0, 2 / fan_in) (He), drawn from ``generator`` in
    sorted name order (JAX draws the same law from ``jax.random``; tests
    carry JAX's draw across with ``convert.gnn_params_from_numpy``)."""
    dev = resolve_device(device)
    out = {}
    for name, s in sorted(param_shapes(cfg).items()):
        if len(s) == 1:
            out[name] = torch.zeros(s, dtype=torch.float32, device=dev)
        else:
            out[name] = torch.randn(s, generator=generator, device=dev) * (2.0 / s[0]) ** 0.5
    return out


def _mean_aggregate(h, src, dst, n_nodes: int, edge_chunk: int):
    """mean over the edges (s, d) of h[s] into rows d, the edge list in
    chunks of ``edge_chunk`` summed into one accumulator (padding edges go to
    the scratch row n_nodes). The degree is an integer count, exact in f32."""
    E = src.shape[0]
    chunk = min(edge_chunk, E)
    pad = (-E) % chunk
    if pad:
        src = F.pad(src, (0, pad), value=0)
        dst = F.pad(dst, (0, pad), value=n_nodes)           # scatter to scratch row
    acc = bag_ops.gather_segment_sum(h, src, dst, n_nodes + 1, chunk)
    deg = torch.bincount(dst.long(), minlength=n_nodes + 1).to(torch.float32)
    return acc[:n_nodes] / torch.clamp(deg[:n_nodes], min=1.0)[:, None]


def _normalize(h):
    return h / torch.clamp(torch.linalg.vector_norm(h, dim=1, keepdim=True), min=1e-6)


def forward_full(cfg: SAGEConfig, params, x, src, dst):
    """Full-batch forward. x [N, d_in]; edges (src, dst) [E]."""
    h = x
    n = x.shape[0]
    for l in range(cfg.n_layers):
        agg = _mean_aggregate(h, src, dst, n, cfg.edge_chunk)
        h = h @ params[f"w_self_{l}"] + agg @ params[f"w_neigh_{l}"] + params[f"b_{l}"]
        h = _normalize(torch.relu(h))
    return h @ params["w_out"] + params["b_out"]


def forward_sampled(cfg: SAGEConfig, params, feats: Sequence[torch.Tensor],
                    neigh: Sequence[torch.Tensor]):
    """Sampled-minibatch forward over bipartite blocks.

    feats[l]  — [n_l, d_in] input features of layer-l nodes (l=0 are seeds;
                feats[L] the outermost frontier);
    neigh[l]  — [n_l, fanout_l] indices into level l+1's rows (-1 = padding).

    JAX's (rows · valid).sum(1) / max(Σ valid, 1) is ``embedding_bag`` with
    the clamped ids, the valid mask as weights and ``combiner="mean"`` (whose
    max(Σ w, 1e-9) is the same divisor: Σ valid is 0 or at least 1).
    """
    L = cfg.n_layers
    h = list(feats)
    for l in range(L - 1, -1, -1):
        # aggregate level l+1 → level l, for every level at depth <= l
        new_h = []
        for depth in range(l + 1):
            nb = neigh[depth]
            valid = (nb >= 0).to(torch.float32)
            agg = bag_ops.embedding_bag(h[depth + 1], nb.clamp_min(0).to(torch.int32),
                                        valid, "mean", dense_grad=True)
            hh = h[depth] @ params[f"w_self_{L-1-l}"] + agg @ params[f"w_neigh_{L-1-l}"] \
                + params[f"b_{L-1-l}"]
            new_h.append(_normalize(torch.relu(hh)))
        h = new_h
    return h[0] @ params["w_out"] + params["b_out"]


def _nll(logits, labels):
    ll = torch.log_softmax(logits, dim=-1)
    return -torch.gather(ll, 1, labels.long()[:, None])[:, 0]


def loss_full(cfg: SAGEConfig, params, x, src, dst, labels, mask):
    nll = _nll(forward_full(cfg, params, x, src, dst), labels)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_graph_pool(cfg: SAGEConfig, params, x, src, dst, graph_ids,
                    n_graphs: int, labels):
    """Graph classification over a disjoint union of small graphs (the
    ``molecule`` shape): node logits mean-pooled per graph. A node whose
    graph id lies outside [0, n_graphs) (padding) is dropped, as JAX's
    ``segment_sum`` drops it: it goes to a scratch segment."""
    node_logits = forward_full(cfg, params, x, src, dst)
    seg = torch.where((graph_ids >= 0) & (graph_ids < n_graphs), graph_ids,
                      torch.full_like(graph_ids, n_graphs))
    summed = bag_ops.segment_sum(node_logits, seg, n_graphs + 1)[:n_graphs]
    counts = torch.bincount(seg.long(), minlength=n_graphs + 1)[:n_graphs].to(torch.float32)
    logits = summed / torch.clamp(counts, min=1.0)[:, None]
    return _nll(logits, labels).mean()


def loss_sampled(cfg: SAGEConfig, params, feats, neigh, labels):
    return _nll(forward_sampled(cfg, params, feats, neigh), labels).mean()
