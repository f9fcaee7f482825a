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

Across ranks (``layout=``, a ``RankLayout``; JAX's GSPMD split of the
cell's rows, ``sharding.gnn_rows_spec``): each rank holds a block of the
node rows and of the edges (global node ids) over every mesh axis, and the
KB-scale weights whole. A layer all_gathers h over "world" (the halo: at
random placement about every edge crosses ranks), sums its edge block's
messages into the global rows (``gather_segment_sum``) and reduce-scatters
the sums and the degrees to the owning ranks; the block aggregate of sampled
training all_gathers the next level's rows. The collectives carry their
gradients (``dist.collectives``); the losses sum over ranks with an
identity backward, so each rank's parameter gradient is its share, summed
over "world" by the cell.

Peacock applicability: none at the core (no huge sharded parameter matrix).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.dist import collectives as coll
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


def _mean_aggregate(h, src, dst, n_nodes: int, edge_chunk: int, layout=None):
    """mean over the edges (s, d) of h[s] into rows d, the edge list in
    chunks of ``edge_chunk`` summed into one accumulator. The last chunk is
    the shorter one: JAX pads it to the chunk width (``lax.scan`` takes one
    shape) with edges into a scratch row, which change no other row, so the
    port leaves them out (a rank's block of edges would pad up to a chunk
    of edges into one row). The degree is an integer count, exact in f32.
    With ``layout``: h is the rank's block of the n_nodes rows, src/dst its
    edge block (global ids); h is all_gathered, and the sums and degrees of
    the global rows reduce-scattered back to the rank's block."""
    chunk = min(edge_chunk, src.shape[0])
    if layout is not None:
        h = coll.all_gather_rows(h, layout, "world")
    acc = bag_ops.gather_segment_sum(h, src, dst, n_nodes, chunk)
    deg = torch.bincount(dst.long(), minlength=n_nodes).to(torch.float32)
    if layout is not None:
        acc = coll.reduce_scatter_rows(acc, layout, "world")
        deg = coll.reduce_scatter(deg, layout, "world")
    return acc / torch.clamp(deg, min=1.0)[:, None]


def _normalize(h):
    return h / torch.clamp(torch.linalg.vector_norm(h, dim=1, keepdim=True), min=1e-6)


def forward_full(cfg: SAGEConfig, params, x, src, dst, layout=None):
    """Full-batch forward. x [N, d_in]; edges (src, dst) [E]. With
    ``layout``: the rank's row block of x and edge block (global ids), and
    the logits of its rows."""
    h = x
    n = x.shape[0] * (1 if layout is None else layout.world_size)
    for l in range(cfg.n_layers):
        agg = _mean_aggregate(h, src, dst, n, cfg.edge_chunk, layout)
        h = h @ params[f"w_self_{l}"] + agg @ params[f"w_neigh_{l}"] + params[f"b_{l}"]
        h = _normalize(torch.relu(h))
    return h @ params["w_out"] + params["b_out"]


def forward_sampled(cfg: SAGEConfig, params, feats: Sequence[torch.Tensor],
                    neigh: Sequence[torch.Tensor], layout=None):
    """Sampled-minibatch forward over bipartite blocks.

    feats[l]  — [n_l, d_in] input features of layer-l nodes (l=0 are seeds;
                feats[L] the outermost frontier);
    neigh[l]  — [n_l, fanout_l] indices into level l+1's rows (-1 = padding).

    JAX's (rows · valid).sum(1) / max(Σ valid, 1) is ``embedding_bag`` with
    the clamped ids, the valid mask as weights and ``combiner="mean"`` (whose
    max(Σ w, 1e-9) is the same divisor: Σ valid is 0 or at least 1).
    With ``layout``: each level's rank block of rows (neigh indexing level
    l+1's global rows); level l+1 is all_gathered before each aggregate.
    """
    L = cfg.n_layers
    h = list(feats)
    for l in range(L - 1, -1, -1):
        # aggregate level l+1 → level l, for every level at depth <= l
        new_h = []
        for depth in range(l + 1):
            nb = neigh[depth]
            valid = (nb >= 0).to(torch.float32)
            nxt = h[depth + 1] if layout is None else \
                coll.all_gather_rows(h[depth + 1], layout, "world")
            agg = bag_ops.embedding_bag(nxt, nb.clamp_min(0).to(torch.int32),
                                        valid, "mean", dense_grad=True)
            hh = h[depth] @ params[f"w_self_{L-1-l}"] + agg @ params[f"w_neigh_{L-1-l}"] \
                + params[f"b_{L-1-l}"]
            new_h.append(_normalize(torch.relu(hh)))
        h = new_h
    return h[0] @ params["w_out"] + params["b_out"]


def _nll(logits, labels):
    ll = torch.log_softmax(logits, dim=-1)
    return -torch.gather(ll, 1, labels.long()[:, None])[:, 0]


def loss_full(cfg: SAGEConfig, params, x, src, dst, labels, mask, layout=None):
    """The masked mean NLL; with ``layout`` the rank's rows' sum and mask
    count summed over "world" (the sum's backward the identity)."""
    nll = _nll(forward_full(cfg, params, x, src, dst, layout), labels)
    num, den = (nll * mask).sum(), mask.sum()
    if layout is not None:
        num = coll.psum(num, layout, "world")
        den = coll.all_reduce_(den, layout, "world")
    return num / torch.clamp(den, min=1.0)


def loss_graph_pool(cfg: SAGEConfig, params, x, src, dst, graph_ids,
                    n_graphs: int, labels, layout=None):
    """Graph classification over a disjoint union of small graphs (the
    ``molecule`` shape): node logits mean-pooled per graph. A node whose
    graph id lies outside [0, n_graphs) (padding) is dropped, as JAX's
    ``segment_sum`` drops it: it goes to a scratch segment. With
    ``layout``: the rank's node rows; each graph's logit sums and node counts
    are summed over "world" (a graph may straddle ranks), and ``labels`` are
    all n_graphs on every rank."""
    node_logits = forward_full(cfg, params, x, src, dst, layout)
    seg = torch.where((graph_ids >= 0) & (graph_ids < n_graphs), graph_ids,
                      torch.full_like(graph_ids, n_graphs))
    summed = bag_ops.segment_sum(node_logits, seg, n_graphs + 1)
    counts = torch.bincount(seg.long(), minlength=n_graphs + 1).to(torch.float32)
    if layout is not None:
        summed = coll.psum(summed, layout, "world")
        counts = coll.all_reduce_(counts, layout, "world")
    logits = summed[:n_graphs] / torch.clamp(counts[:n_graphs], min=1.0)[:, None]
    return _nll(logits, labels).mean()


def loss_sampled(cfg: SAGEConfig, params, feats, neigh, labels, layout=None):
    """The mean NLL of the seeds; with ``layout`` the rank's seeds' mean ÷
    the world size, summed over "world"."""
    loss = _nll(forward_sampled(cfg, params, feats, neigh, layout), labels).mean()
    if layout is not None:
        loss = coll.psum(loss * (1.0 / layout.world_size), layout, "world")
    return loss
