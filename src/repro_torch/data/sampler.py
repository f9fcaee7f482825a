"""Graph containers + a real uniform neighbor sampler (GraphSAGE fanouts),
copied from ``repro.data.sampler`` (numpy only: the same seed gives the same
arrays, the same numpy calls in the same order).

``NeighborSampler`` samples k-hop frontiers from a CSR adjacency with
per-layer fanouts, producing the padded bipartite blocks that
``repro_torch.models.gnn.forward_sampled`` consumes. Sampling is host-side numpy (it is
data-dependent control flow — exactly the part XLA cannot express), batched
and reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Graph:
    """CSR adjacency. indptr [N+1], indices [E] (dst-sorted neighbor lists)."""

    indptr: np.ndarray
    indices: np.ndarray
    feats: np.ndarray        # [N, d]
    labels: np.ndarray       # [N]

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)

    def edge_list(self) -> Tuple[np.ndarray, np.ndarray]:
        dst = np.repeat(np.arange(self.n_nodes), np.diff(self.indptr))
        return self.indices.astype(np.int32), dst.astype(np.int32)


def random_graph(seed: int, n_nodes: int, avg_degree: int, d_feat: int,
                 n_classes: int, feature_signal: float = 1.0) -> Graph:
    """Power-law-ish random graph whose labels correlate with features and
    neighborhoods (so GNN training measurably learns)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes)
    centers = rng.normal(size=(n_classes, d_feat))
    feats = centers[labels] * feature_signal + rng.normal(size=(n_nodes, d_feat))
    # homophilous edges: prefer same-label endpoints
    n_edges = n_nodes * avg_degree
    src = rng.integers(0, n_nodes, n_edges * 2)
    dst = rng.integers(0, n_nodes, n_edges * 2)
    same = labels[src] == labels[dst]
    keep = same | (rng.uniform(size=len(src)) < 0.3)
    src, dst = src[keep][:n_edges], dst[keep][:n_edges]
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, dst + 1, 1)
    indptr = np.cumsum(indptr)
    return Graph(indptr=indptr, indices=src.astype(np.int32),
                 feats=feats.astype(np.float32), labels=labels.astype(np.int32))


class NeighborSampler:
    def __init__(self, graph: Graph, fanouts: Sequence[int], seed: int = 0):
        self.g = graph
        self.fanouts = list(fanouts)
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray):
        """Returns (feats_per_level, neigh_per_level, labels).

        feats[l] — [n_l, d] features of level-l nodes (level 0 = seeds);
        neigh[l] — [n_l, fanout_l] indices into level l+1 (-1 pad for nodes
        with fewer neighbors than the fanout).
        """
        levels = [np.asarray(seeds, np.int64)]
        neigh: List[np.ndarray] = []
        for fan in self.fanouts:
            cur = levels[-1]
            nb = np.full((len(cur), fan), -1, np.int64)
            nxt: List[int] = []
            for i, node in enumerate(cur):
                lo, hi = self.g.indptr[node], self.g.indptr[node + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(fan, deg)
                picks = self.g.indices[
                    lo + self.rng.choice(deg, size=take, replace=deg < fan)
                ] if deg >= fan else self.g.indices[lo:hi]
                for j, p in enumerate(picks):
                    nb[i, j] = len(nxt)
                    nxt.append(int(p))
            levels.append(np.array(nxt, np.int64) if nxt else np.zeros(1, np.int64))
            neigh.append(nb)
        feats = [self.g.feats[lv] for lv in levels]
        # remap neigh indices: they already index into the *flattened* next level
        return feats, [n.astype(np.int32) for n in neigh], self.g.labels[levels[0]]
