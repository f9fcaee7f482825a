"""Topic de-duplication (paper §3.3) + hyperparameter optimization
(port of ``repro.core.dedup``).

1. **Asymmetric Dirichlet prior** α_k, optimized with Minka's fixed point on
   the count histograms Ω_kn (#documents in which topic k occurs n times) and
   H_l (#documents of length l):

       α_k ← α_k · Σ_n Ω_kn [ψ(n + α_k) − ψ(α_k)] / Σ_l H_l [ψ(l + Σα) − ψ(Σα)]

2. **L1 clustering**: topics whose column distributions are closer than a
   threshold in L1 are merged (union-find over the pairwise L1 graph). This
   part is host numpy, O(K²·V), as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.lda import _host


# ---------------------------------------------------------------------------
# Coordinator statistics (paper Fig. 3: CountNtn, doc lengths)
# ---------------------------------------------------------------------------

def topic_count_histogram(doc_ids, z, valid, n_docs: int, n_topics: int,
                          max_count: int = 64) -> torch.Tensor:
    """Ω_kn [K, max_count] int32 for n in [1, max_count); counts at or above
    the cap fall into the last bin, and n = 0 contributes nothing."""
    theta = torch.zeros((n_docs, n_topics), dtype=torch.int32, device=z.device)
    theta.index_put_((doc_ids.long(), z.long()), valid.to(torch.int32),
                     accumulate=True)
    key = theta.clamp_(max=max_count - 1).long()
    key += torch.arange(n_topics, device=z.device) * max_count   # k·max_count + n
    omega = torch.bincount(key.reshape(-1), minlength=n_topics * max_count)
    omega = omega.view(n_topics, max_count).to(torch.int32)
    omega[:, 0] = 0
    return omega


def doc_length_histogram(doc_lengths, max_len: int = 512) -> torch.Tensor:
    clipped = torch.clamp(doc_lengths.long(), max=max_len - 1)
    return torch.bincount(clipped, minlength=max_len).to(torch.int32)


# ---------------------------------------------------------------------------
# OPTIMIZEHYPERPARAMS (paper Fig. 3 line 4)
# ---------------------------------------------------------------------------

def optimize_alpha(alpha, omega, doc_len_hist, n_iters: int = 20,
                   floor: float = 1e-7) -> torch.Tensor:
    """Minka fixed point on histograms. omega [K, Nmax], doc_len_hist [Lmax]."""
    dev = alpha.device
    ns = torch.arange(omega.shape[1], dtype=torch.float32, device=dev)
    ls = torch.arange(doc_len_hist.shape[0], dtype=torch.float32, device=dev)
    omega_f = omega.to(torch.float32)
    hist_f = doc_len_hist.to(torch.float32)
    digamma = torch.special.digamma
    for _ in range(n_iters):
        a0 = alpha.sum()
        num = (omega_f * (digamma(ns[None, :] + alpha[:, None])
                          - digamma(alpha)[:, None])).sum(dim=1)
        den = (hist_f * (digamma(ls + a0) - digamma(a0))).sum()
        alpha = alpha * num / torch.clamp(den, min=1e-30)
        alpha = torch.clamp(alpha, min=floor)
    return alpha


# ---------------------------------------------------------------------------
# L1 topic clustering (host numpy)
# ---------------------------------------------------------------------------

def pairwise_l1(phi, beta, block: int = 512) -> np.ndarray:
    """Pairwise L1 distance between normalized topic columns; blocked over K."""
    pvk = _host(phi).astype(np.float64) + float(beta)
    pvk = pvk / pvk.sum(axis=0, keepdims=True)      # [V, K]
    K = pvk.shape[1]
    out = np.zeros((K, K), np.float32)
    for i in range(0, K, block):
        a = pvk[:, i:i + block]
        for j in range(0, K, block):
            b = pvk[:, j:j + block]
            out[i:i + block, j:j + block] = np.abs(a[:, :, None] - b[:, None, :]).sum(axis=0)
    return out


class _UnionFind:
    def __init__(self, n):
        self.p = list(range(n))

    def find(self, x):
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[max(ra, rb)] = min(ra, rb)


def cluster_topics(phi, beta, l1_threshold: float,
                   dist: np.ndarray | None = None) -> Tuple[np.ndarray, int]:
    """Merge topics with L1 distance below threshold.

    Returns (cluster_of_topic [K], n_clusters). ``dist`` may carry a
    precomputed ``pairwise_l1`` matrix so that callers who also need
    ``duplicate_fraction`` pay the O(K²V) pass once.
    """
    d = pairwise_l1(phi, beta) if dist is None else np.asarray(dist)
    K = d.shape[0]
    uf = _UnionFind(K)
    ii, jj = np.where((d < l1_threshold) & (np.triu(np.ones_like(d), 1) > 0))
    for a, b in zip(ii, jj):
        uf.union(int(a), int(b))
    roots = np.array([uf.find(k) for k in range(K)])
    _, cluster_of = np.unique(roots, return_inverse=True)
    return cluster_of.astype(np.int32), int(cluster_of.max()) + 1


def merge_topics(phi, psi, alpha, cluster_of: np.ndarray, n_clusters: int):
    """Sum counts (and prior mass) of merged topics into cluster representatives.

    Returns tensors on ``phi``'s device (the CPU for a numpy ``phi``).
    """
    device = phi.device if isinstance(phi, torch.Tensor) else torch.device("cpu")
    phi, psi, alpha = _host(phi), _host(psi), _host(alpha)
    phi_new = np.zeros((phi.shape[0], n_clusters), phi.dtype)
    np.add.at(phi_new.T, cluster_of, phi.T)
    psi_new = np.zeros((n_clusters,), psi.dtype)
    np.add.at(psi_new, cluster_of, psi)
    alpha_new = np.zeros((n_clusters,), np.float32)
    np.add.at(alpha_new, cluster_of, alpha)
    return tuple(torch.from_numpy(x).to(device) for x in (phi_new, psi_new, alpha_new))


def duplicate_fraction(phi, beta, l1_threshold: float = 0.5,
                       dist: np.ndarray | None = None) -> float:
    """Fraction of topics that have at least one duplicate (paper: 20–40% at 10⁵).

    Accepts a precomputed ``pairwise_l1`` matrix via ``dist`` (not mutated).
    """
    d = pairwise_l1(phi, beta) if dist is None else np.array(dist, copy=True)
    np.fill_diagonal(d, np.inf)
    return float((d.min(axis=0) < l1_threshold).mean())
