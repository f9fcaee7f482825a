"""LDA count-state and model math (port of ``repro.core.lda``).

Collapsed Gibbs LDA keeps ``phi`` (Φ, [V, K] word-topic counts), ``psi``
(Ψ = Σ_v Φ, [K]) and the token assignments ``z``; Θ is rebuilt on the fly from
``z`` (SparseLDA). Counts are int32 and every count scatter is an integer
``index_put_(accumulate=True)``, which gives the same sums in any order on the
card; float scatters are never used for counts.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass
class LDAState:
    """Device-resident LDA sampler state."""

    phi: torch.Tensor       # [V, K] int32 word-topic counts
    psi: torch.Tensor       # [K]    int32 topic totals (= phi.sum(0) when in sync)
    z: torch.Tensor         # [N]    int32 token topic assignments
    alpha: torch.Tensor     # [K]    f32 asymmetric doc-topic prior
    beta: torch.Tensor      # []     f32 symmetric word-topic prior

    @property
    def n_topics(self) -> int:
        return self.phi.shape[1]

    @property
    def vocab_size(self) -> int:
        return self.phi.shape[0]


def init_state(word_ids, n_topics: int, vocab_size: int, alpha0: float = 50.0,
               beta: float = 0.01, *, generator: torch.Generator | None = None,
               z0=None, device="cuda") -> LDAState:
    """Random (or given) topic init + consistent counts.

    The initial assignments come from ``z0`` when it is given (the tests pass
    the JAX package's draw), else uniformly from ``generator``; exactly one of
    the two is required. ``alpha0`` is the total prior mass: α_k = alpha0 / K.
    """
    if (generator is None) == (z0 is None):
        raise ValueError("pass exactly one of generator= and z0=")
    dev = resolve_device(device)
    word_ids = torch.as_tensor(word_ids, device=dev)
    if z0 is None:
        z = torch.randint(0, n_topics, (word_ids.shape[0],), generator=generator,
                          dtype=torch.int32, device=generator.device).to(dev)
    else:
        z = torch.as_tensor(z0, dtype=torch.int32, device=dev)
    phi, psi = build_counts(word_ids, z, n_topics, vocab_size)
    alpha = torch.full((n_topics,), alpha0 / n_topics, dtype=torch.float32, device=dev)
    return LDAState(phi=phi, psi=psi, z=z, alpha=alpha,
                    beta=torch.tensor(beta, dtype=torch.float32, device=dev))


def build_counts(word_ids, z, n_topics: int, vocab_size: int):
    """Rebuild (phi, psi) from scratch — used at init and by the invariant check."""
    one = torch.ones_like(z, dtype=torch.int32)
    phi = torch.zeros((vocab_size, n_topics), dtype=torch.int32, device=z.device)
    phi.index_put_((word_ids.long(), z.long()), one, accumulate=True)
    psi = torch.zeros((n_topics,), dtype=torch.int32, device=z.device)
    psi.index_put_((z.long(),), one, accumulate=True)
    return phi, psi


def doc_topic_counts(doc_ids, z, n_docs: int, n_topics: int) -> torch.Tensor:
    """Theta block [n_docs, K] int32 rebuilt on the fly (Θ is not stored)."""
    theta = torch.zeros((n_docs, n_topics), dtype=torch.int32, device=z.device)
    theta.index_put_((doc_ids.long(), z.long()),
                     torch.ones_like(z, dtype=torch.int32), accumulate=True)
    return theta


def phi_hat(phi: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """P̂(v|k): column-normalized smoothed topic-word distribution (paper Eq. 2).

    Normalizes in place in its own float copy, so the peak is one [V, K] f32
    beside ``phi``.
    """
    pvk = phi.to(torch.float32, copy=True)
    pvk += beta
    pvk /= pvk.sum(dim=0, keepdim=True)
    return pvk


def theta_hat(theta: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """P̂(k|d): row-normalized smoothed doc-topic distribution."""
    th = theta.to(torch.float32) + alpha[None, :]
    return th / th.sum(dim=1, keepdim=True)


# ---------------------------------------------------------------------------
# Model quality metrics
# ---------------------------------------------------------------------------

# rows of Φ per lgamma pass: at K = 10⁵ a [V, K] f32 temporary is 13 GB
# (XLA fuses the reduction and makes none)
LL_ROWS = 4096


def word_log_likelihood(phi, psi, beta) -> torch.Tensor:
    """Collapsed log p(w|z) word part (the paper's Fig. 6 LL-vs-iteration).

    log p(w|z) = K*[lnG(V*beta) - V*lnG(beta)]
                 + sum_k [ sum_v lnG(phi_vk + beta) - lnG(psi_k + V*beta) ]

    The same sum is taken term by term, each term zero where its count is:

    log p(w|z) = sum_k [ sum_v (lnG(phi_vk + beta) - lnG(beta))
                         + lnG(V*beta) - lnG(psi_k + V*beta) ]

    so in f32 it keeps the changes of a sweep at K = 10⁵, where the two
    large constants of the first form (~10¹⁰) leave an ulp of ~10³. The sum
    over v runs ``LL_ROWS`` rows of Φ at a time, so its f32 temporaries stay
    small at full width.
    """
    V, K = phi.shape
    vb = V * beta
    lg_beta = torch.lgamma(beta)
    per_topic = torch.lgamma(vb) - torch.lgamma(psi.to(torch.float32) + vb)
    for lo in range(0, V, LL_ROWS):
        rows = torch.lgamma(phi[lo:lo + LL_ROWS].to(torch.float32) + beta)
        per_topic += (rows - lg_beta).sum(dim=0)
    return per_topic.sum()


def doc_log_likelihood(doc_ids, z, alpha, n_docs: int) -> torch.Tensor:
    """Collapsed log p(z) document part."""
    K = alpha.shape[0]
    theta = doc_topic_counts(doc_ids, z, n_docs, K).to(torch.float32)
    a0 = alpha.sum()
    lengths = theta.sum(dim=1)
    per_doc = (
        torch.lgamma(a0)
        - torch.lgamma(alpha).sum()
        + torch.lgamma(theta + alpha[None, :]).sum(dim=1)
        - torch.lgamma(lengths + a0)
    )
    return per_doc.sum()


def predictive_log_prob(phi, psi, beta, alpha, word_ids, doc_ids, z,
                        n_docs: int) -> torch.Tensor:
    """Mean log p(w|d) of a (folded-in) corpus under the current model.

    perplexity = exp(-predictive_log_prob) — the Fig. 5B metric.
    """
    K = phi.shape[1]
    pvk = phi_hat(phi, beta)                                    # [V, K]
    pkd = theta_hat(doc_topic_counts(doc_ids, z, n_docs, K), alpha)   # [D, K]
    p = (pvk[word_ids.long()] * pkd[doc_ids.long()]).sum(dim=1)       # [N]
    return torch.log(torch.clamp(p, min=1e-30)).mean()


def perplexity(phi, psi, beta, alpha, word_ids, doc_ids, z, n_docs: int) -> float:
    return float(torch.exp(-predictive_log_prob(
        phi, psi, beta, alpha, word_ids, doc_ids, z, n_docs)))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def topic_pmi(phi, word_ids, doc_ids, n_docs: int, top_n: int = 10,
              eps: float = 1.0) -> np.ndarray:
    """Per-topic PMI coherence over the top-N topic words (paper Fig. 1).

    PMI(k) = mean_{i<j} log [ P(w_i, w_j) / (P(w_i) P(w_j)) ] with document-level
    co-occurrence probabilities estimated on the given corpus (host numpy).
    """
    phi, word_ids, doc_ids = _host(phi), _host(word_ids), _host(doc_ids)
    V, K = phi.shape
    top = np.argsort(-phi, axis=0)[:top_n]                      # [top_n, K]
    used = np.unique(top)
    col = {v: i for i, v in enumerate(used)}
    inc = np.zeros((n_docs, len(used)), dtype=bool)
    mask = np.isin(word_ids, used)
    inc[doc_ids[mask], [col[v] for v in word_ids[mask]]] = True
    df = inc.sum(axis=0).astype(np.float64)                     # doc freq
    co = (inc.T.astype(np.float64) @ inc.astype(np.float64))    # co-doc freq
    pmis = np.zeros(K)
    for k in range(K):
        idx = np.array([col[v] for v in top[:, k]])
        sub_co = co[np.ix_(idx, idx)]
        p_i = df[idx] / n_docs
        p_ij = (sub_co + eps / n_docs) / n_docs
        with np.errstate(divide="ignore", invalid="ignore"):
            pmi = np.log(p_ij / np.outer(p_i, p_i))
        iu = np.triu_indices(top_n, k=1)
        vals = pmi[iu]
        vals = vals[np.isfinite(vals)]
        pmis[k] = vals.mean() if vals.size else 0.0
    return pmis


def check_invariants(state: LDAState, word_ids) -> None:
    """Count-conservation invariants; ``word_ids`` and ``state.z`` hold real tokens only."""
    phi, psi = build_counts(word_ids, state.z, state.n_topics, state.vocab_size)
    if not bool(torch.equal(phi, state.phi)):
        raise AssertionError("phi counts out of sync with z")
    if not bool(torch.equal(psi, state.psi)):
        raise AssertionError("psi counts out of sync with z")
    if int(psi.sum()) != int(word_ids.shape[0]):
        raise AssertionError("total token count mismatch")
