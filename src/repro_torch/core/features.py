"""Topic features for downstream systems (paper §5, Eq. 5; port of
``repro.core.features``).

P(v|d) = Σ_k P(v|k) P(k|d) — a V-length vector compatible with the word
vector space model; the top-N (word, weight) pairs are what Peacock injects at
the head of Weak-AND posting lists.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.rtlda import RTLDAModel, rtlda_infer_batch


def word_likelihood_topk(pvk, pkd, top_n: int = 30) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-N entries of P(v|d) = pvk @ pkd^T per document (Eq. 5).

    pvk [V, K], pkd [B, K] → (ids [B, top_n] int32, weights [B, top_n] f32).
    The product is a plain f32 matmul (TF32 stays off, PyTorch's default).
    Equal weights go to the lower word id, as in ``lax.top_k``: a stable
    descending sort keeps ties in index order, which ``torch.topk`` does not
    promise.
    """
    pvd = pkd @ pvk.T                                   # [B, V]
    w, ids = torch.sort(pvd, dim=1, descending=True, stable=True)
    return ids[:, :top_n].to(torch.int32), w[:, :top_n]


def query_topic_features(model: RTLDAModel, word_ids, seed: int = 0,
                         n_iters: int = 5, n_trials: int = 1, top_n: int = 30):
    """End-to-end serving path: RT-LDA inference → Eq. 5 → top-N features."""
    pkd = rtlda_infer_batch(model, word_ids, seed, n_iters, n_trials)
    ids, w = word_likelihood_topk(model.pvk, pkd, top_n)
    return pkd, ids, w


def make_serving_fn(n_iters: int = 5, n_trials: int = 2, top_n: int = 30,
                    device="cuda"):
    """Serving entry point: ``fn(model, word_ids, seed) -> (pkd, ids, weights)``.

    ``word_ids`` [B, bucket] (−1 padded, numpy or tensor) are moved to the
    model's device, which must be ``device``. The model is an argument, so a
    hot-swapped model of the same shape serves through the same function.
    """
    dev = resolve_device(device)

    def fn(model: RTLDAModel, word_ids, seed: int):
        if model.pvk.device.type != dev.type:
            raise ValueError(f"model is on {model.pvk.device}, serving on {dev}")
        return query_topic_features(model, torch.as_tensor(word_ids, device=model.pvk.device),
                                    seed=seed, n_iters=n_iters, n_trials=n_trials,
                                    top_n=top_n)
    return fn


def cosine_topic_similarity(pkd_a, pkd_b) -> torch.Tensor:
    """Query–document cosine similarity in topic space (the retrieval scorer)."""
    a = pkd_a / torch.linalg.norm(pkd_a, dim=-1, keepdim=True)
    b = pkd_b / torch.linalg.norm(pkd_b, dim=-1, keepdim=True)
    return a @ b.T
