"""L1-regularized log-linear pCTR model (paper §5.1 baseline, [3]; port of
``repro.optim.l1_loglinear``).

The paper trains an L1-regularized logistic regression over sparse text/ad
features and, in the Peacock variant, appends the topic feature vector
P(k|d). Training is proximal SGD (soft-thresholding after each step), the
stochastic analogue of OWL-QN [3], which keeps the weight vector sparse.

The gradient comes from ``torch.autograd``. The sparse weights' gradient is
the gradient of a plain advanced-index gather (as JAX's ``logits`` gathers
with plain ``jnp`` indexing), which autograd takes as
``index_put_(accumulate=True)``: in index order on the CPU, sort-based on
CUDA, so two runs from one state give the same bits. ``dense_x @ w_dense``
and its transpose in the backward pass are f32 GEMVs; keep TF32 off
(``torch.backends.cuda.matmul.allow_tf32``, off by default).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device


class CTRState(NamedTuple):
    w_sparse: torch.Tensor    # [n_sparse] f32: indicator features (ads, pages, ...)
    w_dense: torch.Tensor     # [n_dense] f32: topic features P(k|d) (zeros if unused)
    bias: torch.Tensor        # [] f32


def init_state(n_sparse: int, n_dense: int, device="cuda") -> CTRState:
    dev = resolve_device(device)
    return CTRState(
        w_sparse=torch.zeros((n_sparse,), dtype=torch.float32, device=dev),
        w_dense=torch.zeros((n_dense,), dtype=torch.float32, device=dev),
        bias=torch.zeros((), dtype=torch.float32, device=dev),
    )


def logits(state: CTRState, sparse_ids, dense_x):
    """sparse_ids [B, F] int (-1 pad): multi-hot indicators; dense_x [B, n_dense] f32."""
    valid = (sparse_ids >= 0).to(torch.float32)
    ws = state.w_sparse[sparse_ids.clamp(min=0).long()] * valid
    return state.bias + ws.sum(dim=1) + dense_x @ state.w_dense


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _abs(x):
    """|x| whose derivative at 0 is 1, as JAX's ``abs`` (its JVP selects on
    x ≥ 0); ``torch.abs`` gives 0 there. From the zero init every logit is 0
    on the first step, so the two would part there."""
    return torch.where(x >= 0, x, -x)


def train_step(state: CTRState, sparse_ids, dense_x, labels, lr, l1):
    """One proximal SGD step on the mean stable logistic loss
    max(l, 0) − l·y + log1p(exp(−|l|)); returns (state, loss). The
    gradient takes JAX's conventions at l = 0 (max: 1/2 to each side; |l|: 1).
    ``lr`` and ``l1`` are taken as f32 scalars, as JAX traces them."""
    dev = state.bias.device
    params = [p.detach().requires_grad_(True) for p in state]
    lg = logits(CTRState(*params), sparse_ids, dense_x)
    loss = torch.mean(torch.maximum(lg, torch.zeros((), device=dev)) - lg * labels
                      + torch.log1p(torch.exp(-_abs(lg))))
    grads = torch.autograd.grad(loss, params)
    lr, l1 = _f32(lr, dev), _f32(l1, dev)
    w_sparse, w_dense, bias = (p.detach() - lr * g for p, g in zip(params, grads))
    # proximal step: soft-threshold everything except the bias
    thr = lr * l1
    shrink = lambda w: torch.sign(w) * torch.clamp(torch.abs(w) - thr, min=0.0)
    return CTRState(shrink(w_sparse), shrink(w_dense), bias), loss.detach()


def predict(state: CTRState, sparse_ids, dense_x):
    return torch.sigmoid(logits(state, sparse_ids, dense_x))


def auc(scores, labels) -> float:
    """Rank-based AUC (Mann–Whitney), ties given their average rank (host numpy)."""
    if isinstance(scores, torch.Tensor):
        scores = scores.detach().cpu().numpy()
    if isinstance(labels, torch.Tensor):
        labels = labels.detach().cpu().numpy()
    s = np.asarray(scores, np.float64)
    y = np.asarray(labels)
    order = np.argsort(s, kind="stable")
    ranks = np.empty_like(order, np.float64)
    ranks[order] = np.arange(1, len(s) + 1)
    # average ties
    for v in np.unique(s):
        m = s == v
        if m.sum() > 1:
            ranks[m] = ranks[m].mean()
    pos = y == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
