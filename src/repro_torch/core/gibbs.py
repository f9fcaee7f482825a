"""Blocked collapsed Gibbs sampling for LDA (port of ``repro.core.gibbs``).

Tokens are sampled in blocks by Gumbel-max, z_t = argmax_k [log p(z_t = k | ...)
+ G_tk], an exact draw from Eq. (1). Within a block every token sees the same
count snapshot with exact self-exclusion (¬ivd); count deltas are applied at
block boundaries. RT-LDA is the ``temperature=0`` case of the same code.

Unlike the JAX version, which returns new arrays, the count tensors handed to
``sample_block`` and ``gibbs_epoch`` are updated in place (the JAX version's
buffers would be donated); a ``[V, K]`` Φ at full width is 13 GB.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.lda import LDAState, doc_topic_counts
from repro_torch.kernels.gibbs import ops as gibbs_ops

_M32 = 0xFFFF_FFFF


def token_logits(phi_rows, psi, theta_rows, alpha, beta, vocab_size: int):
    """log of the unnormalized collapsed posterior, Eq. (1)."""
    vb = vocab_size * beta
    return (
        torch.log(phi_rows + beta)
        - torch.log(psi[None, :] + vb)
        + torch.log(theta_rows + alpha[None, :])
    )


def _self_excluded(phi, psi, theta, w, dloc, z):
    """Gather per-token f32 rows with the token's own assignment removed (¬ivd)."""
    T, K = z.shape[0], phi.shape[1]
    at = (torch.arange(T, device=z.device), z)
    phi_rows = phi[w].to(torch.float32)
    phi_rows[at] -= 1.0
    theta_rows = theta[dloc].to(torch.float32)
    theta_rows[at] -= 1.0
    psi_rows = psi.to(torch.float32).expand(T, K).clone()
    psi_rows[at] -= 1.0
    return phi_rows, psi_rows, theta_rows


def _add_at(x, index, value):
    x.index_put_(index, value, accumulate=True)


def sample_block(phi, psi, theta, z, w, dloc, token_uid, alpha, beta, seed: int,
                 vocab_size: int, temperature: float = 1.0) -> Tuple[torch.Tensor, ...]:
    """One Gumbel-max Gibbs sweep over a token block.

    ``phi`` [V, K], ``psi`` [K], ``theta`` [D_blk, K] int32 are updated in place;
    ``z``, ``w``, ``dloc`` [T] int; ``token_uid`` [T] int64 RNG counters.
    The draw goes through ``ops.gibbs_argmax``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. ``vocab_size`` is the global
    V of the smoothing constant V·β. Returns (z_new, phi, psi, theta).
    """
    w, dloc, z = w.long(), dloc.long(), z.long()
    phi_rows, psi_rows, theta_rows = _self_excluded(phi, psi, theta, w, dloc, z)
    z_new = gibbs_ops.gibbs_argmax(phi_rows, psi_rows, theta_rows, alpha, beta,
                                   token_uid, seed, vocab_size, temperature)
    zn = z_new.long()
    one = torch.ones_like(z, dtype=torch.int32)
    _add_at(phi, (w, z), -one)
    _add_at(phi, (w, zn), one)
    _add_at(psi, (z,), -one)
    _add_at(psi, (zn,), one)
    _add_at(theta, (dloc, z), -one)
    _add_at(theta, (dloc, zn), one)
    return z_new, phi, psi, theta


def gibbs_epoch(state: LDAState, word_ids, doc_ids, n_docs: int, vocab_size: int,
                seed: int, n_sweeps: int = 1, block_size: int = 8192) -> LDAState:
    """Full single-device Gibbs pass: a loop over fixed-size token blocks.

    The corpus must be padded to a multiple of ``block_size`` with
    word_id == -1 sentinels (``data.corpus.pad_corpus``). Sentinels are sampled
    against row 0 like every token, then their count updates are rolled back,
    so they leave Φ, Ψ and Θ as they were and keep their z. ``state.phi`` and
    ``state.psi`` are updated in place; the returned state shares them.
    """
    n_tokens = word_ids.shape[0]
    if n_tokens % block_size:
        raise ValueError(f"pad the corpus to a multiple of block_size={block_size}")
    K = state.n_topics
    phi, psi = state.phi, state.psi
    word_ids, doc_ids = word_ids.long(), doc_ids.long()
    theta = doc_topic_counts(doc_ids, state.z, n_docs, K)
    token_uid = torch.arange(n_tokens, dtype=torch.int64, device=phi.device)
    z = state.z.clone()

    for sweep in range(n_sweeps):
        sweep_seed = ((int(seed) & _M32) + sweep) & _M32
        for lo in range(0, n_tokens, block_size):
            blk = slice(lo, lo + block_size)
            w, d, zb = word_ids[blk], doc_ids[blk], z[blk].long()
            valid = w >= 0
            w_safe = torch.where(valid, w, 0)
            d_safe = torch.where(valid, d, 0)
            z_raw, phi, psi, theta = sample_block(
                phi, psi, theta, zb, w_safe, d_safe, token_uid[blk],
                state.alpha, state.beta, sweep_seed, vocab_size, 1.0)
            # roll back the sentinels' updates: +1 where sample_block took one
            # off (z), −1 where it added one (the raw draw)
            zr = z_raw.long()
            undo = (~valid).to(torch.int32)
            _add_at(phi, (w_safe, zb), undo)
            _add_at(phi, (w_safe, zr), -undo)
            _add_at(psi, (zb,), undo)
            _add_at(psi, (zr,), -undo)
            _add_at(theta, (d_safe, zb), undo)
            _add_at(theta, (d_safe, zr), -undo)
            z[blk] = torch.where(valid, z_raw, zb.to(torch.int32))
    return LDAState(phi=phi, psi=psi, z=z, alpha=state.alpha, beta=state.beta)


def fold_in(phi, psi, alpha, beta, word_ids, doc_ids, z0, n_docs: int,
            vocab_size: int, seed: int, n_sweeps: int = 10):
    """Held-out inference: resample z for unseen documents with phi/psi FROZEN.

    Used by perplexity evaluation (paper Fig. 5B) and as the reference against
    which RT-LDA is compared. Returns (z, theta).
    """
    K = phi.shape[1]
    word_ids, doc_ids = word_ids.long(), doc_ids.long()
    z = z0.to(torch.int32)
    theta = doc_topic_counts(doc_ids, z, n_docs, K)
    token_uid = torch.arange(word_ids.shape[0], dtype=torch.int64, device=phi.device)
    rows = torch.arange(word_ids.shape[0], device=phi.device)
    phi_rows = phi[word_ids].to(torch.float32)
    psi_f = psi.to(torch.float32)
    for s in range(n_sweeps):
        theta_rows = theta[doc_ids].to(torch.float32)
        theta_rows[rows, z.long()] -= 1.0
        z_new = gibbs_ops.gibbs_argmax(phi_rows, psi_f, theta_rows, alpha, beta, token_uid,
                                       ((int(seed) & _M32) + s) & _M32, vocab_size, 1.0)
        one = torch.ones_like(z_new)
        _add_at(theta, (doc_ids, z.long()), -one)
        _add_at(theta, (doc_ids, z_new.long()), one)
        z = z_new
    return z, theta
