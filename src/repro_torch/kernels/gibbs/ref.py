"""Plain PyTorch version of the fused Gibbs/RT-LDA argmax.

The same formula as ``repro.kernels.gibbs.ref`` and as the CUDA kernel in
``csrc/gibbs_argmax.cu``, including the counter-based Gumbel noise; ties and
NaNs go as in ``torch.argmax`` and ``jnp.argmax`` (NaN counts as the largest
value, the lowest index wins).
"""
from __future__ import annotations

import torch

from repro_torch.core import prng


def gibbs_scores(
    phi_rows: torch.Tensor,    # [T, K] f32 — self-excluded phi[w_t] rows
    psi_rows: torch.Tensor,    # [T, K] f32 plane, or one [K] row
    theta_rows: torch.Tensor,  # [T, K] f32 — self-excluded theta[d_t] rows
    alpha: torch.Tensor,       # [K] f32
    beta: torch.Tensor,        # [] f32
    token_uid: torch.Tensor,   # [T] int64 holding uint32 counters
    seed: int,                 # uint32
    vocab_size: int,
    temperature: float = 1.0,
) -> torch.Tensor:
    """The [T, K] f32 score plane whose row argmax is the draw."""
    K = phi_rows.shape[1]
    vb = vocab_size * beta
    logits = (
        torch.log(phi_rows + beta)
        - torch.log(psi_rows + vb)
        + torch.log(theta_rows + alpha[None, :])
    )
    if temperature > 0.0:
        k = torch.arange(K, dtype=torch.int64, device=phi_rows.device)
        g = prng.gumbel(int(seed), token_uid.to(torch.int64)[:, None], k[None, :])
        logits = logits + float(temperature) * g
    return logits


def gibbs_argmax_ref(phi_rows, psi_rows, theta_rows, alpha, beta, token_uid, seed,
                     vocab_size: int, temperature: float = 1.0) -> torch.Tensor:
    """[T] int32: the row argmax of ``gibbs_scores`` on the same arguments."""
    scores = gibbs_scores(phi_rows, psi_rows, theta_rows, alpha, beta, token_uid, seed,
                          vocab_size, temperature)
    return torch.argmax(scores, dim=1).to(torch.int32)
