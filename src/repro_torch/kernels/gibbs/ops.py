"""Dispatch of the fused Gibbs/RT-LDA argmax by the device of its tensors.

CPU tensors go to the plain version (``ref.py``); CUDA tensors go to the
hand-written kernel (``kernel.py``), which raises if it cannot launch. There
is no fallback from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels.gibbs.kernel import gibbs_argmax_cuda
from repro_torch.kernels.gibbs.ref import gibbs_argmax_ref

# CUDA kernel launches made through ``gibbs_argmax``; callers reset it to 0
# to count the launches of one run.
launches = 0


def gibbs_argmax(phi_rows, psi_rows, theta_rows, alpha, beta, token_uid, seed,
                 vocab_size: int, temperature: float = 1.0):
    global launches
    if phi_rows.device.type == "cpu":
        return gibbs_argmax_ref(phi_rows, psi_rows, theta_rows, alpha, beta,
                                token_uid, seed, vocab_size, temperature)
    out = gibbs_argmax_cuda(phi_rows, psi_rows, theta_rows, alpha, beta,
                            token_uid, seed, vocab_size, temperature)
    launches += 1
    return out
