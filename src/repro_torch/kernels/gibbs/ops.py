"""Dispatch of the fused Gibbs/RT-LDA argmax by the device of its tensors.

CPU tensors go to the plain version (``ref.py``); CUDA tensors go to the
hand-written kernel (``kernel.py``), which raises if it cannot launch. There
is no fallback from one to the other.
"""
from __future__ import annotations

from repro_torch.dist import analysis
from repro_torch.kernels.gibbs.kernel import gibbs_argmax_cuda
from repro_torch.kernels.gibbs.ref import gibbs_argmax_ref

# CUDA kernel launches made through ``gibbs_argmax``; callers reset it to 0
# to count the launches of one run.
launches = 0


def kernel_bytes(phi_rows, psi_rows, theta_rows, alpha, token_uid) -> float:
    """Bytes the scan must move: its inputs read once (φ and θ rows [T, K],
    ψ [T, K] or [K], α [K], the uids [T]) and z [T] int32 written once."""
    ins = (phi_rows, psi_rows, theta_rows, alpha, token_uid)
    return sum(analysis.tensor_bytes(t) for t in ins) + 4.0 * phi_rows.shape[0]


def gibbs_argmax(phi_rows, psi_rows, theta_rows, alpha, beta, token_uid, seed,
                 vocab_size: int, temperature: float = 1.0):
    global launches
    with analysis.kernel_call("gibbs_argmax") as charge:
        if phi_rows.device.type == "cpu":
            out = gibbs_argmax_ref(phi_rows, psi_rows, theta_rows, alpha, beta,
                                   token_uid, seed, vocab_size, temperature)
        else:
            out = gibbs_argmax_cuda(phi_rows, psi_rows, theta_rows, alpha, beta,
                                    token_uid, seed, vocab_size, temperature)
            launches += 1
        charge(kernel_bytes(phi_rows, psi_rows, theta_rows, alpha, token_uid))
    return out
