"""The yardstick's arithmetic: the card's published peaks, the least time a
piece of work can take on it, and the operations and bytes each kernel and
each step needs, counted from shapes.

Frozen copies: ``bound``, ``build_bytes``, ``mh_ops``, ``GIBBS_OPS_PER_ELEMENT``
and ``SWEEP_OPS_PER_SLOT`` are ``chip_smoke.py``'s (its ``bound`` at line 573,
``build_bytes`` at 589, ``mh_ops`` at 822, the constants at 235 and 239);
``gibbs_bytes`` is ``repro_torch/kernels/gibbs/ops.py:kernel_bytes`` stated on
shapes. Later changes add functions here and edit none: a share of a roofline
is only comparable across PRs while its bound stays as it was.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W limit: HBM3
# bandwidth and float32 outside the tensor cores (the port keeps TF32 off,
# so its f32 GEMMs run there too). A card set below 700 W runs slower; every
# share is printed beside the card's power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# gibbs_argmax, per (token, topic) element, each logf counted as one: 3 adds
# for the log arguments, 5 logf, 2 to combine the three terms, 6 for the
# uniform and Gumbel transform, tau*g and its add, 1 compare (18 float), and
# 12 integer operations of the murmur3 hash (chip_smoke.py:235).
GIBBS_OPS_PER_ELEMENT = 30

# One Walker-sweep step of alias_build (compares, selects, the two float
# subtractions, cursor increments), per (row, slot) (chip_smoke.py:239).
SWEEP_OPS_PER_SLOT = 20

# Eq. 4 of RT-LDA, per (trial, hill step, token, candidate): the compare that
# forms Θ at the candidate, the P̂ gather, the score's subtract, add and
# multiply, the mask, the max and the R term's share (8 in all).
EQ4_OPS_PER_CANDIDATE = 8


def bound(bytes_moved: float, ops: float) -> tuple:
    """(least seconds, what bounds it): the larger of the bytes over the HBM
    peak and the operations over the f32 peak (chip_smoke.py:573, in s)."""
    bytes_s = bytes_moved / HBM_BYTES_PER_S
    ops_s = ops / F32_OPS_PER_S
    return max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s else "operations")


def gibbs_bytes(T: int, K: int, psi_plane: bool = True) -> float:
    """Bytes gibbs_argmax must move for T tokens of K topics: φ and θ rows
    [T, K] f32 and ψ ([T, K] plane, or one [K] row) read once, α [K] f32, the
    uids [T] int64, and z [T] int32 written once."""
    psi = 4.0 * T * K if psi_plane else 4.0 * K
    return 8.0 * T * K + psi + 4.0 * K + 8.0 * T + 4.0 * T


def gibbs_ops(T: int, K: int) -> float:
    return float(GIBBS_OPS_PER_ELEMENT) * T * K


def build_bytes(R: int, K: int) -> float:
    """Bytes the alias build must move: the weights [R, K] and the scale [R]
    read once, prob and alias [R, K] written once (chip_smoke.py:589)."""
    return 12.0 * R * K + 4.0 * R


def build_ops(R: int, K: int) -> float:
    return float(SWEEP_OPS_PER_SLOT) * R * K


def mh_ops(T: int, cap: int, n_mh: int) -> float:
    """Scalar operations of the MH probe for T tokens: per step 4 uniforms of
    ~14 integer ops, up to 3 pair-row lookups or the walk (2 per slot), and
    ~30 for the proposal, the posterior and the ratio (chip_smoke.py:822)."""
    return float(T) * (2 * cap + n_mh * (4 * 14 + 3 * 2 * cap + 30))


def mh_fixed_bytes(T: int, n_docs: int, cap: int, K: int) -> float:
    """The part of the MH probe's bytes that does not depend on the chain
    (chip_smoke.py:mh_bytes): per token w, d, z, the draw (4 B each) and the
    uid (8 B); the pair table once; ψ, α, ap, aa once. The chain's gathers
    into the [rows, K] tables add 32 B for each distinct 32-byte sector they
    touch (``reference.lda.mh_chain``'s ``sectors``)."""
    return T * 24.0 + n_docs * cap * 8.0 + 4 * K * 4.0


def dense_epoch_bytes(n_docs: int, n_words: int, K: int) -> float:
    """What one dense epoch needs to move at the least: the Θ plane of its
    docs written and read, and the Φ rows of its distinct words read, [n, K]
    int32 each, and ψ once. It counts what the algorithm needs, not the
    [T, K] planes the port's kernel is handed."""
    return 4.0 * K * (2 * n_docs + n_words) + 4.0 * K


def serve_gemm_flops(rows: int, K: int, V: int) -> float:
    """Eq. 5's f32 product pkd [rows, K] @ P̂ᵀ [K, V]: 2·rows·K·V."""
    return 2.0 * rows * K * V


def eq4_ops(rows: int, Ld: int, n_trials: int, n_iters: int) -> float:
    """Eq. 4's hill climb for ``rows`` queries padded to Ld tokens: every
    token scores the Ld candidates of its query each step."""
    return float(EQ4_OPS_PER_CANDIDATE) * n_trials * n_iters * rows * Ld * Ld
