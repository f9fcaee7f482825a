"""Dispatch of the alias-table build and the MH probe by the device of their
tensors (port of ``repro.kernels.alias.ops``).

CPU tensors go to the plain versions (``ref.py``); CUDA tensors go to the
hand-written kernels (``kernel.py``), which raise if they cannot launch. There
is no fallback from one to the other.

``build_alias`` computes the per-row mean-1 scale ONCE here (``_scale``) and
hands it to whichever sweep runs: the plain version normalizes and partitions
with it (``_prepare``), the kernel forms the same products ``w·scale`` and the
same small/large partition itself, so the two agree bit for bit. ``mh_resample`` mixes the sampler seed with a
sampler-family salt and sums α here, once, for both; on the card it also
sorts the tokens by word before the launch (same-word probes then share
cached table rows) and scatters the draws back, which changes no bit: every
token samples independently against the same snapshot.

Under an active ``dist.analysis.count_cost`` each call is charged the bytes
its kernel must move (``build_bytes``, ``mh_bytes``), whichever version
runs.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import prng
from repro_torch.dist import analysis
from repro_torch.kernels.alias.kernel import alias_build_cuda, mh_resample_cuda
from repro_torch.kernels.alias.ref import build_alias_ref, mh_resample_ref

# decorrelates the MH uniform stream from the dense sampler's Gumbel stream
MH_SALT = 0x5EED_A11A

# CUDA kernel launches made through ``build_alias`` and ``mh_resample``;
# callers reset them to 0 to count the launches of one run.
build_launches = 0
mh_launches = 0


def _scale(weights: torch.Tensor) -> torch.Tensor:
    """Per-row mean-1 scale of [R, K] rows → [R] f32: an f32 K divided by the
    row sum clamped at 1e-30, one IEEE division as JAX's
    ``jnp.float32(K) / total`` (``K / total`` with a Python int would be
    ``total.reciprocal() * K``, which rounds differently)."""
    K = weights.shape[-1]
    total = weights.sum(dim=-1).clamp_min(1e-30)
    return torch.tensor(float(K), dtype=torch.float32, device=weights.device) / total


def _prepare(weights: torch.Tensor, scale: Optional[torch.Tensor] = None):
    """Mean-1 normalization and stable small/large partition of [R, K] rows,
    for the plain sweep; ``scale`` [R] defaults to ``_scale(weights)``.

    Returns (wn [R, K] f32, order [R, K] int32, ns [R] int32): ``order`` lists
    the small slots (wn < 1, NaN included) in index order, then the large
    ones; ``ns`` is the per-row small count. The order is one stable sort of
    the is-large flags, as ``jnp.argsort(..., stable=True)``.
    """
    if scale is None:
        scale = _scale(weights)
    wn = weights * scale[:, None]
    is_large = wn >= 1.0
    order = torch.sort(is_large.to(torch.uint8), dim=-1, stable=True).indices
    ns = (~is_large).sum(dim=-1, dtype=torch.int32)
    return wn, order.to(torch.int32), ns


def build_bytes(R: int, K: int) -> float:
    """Bytes the alias build must move: the weights [R, K] and the scale [R]
    read once, prob and alias [R, K] written once."""
    return 12.0 * R * K + 4.0 * R


def mh_bytes(T: int, n_mh: int) -> float:
    """Bytes the MH probe moves at the least, from shapes alone: each
    token's w, d, z (int32) and uid (int64) read and z_new written, and per
    step about ten 4-byte gathers (φ, ψ, the pair row's entry, α and the
    proposal tables, for the proposal and the acceptance; the per-token
    term of ``dist.analysis.sampler_epoch_bytes``)."""
    return float(T) * (24.0 + 40.0 * n_mh)


def build_alias(weights: torch.Tensor, out=None):
    """Batched Walker alias tables over the trailing axis.

    weights [..., K] nonneg f32 → (prob [..., K] f32, alias [..., K] int32)
    with the table identity q(k) = (prob_k + Σ_j (1−prob_j)·1[alias_j = k])/K
    = weights_k / Σ weights (up to f32 rounding). ``out``, a (prob, alias)
    pair of contiguous tensors of that shape, receives the tables in place.
    On the card all rows go to the kernel in one launch.
    """
    global build_launches
    lead, K = weights.shape[:-1], weights.shape[-1]
    with analysis.kernel_call("alias_build") as charge:
        flat = weights.reshape(-1, K).to(torch.float32)
        scale = _scale(flat)
        flat_out = None if out is None else tuple(o.view(-1, K) for o in out)
        if flat.device.type == "cpu":
            prob, alias = build_alias_ref(*_prepare(flat, scale))
            if flat_out is not None:
                flat_out[0].copy_(prob)
                flat_out[1].copy_(alias)
                prob, alias = flat_out
        else:
            prob, alias = alias_build_cuda(flat.contiguous(), scale, out=flat_out)
            build_launches += 1
        charge(build_bytes(flat.shape[0], K))
    return prob.view(*lead, K), alias.view(*lead, K)


def mh_seed(seed: int) -> int:
    """The salted uint32 seed of the MH uniform stream."""
    return int(prng.fmix32((int(seed) ^ MH_SALT) & 0xFFFF_FFFF))


def mh_resample(phi, psi, doc_topic, doc_count, wq, wp, wa, alpha, ap, aa,
                w, d, z, uid, seed: int, beta, vocab_size: int, n_mh: int):
    """n_mh alias-MH steps per token; returns z_new [T] int32.

    See ``ref.mh_resample_ref`` for the tensor contract and the proposal
    cycle; ``uid`` is int64 holding uint32 counters, ``beta`` a float or a
    0-dim f32 tensor. ``seed`` is the raw sweep seed — the salt is mixed here.
    """
    with analysis.kernel_call("mh_resample") as charge:
        out = _mh_resample(phi, psi, doc_topic, doc_count, wq, wp, wa, alpha, ap, aa,
                           w, d, z, uid, seed, beta, vocab_size, n_mh)
        charge(mh_bytes(w.shape[0], n_mh))
    return out


def _mh_resample(phi, psi, doc_topic, doc_count, wq, wp, wa, alpha, ap, aa,
                 w, d, z, uid, seed: int, beta, vocab_size: int, n_mh: int):
    global mh_launches
    dev = phi.device
    seed2 = mh_seed(seed)
    beta = torch.as_tensor(beta, dtype=torch.float32, device=dev).reshape(())
    alpha_sum = alpha.sum(dtype=torch.float32)
    if dev.type == "cpu":
        return mh_resample_ref(phi, psi, doc_topic, doc_count, wq, wp, wa, alpha, ap,
                               aa, w, d, z, uid, seed2, beta, alpha_sum, vocab_size,
                               n_mh)
    # by-word batching: stable sort by word, launch, scatter the draws back
    order = torch.sort(w, stable=True).indices
    as32 = lambda x: x[order].to(torch.int32).contiguous()
    out_sorted = mh_resample_cuda(
        phi, psi, doc_topic, doc_count, wq, wp, wa, alpha, ap, aa, as32(w), as32(d),
        as32(z), uid[order].to(torch.int64).contiguous(), seed2, beta, alpha_sum,
        vocab_size, n_mh)
    mh_launches += 1
    out = torch.empty_like(out_sorted)
    out[order] = out_sorted
    return out
