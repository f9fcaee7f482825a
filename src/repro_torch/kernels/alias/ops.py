"""Dispatch of the alias-table build and the MH probe by the device of their
tensors (port of ``repro.kernels.alias.ops``).

CPU tensors go to the plain versions (``ref.py``); CUDA tensors go to the
hand-written kernels (``kernel.py``), which raise if they cannot launch. There
is no fallback from one to the other.

``build_alias`` normalizes and partitions ONCE here (``_prepare``) and hands
the same (wn, order, ns) to whichever sweep runs, so kernel and plain version
agree bit for bit. ``mh_resample`` mixes the sampler seed with a
sampler-family salt and sums α here, once, for both; on the card it also
sorts the tokens by word before the launch (same-word probes then share
cached table rows) and scatters the draws back, which changes no bit: every
token samples independently against the same snapshot.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.kernels.alias.kernel import alias_build_cuda, mh_resample_cuda
from repro_torch.kernels.alias.ref import build_alias_ref, mh_resample_ref

# decorrelates the MH uniform stream from the dense sampler's Gumbel stream
MH_SALT = 0x5EED_A11A

# CUDA kernel launches made through ``build_alias`` and ``mh_resample``;
# callers reset them to 0 to count the launches of one run.
build_launches = 0
mh_launches = 0


def _prepare(weights: torch.Tensor):
    """Mean-1 normalization and stable small/large partition of [R, K] rows.

    Returns (wn [R, K] f32, order [R, K] int32, ns [R] int32): ``order`` lists
    the small slots (wn < 1, NaN included) in index order, then the large
    ones; ``ns`` is the per-row small count. The order is one stable sort of
    the is-large flags, as ``jnp.argsort(..., stable=True)``.
    """
    K = weights.shape[-1]
    total = weights.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    wn = weights * (K / total)
    is_large = wn >= 1.0
    order = torch.sort(is_large.to(torch.uint8), dim=-1, stable=True).indices
    ns = (~is_large).sum(dim=-1, dtype=torch.int32)
    return wn, order.to(torch.int32), ns


def build_alias(weights: torch.Tensor, out=None):
    """Batched Walker alias tables over the trailing axis.

    weights [..., K] nonneg f32 → (prob [..., K] f32, alias [..., K] int32)
    with the table identity q(k) = (prob_k + Σ_j (1−prob_j)·1[alias_j = k])/K
    = weights_k / Σ weights (up to f32 rounding). ``out``, a (prob, alias)
    pair of contiguous tensors of that shape, receives the tables in place.
    """
    global build_launches
    lead, K = weights.shape[:-1], weights.shape[-1]
    wn, order, ns = _prepare(weights.reshape(-1, K).to(torch.float32))
    flat_out = None if out is None else tuple(o.view(-1, K) for o in out)
    if wn.device.type == "cpu":
        prob, alias = build_alias_ref(wn, order, ns)
        if flat_out is not None:
            flat_out[0].copy_(prob)
            flat_out[1].copy_(alias)
            prob, alias = flat_out
    else:
        prob, alias = alias_build_cuda(wn, order, ns, out=flat_out)
        build_launches += 1
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
