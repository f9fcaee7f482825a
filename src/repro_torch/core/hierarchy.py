"""Peacock layer 2: the coordinator loop (port of
``repro.core.hierarchy.run_hierarchical``).

Each pod is one Peacock layer-1 configuration. Configurations run
``agg_every`` Gibbs epochs, then the aggregation step merges model deltas,
Φ_global ← Φ_ref + Σ_pods (Φ_pod − Φ_ref). ``run_hierarchical`` is the one
epoch/boundary loop: with ``agg_fn=None`` it drives a single configuration
(the ``Trainer``'s one-device ring); with an ``agg_fn`` it merges at every
boundary; with ``segments=`` it streams the corpus through a
``SegmentStream`` (Fig. 3/4). The pod-batched ring epoch and the aggregate
functions (``make_aggregate``, ``make_elastic_aggregate``) come with the
multi-GPU port (ROADMAP queue 1, item 11); here ``agg_fn`` is any callable.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFF_FFFF


def run_hierarchical(
    epoch_fn, agg_fn, state, alpha, beta, n_epochs: int, agg_every: int,
    seed0: int = 0, liveness=None, start_epoch: int = 0,
    on_epoch_end=None, on_aggregate=None, refs=None,
    segments=None, start_segment: int = 0, on_segment_end=None,
    epoch_aux=None,
):
    """Coordinator loop: epochs in each pod, aggregate every ``agg_every``.

    ``state`` = (phi, psi, wl, dl, uid, z). Returns the final state, merged at
    the last boundary. ``epoch_fn(phi, psi, wl, dl, uid, z, alpha, beta,
    seed, *epoch_aux())`` runs one epoch; the seed of epoch ``ep`` is
    ``(seed0 + ep) mod 2³²``, the JAX package's ``jnp.uint32(seed0 + ep)``.

    ``agg_fn=None`` runs the single-configuration schedule (no boundaries).
    Otherwise ``agg_fn(phi, psi, phi_ref, psi_ref, seed=seed0 + ep)`` (plus
    ``live=liveness(ep)`` when a ``liveness`` probe is given) returns the
    merged (phi, psi) at every boundary, which become the next refs (cloned,
    so that an epoch updating its state in place leaves them alone).
    ``refs`` resumes a multi-pod run mid-window against the refs of the last
    boundary before the checkpoint.

    ``on_aggregate(ep, state)`` fires after each boundary merge;
    ``on_epoch_end(ep, state, alpha)`` fires after every epoch (post-merge at
    boundaries) and may return a replacement ``alpha`` for the next epoch.
    ``epoch_aux`` is a zero-arg callable returning extra positional args for
    every ``epoch_fn`` call (the alias sampler's stale proposal tables),
    re-invoked per epoch.

    ``segments`` (a :class:`repro_torch.data.SegmentStream`) switches the
    loop to the Fig. 3/4 out-of-core schedule: ``state`` is then just
    ``(phi, psi)`` — the n_t the paper carries across segment swaps — and
    each epoch iterates the stream's segments, calling ``epoch_fn(phi, psi,
    wl, dl, uid, z, ...)`` per segment (LoadShard), then ``segments.commit``
    (SaveShard). The epoch's seed is shared by its segments — tokens carry
    globally unique uids, so the counter-based RNG stays decorrelated.
    ``start_segment`` resumes the FIRST replayed epoch at a mid-epoch
    segment boundary (the visit order is a seeded permutation, so replay
    regenerates it); ``on_segment_end(ep, seg, (phi, psi))`` fires after
    each segment's swap. Streaming is single-configuration: ``agg_fn`` must
    be ``None``. The branch returns ``(phi, psi)``.
    """
    aux = (lambda: ()) if epoch_aux is None else epoch_aux
    if segments is not None:
        if agg_fn is not None:
            raise ValueError("segment streaming drives a single "
                             "configuration: agg_fn must be None")
        phi, psi = state[0], state[1]
        for ep in range(start_epoch, n_epochs):
            first = start_segment if ep == start_epoch else 0
            for seg in segments.epoch(ep, start=first):
                phi, psi, _, _, _, z = epoch_fn(
                    phi, psi, seg.wl, seg.dl, seg.uid, seg.z,
                    alpha, beta, (seed0 + ep) & _M32, *aux())
                segments.commit(seg, z)                      # SaveShard
                if on_segment_end is not None:
                    on_segment_end(ep, seg, (phi, psi))
            if on_epoch_end is not None:
                new_alpha = on_epoch_end(ep, (phi, psi), alpha)
                if new_alpha is not None:
                    alpha = new_alpha
        return phi, psi

    phi, psi, wl, dl, uid, z = state
    if agg_fn is not None:
        if refs is not None:
            phi_ref, psi_ref = refs
        else:
            # refs must survive the epochs' in-place updates
            phi_ref, psi_ref = torch.clone(phi), torch.clone(psi)
    for ep in range(start_epoch, n_epochs):
        phi, psi, wl, dl, uid, z = epoch_fn(
            phi, psi, wl, dl, uid, z, alpha, beta, (seed0 + ep) & _M32, *aux())
        if agg_fn is not None and (ep + 1) % agg_every == 0:
            # boundary index as quantization seed (decorrelated rounding)
            if liveness is not None:
                phi, psi = agg_fn(phi, psi, phi_ref, psi_ref,
                                  live=liveness(ep), seed=seed0 + ep)
            else:
                phi, psi = agg_fn(phi, psi, phi_ref, psi_ref, seed=seed0 + ep)
            phi_ref, psi_ref = torch.clone(phi), torch.clone(psi)
            if on_aggregate is not None:
                on_aggregate(ep, (phi, psi, wl, dl, uid, z))
        if on_epoch_end is not None:
            new_alpha = on_epoch_end(ep, (phi, psi, wl, dl, uid, z), alpha)
            if new_alpha is not None:
                alpha = new_alpha
    return phi, psi, wl, dl, uid, z
