"""Peacock layer 2: the coordinator loop (port of
``repro.core.hierarchy.run_hierarchical``).

Each pod is one Peacock layer-1 configuration. Configurations run
``agg_every`` Gibbs epochs, then the aggregation step merges model deltas,
Φ_global ← Φ_ref + Σ_pods (Φ_pod − Φ_ref). ``run_hierarchical`` is the one
epoch/boundary loop: with ``agg_fn=None`` it drives a single configuration
(the ``Trainer``'s one-device ring); with an ``agg_fn`` it merges at every
boundary. The pod-batched ring epoch and the aggregate functions
(``make_aggregate``, ``make_elastic_aggregate``) come with the multi-GPU
port (ROADMAP queue 1, item 11); here ``agg_fn`` is any callable.
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

    ``segments`` (the out-of-core schedule of Fig. 3/4) comes with the
    streaming pipeline, ``data/stream.py`` (ROADMAP queue 1); passing it
    raises ``NotImplementedError``.
    """
    if segments is not None:
        raise NotImplementedError(
            "segment streaming (segments=) comes with data/stream.py, which is not "
            "ported yet (ROADMAP queue 1, the streaming item)")
    del start_segment, on_segment_end      # streaming-only arguments
    phi, psi, wl, dl, uid, z = state
    aux = (lambda: ()) if epoch_aux is None else epoch_aux
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
