"""Peacock layer 2: replicated configurations with stale-synchronous
aggregation (port of ``repro.core.hierarchy``).

Each pod is one Peacock layer-1 configuration: a full model replica (every Φ
vocab shard, over the pod's ranks) plus its own partition of the corpus.
Configurations run ``agg_every`` Gibbs epochs, then the aggregation step
merges model deltas,

    Φ_global ← Φ_ref + Σ_pods (Φ_pod − Φ_ref)        (ΔΦ aggregation)

which is one all-reduce over the ``"pod"`` group: each rank merges its block
with the ranks of the same (data, model) coordinate in the other pods (the
m-th sampling server reporting to the m-th aggregation server).

``run_hierarchical`` is the one epoch/boundary loop: with ``agg_fn=None`` it
drives a single configuration (the ``Trainer``'s ring); with an ``agg_fn``
(``make_aggregate``, exact or compressed, or ``make_elastic_aggregate``) it
merges at every boundary; with ``segments=`` it streams the corpus through a
``SegmentStream`` (Fig. 3/4). Fault recovery (§3.1.4): a failed pod restores
from its own checkpoint and rejoins at the next boundary; the elastic merge
drops the deltas of dead pods, and the other pods never roll back.
"""
from __future__ import annotations

import torch

from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import RankLayout

_M32 = 0xFFFF_FFFF


def _exact_merge_(x, ref, layout: RankLayout) -> None:
    """x ← ref + Σ_pods (x − ref), in place: no temporary the size of x."""
    x.sub_(ref)
    coll.all_reduce_(x, layout, "pod")
    x.add_(ref)


def _compressed_merge_(phi, ref, layout: RankLayout, seed: int, chunk_elems: int) -> None:
    """phi ← ref + round(compressed_psum(phi − ref)), in place, one chunk of
    rows at a time (each chunk's uniforms use the block's flat element
    counters, so the result equals the whole-block quantization)."""
    K = phi.shape[-1]
    p2, r2 = phi.view(-1, K), ref.view(-1, K)
    rows = max(1, chunk_elems // K)
    amax = torch.zeros((), dtype=torch.int32, device=phi.device)
    for lo in range(0, p2.shape[0], rows):
        amax = torch.maximum(amax, (p2[lo:lo + rows] - r2[lo:lo + rows]).abs().max())
    scale = coll.shared_scale(amax.to(torch.float32), layout, "pod")
    me = coll.group_index(layout, "pod")
    for lo in range(0, p2.shape[0], rows):
        x = (p2[lo:lo + rows] - r2[lo:lo + rows]).to(torch.float32)
        q = coll.quantize(x, scale, seed, me, 0, offset=lo * K)
        del x
        total = coll.sum_payload(q, layout, "pod")
        d = torch.round(total.to(torch.float32) * scale).to(phi.dtype)
        torch.add(r2[lo:lo + rows], d, out=p2[lo:lo + rows])


def make_aggregate(layout: RankLayout, compressed: bool = False,
                   chunk_elems: int = coll.HOST_CHUNK // 2):
    """The ΔΦ/ΔΨ merge over the pod group, in place.

    ``call(phi, psi, phi_ref, psi_ref, seed=0)`` takes this rank's views and
    the refs of the previous boundary and returns the merged (phi, psi) —
    the same on every pod. ``compressed=True`` sends ΔΦ int8-quantized
    (``repro_torch.dist.collectives``: all-gathered int8, summed in int16;
    Ψ stays exact), with the boundary index as ``seed`` so the stochastic
    rounding decorrelates across boundaries; its f32 temporaries are cut in
    chunks of ``chunk_elems`` elements.
    """
    def call(phi, psi, phi_ref, psi_ref, seed=0):
        if compressed:
            _compressed_merge_(phi, phi_ref, layout, int(seed) & _M32, chunk_elems)
        else:
            _exact_merge_(phi, phi_ref, layout)
        _exact_merge_(psi, psi_ref, layout)
        return phi, psi

    return call


def make_elastic_aggregate(layout: RankLayout):
    """§3.1.4's fault-tolerant merge: aggregate over the live pods only.

    ``call(phi, psi, phi_ref, psi_ref, live, seed=0)`` with ``live`` the
    [n_pods] flags (nonzero = alive): dead pods' deltas are dropped, and every
    pod, dead ones included, receives the merged state. ``call.last_n_live``
    records the live count of the last boundary.
    """
    def call(phi, psi, phi_ref, psi_ref, live, seed=0):
        del seed  # uncompressed: nothing stochastic at the boundary
        alive = int(live[layout.pod_index])
        _, n_live = coll.elastic_aggregate({"phi": phi, "psi": psi},
                                           {"phi": phi_ref, "psi": psi_ref}, alive, layout)
        call.last_n_live = n_live
        return phi, psi

    call.last_n_live = None
    return call


def make_pod_ring_epoch(cfg, layout: RankLayout):
    """The layer-1 ring epoch of this rank's pod: the same round loop as the
    single-pod ring (``distributed.build_epoch_body``) with the pod axis
    named, so every view carries a leading pod dim and the sampler seed is
    offset per pod. Pods never talk inside an epoch."""
    from repro_torch.core import distributed as dist

    return dist.build_epoch_body(cfg, layout, pod_axis=True)


def init_pod_state(scs, n_topics: int, layout: RankLayout, device="cuda"):
    """This rank's pod-layout views: its pod's stacks, and Φ/Ψ counted over
    every pod's z0 — every pod starts from the same global replica."""
    from repro_torch.core import distributed as dist

    return dist.rank_arrays(scs, n_topics, layout, device=device, pod_axis=True)


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
    each segment's swap. On a ring of several ranks ``epoch_fn`` is the rank
    epoch body (``distributed.build_epoch_body(cfg, layout)``), ``state`` the
    rank's (phi [1, rows/P, K], psi [K]) and the stream the rank's, which
    yields the rank's block of each segment; every rank runs the same loop.
    Streaming is single-configuration: ``agg_fn`` must be ``None``
    (``ValueError`` otherwise, as in the JAX package). The branch returns
    ``(phi, psi)``.
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
