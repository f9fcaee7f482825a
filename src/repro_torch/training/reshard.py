"""Checkpoint resharding across word-shard layouts (DESIGN.md §10); a
numpy copy of ``repro.training.reshard``.

A checkpoint records the ``n_model_shards`` it was written under; resuming
with a different value (most commonly: an old replicated checkpoint into a
P-way word-sharded session, or a sharded session back onto one device) only
changes the *layout* of Φ rows and token stacks — never the model. Both
layouts index the same coarse vocabulary placement: shard ``m`` holds coarse
rows ``0..rows_coarse``; a P-way layout stores coarse row ``r`` at
``(r % P) · rpm + r // P`` with ``rpm = ceil(rows_coarse / P)`` (slice-major,
see ``repro_torch.data.corpus.shard_corpus``). Resharding is therefore a pure row
permutation through the coarse ids:

    g_old = (r % P_old) · rpm_old + r // P_old
    g_new = (r % P_new) · rpm_new + r // P_new

applied identically to Φ, the aggregation ref, and the alias word tables
(``wq``/``wp``/``wa`` are per-row — permuting them preserves the §9 staleness
contract exactly). Ψ, α and the alias α table are row-layout-free and pass
through. Resident token stacks cannot be permuted in place (cap bucketing
changes too); they are rebuilt from the session's freshly sharded corpus and
the sampled z carried over through the global token uids.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def row_permutation(rows_coarse: int, p_old: int, rows_old: int,
                    p_new: int, rows_new: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Gather/scatter index pair moving coarse rows between slice layouts.

    Returns ``(g_old, g_new)`` of length ``rows_coarse``: the value at padded
    row ``g_old[r]`` of the old layout belongs at padded row ``g_new[r]`` of
    the new one.
    """
    if rows_old % p_old or rows_new % p_new:
        raise ValueError(
            f"padded rows must divide by the slice count: got "
            f"{rows_old}/{p_old} and {rows_new}/{p_new}")
    r = np.arange(rows_coarse)
    rpm_old = rows_old // p_old
    rpm_new = rows_new // p_new
    g_old = (r % p_old) * rpm_old + r // p_old
    g_new = (r % p_new) * rpm_new + r // p_new
    return g_old, g_new


def permute_rows(arr, g_old: np.ndarray, g_new: np.ndarray,
                 rows_new: int) -> np.ndarray:
    """Move axis ``-2`` (the Φ row axis) between layouts; pad rows zero-fill
    (they are never sampled — no word maps to them)."""
    arr = np.asarray(arr)
    shape = list(arr.shape)
    shape[-2] = rows_new
    out = np.zeros(shape, arr.dtype)
    out[..., g_new, :] = arr[..., g_old, :]
    return out


def reshard_checkpoint(tree: dict, p_old: int, p_new: int,
                       scs: Sequence) -> dict:
    """Reshard a restored checkpoint tree from ``p_old`` to ``p_new`` slices.

    ``scs`` — the session's freshly sharded corpora in the NEW layout (one
    :class:`~repro_torch.data.corpus.ShardedCorpus` per pod; a single-element list
    for single-pod sessions). Returns a new tree dict; host numpy arrays
    throughout (the caller converts to device arrays).
    """
    sc0 = scs[0]
    rows_coarse = int(getattr(sc0, "rows_coarse", 0) or sc0.rows_per_shard)
    rows_new = int(sc0.rows_per_shard)
    state = list(tree["state"])
    phi_old = np.asarray(state[0])
    rows_old = int(phi_old.shape[-2])
    g_old, g_new = row_permutation(rows_coarse, p_old, rows_old,
                                   p_new, rows_new)
    state[0] = permute_rows(phi_old, g_old, g_new, rows_new)

    if len(state) == 6:
        # resident stacks: the cap bucketing changed with the layout, so the
        # stacks are rebuilt from the session's own sharding and only the
        # sampled z rides over, keyed by the layout-stable global uids
        wl_old = np.asarray(state[2])
        uid_old = np.asarray(state[4])
        z_old = np.asarray(state[5])
        pods = wl_old.ndim == 4
        valid = wl_old >= 0
        zmap = np.zeros(int(uid_old.max()) + 1, np.int32)
        zmap[uid_old[valid]] = z_old[valid]
        wls, dls, uids, zs = [], [], [], []
        for sc in scs:
            wl_n = np.asarray(sc.word_local)
            uid_n = np.asarray(sc.uid)
            wls.append(wl_n)
            dls.append(np.asarray(sc.doc_local))
            uids.append(uid_n.astype(np.uint32))
            zs.append(np.where(wl_n >= 0, zmap[uid_n], 0).astype(np.int32))
        if pods:
            state[2], state[3] = np.stack(wls), np.stack(dls)
            state[4], state[5] = np.stack(uids), np.stack(zs)
        else:
            state[2], state[3], state[4], state[5] = (
                wls[0], dls[0], uids[0], zs[0])

    out = dict(tree)
    out["state"] = tuple(state)
    if "tables" in tree:
        wq, wp, wa, ap, aa = tree["tables"]
        out["tables"] = (permute_rows(wq, g_old, g_new, rows_new),
                         permute_rows(wp, g_old, g_new, rows_new),
                         permute_rows(wa, g_old, g_new, rows_new),
                         np.asarray(ap), np.asarray(aa))
    if "refs" in tree:
        phi_r, psi_r = tree["refs"]
        out["refs"] = (permute_rows(phi_r, g_old, g_new, rows_new),
                       np.asarray(psi_r))
    return out
